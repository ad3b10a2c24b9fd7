"""VLA input processor: camera frames + instruction -> model inputs
(`InternVLAProcessor` of vlaser_tpu/policy/processing.py, copied unchanged
with the three image tags of vlaser_tpu/tokenizer/conversation.py).

Prompt `<|im_start|>system\\nNone<|im_end|>\\n<|im_start|>user\\n<img>{N x
<IMG_CONTEXT>}</img>\\n{instruction}<|im_end|>\\n<|im_start|>assistant\\n`,
right-padded to max_seq_len; ImageNet-normalized uint8 frames.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..image.tiling import normalize_uint8

IMG_START_TOKEN = "<img>"
IMG_END_TOKEN = "</img>"
IMG_CONTEXT_TOKEN = "<IMG_CONTEXT>"


class InternVLAProcessor:
    def __init__(
        self,
        tokenizer,
        num_image_tokens: int = 256,
        max_seq_len: int = 384,
        pad_token_id: Optional[int] = None,
        num_images: int = 1,
    ):
        self.tokenizer = tokenizer
        self.num_image_tokens = num_image_tokens
        self.max_seq_len = max_seq_len
        self.num_images = num_images
        self.pad_token_id = (
            pad_token_id if pad_token_id is not None else tokenizer.pad_token_id
        )

    def build_prompt(self, instruction: str) -> str:
        img = IMG_START_TOKEN + IMG_CONTEXT_TOKEN * (
            self.num_image_tokens * self.num_images
        ) + IMG_END_TOKEN
        return (
            "<|im_start|>system\nNone<|im_end|>\n"
            f"<|im_start|>user\n{img}\n{instruction}<|im_end|>\n"
            "<|im_start|>assistant\n"
        )

    def __call__(
        self,
        text: Sequence[str],
        images: np.ndarray,  # [B, T_img, H, W, 3] uint8
    ) -> Dict[str, np.ndarray]:
        assert images.dtype == np.uint8
        b = len(text)
        pixel_values = normalize_uint8(images).reshape(
            (-1,) + images.shape[-3:]
        )  # [B*T_img, H, W, 3]

        input_ids = np.full((b, self.max_seq_len), self.pad_token_id, np.int32)
        attention_mask = np.zeros((b, self.max_seq_len), np.int32)
        for i, instr in enumerate(text):
            ids = self.tokenizer(self.build_prompt(instr),
                                 add_special_tokens=False)["input_ids"]
            ids = ids[: self.max_seq_len]
            input_ids[i, : len(ids)] = ids
            attention_mask[i, : len(ids)] = 1
        return {
            "input_ids": input_ids,
            "pixel_values": pixel_values.astype(np.float32),
            "attention_mask": attention_mask,
        }
