"""Preference-pair dataset for MPO / DPO training (a copy of
vlaser_tpu/data/preference_dataset.py: numpy, PIL imported only where an
image item is read).

Parity surface: internvl/train/internvl_chat_mpo.py:400-520 -- JSONL items
{image?, question, chosen, rejected}; the chosen and rejected responses are
tokenized as two conversations sharing the same (image +) question, with
assistant-only label masking. The pair shares one set of pixel tiles.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..image.tiling import load_image_tiles
from .chat_dataset import IGNORE_TOKEN_ID, preprocess_internvl2_5


@dataclass
class PreferenceDatasetConfig:
    jsonl_path: str
    image_root: str = ""
    template: str = "internvl2_5"
    num_image_token: int = 256
    image_size: int = 448
    max_dynamic_patch: int = 6  # MPO recipe uses fewer tiles than SFT
    max_seq_length: int = 4096


class PreferenceDataset:
    def __init__(self, cfg: PreferenceDatasetConfig, tokenizer):
        self.cfg = cfg
        self.tokenizer = tokenizer
        with open(cfg.jsonl_path) as f:
            self.lines = f.readlines()

    def __len__(self):
        return len(self.lines)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        for attempt in range(10):
            try:
                return self._get(i)
            except Exception:
                if attempt == 9:
                    raise
                i = random.Random(i + attempt).randrange(len(self.lines))
        raise RuntimeError("unreachable")

    def _get(self, i: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        item = json.loads(self.lines[i])
        question = item["question"]
        if item.get("image"):
            from PIL import Image

            img = Image.open(
                os.path.join(cfg.image_root, item["image"])
            ).convert("RGB")
            tiles = load_image_tiles(
                img, cfg.image_size, 1, cfg.max_dynamic_patch,
                use_thumbnail=True, dynamic=True,
            )
            flags = np.ones(len(tiles), np.int32)
            if "<image>" not in question:
                question = "<image>\n" + question
            n_tok = [cfg.num_image_token * len(tiles)]
            text_only = False
        else:
            tiles = np.zeros((1, cfg.image_size, cfg.image_size, 3), np.float32)
            flags = np.zeros(1, np.int32)
            n_tok = []
            text_only = True

        out: Dict[str, np.ndarray] = {
            "pixel_values": tiles.astype(np.float32),
            "image_flags": flags,
        }
        for side in ("chosen", "rejected"):
            convs = [
                {"from": "human", "value": question},
                {"from": "gpt", "value": item[side]},
            ]
            ids, labels = preprocess_internvl2_5(
                convs, self.tokenizer, n_tok, cfg.template, text_only=text_only
            )
            out[f"{side}_input_ids"] = ids[: cfg.max_seq_length]
            out[f"{side}_labels"] = labels[: cfg.max_seq_length]
        return out


def preference_collate(samples: List[Dict[str, np.ndarray]],
                       pad_token_id: int) -> Dict[str, np.ndarray]:
    """Pad chosen/rejected to one shared max length (the concatenated forward
    in train/mpo.py requires equal sequence lengths)."""
    max_len = max(
        max(len(s["chosen_input_ids"]), len(s["rejected_input_ids"]))
        for s in samples
    )
    b = len(samples)
    out: Dict[str, np.ndarray] = {}
    for side in ("chosen", "rejected"):
        ids = np.full((b, max_len), pad_token_id, np.int32)
        labels = np.full((b, max_len), IGNORE_TOKEN_ID, np.int32)
        seg = np.zeros((b, max_len), np.int32)
        for i, s in enumerate(samples):
            n = len(s[f"{side}_input_ids"])
            ids[i, :n] = s[f"{side}_input_ids"]
            labels[i, :n] = s[f"{side}_labels"]
            seg[i, :n] = 1
        out[f"{side}_input_ids"] = ids
        out[f"{side}_labels"] = labels
        out[f"{side}_seg_ids"] = seg
    out["pixel_values"] = np.concatenate([s["pixel_values"] for s in samples], 0)
    out["image_flags"] = np.concatenate([s["image_flags"] for s in samples], 0)
    return out
