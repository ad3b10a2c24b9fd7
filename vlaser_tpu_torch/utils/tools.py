"""Checkpoint tools (a copy of vlaser_tpu/utils/tools.py; numpy, with
PIL, imageio and torch.load imported inside the functions that use them):
torch VLA checkpoint conversion, pos-emb resize, ViT / projector
extraction, the InternVL special tokens and the vocab resize the training
CLIs apply, and the data-prep helpers.

Parity surface: internvl_chat/tools/ (merge_lora.py -> train.lora;
internvl_hf2custom.py / custom2hf -> utils.hf_convert + this module;
extract scripts; modeling resize_pos_embeddings: modeling_intern_vit.py:378)
and the Simpler VLA single-.pt checkpoint layout (train.py:641-683,
including the '_orig_mod.' torch.compile prefix strip).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from .hf_convert import _np, _stack, convert_internvit


def resize_pos_embeddings(
    pos_emb: np.ndarray,  # [1, old_n*old_n + 1, C]
    new_side: int,
) -> np.ndarray:
    """Bicubic-resize the patch grid of a learnable position embedding
    (modeling_intern_vit.py:378-392); CLS slot preserved."""
    from PIL import Image

    cls, patch = pos_emb[:, :1], pos_emb[:, 1:]
    n = int(round(patch.shape[1] ** 0.5))
    c = patch.shape[-1]
    grid = patch.reshape(n, n, c)
    out = np.empty((new_side, new_side, c), np.float32)
    # channel-wise PIL bicubic (float32 'F' mode)
    for ch in range(c):
        img = Image.fromarray(grid[:, :, ch].astype(np.float32), mode="F")
        out[:, :, ch] = np.asarray(
            img.resize((new_side, new_side), Image.BICUBIC)
        )
    return np.concatenate(
        [cls, out.reshape(1, new_side * new_side, c)], axis=1
    )


def strip_compile_prefix(sd: Mapping) -> Dict:
    """Remove the '_orig_mod.' prefix torch.compile adds (train.py:681-683)."""
    return {
        (k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k): v
        for k, v in sd.items()
    }


def extract_vit_and_projector(vlm_params: Dict) -> Dict:
    """tools/extract_* analogue: pull the vision encoder + mlp1 subtree for
    re-use as a standalone encoder init."""
    return {
        "vision_model": vlm_params["vision_model"],
        "mlp1": vlm_params["mlp1"],
    }


def convert_pizero_torch_checkpoint(
    sd: Mapping,
    num_layers: int,
    vision_layers: int = 24,
) -> Dict:
    """Simpler VLA .pt 'model' state dict -> PiZeroVLA flax params.

    Key layout per the reference PiZero module tree (pizero_internvl.py:
    vision_tower.vision_model.*, multi_modal_projector.{0,1,3}, embed_tokens,
    joint_model.mixtures.{vlm,action}.layers.N.* (proprio ties action),
    joint_model.mixtures.{vlm,action}.norm, action_encoder.linear_{1,2,3},
    proprio_encoder, action_decoder).
    """
    sd = strip_compile_prefix(sd)

    def lin(prefix):
        out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
        if f"{prefix}.bias" in sd:
            out["bias"] = _np(sd[f"{prefix}.bias"])
        return out

    def mixture_layers(name):
        p = f"joint_model.mixtures.{name}.layers"
        lay: Dict = {"mlp": {}}
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            entry = {
                "kernel": _stack(sd, f"{p}.{{}}.self_attn.{proj}.weight",
                                 num_layers, True)
            }
            if f"{p}.0.self_attn.{proj}.bias" in sd:
                entry["bias"] = _stack(
                    sd, f"{p}.{{}}.self_attn.{proj}.bias", num_layers
                )
            lay[proj] = entry
        for proj in ("gate_proj", "up_proj", "down_proj"):
            lay["mlp"][proj] = {
                "kernel": _stack(sd, f"{p}.{{}}.mlp.{proj}.weight", num_layers, True)
            }
        for norm in ("input_layernorm", "post_attention_layernorm"):
            lay[norm] = {
                "weight": _stack(sd, f"{p}.{{}}.{norm}.weight", num_layers)
            }
        return lay

    params = {
        "vision_model": convert_internvit(
            sd, vision_layers, "vision_tower.vision_model."
        ),
        "mlp1": {
            "norm": {
                "weight": _np(sd["multi_modal_projector.0.weight"]),
                "bias": _np(sd["multi_modal_projector.0.bias"]),
            },
            "fc1": lin("multi_modal_projector.1"),
            "fc2": lin("multi_modal_projector.3"),
        },
        "embed_tokens": {"embedding": _np(sd["embed_tokens.weight"])},
        "joint": {
            "layers": {
                "vlm": mixture_layers("vlm"),
                "expert": mixture_layers("action"),
            },
            "vlm_norm": {
                "weight": _np(sd["joint_model.mixtures.vlm.norm.weight"])
            },
            "expert_norm": {
                "weight": _np(sd["joint_model.mixtures.action.norm.weight"])
            },
        },
        "action_encoder": {
            "linear_1": lin("action_encoder.linear_1"),
            "linear_2": lin("action_encoder.linear_2"),
            "linear_3": lin("action_encoder.linear_3"),
        },
        "proprio_encoder": lin("proprio_encoder"),
        "action_decoder": lin("action_decoder"),
    }
    return params


def load_torch_checkpoint(path: str) -> Dict:
    """Load a torch .pt on CPU and return the model state dict
    (train.py:641-672 layout: {'model': ..., 'optimizer': ..., ...})."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        return ckpt["model"]
    return ckpt


def ensure_special_tokens(tokenizer):
    """Add the 9 InternVL special tokens if absent; returns (n_added,
    img_context_id, img_start_id, img_end_id).

    Parity: internvl_chat_finetune.py:865-876 — the SFT entry always adds the
    token set and records img_context_token_id on the model."""
    from ..tokenizer.conversation import (
        IMG_CONTEXT_TOKEN, IMG_END_TOKEN, IMG_START_TOKEN, SPECIAL_TOKENS,
    )

    n_added = tokenizer.add_tokens(SPECIAL_TOKENS, special_tokens=True)
    ids = tokenizer.convert_tokens_to_ids(
        [IMG_CONTEXT_TOKEN, IMG_START_TOKEN, IMG_END_TOKEN]
    )
    return n_added, ids[0], ids[1], ids[2]


def resize_token_embeddings(params: Dict, new_vocab: int) -> Dict:
    """Grow every vocab-sized table (embed_tokens/embedding rows,
    lm_head/kernel columns) to new_vocab, initializing new rows/cols with the
    mean of the existing ones.

    Parity: internvl_chat_finetune.py:955-1018 calls
    model.resize_token_embeddings after adding tokens; mean-init keeps the
    softmax over new tokens near-uniform instead of random-logit."""
    import numpy as np

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            arr = np.asarray(v)
            if (
                path and path[-1] == "embed_tokens" and k == "embedding"
                and arr.shape[0] < new_vocab
            ):
                extra = np.broadcast_to(
                    arr.mean(axis=0, keepdims=True),
                    (new_vocab - arr.shape[0], arr.shape[1]),
                ).astype(arr.dtype)
                arr = np.concatenate([arr, extra], axis=0)
            elif (
                path and path[-1] == "lm_head" and k == "kernel"
                and arr.shape[-1] < new_vocab
            ):
                extra = np.broadcast_to(
                    arr.mean(axis=-1, keepdims=True),
                    (*arr.shape[:-1], new_vocab - arr.shape[-1]),
                ).astype(arr.dtype)
                arr = np.concatenate([arr, extra], axis=-1)
            out[k] = arr
        return out

    return walk(params)


# ---------------------------------------------------------------------------
# data-prep utilities (tools/images_stitching.py, json2jsonl.py,
# extract_video_frames.py)
# ---------------------------------------------------------------------------


def stitch_images_grid(
    images: Mapping[str, "object"],
    captions=None,
    *,
    image_size: int = 448,
    cols: int = 3,
    label: bool = True,
):
    """Stitch labeled camera views into one grid image
    (tools/images_stitching.py:11-51 — nuScenes 6-cam layout: each view
    resized to (2*image_size, image_size), pasted row-major over `cols`
    columns with its caption drawn top-left). `images` maps caption -> PIL
    image; `captions` fixes the order (reference: FRONT_LEFT, FRONT,
    FRONT_RIGHT / BACK_LEFT, BACK, BACK_RIGHT)."""
    from PIL import Image, ImageDraw

    captions = list(captions or images.keys())
    w, h = image_size * 2, image_size
    rows = (len(captions) + cols - 1) // cols
    out = Image.new("RGB", (w * cols, h * rows))
    for i, cap in enumerate(captions):
        img = images[cap].convert("RGB").resize((w, h))
        if label:
            ImageDraw.Draw(img).text((0, 0), cap, fill=(255, 0, 255))
        out.paste(img, ((i % cols) * w, (i // cols) * h))
    return out


def json_to_jsonl(json_path: str, jsonl_path: str):
    """tools/json2jsonl.py: a json list (or dict of lists) -> one object per
    line, id field injected when missing."""
    import json

    with open(json_path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = [v for vs in data.values() for v in
                (vs if isinstance(vs, list) else [vs])]
    with open(jsonl_path, "w") as f:
        for i, item in enumerate(data):
            if isinstance(item, dict) and "id" not in item:
                item = {"id": i, **item}
            f.write(json.dumps(item, ensure_ascii=False) + "\n")
    return len(data)


def video_frame_indices(num_frames: int, num_segments: int):
    """Uniform segment-center sampling (tools/extract_video_frames.py:37-49
    get_index; also the chat video convention): when the clip is shorter
    than num_segments, every frame (padded by repeating the last)."""
    if num_segments > num_frames:
        idx = list(range(num_frames))
        return idx + [num_frames - 1] * (num_segments - num_frames)
    seg = float(num_frames - 1) / num_segments
    return [int(seg / 2 + round(seg * i)) for i in range(num_segments)]


def extract_video_frames(
    video_path: str, out_dir: str, *, num_segments: int = 16,
    name_format: str = "{:05d}.jpg",
):
    """Decode a video into the frames-directory convention used by the chat
    dataset and MVBench runner (1-based '{i:05d}.jpg'). Uses imageio when a
    video backend is available (decord/ffmpeg are not shipped in this
    environment — SURVEY video delta); raises a clear error otherwise."""
    import os

    import imageio.v3 as iio
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    frames = iio.imread(video_path, plugin=None)  # [T, H, W, C]
    idxs = video_frame_indices(len(frames), num_segments)
    paths = []
    for j, fi in enumerate(idxs):
        p = os.path.join(out_dir, name_format.format(j + 1))
        Image.fromarray(frames[fi]).save(p)
        paths.append(p)
    return paths
