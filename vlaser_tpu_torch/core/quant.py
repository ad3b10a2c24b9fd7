"""Serving quantization of the port's modules (the twin of
vlaser_tpu/core/quant.py).

Matched kernels `[..., in, out]` get per-output-channel scales `[..., 1, out]`
(reduce over `in`); embeddings `[V, H]` get per-row scales `[V, 1]`. Leaves
under `min_size` elements stay as they are. The quantized tensors replace
the float parameter in place: `kernel` -> `kernel_q` (int8) + `kernel_scale`
(fp32), frozen buffers that `models.layers.Dense` / `Embed` dequantize
inline. A quantized kernel that also matches `act_quant_patterns` gets the
`kernel_aq` flag (int8 zeros shaped `[..., 1]`, `[L, 1]` for a stacked
kernel): Dense then runs w8a8 (int8 activations through the int8 GEMM) at
call sites of >= 128 rows, and the fused ViT packer switches the encoder
stack to its act_quant mode when its four kernels are int8. The int8 GEMM
reads the kernel K-major ([..., out, in]): the Dense derives that copy on
its first w8a8 call (models/layers.Dense.kernel_kmajor), outside the state
dict, so the converters see only the JAX layout.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

import torch
from torch import nn

# The patterns of vlaser_tpu/core/quant.py, matched against "/"-joined
# module paths (the port keeps the JAX package's module names).
# Streamed decode weights of the chat model: every scanned LLM layer kernel
# (the ViT stack is scoped "encoder", not "layers"), the token embedding and
# the untied lm_head.
DEFAULT_PATTERNS: Tuple[str, ...] = (
    r"(^|/)layers/.*kernel$",
    r"embed_tokens/embedding$",
    r"lm_head/kernel$",
)
POLICY_PATTERNS: Tuple[str, ...] = (
    r"(^|/)joint/layers/.*kernel$",
    r"embed_tokens/embedding$",
)
# the ViT encoder's four kernels, int8 for the w8a8 fused stack
VIT_W8A8_PATTERNS: Tuple[str, ...] = (
    r"(^|/)encoder/(attn/(qkv|proj)|mlp/(fc1|fc2))/kernel$",
)
POLICY_W8A8_PATTERNS: Tuple[str, ...] = POLICY_PATTERNS + VIT_W8A8_PATTERNS
# kernels that also get the w8a8 flag: the joint mixtures (their prefix
# pass) and the ViT encoder
POLICY_W8A8_ACT_PATTERNS: Tuple[str, ...] = (
    r"(^|/)joint/layers/.*kernel$",
) + VIT_W8A8_PATTERNS
# chat serving: the LLM layers run w8a8 at prefill row counts, the decode
# GEMVs stay weight-only; the ViT encoder as for the policy
VLM_W8A8_ACT_PATTERNS: Tuple[str, ...] = (r"(^|/)layers/.*kernel$",)
VLM_W8A8_PATTERNS: Tuple[str, ...] = DEFAULT_PATTERNS + VIT_W8A8_PATTERNS
VLM_W8A8_SERVING_ACT_PATTERNS: Tuple[str, ...] = (
    VLM_W8A8_ACT_PATTERNS + VIT_W8A8_PATTERNS)


def quantize_int8(w: torch.Tensor, reduce_axis: int):
    """Symmetric per-channel int8: w ~= q * scale, scale over `reduce_axis`.
    The scale multiplies by 1/127 (not divides): the jitted JAX version is
    compiled to that form, and the two must agree bit for bit."""
    wf = w.float()
    scale = wf.abs().amax(dim=reduce_axis, keepdim=True) * (1.0 / 127.0)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def is_quantized(model: nn.Module) -> bool:
    return any(name.endswith(("kernel_q", "embedding_q"))
               for name, _ in model.named_buffers())


@torch.no_grad()
def quantize_module(model: nn.Module, patterns: Sequence[str],
                    act_quant_patterns: Sequence[str] = (),
                    min_size: int = 4096) -> nn.Module:
    """In place: every `kernel` / `embedding` parameter whose path matches
    `patterns` becomes int8 + scale buffers; a matched kernel that also
    matches `act_quant_patterns` gets the `kernel_aq` flag."""
    regs = [re.compile(p) for p in patterns]
    act_regs = [re.compile(p) for p in act_quant_patterns]
    for mod_name, mod in list(model.named_modules()):
        for leaf in ("kernel", "embedding"):
            val = mod._parameters.get(leaf)
            if val is None or val.dim() < 2 or val.numel() < min_size:
                continue
            path = "/".join(filter(None, [mod_name.replace(".", "/"), leaf]))
            if not any(r.search(path) for r in regs):
                continue
            q, s = quantize_int8(val, reduce_axis=-1 if leaf == "embedding"
                                 else -2)
            del mod._parameters[leaf]
            mod.register_buffer(leaf + "_q", q)
            mod.register_buffer(leaf + "_scale", s)
            if leaf == "kernel" and any(r.search(path) for r in act_regs):
                mod.register_buffer("kernel_aq", torch.zeros(
                    (*val.shape[:-2], 1), dtype=torch.int8,
                    device=val.device))
    return model


def quantize_for_serving(model: nn.Module, target: str = "vlm",
                         mode: str = "w8a8",
                         min_size: int = 4096) -> nn.Module:
    """Serving quantization in place, as the JAX package's. target "vlm"
    (the chat model, the default): mode "w8a8" makes every LLM layer kernel,
    the token embedding, the lm_head and the ViT encoder int8 and flags the
    LLM layers and the encoder for w8a8; mode "int8" is weight-only on the
    LLM layers, the embedding and the lm_head. target "policy" (the VLA):
    mode "w8a8" makes the joint mixtures, the token embedding and the ViT
    encoder int8 and flags the mixtures and the encoder; mode "int8" is
    weight-only on the mixtures and the embedding. Already-quantized models
    pass through."""
    sets = {("vlm", "w8a8"): (VLM_W8A8_PATTERNS,
                              VLM_W8A8_SERVING_ACT_PATTERNS),
            ("vlm", "int8"): (DEFAULT_PATTERNS, ()),
            ("policy", "w8a8"): (POLICY_W8A8_PATTERNS,
                                 POLICY_W8A8_ACT_PATTERNS),
            ("policy", "int8"): (POLICY_PATTERNS, ())}
    if target not in ("vlm", "policy"):
        raise ValueError(f"unknown serving target {target!r}")
    if mode not in ("w8a8", "int8"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    if is_quantized(model):
        return model
    pats, acts = sets[target, mode]
    return quantize_module(model, pats, acts, min_size)
