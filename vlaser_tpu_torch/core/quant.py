"""Int8 weight-only quantization of the port's modules (the twin of
vlaser_tpu/core/quant.py, `mode="int8"`).

Matched kernels `[..., in, out]` get per-output-channel scales `[..., 1, out]`
(reduce over `in`); embeddings `[V, H]` get per-row scales `[V, 1]`. Leaves
under `min_size` elements stay as they are. The quantized tensors replace
the float leaf in place: `kernel` -> `kernel_q` (int8) + `kernel_scale`
(fp32), which `models.layers.Dense` / `Embed` dequantize inline. The w8a8
mode (int8 activations through an int8 tensor-core GEMM) is not ported yet.
"""

from __future__ import annotations

import re
from typing import Tuple

import torch
from torch import nn

# The policy patterns of vlaser_tpu/core/quant.py, matched against
# "/"-joined module paths (the port keeps the JAX package's module names).
# The VLM-only patterns (target "vlm") wait for the chat slice.
POLICY_PATTERNS: Tuple[str, ...] = (
    r"(^|/)joint/layers/.*kernel$",
    r"embed_tokens/embedding$",
)


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


def quantize_for_serving(model: nn.Module, target: str = "policy",
                         mode: str = "int8", min_size: int = 4096) -> nn.Module:
    """Serving quantization in place: every `kernel` / `embedding` buffer
    that matches POLICY_PATTERNS becomes int8: the joint mixtures and the
    token embedding. Only target "policy" is ported. Already-quantized
    models pass through."""
    if mode == "w8a8":
        raise NotImplementedError(
            "w8a8 needs the int8 tensor-core GEMM, which is not ported yet"
        )
    if mode != "int8":
        raise ValueError(f"unknown quantization mode {mode!r}")
    if target != "policy":
        raise NotImplementedError(f"target {target!r}: only 'policy' is ported")
    if is_quantized(model):
        return model
    regs = [re.compile(p) for p in POLICY_PATTERNS]
    for mod_name, mod in list(model.named_modules()):
        for leaf in ("kernel", "embedding"):
            val = mod._buffers.get(leaf)
            if val is None or val.dim() < 2 or val.numel() < min_size:
                continue
            path = "/".join(filter(None, [mod_name.replace(".", "/"), leaf]))
            if not any(r.search(path) for r in regs):
                continue
            q, s = quantize_int8(val, reduce_axis=-1 if leaf == "embedding"
                                 else -2)
            del mod._buffers[leaf]
            mod.register_buffer(leaf + "_q", q)
            mod.register_buffer(leaf + "_scale", s)
    return model
