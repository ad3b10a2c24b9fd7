"""Building blocks with the JAX package's parameter names
(vlaser_tpu/models/layers.py).

Weights are buffers (inference only). A block built for a scanned stack
holds every layer's weights stacked on a leading `[L]` axis, as the fused
kernels consume them; `forward(x, layer)` picks one slice. A `Dense` whose
kernel was quantized (core/quant.py) holds `kernel_q` int8 + `kernel_scale`
and dequantizes inline in the compute dtype, as the JAX Dense does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..kernels import ops


def _pick(t: torch.Tensor, layer: Optional[int]) -> torch.Tensor:
    return t if layer is None else t[layer]


class Block(nn.Module):
    """Module whose weights are buffers allocated from shapes up front."""

    def __init__(self, param_dtype=torch.float32, device=None):
        super().__init__()
        self.param_dtype = param_dtype
        self.device_ = device

    def _alloc(self, name: str, shape: Sequence[int]):
        self.register_buffer(name, torch.empty(
            tuple(shape), dtype=self.param_dtype, device=self.device_))


class RMSNorm(Block):
    def __init__(self, dim: int, eps: float = 1e-6, stack: Sequence[int] = (),
                 param_dtype=torch.float32, device=None):
        super().__init__(param_dtype, device)
        self.eps = eps
        self._alloc("weight", (*stack, dim))

    def forward(self, x, layer: Optional[int] = None):
        return ops.rms_norm(x, _pick(self.weight, layer).to(x.dtype), self.eps)


class LayerNorm(Block):
    def __init__(self, dim: int, eps: float = 1e-6, stack: Sequence[int] = (),
                 param_dtype=torch.float32, device=None):
        super().__init__(param_dtype, device)
        self.eps = eps
        self._alloc("weight", (*stack, dim))
        self._alloc("bias", (*stack, dim))

    def forward(self, x, layer: Optional[int] = None):
        return ops.layer_norm(x, _pick(self.weight, layer).float(),
                              _pick(self.bias, layer).float(), self.eps)


class Dense(Block):
    """Kernel layout [in, out] (the JAX layout, HF weight.T)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 stack: Sequence[int] = (), param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__(param_dtype, device)
        self.use_bias = use_bias
        self.compute_dtype = compute_dtype
        self._alloc("kernel", (*stack, in_features, features))
        if use_bias:
            self._alloc("bias", (*stack, features))

    def weight(self, layer: Optional[int] = None) -> torch.Tensor:
        """The [in, out] kernel in the compute dtype (dequantized if int8)."""
        cd = self.compute_dtype
        if "kernel_q" in self._buffers:
            # int8 -> cd is exact, so one mixed-dtype multiply rounds exactly
            # as kq.to(cd) * ks.to(cd) does, in one pass over the weight
            return _pick(self.kernel_q, layer) * _pick(self.kernel_scale,
                                                       layer).to(cd)
        return _pick(self.kernel, layer).to(cd)

    def forward(self, x, layer: Optional[int] = None):
        y = torch.matmul(x.to(self.compute_dtype), self.weight(layer))
        if self.use_bias:
            y = y + _pick(self.bias, layer).to(y.dtype)
        return y


class Embed(Block):
    """Token embedding ('embedding' [V, H]) or its per-row int8 form."""

    def __init__(self, num_embeddings: int, features: int,
                 param_dtype=torch.float32, dtype=torch.bfloat16, device=None):
        super().__init__(param_dtype, device)
        self.dtype = dtype
        self._alloc("embedding", (num_embeddings, features))

    def forward(self, ids):
        if "embedding_q" in self._buffers:
            rows = self.embedding_q[ids].to(self.dtype)
            return rows * self.embedding_scale[ids].to(self.dtype)
        return self.embedding[ids].to(self.dtype)


@torch.no_grad()
def init_normal_(model: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Fill every floating buffer with N(0, std^2) draws from `generator`
    (drawn in fp32 on the buffer's device, then cast)."""
    for _, mod in model.named_modules():
        for name, buf in list(mod._buffers.items()):
            if buf is None or not buf.is_floating_point():
                continue
            r = torch.randn(buf.shape, generator=generator, dtype=torch.float32,
                            device=buf.device)
            buf.copy_((r * std).to(buf.dtype))
    return model


_QUANT_OF = {"kernel_q": "kernel", "kernel_scale": "kernel",
             "embedding_q": "embedding", "embedding_scale": "embedding"}


@torch.no_grad()
def load_state(model: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """Load a flat {dotted name: tensor} state (utils/convert.py) into the
    model's buffers. Float leaves keep the model's dtype; int8 leaves and
    their scales replace the float leaf they quantize. Every buffer must be
    covered and every key must name one."""
    seen = set()
    for key, val in state.items():
        mod_name, _, leaf = key.rpartition(".")
        mod = model.get_submodule(mod_name)
        device = next(iter(mod._buffers.values())).device
        if leaf in _QUANT_OF:
            mod._buffers.pop(_QUANT_OF[leaf], None)
            mod.register_buffer(leaf, val.to(device))
        else:
            if leaf not in mod._buffers:
                raise KeyError(f"{key}: no such buffer in the model")
            cur = mod._buffers[leaf]
            if tuple(cur.shape) != tuple(val.shape):
                raise ValueError(f"{key}: shape {tuple(val.shape)} != "
                                 f"{tuple(cur.shape)}")
            mod.register_buffer(leaf, val.to(device=device, dtype=cur.dtype))
        seen.add(key)
    missing = [n for n, _ in model.named_buffers() if n not in seen]
    if missing:
        raise KeyError(f"state misses {missing[:8]}")
    return model
