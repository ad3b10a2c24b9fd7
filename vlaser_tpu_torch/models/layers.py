"""Building blocks with the JAX package's parameter names
(vlaser_tpu/models/layers.py).

Float weights are `nn.Parameter`s (trainable); a `Dense` or `Embed` whose
weight was quantized (core/quant.py) holds `kernel_q` / `embedding_q` int8
plus a scale as buffers instead, frozen, and dequantizes inline in the
compute dtype, as the JAX Dense does. A Dense that also holds the
`kernel_aq` flag (w8a8) runs `w8a8_dot` instead at call sites of at least
ACT_QUANT_MIN_ROWS rows (counted over the leading dims), on `kernel_qt`:
its int8 kernel transposed to [..., out, in] (K-major, as the int8 GEMM
reads it), a non-persistent buffer derived from `kernel_q` on the Dense's
first w8a8 call (`Dense.kernel_kmajor`; the state dict keeps only the JAX
layout, and a Dense whose call sites stay under the row count never holds
one). Several w8a8 Dense that read one input (q/k/v, gate/up) share its
int8 rows through `w8a8_group`, and a SiLU MLP's down projection
quantizes silu(g) * u without storing it (`gated_mlp`), as XLA merges and
fuses the JAX function's quantizers under `jit`. A Dense may also hold a
LoRA adapter (`lora_a` [..., in, r], `lora_b` [..., r, out], parameters
made by train/lora.init_qlora_collection): its term (x a) b is added on
the activation path after the base product, whatever that product is
(float, int8 weight-only, w8a8), as the JAX Dense adds its `lora`
collection. Such a Dense never takes the shared int8 route, which has no
x to form the term from. A block built
for a scanned stack holds every layer's weights stacked on a leading `[L]`
axis, as the fused
kernels consume them; `forward(x, layer)` picks one slice. Inside
`layer_slices(model)` each stacked parameter is cut into its L slices once
for the whole pass, so the backward stacks the L slice gradients in one op
(indexing per layer would add a zero-padded full-size gradient per layer).
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops, rmsnorm, w8a8

# Minimum row count (product of the leading dims) for a kernel_aq-flagged
# Dense to take w8a8_dot; below it the weight-only path runs (the JAX
# package's threshold: decode/denoise GEMVs stay weight-only).
ACT_QUANT_MIN_ROWS = 128


class W8A8Dot(torch.autograd.Function):
    """y = w8a8_dot(x, kt, ks) in `out_dtype`: per-row int8 activations,
    int8 x int8 product, (am / 127) * ks rescale (kernels/w8a8.py); kt is
    the int8 kernel K-major [out, in]. The backward is the straight-through
    estimator of the JAX custom VJP: dx = g @ (kq * ks)^T in x's dtype, a
    plain matmul; the frozen int8 weight gets no gradient."""

    @staticmethod
    def forward(ctx, x, kt, ks, out_dtype):
        ctx.save_for_backward(kt, ks)
        ctx.x_dtype = x.dtype
        return w8a8.w8a8_dot(x, kt, ks, out_dtype)

    @staticmethod
    def backward(ctx, g):
        kt, ks = ctx.saved_tensors
        dt = ctx.x_dtype
        wt = kt.to(dt) * ks.to(dt).reshape(-1, 1)  # (kq * ks)^T, [out, in]
        return g.to(dt) @ wt, None, None, None


def w8a8_dot(x, kt, ks, out_dtype=torch.float32):
    """x [..., in] @ int8 kt^T (kt [out, in], K-major) with per-row int8
    activations."""
    return W8A8Dot.apply(x, kt, ks, out_dtype)


class Block(nn.Module):
    """Module whose weights are allocated from shapes up front. `stacked`:
    every weight carries the scan's leading [L] axis."""

    def __init__(self, param_dtype=torch.float32, device=None,
                 stacked: bool = False):
        super().__init__()
        self.param_dtype = param_dtype
        self.device_ = device
        self.stacked = stacked
        self._slices: Optional[Dict[str, Sequence[torch.Tensor]]] = None

    def _alloc(self, name: str, shape: Sequence[int]):
        self.register_parameter(name, nn.Parameter(torch.empty(
            tuple(shape), dtype=self.param_dtype, device=self.device_)))

    def leaf(self, name: str, layer: Optional[int] = None) -> torch.Tensor:
        """Weight `name`, or its slice for `layer` of a stacked block."""
        if layer is None:
            return getattr(self, name)
        if self._slices is not None and name in self._slices:
            return self._slices[name][layer]
        return getattr(self, name)[layer]


@contextlib.contextmanager
def layer_slices(model: nn.Module):
    """Within the block, stacked parameters are read through one unbind per
    parameter (see the module docstring)."""
    blocks = [m for m in model.modules() if isinstance(m, Block) and m.stacked]
    for m in blocks:
        m._slices = {n: p.unbind(0) for n, p in m._parameters.items()}
    try:
        yield
    finally:
        for m in blocks:
            m._slices = None


class RMSNorm(Block):
    """`impl` picks the route of kernels.rmsnorm.rms_norm ("auto": the
    kernel for a CUDA tensor of >= 2048 rows x <= 2048, as the JAX dispatch
    takes Pallas; "reference": the eager twin). `plus_one` (Gemma) scales
    by (1 + weight), the weight starting at zero, and always takes
    ops.rms_norm, as the JAX RMSNorm does."""

    def __init__(self, dim: int, eps: float = 1e-6, stack: Sequence[int] = (),
                 param_dtype=torch.float32, device=None,
                 plus_one: bool = False):
        super().__init__(param_dtype, device, bool(stack))
        self.eps, self.plus_one = eps, plus_one
        self.impl = "auto"
        self._alloc("weight", (*stack, dim))
        if plus_one:
            nn.init.zeros_(self.weight)

    def forward(self, x, layer: Optional[int] = None):
        w = self.leaf("weight", layer).to(x.dtype)
        if self.plus_one:
            return ops.rms_norm(x, w, self.eps, plus_one=True)
        return rmsnorm.rms_norm(x, w, self.eps, impl=self.impl)


def gelu_tanh(x):
    """GELU's tanh approximation (JAX nn.gelu(approximate=True))."""
    return F.gelu(x, approximate="tanh")


def set_rms_impl(model: nn.Module, impl: str) -> nn.Module:
    for m in model.modules():
        if isinstance(m, RMSNorm):
            m.impl = impl
    return model


class LayerNorm(Block):
    def __init__(self, dim: int, eps: float = 1e-6, stack: Sequence[int] = (),
                 param_dtype=torch.float32, device=None):
        super().__init__(param_dtype, device, bool(stack))
        self.eps = eps
        self._alloc("weight", (*stack, dim))
        self._alloc("bias", (*stack, dim))

    def forward(self, x, layer: Optional[int] = None):
        return ops.layer_norm(x, self.leaf("weight", layer).float(),
                              self.leaf("bias", layer).float(), self.eps)


class Dense(Block):
    """Kernel layout [in, out] (the JAX layout, HF weight.T)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 stack: Sequence[int] = (), param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__(param_dtype, device, bool(stack))
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
            return self.leaf("kernel_q", layer) * self.leaf(
                "kernel_scale", layer).to(cd)
        return self.leaf("kernel", layer).to(cd)

    def kernel_kmajor(self, layer: Optional[int] = None) -> torch.Tensor:
        """The int8 kernel K-major [..., out, in], as the int8 GEMM reads it:
        `kernel_q` transposed, kept from the first call on as the
        non-persistent buffer `kernel_qt`. Loading a state drops it
        (load_state, load_state_dict), so the next call derives it from the
        new `kernel_q`."""
        if "kernel_qt" not in self._buffers:
            # a normal tensor even when first asked for under inference_mode
            with torch.inference_mode(False), torch.no_grad():
                self.register_buffer("kernel_qt", self.kernel_q.transpose(
                    -1, -2).contiguous(), persistent=False)
        return self.leaf("kernel_qt", layer)

    def _load_from_state_dict(self, *args, **kwargs):
        self._buffers.pop("kernel_qt", None)
        super()._load_from_state_dict(*args, **kwargs)

    @property
    def has_lora(self) -> bool:
        return "lora_a" in self._parameters

    def takes_w8a8(self, x) -> bool:
        """Whether a call on x runs w8a8_dot (a kernel_aq-flagged Dense at
        >= ACT_QUANT_MIN_ROWS rows)."""
        return ("kernel_aq" in self._buffers
                and math.prod(x.shape[:-1]) >= ACT_QUANT_MIN_ROWS)

    def forward(self, x, layer: Optional[int] = None):
        cd = self.compute_dtype
        xc = x.to(cd)
        if self.takes_w8a8(x):
            y = w8a8_dot(xc, self.kernel_kmajor(layer),
                         self.leaf("kernel_scale", layer), out_dtype=cd)
        else:
            y = torch.matmul(xc, self.weight(layer))
        if self.has_lora:  # alpha / r is folded into a
            y = y + (xc @ self.leaf("lora_a", layer).to(cd)) @ self.leaf(
                "lora_b", layer).to(cd)
        return self._biased(y, layer)

    def forward_int8(self, q, am, lead, layer: Optional[int] = None):
        """forward's w8a8 route from int8 rows already made (q int8 [M, in],
        am fp32 [M, 1]): -> [*lead, out], equal to forward on the input
        they were made from. No gradient flows."""
        y = w8a8.int8_gemm(q, am, self.kernel_kmajor(layer),
                           self.leaf("kernel_scale", layer),
                           self.compute_dtype)
        return self._biased(y.reshape(*lead, -1), layer)

    def _biased(self, y, layer):
        if self.use_bias:
            y = y + self.leaf("bias", layer).to(y.dtype)
        return y


def _int8_shared(x, denses) -> bool:
    """Whether `denses` may share x's int8 rows: each takes w8a8 at x and
    holds no LoRA adapter (whose term needs x), and no gradient is asked of
    x (with one, each Dense runs its own W8A8Dot, whose STE backward the
    shared route does not have)."""
    return (all(d.takes_w8a8(x) and not d.has_lora for d in denses)
            and not (x.requires_grad and torch.is_grad_enabled()))


def w8a8_group(x, denses, layer: Optional[int] = None):
    """[d(x, layer) for d in denses], x quantized once where every Dense
    takes w8a8 and no gradient is asked of x (each output equal to the
    Dense's own forward bit for bit: the same int8 rows and GEMM); else
    each Dense's own forward, the w8a8 ones through W8A8Dot and its STE
    backward."""
    if not _int8_shared(x, denses):
        return [d(x, layer) for d in denses]
    q, am = w8a8.quantize_rows(
        x.to(denses[0].compute_dtype).reshape(-1, x.shape[-1]))
    return [d.forward_int8(q, am, x.shape[:-1], layer) for d in denses]


def gated_mlp(x, gate, up, down, act, layer: Optional[int] = None):
    """down(act(gate(x)) * up(x)): gate and up share x's int8 rows
    (w8a8_group); with act SiLU, bf16 g and u and a w8a8 down that needs no
    gradient, the down projection quantizes silu(g) * u in one kernel
    (w8a8.quantize_silu_mul; the product is the eager ops' bit for bit and
    is never stored). Any other activation stays eager."""
    g, u = w8a8_group(x, (gate, up), layer)
    if (act is F.silu and g.dtype == u.dtype == down.compute_dtype
            == torch.bfloat16 and _int8_shared(g, (down,))
            and not u.requires_grad):
        q, am = w8a8.quantize_silu_mul(g.reshape(-1, g.shape[-1]),
                                       u.reshape(-1, u.shape[-1]))
        return down.forward_int8(q, am, g.shape[:-1], layer)
    return down(act(g) * u, layer)


class Embed(Block):
    """Token embedding ('embedding' [V, H]) or its per-row int8 form;
    `attend` is the tied logits head."""

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

    def attend(self, hidden):
        """Tied logits head: hidden @ table^T, operands in the embedding
        dtype, fp32 out (per-row scales on the output for the int8 table)."""
        h = hidden.to(self.dtype).float()
        if "embedding_q" in self._buffers:
            y = h @ self.embedding_q.to(self.dtype).float().T
            return y * self.embedding_scale[:, 0].float()
        return h @ self.embedding.to(self.dtype).float().T


def _leaves(mod: nn.Module):
    """(name, tensor) of a module's own parameters and buffers."""
    return itertools.chain(mod._parameters.items(), mod._buffers.items())


@torch.no_grad()
def init_normal_(model: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Fill every floating parameter and buffer with N(0, std^2) draws from
    `generator` (drawn in fp32 on the tensor's device, then cast)."""
    for _, mod in model.named_modules():
        for _, t in list(_leaves(mod)):
            if t is None or not t.is_floating_point():
                continue
            r = torch.randn(t.shape, generator=generator, dtype=torch.float32,
                            device=t.device)
            t.copy_((r * std).to(t.dtype))
    return model


LORA_FACTORS = ("lora_a", "lora_b")
_QUANT_OF = {"kernel_q": "kernel", "kernel_scale": "kernel",
             "kernel_aq": "kernel",
             "embedding_q": "embedding", "embedding_scale": "embedding"}


@torch.no_grad()
def load_state(model: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """Load a flat {dotted name: tensor} state (utils/convert.py) into the
    model. Float leaves are copied into the model's parameters (their dtype
    and identity kept); int8 leaves, their scales and w8a8 flags
    (`kernel_aq`) become buffers that replace the float parameter they
    quantize; a new `kernel_q` drops the Dense's K-major copy `kernel_qt`
    (Dense.kernel_kmajor derives it again); LoRA factors (`lora_a`,
    `lora_b`) a Dense does not hold yet become new parameters of it, in the
    state's dtype. Every parameter and buffer must be covered and every key
    must name one."""
    seen = set()
    for key, val in state.items():
        mod_name, _, leaf = key.rpartition(".")
        mod = model.get_submodule(mod_name)
        device = next(t for _, t in _leaves(mod) if t is not None).device
        if leaf in LORA_FACTORS and leaf not in mod._parameters:
            mod.register_parameter(leaf, nn.Parameter(val.to(device)))
        elif leaf in _QUANT_OF:
            mod._parameters.pop(_QUANT_OF[leaf], None)
            if leaf == "kernel_q":
                mod._buffers.pop("kernel_qt", None)
            mod.register_buffer(leaf, val.to(device))
        else:
            cur = dict(_leaves(mod)).get(leaf)
            if cur is None:
                raise KeyError(f"{key}: no such weight in the model")
            if tuple(cur.shape) != tuple(val.shape):
                raise ValueError(f"{key}: shape {tuple(val.shape)} != "
                                 f"{tuple(cur.shape)}")
            cur.copy_(val)
        seen.add(key)
    names = itertools.chain(model.named_parameters(), model.named_buffers())
    missing = [n for n, _ in names if n not in seen]
    if missing:
        raise KeyError(f"state misses {missing[:8]}")
    return model
