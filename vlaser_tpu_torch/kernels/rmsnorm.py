"""Fused RMSNorm: the port of vlaser_tpu/kernels/rmsnorm.py.

Math (y = w * x / rms, rms = sqrt(mean(x^2) + eps)), statistics in fp32:
  y  = x * rrms * w, in x's dtype; rrms = rsqrt(mean(x^2) + eps), fp32 [n, 1]
  dx = (g*w)*rrms - x * sum(g*w*x, -1) * rrms^3 / H, in x's dtype
  dw = sum_rows g * x * rrms, fp32 (the autograd Function casts it to w's
       dtype, as the JAX custom VJP does)

`rms_fwd` / `rms_bwd` launch the Hopper kernels of `csrc/rmsnorm.cu` on
CUDA tensors (bf16 or fp32, hidden % 8 == 0) and run their plain versions
on CPU tensors; any other device raises. `rms_norm(impl="auto")` takes the
kernel on a CUDA tensor where the JAX dispatch takes Pallas on the TPU
(rows >= 2048 and hidden <= 2048) and the eager reference (`ops.rms_norm`)
elsewhere, including every CPU tensor; `impl="kernel"` forces the kernel
route (its plain version on the CPU).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ops

MIN_ROWS, MAX_HIDDEN = 2048, 2048  # the JAX dispatch's thresholds
BWD_WARPS, BWD_BLOCKS = 8, 2 * 132  # the backward's warps a block; its grid
fwd_launch_count = 0  # rms_fwd launches through the CUDA route
bwd_launch_count = 0  # rms_bwd launches (one-pass kernel + partial sums)


def rms_fwd_plain(x2, w, eps: float):
    """x2 [n, H], w [H] -> (y [n, H] in x2's dtype, rrms [n, 1] fp32)."""
    xf = x2.float()
    rrms = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * rrms * w.float()).to(x2.dtype), rrms


def rms_bwd_plain(x2, w, g2, rrms):
    """-> (dx [n, H] in x2's dtype, dw [H] fp32)."""
    x, g = x2.float(), g2.float()
    gw = g * w.float()
    dot = (gw * x).sum(-1, keepdim=True)
    dx = gw * rrms - x * (dot * rrms ** 3 / x2.shape[-1])
    return dx.to(x2.dtype), (g * x * rrms).sum(0)


_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_SIGNATURES = {  # C name -> (pointer args, the types after them)
    "rms_norm_fwd": (4, (_I, _I, _F, _I, _P)),
    "rms_norm_bwd": (7, (_I, _I, _I, _I, _P)),
}
_fns = {}


def _kernel(name):
    if name not in _fns:
        _fns[name] = _build.bind(name, *_SIGNATURES[name])
    return _fns[name]


def _check(x2, w, what):
    if x2.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x2.dtype:
        raise TypeError(f"{what}: x and w must share one dtype, bf16 or fp32")
    if x2.dim() != 2 or w.shape != (x2.shape[1],) or x2.shape[1] % 8:
        raise ValueError(f"{what}: x [n, H] with H % 8 == 0 and w [H]")
    if w.device != x2.device:
        raise ValueError(f"{what}: w must be on {x2.device}")


def _route(x, what):
    if x.device.type in ("cpu", "cuda"):
        return x.device.type
    raise RuntimeError(f"{what}: no route for device {x.device}")


def rms_fwd(x2, w, eps: float):
    """x2 [n, H], w [H] (x2's dtype) -> (y, rrms [n, 1] fp32)."""
    global fwd_launch_count
    if _route(x2, "rms_fwd") == "cpu":
        return rms_fwd_plain(x2, w, eps)
    _check(x2, w, "rms_fwd")
    x2, w = x2.contiguous(), w.contiguous()
    n, h = x2.shape
    y = torch.empty_like(x2)
    rrms = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    code = _kernel("rms_norm_fwd")(
        x2.data_ptr(), w.data_ptr(), y.data_ptr(), rrms.data_ptr(), n, h,
        float(eps), int(x2.dtype == torch.bfloat16), stream)
    _build.check(code, "rms_norm_fwd")
    fwd_launch_count += 1
    return y, rrms


def rows_per_block(n: int) -> int:
    """Rows whose dw one block of the backward sums into its partial row:
    enough blocks for two on each of the H100's 132 SMs, a multiple of the
    block's warps. A function of n alone, so that dw's order of summation,
    and so its bits, never change from run to run."""
    per = -(-n // BWD_BLOCKS)
    return -(-per // BWD_WARPS) * BWD_WARPS


def rms_bwd(x2, w, g2, rrms):
    """-> (dx [n, H] in x2's dtype, dw [H] fp32)."""
    global bwd_launch_count
    if _route(x2, "rms_bwd") == "cpu":
        return rms_bwd_plain(x2, w, g2, rrms)
    _check(x2, w, "rms_bwd")
    n, h = x2.shape
    if g2.shape != x2.shape or g2.dtype != x2.dtype:
        raise TypeError("rms_bwd: g must match x")
    if rrms.dtype != torch.float32 or rrms.numel() != n:
        raise TypeError("rms_bwd: rrms must be fp32 [n, 1]")
    x2, w, g2, rrms = (t.contiguous() for t in (x2, w, g2, rrms))
    dx = torch.empty_like(x2)
    rows = rows_per_block(n)
    part = torch.empty((-(-n // rows), h), dtype=torch.float32,
                       device=x2.device)
    dw = torch.empty(h, dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    code = _kernel("rms_norm_bwd")(
        *[t.data_ptr() for t in (x2, w, g2, rrms, dx, part, dw)], n, h,
        rows, int(x2.dtype == torch.bfloat16), stream)
    _build.check(code, "rms_norm_bwd")
    bwd_launch_count += 1
    return dx, dw


class FusedRMSNorm(torch.autograd.Function):
    """x [..., H], w [H] -> RMSNorm(x) * w; the backward is rms_bwd."""

    @staticmethod
    def forward(ctx, x, w, eps):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        y, rrms = rms_fwd(x2, w, eps)
        ctx.save_for_backward(x2, w, rrms)
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x2, w, rrms = ctx.saved_tensors
        dx, dw = rms_bwd(x2, w, g.reshape(x2.shape), rrms)
        return dx.reshape(g.shape), dw.to(w.dtype), None


def fused_rms_norm(x, w, eps: float = 1e-6):
    return FusedRMSNorm.apply(x, w, eps)


def rms_norm(x, w, eps: float = 1e-6, impl: str = "auto"):
    """Dispatcher: impl "auto" | "kernel" | "reference" (no plus-one
    variant; Gemma's plus-one norm stays on ops.rms_norm)."""
    if impl == "auto":
        rows = x.numel() // max(x.shape[-1], 1)
        impl = ("kernel" if x.device.type == "cuda" and rows >= MIN_ROWS
                and x.shape[-1] <= MAX_HIDDEN else "reference")
    if impl == "kernel":
        return fused_rms_norm(x, w, eps)
    if impl == "reference":
        return ops.rms_norm(x, w, eps)
    raise ValueError(f"unknown rms_norm impl {impl!r}")
