"""Flash attention: the port of vlaser_tpu/kernels/flash_attention.py.

Layouts are the JAX package's: q [B, Sq, H, D], k/v [B, Skv, KVH, D] (GQA,
head h reads kv head h // (H // KVH)), lse [B, H, Sq] fp32. Per-token
metadata packs (segment, level) into one int32 (`pack_meta`); a key is
allowed iff q_seg == k_seg, k_seg != 0 and k_lev <= q_lev, and, when causal,
q_offset + q_idx >= k_idx. A row with no allowed key gives out = 0 and
lse = -1e30 + log(1).

`flash_attention_fwd` / `flash_attention_bwd` launch the Hopper kernels of
`csrc/flash_attention.cu` on CUDA tensors (bf16, head_dim 64 or 128) and run
their plain versions (`*_plain`, fp32 math) on CPU tensors; any other device
raises. `attention` is the differentiable entry point (`attention_fn`
builds it once for a layer stack): `impl="auto"` takes the kernel
(`FlashAttention`, whose backward is `flash_attention_bwd`) on a CUDA
tensor exactly where the JAX dispatch takes Pallas on the TPU (Sq >= 2048
or fp32 logits over 128 MiB) and the eager reference (kernels.ops)
elsewhere, as the JAX package leaves those shapes to XLA.
`softcap` and `window` have no kernel: with the kernel they raise
NotImplementedError. A per-row q_offset always takes the reference.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, ops

LEVEL_BITS = 2
LEVEL_MASK = (1 << LEVEL_BITS) - 1
NEG_INF = -1e30
LOGITS_BYTES_MIN = 128 * 2**20  # the JAX dispatch's threshold
fwd_launch_count = 0  # flash_attention_fwd launches through the CUDA route
bwd_launch_count = 0  # flash_attention_bwd launches (dq + dkv kernels)


def pack_meta(segment_ids: torch.Tensor,
              levels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack per-token (segment, level) into one int32. Segment 0 = padding."""
    meta = segment_ids.to(torch.int32) << LEVEL_BITS
    if levels is not None:
        meta = meta | levels.to(torch.int32)
    return meta


def _allowed(q_meta, kv_meta, q_offset: int, causal: bool):
    """[B, Sq, Skv] bool: the kernels' mask rule."""
    qs, ks = (q_meta >> LEVEL_BITS)[:, :, None], (kv_meta >> LEVEL_BITS)[:, None]
    ql, kl = (q_meta & LEVEL_MASK)[:, :, None], (kv_meta & LEVEL_MASK)[:, None]
    ok = (qs == ks) & (ks != 0) & (kl <= ql)
    if causal:
        sq, skv = q_meta.shape[1], kv_meta.shape[1]
        rows = q_offset + torch.arange(sq, device=q_meta.device)[:, None]
        ok = ok & (rows >= torch.arange(skv, device=q_meta.device))[None]
    return ok


def _scale(scale, d):
    return scale if scale is not None else 1.0 / math.sqrt(d)


def flash_attention_fwd_plain(q, k, v, q_meta, kv_meta, q_offset: int = 0,
                              causal: bool = False,
                              scale: Optional[float] = None):
    """-> (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] fp32)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, sq, kvh, g, d) * _scale(scale, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    ok = _allowed(q_meta, kv_meta, q_offset, causal)[:, None, None]
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(torch.where(ok, s - m, -math.inf))
    lsum = p.sum(-1, keepdim=True)
    safe = torch.where(lsum == 0, 1.0, lsum)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / safe
    out = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return out, (m + torch.log(safe))[..., 0].reshape(b, h, sq)


def _delta(out, dout):
    """rowsum(dO * O) -> [B, H, Sq] fp32 (outside the kernels, as in JAX)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_math(q, k, v, q_meta, kv_meta, q_offset, lse, delta, dout, causal,
              scale):
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = _scale(scale, d)
    qf = q.float().reshape(b, sq, kvh, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf * scale, kf)
    ok = _allowed(q_meta, kv_meta, q_offset, causal)[:, None, None]
    lse5 = lse.reshape(b, kvh, g, sq, 1)
    # masked entries are zeroed before exp: a fully masked row has
    # lse = -1e30, and exp(s - lse) there is inf
    p = torch.exp(torch.where(ok, s - lse5, -math.inf))
    do = dout.float().reshape(b, sq, kvh, g, d)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, vf)
    ds = p * (dp - delta.reshape(b, kvh, g, sq, 1))
    dq = scale * torch.einsum("bkgqs,bskd->bqkgd", ds, kf)
    dk = scale * torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_plain(q, k, v, q_meta, kv_meta, q_offset, out, lse,
                              dout, causal: bool = False,
                              scale: Optional[float] = None):
    """-> (dq, dk, dv), P recomputed from lse."""
    return _bwd_math(q, k, v, q_meta, kv_meta, q_offset, lse,
                     _delta(out, dout), dout, causal, scale)


_fns = {}


def _kernel(name, n_ptr):
    if name not in _fns:
        _fns[name] = _build.bind(
            name, n_ptr, (ctypes.c_int,) * 8 + (ctypes.c_float, ctypes.c_void_p))
    return _fns[name]


def _check(q, k, v, q_meta, kv_meta, what):
    b, sq, h, d = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q/k/v must be bf16")
    if d not in (64, 128):
        raise ValueError(f"{what}: the CUDA kernel takes head_dim 64 or 128")
    if (k.dim() != 4 or k.shape[0] != b or k.shape[3] != d
            or v.shape != k.shape or h % k.shape[2]):
        raise ValueError(f"{what}: k/v must be [B, Skv, KVH, D], H % KVH == 0")
    for name, m, n in (("q_meta", q_meta, sq), ("kv_meta", kv_meta, k.shape[1])):
        if m.dtype != torch.int32 or tuple(m.shape) != (b, n):
            raise TypeError(f"{what}: {name} must be int32 [B, {n}]")
    for t in (k, v, q_meta, kv_meta):
        if t.device != q.device:
            raise ValueError(f"{what}: all inputs must be on {q.device}")


def _fwd_launch(q, k, v, q_meta, kv_meta, q_offset, causal, scale):
    global fwd_launch_count
    _check(q, k, v, q_meta, kv_meta, "flash_attention_fwd")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_meta, kv_meta = q_meta.contiguous(), kv_meta.contiguous()
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _kernel("flash_attention_fwd", 7)(
        *[t.data_ptr() for t in (q, k, v, q_meta, kv_meta, out, lse)],
        b, sq, skv, h, kvh, d, int(causal), int(q_offset),
        _scale(scale, d), stream)
    _build.check(code, "flash_attention_fwd")
    fwd_launch_count += 1
    return out, lse


def _bwd_launch(q, k, v, q_meta, kv_meta, q_offset, lse, delta, dout, causal,
                scale):
    global bwd_launch_count
    _check(q, k, v, q_meta, kv_meta, "flash_attention_bwd")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise TypeError("flash_attention_bwd: dout must match q")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq):
        raise TypeError("flash_attention_bwd: lse must be fp32 [B, H, Sq]")
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    q_meta, kv_meta, lse = (t.contiguous() for t in (q_meta, kv_meta, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _kernel("flash_attention_bwd", 11)(
        *[t.data_ptr() for t in (q, k, v, dout, q_meta, kv_meta, lse, delta,
                                 dq, dk, dv)],
        b, sq, skv, h, kvh, d, int(causal), int(q_offset), _scale(scale, d),
        stream)
    _build.check(code, "flash_attention_bwd")
    bwd_launch_count += 1
    return dq, dk, dv


def _route(x, what):
    if x.device.type in ("cpu", "cuda"):
        return x.device.type
    raise RuntimeError(f"{what}: no route for device {x.device}")


def flash_attention_fwd(q, k, v, q_meta, kv_meta, q_offset: int = 0,
                        causal: bool = False, scale: Optional[float] = None):
    """-> (out [B, Sq, H, D], lse [B, H, Sq] fp32)."""
    if _route(q, "flash_attention_fwd") == "cpu":
        return flash_attention_fwd_plain(q, k, v, q_meta, kv_meta, q_offset,
                                         causal, scale)
    return _fwd_launch(q, k, v, q_meta, kv_meta, q_offset, causal, scale)


def flash_attention_bwd(q, k, v, q_meta, kv_meta, q_offset, out, lse, dout,
                        causal: bool = False, scale: Optional[float] = None):
    """-> (dq, dk, dv). delta = rowsum(dO * O) is a plain torch op."""
    route = _route(q, "flash_attention_bwd")
    delta = _delta(out, dout)
    if route == "cpu":
        return _bwd_math(q, k, v, q_meta, kv_meta, q_offset, lse, delta, dout,
                         causal, scale)
    return _bwd_launch(q, k, v, q_meta, kv_meta, q_offset, lse, delta, dout,
                       causal, scale)


class FlashAttention(torch.autograd.Function):
    """out = flash(q, k, v); the backward is flash_attention_bwd."""

    @staticmethod
    def forward(ctx, q, k, v, q_meta, kv_meta, q_offset, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, q_meta, kv_meta, q_offset,
                                       causal, scale)
        ctx.save_for_backward(q, k, v, q_meta, kv_meta, out, lse)
        ctx.args = (q_offset, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_meta, kv_meta, out, lse = ctx.saved_tensors
        q_offset, causal, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, q_meta, kv_meta, q_offset,
                                         out, lse, dout.contiguous(), causal,
                                         scale)
        return dq, dk, dv, None, None, None, None, None


def attention_fn(b: int, sq: int, skv: int, h: int, device, *,
                 q_segment_ids=None, kv_segment_ids=None, q_levels=None,
                 kv_levels=None, q_offset=0, causal: bool = False,
                 scale: Optional[float] = None, impl: str = "auto",
                 softcap: Optional[float] = None,
                 window: Optional[int] = None):
    """-> fn(q, k, v): `attention` with this metadata, its route picked and
    its mask (or packed metadata) built once, so that a layer stack reuses
    them. q [b, sq, h, D]; k/v [b, skv, KVH, D]."""
    if window is not None and not causal:
        raise ValueError("sliding window is defined for the causal path")
    ones = lambda n: torch.ones((b, n), dtype=torch.int32, device=device)
    q_seg = q_segment_ids if q_segment_ids is not None else ones(sq)
    kv_seg = kv_segment_ids if kv_segment_ids is not None else ones(skv)
    if torch.is_tensor(q_offset) and q_offset.dim() == 1:
        # per-row offsets (speculative decode blocks): the kernel reads one
        # scalar offset, so this shape takes the reference, as in JAX
        if impl == "kernel":
            raise NotImplementedError("per-row q_offset has no kernel")
        impl = "reference"
    if impl == "auto":
        logits_bytes = b * h * sq * skv * 4
        impl = ("kernel" if torch.device(device).type == "cuda" and (
            sq >= 2048 or logits_bytes > LOGITS_BYTES_MIN) else "reference")
    if impl == "kernel":
        if softcap is not None or window is not None:
            raise NotImplementedError(
                "softcap and window have no flash kernel in the port yet")
        q_meta, kv_meta = pack_meta(q_seg, q_levels), pack_meta(kv_seg,
                                                                kv_levels)
        return lambda q, k, v: FlashAttention.apply(
            q, k, v, q_meta, kv_meta, int(q_offset), causal, scale)
    if impl != "reference":
        raise ValueError(f"unknown attention impl {impl!r}")
    mask = ops.make_attention_mask(
        batch=b, q_len=sq, kv_len=skv, causal=causal, q_offset=q_offset,
        q_segment_ids=q_seg, kv_segment_ids=kv_seg, q_levels=q_levels,
        kv_levels=kv_levels, window=window, device=device)
    return lambda q, k, v: ops.attention_reference(q, k, v, mask=mask,
                                                   scale=scale,
                                                   softcap=softcap)


def attention(q, k, v, **kw):
    """Differentiable attention. q [B, Sq, H, D]; k/v [B, Skv, KVH, D].
    Keywords as `attention_fn`; impl: "auto" | "kernel" | "reference"."""
    b, sq, h = q.shape[:3]
    return attention_fn(b, sq, k.shape[1], h, q.device, **kw)(q, k, v)
