"""Flash attention: the port of vlaser_tpu/kernels/flash_attention.py.

Layouts are the JAX package's: q [B, Sq, H, D], k/v [B, Skv, KVH, D] (GQA,
head h reads kv head h // (H // KVH)), lse [B, H, Sq] fp32. Per-token
metadata packs (segment, level) into one int32 (`pack_meta`); a key is
allowed iff q_seg == k_seg, k_seg != 0 and k_lev <= q_lev, and, when causal,
q_offset + q_idx >= k_idx. A row with no allowed key gives out = 0 and
lse = -1e30 + log(1). `window` (causal callers only, as in JAX) further
allows a key iff q_offset + q_idx - k_idx <= window (flash-attn's left
window); `softcap` replaces each logit z = scale * q.k by
softcap * tanh(z / softcap) before the mask (Gemma).

`flash_attention_fwd` / `flash_attention_bwd` launch the Hopper kernels of
`csrc/flash_attention.cu` on CUDA tensors (bf16, head_dim in HEAD_DIMS) and
run their plain versions (`*_plain`, fp32 math, any head_dim) on CPU
tensors; any other device raises. `attention` is the differentiable entry
point (`attention_fn` builds it once for a layer stack): `impl="auto"`
takes the kernel (`FlashAttention`, whose backward is
`flash_attention_bwd`) on a CUDA tensor exactly where the JAX dispatch
takes Pallas on the TPU (Sq >= 2048 or fp32 logits over 128 MiB) and the
eager reference (kernels.ops) elsewhere, as the JAX package leaves those
shapes to XLA. A per-row q_offset always takes the reference.
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
LOGITS_BYTES_MIN = 128 * 2**20  # the JAX dispatch's thresholds: logits
SQ_MIN = 2048                   # bytes, query rows
HEAD_DIMS = (64, 72, 128, 256)  # the CUDA kernels' head dims
NCW = 2  # consumer warpgroups of a CUDA block (64 rows or keys each)
fwd_launch_count = 0  # flash_attention_fwd launches through the CUDA route
bwd_launch_count = 0  # flash_attention_bwd launches (delta, dq, dk/dv)


def launch_plan(b: int, sq: int, skv: int, h: int, kvh: int, d: int):
    """The CUDA kernels' launch plan (`csrc/flash_attention.cu`: pack_of,
    the tile sizes of Dims<D>, the grids of fwd / bwd), kept here so that
    the CPU tests can hold it.

    `pack`: the rows of a q tile are (q row, head) pairs, row r = (q row
    x * rows / pack + r // pack, head y * pack + r % pack) of block (x, y):
    a group's heads share a tile when the queries are few (Sq < 64 and the
    group G divides 32: pack = G), else one head fills it (pack = 1). The
    dk/dv kernel walks, for each block of keys, the group's head groups and
    q tiles of `q_rows` such pairs in the same order."""
    g = h // kvh
    pack = g if sq < 64 and g > 1 and 32 % g == 0 else 1
    grid = lambda rows: (-(-sq // (rows // pack)), h // pack, b)
    rows = 64 * (3 if d == 64 else NCW)  # three warpgroups at D 64
    split = d > 128
    bk, bq = (64, 32) if split else (64 * NCW, 64)
    return {"pack": pack,
            "fwd": {"grid": grid(rows), "rows": rows,
                    "keys": 64 if d > 128 else 128},
            "dq": {"grid": grid(rows), "rows": rows,
                   "keys": 32 if d > 128 else 64},
            "dkv": {"grid": (-(-skv // bk), kvh, b), "keys": bk,
                    "q_rows": bq, "head_groups": g // pack,
                    "q_tiles": -(-sq // (bq // pack)), "split": split}}


def tile_pairs(pack: int, rows: int, tile: int, head0: int, sq: int):
    """-> [(head, q row)] of a tile of `rows` packed rows: the tile-th tile
    of q rows of the heads head0 .. head0 + pack - 1, in row order; rows past
    sq (TMA's zero fill) are left out."""
    nq = rows // pack
    pairs = []
    for r in range(rows):
        i = tile * nq + r // pack
        if i < sq:
            pairs.append((head0 + r % pack, i))
    return pairs


def pack_meta(segment_ids: torch.Tensor,
              levels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack per-token (segment, level) into one int32. Segment 0 = padding."""
    meta = segment_ids.to(torch.int32) << LEVEL_BITS
    if levels is not None:
        meta = meta | levels.to(torch.int32)
    return meta


def _allowed(q_meta, kv_meta, q_offset: int, causal: bool,
             window: Optional[int] = None):
    """[B, Sq, Skv] bool: the kernels' mask rule."""
    qs, ks = (q_meta >> LEVEL_BITS)[:, :, None], (kv_meta >> LEVEL_BITS)[:, None]
    ql, kl = (q_meta & LEVEL_MASK)[:, :, None], (kv_meta & LEVEL_MASK)[:, None]
    ok = (qs == ks) & (ks != 0) & (kl <= ql)
    if causal or window is not None:
        sq, skv = q_meta.shape[1], kv_meta.shape[1]
        rows = q_offset + torch.arange(sq, device=q_meta.device)[:, None]
        cols = torch.arange(skv, device=q_meta.device)
        if causal:
            ok = ok & (rows >= cols)[None]
        if window is not None:
            ok = ok & (rows - cols <= window)[None]
    return ok


def _scale(scale, d):
    return scale if scale is not None else 1.0 / math.sqrt(d)


def _capped(s, softcap):
    """-> (logits, tanh(s / softcap) or None): the Gemma soft clamp."""
    if softcap is None:
        return s, None
    t = torch.tanh(s / softcap)
    return softcap * t, t


def flash_attention_fwd_plain(q, k, v, q_meta, kv_meta, q_offset: int = 0,
                              causal: bool = False,
                              scale: Optional[float] = None,
                              softcap: Optional[float] = None,
                              window: Optional[int] = None):
    """-> (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] fp32)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, sq, kvh, g, d) * _scale(scale, d)
    s, _ = _capped(torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()), softcap)
    ok = _allowed(q_meta, kv_meta, q_offset, causal, window)[:, None, None]
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(torch.where(ok, s - m, -math.inf))
    lsum = p.sum(-1, keepdim=True)
    safe = torch.where(lsum == 0, 1.0, lsum)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / safe
    out = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return out, (m + torch.log(safe))[..., 0].reshape(b, h, sq)


def _delta(out, dout):
    """rowsum(dO * O) -> [B, H, Sq] fp32 (the plain version's; on the card
    a pre-pass kernel takes it)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_math(q, k, v, q_meta, kv_meta, q_offset, lse, delta, dout, causal,
              scale, softcap=None, window=None):
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = _scale(scale, d)
    qf = q.float().reshape(b, sq, kvh, g, d)
    kf, vf = k.float(), v.float()
    s, t = _capped(torch.einsum("bqkgd,bskd->bkgqs", qf * scale, kf), softcap)
    ok = _allowed(q_meta, kv_meta, q_offset, causal, window)[:, None, None]
    lse5 = lse.reshape(b, kvh, g, sq, 1)
    # masked entries are zeroed before exp: a fully masked row has
    # lse = -1e30, and exp(s - lse) there is inf
    p = torch.exp(torch.where(ok, s - lse5, -math.inf))
    do = dout.float().reshape(b, sq, kvh, g, d)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, vf)
    ds = p * (dp - delta.reshape(b, kvh, g, sq, 1))
    if t is not None:
        ds = ds * (1.0 - t * t)  # d/dz of softcap * tanh(z / softcap)
    dq = scale * torch.einsum("bkgqs,bskd->bqkgd", ds, kf)
    dk = scale * torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_plain(q, k, v, q_meta, kv_meta, q_offset, out, lse,
                              dout, causal: bool = False,
                              scale: Optional[float] = None,
                              softcap: Optional[float] = None,
                              window: Optional[int] = None):
    """-> (dq, dk, dv), P recomputed from lse."""
    return _bwd_math(q, k, v, q_meta, kv_meta, q_offset, lse,
                     _delta(out, dout), dout, causal, scale, softcap, window)


_fns = {}


def _kernel(name, n_ptr):
    if name not in _fns:
        _fns[name] = _build.bind(
            name, n_ptr, (ctypes.c_int,) * 8 + (ctypes.c_float, ctypes.c_float,
                                                ctypes.c_int, ctypes.c_void_p))
    return _fns[name]


def _aligned(t):
    """t contiguous at a 16-byte aligned address (TMA's rule)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _opts(causal, q_offset, d, scale, softcap, window):
    """The C entry's trailing scalars: softcap 0 and window -1 mean none."""
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return (int(causal), int(q_offset), _scale(scale, d),
            0.0 if softcap is None else float(softcap),
            -1 if window is None else int(window))


def _check(q, k, v, q_meta, kv_meta, what):
    b, sq, h, d = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q/k/v must be bf16")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: the CUDA kernel takes head_dim in "
                         f"{HEAD_DIMS}, not {d}")
    if (k.dim() != 4 or k.shape[0] != b or k.shape[3] != d
            or v.shape != k.shape or h % k.shape[2]):
        raise ValueError(f"{what}: k/v must be [B, Skv, KVH, D], H % KVH == 0")
    for name, m, n in (("q_meta", q_meta, sq), ("kv_meta", kv_meta, k.shape[1])):
        if m.dtype != torch.int32 or tuple(m.shape) != (b, n):
            raise TypeError(f"{what}: {name} must be int32 [B, {n}]")
    for t in (k, v, q_meta, kv_meta):
        if t.device != q.device:
            raise ValueError(f"{what}: all inputs must be on {q.device}")


def _fwd_launch(q, k, v, q_meta, kv_meta, q_offset, causal, scale, softcap,
                window):
    global fwd_launch_count
    _check(q, k, v, q_meta, kv_meta, "flash_attention_fwd")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    q_meta, kv_meta = q_meta.contiguous(), kv_meta.contiguous()
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _kernel("flash_attention_fwd", 7)(
        *[t.data_ptr() for t in (q, k, v, q_meta, kv_meta, out, lse)],
        b, sq, skv, h, kvh, d,
        *_opts(causal, q_offset, d, scale, softcap, window), stream)
    _build.check(code, "flash_attention_fwd")
    fwd_launch_count += 1
    return out, lse


def _bwd_launch(q, k, v, q_meta, kv_meta, q_offset, out, lse, dout, causal,
                scale, softcap, window):
    global bwd_launch_count
    _check(q, k, v, q_meta, kv_meta, "flash_attention_bwd")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    for name, t in (("dout", dout), ("out", out)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"flash_attention_bwd: {name} must match q")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq):
        raise TypeError("flash_attention_bwd: lse must be fp32 [B, H, Sq]")
    q, k, v, out, dout = (_aligned(t) for t in (q, k, v, out, dout))
    q_meta, kv_meta, lse = (t.contiguous() for t in (q_meta, kv_meta, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # rowsum(dO * O): written by the delta kernel, read by dq and dk/dv
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _kernel("flash_attention_bwd", 12)(
        *[t.data_ptr() for t in (q, k, v, out, dout, q_meta, kv_meta, lse,
                                 delta, dq, dk, dv)],
        b, sq, skv, h, kvh, d,
        *_opts(causal, q_offset, d, scale, softcap, window), stream)
    _build.check(code, "flash_attention_bwd")
    bwd_launch_count += 1
    return dq, dk, dv


def _route(x, what, *others):
    return _build.route(x, what, *others)


def flash_attention_fwd(q, k, v, q_meta, kv_meta, q_offset: int = 0,
                        causal: bool = False, scale: Optional[float] = None,
                        softcap: Optional[float] = None,
                        window: Optional[int] = None):
    """-> (out [B, Sq, H, D], lse [B, H, Sq] fp32)."""
    if _route(q, "flash_attention_fwd", k, v, q_meta, kv_meta) == "cpu":
        return flash_attention_fwd_plain(q, k, v, q_meta, kv_meta, q_offset,
                                         causal, scale, softcap, window)
    return _fwd_launch(q, k, v, q_meta, kv_meta, q_offset, causal, scale,
                       softcap, window)


def flash_attention_bwd(q, k, v, q_meta, kv_meta, q_offset, out, lse, dout,
                        causal: bool = False, scale: Optional[float] = None,
                        softcap: Optional[float] = None,
                        window: Optional[int] = None):
    """-> (dq, dk, dv). On the card delta = rowsum(dO * O) is taken by a
    pre-pass kernel; the CPU route takes it with `_delta`."""
    if _route(q, "flash_attention_bwd", k, v, q_meta, kv_meta, out, lse,
              dout) == "cpu":
        return flash_attention_bwd_plain(q, k, v, q_meta, kv_meta, q_offset,
                                         out, lse, dout, causal, scale,
                                         softcap, window)
    return _bwd_launch(q, k, v, q_meta, kv_meta, q_offset, out, lse, dout,
                       causal, scale, softcap, window)


def wgmma_probe(q, k, v):
    """The kernels' first product of each kind on one tile, alone (the
    probe_kernel of `csrc/flash_attention.cu`): q, k, v [64, D] bf16 on the
    card -> (s = q k^T [64, 64] fp32, o = bf16(s) v [64, D] fp32)."""
    d = q.shape[-1]
    if q.shape != (64, d) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("wgmma_probe: q, k, v must be [64, D]")
    if d not in HEAD_DIMS or q.dtype != torch.bfloat16:
        raise ValueError(f"wgmma_probe: bf16 with D in {HEAD_DIMS}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    s = torch.empty((64, 64), dtype=torch.float32, device=q.device)
    o = torch.empty((64, d), dtype=torch.float32, device=q.device)
    fn = _fns.get("flash_wgmma_probe")
    if fn is None:
        fn = _fns["flash_wgmma_probe"] = _build.bind(
            "flash_wgmma_probe", 5, (ctypes.c_int, ctypes.c_void_p))
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
                    o.data_ptr(), d,
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "flash_wgmma_probe")
    return s, o


class FlashAttention(torch.autograd.Function):
    """out = flash(q, k, v); the backward is flash_attention_bwd."""

    @staticmethod
    def forward(ctx, q, k, v, q_meta, kv_meta, q_offset, causal, scale,
                softcap, window):
        out, lse = flash_attention_fwd(q, k, v, q_meta, kv_meta, q_offset,
                                       causal, scale, softcap, window)
        ctx.save_for_backward(q, k, v, q_meta, kv_meta, out, lse)
        ctx.args = (q_offset, causal, scale, softcap, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_meta, kv_meta, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, q_meta, kv_meta, ctx.args[0],
                                         out, lse, dout.contiguous(),
                                         *ctx.args[1:])
        return dq, dk, dv, None, None, None, None, None, None, None


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
            sq >= SQ_MIN or logits_bytes > LOGITS_BYTES_MIN) else "reference")
    if impl == "kernel":
        q_meta, kv_meta = pack_meta(q_seg, q_levels), pack_meta(kv_seg,
                                                                kv_levels)
        return lambda q, k, v: FlashAttention.apply(
            q, k, v, q_meta, kv_meta, int(q_offset), causal, scale, softcap,
            window)
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
