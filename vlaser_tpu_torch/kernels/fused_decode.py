"""Fused decoder stack: the port of vlaser_tpu/kernels/fused_decode.py.

`fused_int8_stack` runs L Qwen2-family layers for R rows against per-layer
external K/V: the VLA denoise suffix (R action rows over the prefix cache)
and the VLM decode (R = 1 token over the whole KV cache, its empty and
padded slots masked). Weights are int8 with per-output-channel fp32 scales,
or bf16 with unit scales (the TPU kernel's two modes). On a CUDA tensor it
launches the Hopper kernels of `csrc/fused_decode.cu` (built on first use);
on a CPU tensor it runs `fused_int8_stack_plain`, the eager twin with the
TPU kernel's rounding points. A tensor on any other device raises, and a
failed build or launch raises.

Rounding points (both versions): RMSNorm out bf16; q/k/v in fp32 (scale on
the output, then bias), rounded to bf16 before and after rope (each rope
product and the sum in the dtype of cos/sin: bf16 tables round each, fp32
ones round once); fp32 softmax with additive fp32 masks; attention out
bf16; x_new = bf16(x + o); gate/up in fp32, silu(g)*u staged in fp32 and
rounded to bf16 for the down GEMV; x = bf16(x_new + down).

The CUDA stack is one cooperative launch. Its attention is split-KV: the
[external | self] keys of each (kv head, row) are cut into chunks of
`kv_chunk(...)` keys (`chunk_bounds`), each chunk gives a partial (m, l, o)
and the chunks are combined in order (`split_kv_attention_plain` is that
computation in plain PyTorch, for the tests and chip_smoke.py's gates; the
twin keeps the unsplit softmax).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
launch_count = 0  # kernel launches through the CUDA route
rows_launch_count = {}  # the same launches by row count R
trace = None  # an int64 CUDA tensor of 1 + 8 L: the next stack call records
# block 0's clock (ns) as it starts and as each of a layer's 8 phases ends
PHASES = ("q/k/v", "rope", "attention", "o", "residual 1", "gate/up", "down",
          "residual 2")
KV_CHUNK_MIN, KV_CHUNK_MAX = 64, 256  # keys of an attention item (the
# kernel's score buffer holds 256 a head)
ITEM_TARGET = 264  # attention items to aim for: the cooperative grid's two
# blocks per SM of an H100's 132


def kv_chunk(keys: int, kv_heads: int, rows: int) -> int:
    """Keys per attention chunk for `keys` = E + R keys of `kv_heads` x
    `rows` (kv head, row) pairs: enough chunks that the items fill about
    ITEM_TARGET blocks, each a multiple of 32 keys within [KV_CHUNK_MIN,
    KV_CHUNK_MAX] (the combine reads every chunk once per output column, so
    chunks are not cut finer than that)."""
    per_pair = max(1, ITEM_TARGET // (kv_heads * rows))
    c = -(-keys // per_pair)
    c = -(-c // 32) * 32
    return min(KV_CHUNK_MAX, max(KV_CHUNK_MIN, c))


def chunk_bounds(keys: int, chunk: int) -> list[tuple[int, int]]:
    """[(first key, one past the last)] of each chunk: every key in exactly
    one chunk, in order, none empty."""
    return [(j, min(j + chunk, keys)) for j in range(0, keys, chunk)]


def split_kv_attention_plain(q, keys, vals, mask, chunk: int):
    """softmax(q . keys^T + mask) . vals as the CUDA stack computes it: q
    [n, D] fp32 (scaled), keys / vals [T, D], mask [n, T] fp32 additive ->
    [n, D] fp32. Each chunk of `chunk` keys gives m = max s, l = sum exp(s -
    m), o = exp(s - m) . V; the chunks combine in order with weights exp(m -
    M), M the largest m, so a chunk whose keys are all masked (m = NEG_INF)
    weighs exactly 0 beside any chunk with an unmasked key."""
    ms, ls, os_ = [], [], []
    for j0, j1 in chunk_bounds(keys.shape[0], chunk):
        s = q @ keys[j0:j1].float().T + mask[:, j0:j1]
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        os_.append(p @ vals[j0:j1].float())
    M = torch.stack(ms).amax(0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(os_[0])
    for m, l, o in zip(ms, ls, os_):
        w = torch.exp(m - M)
        L = L + w * l
        O = O + w * o
    return O / L


def _dq(a, w8, s):
    """bf16 activations x int8 (or bf16) weights, fp32 accumulation, scale
    on out."""
    return (a.to(torch.bfloat16).float() @ w8.float()) * s.float()


def _rms(v, w, eps):
    vf = v.float()
    var = (vf * vf).mean(-1, keepdim=True)
    return (vf * torch.rsqrt(var + eps) * w.float()).to(torch.bfloat16)


def _rope(v, cos, sin):
    """v [R, H, D]; cos/sin [R, D] -- rotate-half, in the inputs' dtypes."""
    d = v.shape[-1]
    rot = torch.cat([-v[..., d // 2:], v[..., :d // 2]], dim=-1)
    return v * cos[:, None, :] + rot * sin[:, None, :]


@torch.no_grad()  # an inference stack: no backward
def fused_int8_stack_plain(x, cos, sin, self_mask, ext_mask, ln1, ln2,
                           bq, bk, bv, wq, sq, wk, sk, wv, sv, wo, so,
                           wg, sg, wu, su, wd, sd, k_ext, v_ext,
                           eps: float = 1e-6):
    """Eager twin: -> (x_out [R, C] bf16, k_self, v_self [L, R, KVH, D])."""
    bf = torch.bfloat16
    R, _ = x.shape
    L, _, q_dim = wq.shape
    head_dim = cos.shape[-1]
    kv_heads, ext_len = k_ext.shape[2], k_ext.shape[1]
    heads = q_dim // head_dim
    groups = heads // kv_heads
    scale = head_dim ** -0.5
    mask = torch.cat([ext_mask.float().expand(R, ext_len),
                      self_mask.float()], dim=1)
    xs = x.to(bf)
    k_out, v_out = [], []
    for l in range(L):
        h = _rms(xs, ln1[l], eps)
        q = _dq(h, wq[l], sq[l]) + bq[l][None, :].float()
        k = _dq(h, wk[l], sk[l]) + bk[l][None, :].float()
        v = _dq(h, wv[l], sv[l]) + bv[l][None, :].float()
        q = _rope(q.reshape(R, heads, head_dim).to(bf), cos, sin).to(bf)
        k = _rope(k.reshape(R, kv_heads, head_dim).to(bf), cos, sin).to(bf)
        v = v.reshape(R, kv_heads, head_dim).to(bf)
        k_out.append(k)
        v_out.append(v)
        outs = []
        for g in range(kv_heads):
            qg = (q[:, g * groups:(g + 1) * groups].reshape(R * groups,
                                                            head_dim)
                  .float() * scale)
            keys = torch.cat([k_ext[l, :, g], k[:, g]], dim=0).float()
            m = mask[:, None, :].expand(R, groups, ext_len + R)
            p = torch.softmax(qg @ keys.T + m.reshape(R * groups, -1), dim=-1)
            vals = torch.cat([v_ext[l, :, g], v[:, g]], dim=0).float()
            outs.append((p @ vals).reshape(R, groups, head_dim))
        attn = torch.cat(outs, dim=1).reshape(R, q_dim).to(bf)
        x_new = (xs.float() + _dq(attn, wo[l], so[l])).to(bf)
        h2 = _rms(x_new, ln2[l], eps)
        gt = _dq(h2, wg[l], sg[l])
        up = _dq(h2, wu[l], su[l])
        d = _dq((gt * torch.sigmoid(gt) * up).to(bf), wd[l], sd[l])
        xs = (x_new.float() + d).to(bf)
    return xs, torch.stack(k_out), torch.stack(v_out)


_fns = {}
_barriers = {}  # (device, stream) -> the grid barrier's counters


def _kernel():
    """-> (the stack, its scratch size, its cooperative grid)."""
    if not _fns:
        lib = _build.library()
        scratch, grid = lib.int8_stack_scratch_floats, lib.int8_stack_grid
        scratch.argtypes, scratch.restype = [ctypes.c_int] * 5, ctypes.c_longlong
        grid.argtypes, grid.restype = [ctypes.c_int] * 2, ctypes.c_int
        _fns["stack"] = _build.bind(
            "int8_stack_forward", 35,
            (ctypes.c_int,) * 11 + (ctypes.c_float, ctypes.c_void_p))
        _fns["attention"] = _build.bind(
            "int8_stack_attention", 10,
            (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
        _fns["scratch"], _fns["grid"] = scratch, grid
    return _fns["stack"], _fns["scratch"], _fns["grid"]


def _barrier(dev, stream):
    """The grid barrier's counters for launches on `stream` of device `dev`
    (an index): zero, and left zero by every launch (a launch on another
    stream gets its own)."""
    key = (dev, stream)
    if key not in _barriers:
        _barriers[key] = torch.zeros(3, dtype=torch.int32, device=dev)
    return _barriers[key]


def _index(dev):
    return dev.index if dev.index is not None else torch.cuda.current_device()


def grid_blocks(R: int, bf16_weights: bool, device=None) -> int:
    """Blocks of the stack's cooperative grid on the card (the occupancy
    query for the kernel's registers and shared memory, at most two per
    SM)."""
    _, _, grid = _kernel()
    with torch.cuda.device(device):
        n = int(grid(R, int(bf16_weights)))
    _build.check(max(0, -n), "int8_stack_grid")
    return n


def split_kv_attention(q, k_ext, v_ext, k_self, v_self, self_mask, ext_mask):
    """The stack's split-KV attention alone on the card (one layer, at the
    planner's chunk; for timing and tests, the stack does not call it): q
    [R, H*D] bf16 (roped), k_ext / v_ext [E, KVH, D], k_self / v_self [R,
    KVH, D] bf16, masks as the stack's -> [R, H*D] bf16."""
    R, QD = q.shape
    E, KVH, D = k_ext.shape
    chunk = kv_chunk(E + R, KVH, R)
    nch = -(-(E + R) // chunk)
    dev = q.device
    apart = torch.empty((QD // D) * R * nch * (2 + D), dtype=torch.float32,
                        device=dev)
    out = torch.empty_like(q)
    _kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q, k_ext, v_ext, k_self, v_self, self_mask, ext_mask, out, apart,
            _barrier(_index(dev), stream))
    code = _fns["attention"](*[t.data_ptr() for t in ptrs], R, QD // D, KVH,
                             E, chunk, stream)
    _build.check(code, "int8_stack_attention")
    return out


def _need(t, dtype, shape, dev, name):
    if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise TypeError(f"fused_int8_stack: {name} must be contiguous {dtype} "
                        f"{tuple(shape)} on {dev}, got {t.dtype} "
                        f"{tuple(t.shape)} on {t.device}")


def _launch(x, cos, sin, self_mask, ext_mask, ln1, ln2, bq, bk, bv,
            wq, sq, wk, sk, wv, sv, wo, so, wg, sg, wu, su, wd, sd,
            k_ext, v_ext, eps):
    global launch_count
    dev = x.device
    R, C = x.shape
    L, _, QD = wq.shape
    KD, I = wk.shape[-1], wg.shape[-1]
    D = cos.shape[-1]
    _, E, KVH, _ = k_ext.shape
    H = QD // D
    f32, bf = torch.float32, torch.bfloat16
    wdt, cdt = wq.dtype, cos.dtype
    if wdt not in (torch.int8, bf) or cdt not in (f32, bf):
        raise TypeError("fused_int8_stack: weights must be int8 or bf16, "
                        "cos/sin bf16 or fp32")
    _need(x, bf, (R, C), dev, "x")
    _need(cos, cdt, (R, D), dev, "cos")
    _need(sin, cdt, (R, D), dev, "sin")
    _need(self_mask, f32, (R, R), dev, "self_mask")
    _need(ext_mask, f32, (1, E), dev, "ext_mask")
    for t, n, nm in ((ln1, C, "ln1"), (ln2, C, "ln2"), (bq, QD, "bq"),
                     (bk, KD, "bk"), (bv, KD, "bv")):
        _need(t, f32, (L, n), dev, nm)
    for w, s, k, n, nm in ((wq, sq, C, QD, "wq"), (wk, sk, C, KD, "wk"),
                           (wv, sv, C, KD, "wv"), (wo, so, QD, C, "wo"),
                           (wg, sg, C, I, "wg"), (wu, su, C, I, "wu"),
                           (wd, sd, I, C, "wd")):
        _need(w, wdt, (L, k, n), dev, nm)
        _need(s, f32, (L, 1, n), dev, nm + " scale")
    if (D != 128 or H % KVH or H // KVH > 8 or R > 8
            or any(n % 8 for n in (C, QD, KD, I))):
        raise ValueError("fused_int8_stack CUDA kernel needs head_dim 128, "
                         "R <= 8, at most 8 q heads a kv head, widths % 8 "
                         "== 0")
    _need(k_ext, bf, (L, E, KVH, D), dev, "k_ext")
    _need(v_ext, bf, (L, E, KVH, D), dev, "v_ext")
    fn, scratch, _ = _kernel()
    idx = _index(dev)
    shape = (R, C, QD, KD, I)
    if shape not in _fns:  # a host query that depends on the shapes
        _fns[shape] = int(scratch(R, C, QD, KD, I))
    n_part = _fns[shape]
    chunk = kv_chunk(E + R, KVH, R)
    nch = -(-(E + R) // chunk)
    e = lambda *s, dt=bf: torch.empty(s, dtype=dt, device=dev)
    x_out, k_self, v_self = e(R, C), e(L, R, KVH, D), e(L, R, KVH, D)
    xn, qr = e(R, C), e(R, QD)
    part, apart = e(n_part, dt=f32), e(H * R * nch * (2 + D), dt=f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x, cos, sin, self_mask, ext_mask, ln1, ln2, bq, bk, bv,
            wq, sq, wk, sk, wv, sv, wo, so, wg, sg, wu, su, wd, sd,
            k_ext, v_ext, x_out, k_self, v_self, xn, qr, part, apart,
            _barrier(idx, stream)]
    if trace is not None and trace.numel() < 1 + 8 * L:
        raise ValueError(f"fused_int8_stack: trace needs {1 + 8 * L} slots")
    # one cooperative launch; a refused launch returns its error, raised here
    code = fn(*[t.data_ptr() for t in ptrs],
              None if trace is None else trace.data_ptr(), L, R, C, H, KVH, D,
              I, E, int(wdt == bf), int(cdt == f32), chunk, eps, stream)
    _build.check(code, "int8_stack_forward")
    launch_count += 1
    rows_launch_count[R] = rows_launch_count.get(R, 0) + 1
    return x_out, k_self, v_self


@torch.no_grad()  # an inference stack: no backward
def fused_int8_stack(x, cos, sin, self_mask, ext_mask, ln1, ln2, bq, bk, bv,
                     wq, sq, wk, sk, wv, sv, wo, so, wg, sg, wu, su, wd, sd,
                     k_ext, v_ext, eps: float = 1e-6):
    """-> (x_out [R, hidden] bf16, k_self [L, R, KVH, D], v_self [...]).

    Weights w* int8 [L, K, N] with fp32 per-output-channel scales [L, 1, N],
    or bf16 with unit scales; ln/bias fp32 [L, n]; cos/sin [R, D] bf16 or
    fp32; k_ext/v_ext bf16 [L, ext_len, KVH, D]; masks are additive fp32 (0
    = attend, NEG_INF = blocked; a self row always sees itself)."""
    args = (x, cos, sin, self_mask, ext_mask, ln1, ln2, bq, bk, bv,
            wq, sq, wk, sk, wv, sv, wo, so, wg, sg, wu, su, wd, sd,
            k_ext, v_ext)
    _build.route(x, "fused_int8_stack", *[t for t in args
                                   if t is not None])
    if x.device.type == "cpu":
        return fused_int8_stack_plain(*args, eps=eps)
    if x.device.type == "cuda":
        return _launch(*args, eps)
    raise RuntimeError(f"fused_int8_stack: no route for device {x.device}")
