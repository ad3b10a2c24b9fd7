"""Fused int8 decoder stack: the port of vlaser_tpu/kernels/fused_decode.py.

`fused_int8_stack` runs L Qwen2-family layers for R rows against per-layer
external K/V (the VLA denoise suffix: R action rows over the prefix cache).
On a CUDA tensor it launches the Hopper kernels of `csrc/fused_decode.cu`
(built on first use); on a CPU tensor it runs `fused_int8_stack_plain`, the
eager twin with the TPU kernel's rounding points. A tensor on any other
device raises, and a failed build or launch raises.

Rounding points (both versions): RMSNorm out bf16; q/k/v in fp32 (scale on
the output, then bias), rounded to bf16 before and after rope (each rope
product and the sum in the dtype of cos/sin); fp32 softmax with additive
fp32 masks; attention out bf16; x_new = bf16(x + o); gate/up in fp32,
silu(g)*u staged in fp32 and rounded to bf16 for the down GEMV; x = bf16(
x_new + down). The bf16-weight mode (unit scales) is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
launch_count = 0  # kernel launches through the CUDA route


def _dq(a, w8, s):
    """bf16 activations x int8 weights, fp32 accumulation, scale on out."""
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


_fn = None
_scratch_fn = None


def _kernel():
    global _fn, _scratch_fn
    if _fn is None:
        _fn = _build.bind(
            "int8_stack_forward", 33,
            (ctypes.c_int,) * 8 + (ctypes.c_float, ctypes.c_void_p),
        )
        _scratch_fn = _build.library().int8_stack_scratch_floats
        _scratch_fn.argtypes = [ctypes.c_int] * 5
        _scratch_fn.restype = ctypes.c_longlong
    return _fn, _scratch_fn


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
    f32, bf, i8 = torch.float32, torch.bfloat16, torch.int8
    _need(x, bf, (R, C), dev, "x")
    _need(cos, bf, (R, D), dev, "cos")
    _need(sin, bf, (R, D), dev, "sin")
    _need(self_mask, f32, (R, R), dev, "self_mask")
    _need(ext_mask, f32, (1, E), dev, "ext_mask")
    for t, n, nm in ((ln1, C, "ln1"), (ln2, C, "ln2"), (bq, QD, "bq"),
                     (bk, KD, "bk"), (bv, KD, "bv")):
        _need(t, f32, (L, n), dev, nm)
    for w, s, k, n, nm in ((wq, sq, C, QD, "wq"), (wk, sk, C, KD, "wk"),
                           (wv, sv, C, KD, "wv"), (wo, so, QD, C, "wo"),
                           (wg, sg, C, I, "wg"), (wu, su, C, I, "wu"),
                           (wd, sd, I, C, "wd")):
        _need(w, i8, (L, k, n), dev, nm)
        _need(s, f32, (L, 1, n), dev, nm + " scale")
    if D != 128 or H % KVH or R > 8 or any(n % 8 for n in (C, QD, KD, I)):
        raise ValueError("fused_int8_stack CUDA kernel needs head_dim 128, "
                         "R <= 8, widths % 8 == 0")
    _need(k_ext, bf, (L, E, KVH, D), dev, "k_ext")
    _need(v_ext, bf, (L, E, KVH, D), dev, "v_ext")
    fn, scratch = _kernel()
    e = lambda *s, dt=bf: torch.empty(s, dtype=dt, device=dev)
    x_out, k_self, v_self = e(R, C), e(L, R, KVH, D), e(L, R, KVH, D)
    h, xn, qr = e(R, max(C, QD, I)), e(R, C), e(R, QD)
    part = e(int(scratch(R, C, QD, KD, I)), dt=f32)
    ptrs = [x, cos, sin, self_mask, ext_mask, ln1, ln2, bq, bk, bv,
            wq, sq, wk, sk, wv, sv, wo, so, wg, sg, wu, su, wd, sd,
            k_ext, v_ext, x_out, k_self, v_self, h, xn, qr, part]
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(*[t.data_ptr() for t in ptrs], L, R, C, H, KVH, D, I, E, eps,
              stream)
    _build.check(code, "int8_stack_forward")
    launch_count += 1
    return x_out, k_self, v_self


@torch.no_grad()  # an inference stack: no backward
def fused_int8_stack(x, cos, sin, self_mask, ext_mask, ln1, ln2, bq, bk, bv,
                     wq, sq, wk, sk, wv, sv, wo, so, wg, sg, wu, su, wd, sd,
                     k_ext, v_ext, eps: float = 1e-6):
    """-> (x_out [R, hidden] bf16, k_self [L, R, KVH, D], v_self [...]).

    Weights w* int8 [L, K, N] with fp32 per-output-channel scales [L, 1, N];
    ln/bias fp32 [L, n]; k_ext/v_ext bf16 [L, ext_len, KVH, D]; masks are
    additive fp32 (0 = attend, NEG_INF = blocked; a self row always sees
    itself)."""
    args = (x, cos, sin, self_mask, ext_mask, ln1, ln2, bq, bk, bv,
            wq, sq, wk, sk, wv, sv, wo, so, wg, sg, wu, su, wd, sd,
            k_ext, v_ext)
    if x.device.type == "cpu":
        return fused_int8_stack_plain(*args, eps=eps)
    if x.device.type == "cuda":
        return _launch(*args, eps)
    raise RuntimeError(f"fused_int8_stack: no route for device {x.device}")
