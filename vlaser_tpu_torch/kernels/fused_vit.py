"""InternViT encoder stack: the port of vlaser_tpu/kernels/fused_vit.py.

`fused_vit_stack` runs the whole L-layer encoder (select_layer=-1). On a
CUDA tensor it launches the Hopper kernels of `csrc/fused_vit.cu` (built on
first use); on a CPU tensor it runs `fused_vit_stack_plain`, the eager twin
with the same rounding points. There is no other route: a tensor on any
other device raises, and a failed build or launch raises.

Rounding points (both versions, as the TPU kernel): LayerNorm in fp32 ->
bf16; QKV in fp32 with bias; optional full-hidden QK-RMSNorm in fp32; q is
scaled by head_dim^-0.5*log2(e) and q/k/v are rounded to bf16; softmax in
exp2 under the TPU kernel's shift, no row max: every score of a row is
shifted by m = sqrt(||q_h||^2 * max_r ||k_h||^2 + 1e-12) (Cauchy-Schwarz on
the bf16 operands, norms in fp32), e = exp2(s - m) rounded to bf16 for the
P.V product, the denominator d summed over the rounded e in fp32, and the
output multiplied by 1 / d (a row whose d falls below MIN_D = 2^-100,
where the TPU kernel's exponents underflow to a NaN row, is shifted by its
largest score); attention out bf16; proj/fc2 outputs are
rounded to bf16 before `x + out * ls` (fp32) -> bf16; fc1 -> exact-erf GELU
-> bf16. The TPU kernel's polynomial erf is replaced by erf (the same
function within bf16 rounding); its padded keys (B > 1), whose closed-form
correction `d - npad * 2^-m` removes them, are not there at all.

act_quant (w8a8) mode: int8 weights K-major [L, N, K] (the layout the int8
tensor-core GEMM reads; `pack_vit_stack` packs them so) with fp32 scales
[L, N] (qkvs, projs, fc1s, fc2s). qkv and fc1 quantize the fp32 LayerNorm
output (not rounded to bf16), proj the bf16 attention output, fc2 the fp32
GELU output (kernels/w8a8.py: per-row amax, round half to even); each
product is exact in integers and rescaled as float(acc) * ((amax / 127) *
scale) + bias (fused_vit.py:150-168). At B > 1 fc2's input is quantized in
two halves of `inter`, each with its own row amax, and the two rescaled
products are added to fc2b in order: (fc2b + half 0) + half 1, as the TPU
kernel's two MLP chunks; each half's weight is a column slice of fc2's
K-major [C, inter] rows.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.tensor_parallel import refuse_cut
from . import _build
from .w8a8 import INV127, int_mm_exact, quantize_rows_plain

LOG2E = 1.4426950408889634
launch_count = 0  # bf16-mode stack launches through the CUDA route
act_quant_launch_count = 0  # act_quant (w8a8) stack launches


def _ln(x, w, b, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    return (xf - mean) * torch.rsqrt(var + eps) * w.float() + b.float()


def _rms(x, w, eps):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * w.float()


def _mm(a, w):
    """bf16 operands, fp32 accumulation."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def _qdot(a, w8, s):
    """The act_quant stack's dot: a [M, K] fp32/bf16, w8 int8 [N, K]
    (K-major), s fp32 [N] -> float(int8(a) @ w8^T) * ((amax / 127) * s),
    fp32 [M, N]."""
    q, am = quantize_rows_plain(a)
    return int_mm_exact(q, w8) * ((am * INV127) * s.float())


def _fc2_groups(B: int) -> int:
    """fc2's activation groups: the TPU kernel's MLP chunks (1 at B=1)."""
    return 1 if B == 1 else 2


MIN_D = 2.0 ** -100  # a denominator under the norm bound below this: the
# row's exponents have underflowed (or nearly)


def norm_bound(q, k):
    """The TPU kernel's shift for q/k [B, S, heads, D] (bf16 values, q in
    the log2 domain): m = sqrt(||q||^2 max_r ||k_r||^2 + 1e-12) [B, heads,
    S, 1], which no score of the row exceeds (Cauchy-Schwarz)."""
    qn = (q * q).sum(-1).permute(0, 2, 1)[..., None]  # [B, heads, S, 1]
    kn = (k * k).sum(-1).amax(1)[:, :, None, None]    # [B, heads, 1, 1]
    return torch.sqrt(qn * kn + 1e-12)


def shifted_attention(q, k, v):
    """The TPU kernel's softmax.V (fused_vit.py:270-281, 374-381) in fp32:
    q/k/v [B, S, heads, D] (bf16 values, q in the log2 domain) -> o [B,
    heads, S, D] fp32, before its bf16 rounding. Every score of a row is
    shifted by the norm bound m; e = bf16(exp2(s - m)); o = (e.V) / d with d
    the fp32 sum of the rounded e. A row whose d falls below MIN_D, where
    the TPU kernel's exponents underflow (d = 0: a NaN row), is shifted by
    its largest score instead."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    m = norm_bound(q, k)
    e = torch.exp2(s - m).to(torch.bfloat16).float()
    d = e.sum(-1, keepdim=True)
    low = d < MIN_D
    if low.any():
        m = torch.where(low, s.amax(-1, keepdim=True), m)
        e = torch.exp2(s - m).to(torch.bfloat16).float()
        d = e.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bhqd", e, v) * (1.0 / d)


def _attention(qs, ks, vs, B, S, heads):
    """qs/ks/vs bf16 [B*S, C], q pre-scaled into the log2 domain."""
    C = qs.shape[-1]
    D = C // heads
    q, k, v = (t.view(B, S, heads, D).float() for t in (qs, ks, vs))
    o = shifted_attention(q, k, v)
    return o.permute(0, 2, 1, 3).reshape(B * S, C).to(torch.bfloat16)


@torch.no_grad()  # an inference stack: no backward
def fused_vit_stack_plain(x, ln1w, ln1b, ln2w, ln2b, ls1, ls2, qnw, knw,
                          qkvb, projb, fc1b, fc2b, qkvw, projw, fc1w, fc2w,
                          qkvs=None, projs=None, fc1s=None, fc2s=None,
                          num_heads: int = 16, eps: float = 1e-6,
                          qk_norm: bool = False, act_quant: bool = False):
    """Eager twin of the CUDA stack: x [B, S, C] or [S, C] bf16 -> same.
    Weights [L, K, N] (bf16 mode) or K-major [L, N, K] (act_quant)."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    B, S, C = x.shape
    L = qkvw.shape[0]
    qscale = (C // num_heads) ** -0.5 * LOG2E
    bf = torch.bfloat16
    x = x.reshape(B * S, C).to(bf)
    # the one difference between the modes: w8a8 quantizes the fp32 input,
    # the bf16 mode rounds it to bf16 (_mm); fc2's groups exist only in w8a8
    if act_quant:
        dot, G = _qdot, _fc2_groups(B)
        k_rows = lambda w, ch: w[:, ch]  # K-major: K runs along the columns
    else:
        dot, G = (lambda a, w, s: _mm(a, w)), 1
        k_rows = lambda w, ch: w[ch]
        qkvs = projs = fc1s = fc2s = (None,) * L
    half = fc2w.shape[2 if act_quant else 1] // G
    for l in range(L):
        h = _ln(x, ln1w[l], ln1b[l], eps)
        qkv = dot(h, qkvw[l], qkvs[l]) + qkvb[l].float()
        q, k, v = qkv[:, :C], qkv[:, C:2 * C], qkv[:, 2 * C:]
        if qk_norm:
            q = _rms(q, qnw[l], eps)
            k = _rms(k, knw[l], eps)
        attn = _attention((q * qscale).to(bf), k.to(bf), v.to(bf), B, S,
                          num_heads)
        o = dot(attn, projw[l], projs[l]) + projb[l].float()
        x = (x.float() + o.to(bf).float() * ls1[l].float()).to(bf)
        h2 = _ln(x, ln2w[l], ln2b[l], eps)
        m = torch.nn.functional.gelu(dot(h2, fc1w[l], fc1s[l])
                                     + fc1b[l].float())
        m2 = fc2b[l].float()
        for g in range(G):  # fc2b + group 0, then + group 1 (w8a8 at B > 1)
            ch = slice(g * half, (g + 1) * half)
            m2 = m2 + dot(m[:, ch], k_rows(fc2w[l], ch), fc2s[l])
        x = (x.float() + m2.to(bf).float() * ls2[l].float()).to(bf)
    x = x.reshape(B, S, C)
    return x[0] if squeeze else x


_SIGNATURES = {  # C name -> (pointer args, the types after them)
    "vit_stack_forward": (26, (ctypes.c_int,) * 6 + (
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)),
    "vit_stack_forward_w8a8": (33, (ctypes.c_int,) * 6 + (
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_longlong,
        ctypes.c_void_p)),
}
_fns = {}


def attention_norms(qs, ks, B, S, heads):
    """The shift's inputs for `attention`, in fp32 from the bf16 values:
    ||q_h||^2 [B*S, heads] and the bits of max_r ||k_h||^2 [B, heads]."""
    q, k = (t.view(B, S, heads, 64).float() for t in (qs, ks))
    return ((q * q).sum(-1).reshape(B * S, heads).contiguous(),
            (k * k).sum(-1).amax(1).contiguous().view(torch.int32))


def attention(qs, ks, vs, B, S, heads, norms=None):
    """The stack's attention kernel alone on the card (timing and tests):
    qs/ks/vs bf16 [B*S, heads * 64], q pre-scaled into the log2 domain ->
    bf16 [B*S, heads * 64], as `_attention` computes it; `norms` from
    `attention_norms` (taken here when not given)."""
    fn = _fns.get("attention")
    if fn is None:
        fn = _fns["attention"] = _build.bind(
            "vit_attention_forward", 6, (ctypes.c_int,) * 3 + (
                ctypes.c_void_p,))
    qn, kmax = norms or attention_norms(qs, ks, B, S, heads)
    out = torch.empty_like(qs)
    code = fn(*[t.data_ptr() for t in (qs, ks, vs, qn, kmax, out)], B, S,
              heads, torch.cuda.current_stream(qs.device).cuda_stream)
    _build.check(code, "vit_attention_forward")
    return out


def _kernel(name):
    if name not in _fns:
        _fns[name] = _build.bind(name, *_SIGNATURES[name])
    return _fns[name]


def _check_args(x, vecs, mats, scales, num_heads):
    """-> (B, S, C, L, inter); raises on what the CUDA stack does not take."""
    if x.dtype != torch.bfloat16 or x.dim() not in (2, 3):
        raise TypeError("fused_vit_stack: x must be bf16 [B, S, C] or [S, C]")
    if mats[2].dim() != 3:
        raise TypeError("fused_vit_stack: weights must be stacked [L, K, N]"
                        " (bf16) or [L, N, K] (act_quant)")
    B, S, C = x.shape if x.dim() == 3 else (1, *x.shape)
    L = mats[2].shape[0]
    inter = mats[2].shape[2 if scales is None else 1]
    dev = x.device
    if C % num_heads or C // num_heads != 64:
        raise ValueError("fused_vit_stack CUDA kernel needs head_dim 64")
    # 16-byte rows: bf16 TMA strides (8), int8 TMA strides (16; inter in
    # two fc2 halves of 16)
    c_mult, i_mult = (8, 8) if scales is None else (16, 32)
    if C % c_mult or inter % i_mult:
        raise ValueError(f"fused_vit_stack CUDA kernel needs C % {c_mult} "
                         f"== 0 and inter % {i_mult} == 0")
    widths = (C,) * 8 + (3 * C, C, inter, C)
    fp32_vecs = tuple(zip(vecs, widths))
    if scales is not None:
        fp32_vecs += tuple(zip(scales, (3 * C, C, inter, C)))
    for t, n in fp32_vecs:
        if (t is None or t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != (L, n)):
            raise TypeError("fused_vit_stack: vectors and scales must be "
                            f"contiguous fp32 [L, n] on {dev}")
    wdt = torch.bfloat16 if scales is None else torch.int8
    kn = ((C, 3 * C), (C, C), (C, inter), (inter, C))
    if scales is not None:  # K-major
        kn = tuple((n, k) for k, n in kn)
    for t, shape in zip(mats, tuple((L, *d) for d in kn)):
        if (t.device != dev or t.dtype != wdt or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise TypeError(f"fused_vit_stack: weight must be contiguous "
                            f"{wdt} {shape} on {dev}")
    return B, S, C, L, inter


def _norm_scratch(B, S, C, dev):
    """The attention's shift inputs: ||q_h||^2 fp32 [B*S, heads] and max_r
    ||k_h||^2 [B, heads] (the float's bits, int32)."""
    heads = C // 64
    return [torch.empty((B * S, heads), dtype=torch.float32, device=dev),
            torch.empty((B, heads), dtype=torch.int32, device=dev)]


def w8a8_scratch(B, S, C, inter, dev):
    """The act_quant stack's scratch, in the C function's order: int8
    activations and their row amax (two groups at B > 1), qkv fp32, q / k /
    v / attention bf16, the fp32 GELU output fc2 quantizes, fc2's fp32
    partial sum over the first half (B > 1), the GEMM's int32 partials (its
    K splits) and the attention's shift inputs -> (tensors, int32 elements
    of the GEMM's partials)."""
    M, f32 = B * S, torch.float32
    e = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device=dev)
    fn = _build.library().vit_w8a8_workspace
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    n_ws = int(fn(B, S, C, inter))
    return [e(M, max(C, inter), dt=torch.int8), e(M, 2, dt=f32),
            e(M, 3 * C, dt=f32), e(M, C), e(M, C), e(M, C), e(M, C),
            e(M, inter, dt=f32), e(M if B > 1 else 1, C, dt=f32),
            e(max(n_ws, 1), dt=torch.int32), *_norm_scratch(B, S, C, dev)], \
        n_ws


def _launch(x, vecs, mats, scales, num_heads, eps, qk_norm):
    """scales None: the bf16 stack; else the act_quant stack."""
    global launch_count, act_quant_launch_count
    B, S, C, L, inter = _check_args(x, vecs, mats, scales, num_heads)
    name = "vit_stack_forward" if scales is None else "vit_stack_forward_w8a8"
    fn = _kernel(name)  # a failed build raises here
    dev = x.device
    M = B * S
    out = x.reshape(M, C).contiguous().clone()
    tail = (B, S, C, inter, num_heads, L, eps, int(qk_norm),
            (C // num_heads) ** -0.5 * LOG2E)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if scales is None:
        e = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device=dev)
        ptrs = [out, *vecs, *mats, e(M, C), e(M, 3 * C, dt=torch.float32),
                e(M, C), e(M, C), e(M, C), e(M, C), e(M, inter),
                *_norm_scratch(B, S, C, dev)]
        tail = (*tail, stream)
    else:
        scratch, n_ws = w8a8_scratch(B, S, C, inter, dev)
        ptrs = [out, *vecs, *scales, *mats, *scratch]
        tail = (*tail, n_ws, stream)
    code = fn(*[t.data_ptr() for t in ptrs], *tail)
    _build.check(code, name)
    if scales is None:
        launch_count += 1
    else:
        act_quant_launch_count += 1
    out = out.reshape(B, S, C)
    return out if x.dim() == 3 else out[0]


@torch.no_grad()  # an inference stack: no backward
def fused_vit_stack(x, ln1w, ln1b, ln2w, ln2b, ls1, ls2, qnw, knw,
                    qkvb, projb, fc1b, fc2b, qkvw, projw, fc1w, fc2w,
                    qkvs=None, projs=None, fc1s=None, fc2s=None,
                    num_heads: int = 16, eps: float = 1e-6,
                    qk_norm: bool = False, act_quant: bool = False):
    """-> x_out (same leading shape as x) after the full L-layer stack.
    x [B, S, C] or [S, C] bf16; vectors fp32 [L, n]; weights bf16 [L, K, N],
    or int8 K-major [L, N, K] with fp32 scales [L, N] when act_quant."""
    vecs = (ln1w, ln1b, ln2w, ln2b, ls1, ls2, qnw, knw, qkvb, projb, fc1b,
            fc2b)
    mats = (qkvw, projw, fc1w, fc2w)
    scales = (qkvs, projs, fc1s, fc2s) if act_quant else None
    _build.route(x, "fused_vit_stack", *[t for t in (vecs + mats)
                                   if t is not None])
    if x.device.type == "cpu":
        return fused_vit_stack_plain(x, *vecs, *mats, *(scales or ()),
                                     num_heads=num_heads, eps=eps,
                                     qk_norm=qk_norm, act_quant=act_quant)
    if x.device.type == "cuda":
        return _launch(x, vecs, mats, scales, num_heads, eps, qk_norm)
    raise RuntimeError(f"fused_vit_stack: no route for device {x.device}")


def supports_fused_vit(vision_cfg) -> bool:
    """LayerNorm blocks with a biased fused QKV (the 300M/6B-448 layouts)."""
    return (getattr(vision_cfg, "norm_type", "layer_norm") == "layer_norm"
            and getattr(vision_cfg, "qkv_bias", True))


def pack_vit_stack(vision_model, dtype=torch.bfloat16) -> dict:
    """models.internvit.InternVisionModel -> the stack's keyword arguments.
    Per-layer weights are already stacked [L, ...]. An encoder whose four
    kernels are all int8 packs its int8 weights K-major [L, N, K] (the
    Dense's `kernel_kmajor()`, one copy per model) with fp32 scales [L, N]
    and act_quant=True (the w8a8 stack); a partly quantized one is
    dequantized to `dtype` [L, K, N], as the JAX packer does."""
    refuse_cut(vision_model, "pack_vit_stack")
    if not supports_fused_vit(vision_model.cfg):
        raise NotImplementedError(
            "fused_vit_stack takes LayerNorm blocks with a biased QKV")
    enc = vision_model.encoder
    att = enc.attn
    L, hidden = enc.norm1.weight.shape
    f32 = lambda t: t.detach().float().contiguous()
    ones = torch.ones((L, hidden), dtype=torch.float32,
                      device=enc.norm1.weight.device)
    out = dict(
        ln1w=f32(enc.norm1.weight), ln1b=f32(enc.norm1.bias),
        ln2w=f32(enc.norm2.weight), ln2b=f32(enc.norm2.bias),
        ls1=f32(enc.ls1), ls2=f32(enc.ls2),
        qnw=f32(att.q_norm.weight) if hasattr(att, "q_norm") else ones,
        knw=f32(att.k_norm.weight) if hasattr(att, "k_norm") else ones,
        qkvb=f32(att.qkv.bias), projb=f32(att.proj.bias),
        fc1b=f32(enc.mlp.fc1.bias), fc2b=f32(enc.mlp.fc2.bias),
    )
    sites = (("qkvw", "qkvs", att.qkv), ("projw", "projs", att.proj),
             ("fc1w", "fc1s", enc.mlp.fc1), ("fc2w", "fc2s", enc.mlp.fc2))
    if all("kernel_q" in d._buffers for _, _, d in sites):
        for wk, sk, dense in sites:  # scales [L, 1, N] -> [L, N]
            out[wk] = dense.kernel_kmajor()
            out[sk] = dense.kernel_scale[:, 0].float().contiguous()
        out["act_quant"] = True
        return out
    for wk, _, dense in sites:
        if "kernel_q" in dense._buffers:
            w = dense.kernel_q.float() * dense.kernel_scale.float()
        else:
            w = dense.kernel.detach()
        out[wk] = w.to(dtype).contiguous()
    return out
