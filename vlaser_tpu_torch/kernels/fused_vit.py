"""InternViT encoder stack: the port of vlaser_tpu/kernels/fused_vit.py.

`fused_vit_stack` runs the whole L-layer encoder (select_layer=-1). On a
CUDA tensor it launches the Hopper kernels of `csrc/fused_vit.cu` (built on
first use); on a CPU tensor it runs `fused_vit_stack_plain`, the eager twin
with the same rounding points. There is no other route: a tensor on any
other device raises, and a failed build or launch raises.

Rounding points (both versions, as the TPU kernel): LayerNorm in fp32 ->
bf16; QKV in fp32 with bias; optional full-hidden QK-RMSNorm in fp32; q is
scaled by head_dim^-0.5*log2(e) and q/k/v are rounded to bf16; softmax in
exp2 with one shift per row (the row max), exponent rounded to bf16 for the
P.V product and the denominator; attention out bf16; proj/fc2 outputs are
rounded to bf16 before `x + out * ls` (fp32) -> bf16; fc1 -> exact-erf GELU
-> bf16. The TPU kernel's Cauchy-Schwarz shift and polynomial erf are
replaced by the row max and erf (same function, within bf16 rounding).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LOG2E = 1.4426950408889634
launch_count = 0  # kernel launches through the CUDA route


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


def _attention(qs, ks, vs, B, S, heads):
    """qs/ks/vs bf16 [B*S, C], q pre-scaled into the log2 domain."""
    C = qs.shape[-1]
    D = C // heads
    q = qs.view(B, S, heads, D).float()
    k = ks.view(B, S, heads, D).float()
    v = vs.view(B, S, heads, D).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    e = torch.exp2(s - s.amax(-1, keepdim=True)).to(torch.bfloat16).float()
    d = e.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", e, v) * (1.0 / d)
    return o.permute(0, 2, 1, 3).reshape(B * S, C).to(torch.bfloat16)


@torch.no_grad()  # an inference stack: no backward
def fused_vit_stack_plain(x, ln1w, ln1b, ln2w, ln2b, ls1, ls2, qnw, knw,
                          qkvb, projb, fc1b, fc2b, qkvw, projw, fc1w, fc2w,
                          num_heads: int = 16, eps: float = 1e-6,
                          qk_norm: bool = False):
    """Eager twin of the CUDA stack: x [B, S, C] or [S, C] bf16 -> same."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    B, S, C = x.shape
    L = qkvw.shape[0]
    qscale = (C // num_heads) ** -0.5 * LOG2E
    bf = torch.bfloat16
    x = x.reshape(B * S, C).to(bf)
    for l in range(L):
        h = _ln(x, ln1w[l], ln1b[l], eps).to(bf)
        qkv = _mm(h, qkvw[l]) + qkvb[l].float()
        q, k, v = qkv[:, :C], qkv[:, C:2 * C], qkv[:, 2 * C:]
        if qk_norm:
            q = _rms(q, qnw[l], eps)
            k = _rms(k, knw[l], eps)
        attn = _attention((q * qscale).to(bf), k.to(bf), v.to(bf), B, S,
                          num_heads)
        o = _mm(attn, projw[l]) + projb[l].float()
        x = (x.float() + o.to(bf).float() * ls1[l].float()).to(bf)
        h2 = _ln(x, ln2w[l], ln2b[l], eps).to(bf)
        m = torch.nn.functional.gelu(_mm(h2, fc1w[l]) + fc1b[l].float())
        m2 = _mm(m.to(bf), fc2w[l]) + fc2b[l].float()
        x = (x.float() + m2.to(bf).float() * ls2[l].float()).to(bf)
    x = x.reshape(B, S, C)
    return x[0] if squeeze else x


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.bind(
            "vit_stack_forward", 24,
            (ctypes.c_int,) * 6 + (ctypes.c_float, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_void_p),
        )
    return _fn


def _launch(x, vecs, mats, num_heads, eps, qk_norm):
    global launch_count
    if x.dtype != torch.bfloat16 or x.dim() not in (2, 3):
        raise TypeError("fused_vit_stack: x must be bf16 [B, S, C] or [S, C]")
    if mats[2].dim() != 3:
        raise TypeError("fused_vit_stack: weights must be stacked [L, K, N]")
    squeeze = x.dim() == 2
    x3 = x[None] if squeeze else x
    B, S, C = x3.shape
    L, _, inter = mats[2].shape
    dev = x.device
    if C % num_heads or C // num_heads != 64:
        raise ValueError("fused_vit_stack CUDA kernel needs head_dim 64")
    if C % 8 or inter % 8:
        raise ValueError("fused_vit_stack CUDA kernel needs C, inter % 8 == 0")
    widths = (C,) * 8 + (3 * C, C, inter, C)
    for t, n in zip(vecs, widths):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != (L, n)):
            raise TypeError("fused_vit_stack: vectors must be contiguous fp32 "
                            f"[L, n] on {dev}")
    for t, shape in zip(mats, ((L, C, 3 * C), (L, C, C), (L, C, inter),
                               (L, inter, C))):
        if (t.device != dev or t.dtype != torch.bfloat16
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise TypeError(f"fused_vit_stack: weight must be contiguous bf16 "
                            f"{shape} on {dev}")
    M = B * S
    out = x3.reshape(M, C).contiguous().clone()
    e = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device=dev)
    h, qkv = e(M, C), e(M, 3 * C, dt=torch.float32)
    qb, kb, vb, attn, mid = e(M, C), e(M, C), e(M, C), e(M, C), e(M, inter)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [out, *vecs, *mats, h, qkv, qb, kb, vb, attn, mid]
    code = _kernel()(*[t.data_ptr() for t in ptrs], B, S, C, inter, num_heads,
                     L, eps, int(qk_norm), (C // num_heads) ** -0.5 * LOG2E,
                     stream)
    _build.check(code, "vit_stack_forward")
    launch_count += 1
    out = out.reshape(B, S, C)
    return out[0] if squeeze else out


@torch.no_grad()  # an inference stack: no backward
def fused_vit_stack(x, ln1w, ln1b, ln2w, ln2b, ls1, ls2, qnw, knw,
                    qkvb, projb, fc1b, fc2b, qkvw, projw, fc1w, fc2w,
                    qkvs=None, projs=None, fc1s=None, fc2s=None,
                    num_heads: int = 16, eps: float = 1e-6,
                    qk_norm: bool = False, act_quant: bool = False):
    """-> x_out (same leading shape as x) after the full L-layer stack.
    x [B, S, C] or [S, C] bf16; vectors fp32 [L, n]; weights bf16 [L, K, N]."""
    if act_quant:
        raise NotImplementedError("the w8a8 (act_quant) mode is not ported yet")
    vecs = (ln1w, ln1b, ln2w, ln2b, ls1, ls2, qnw, knw, qkvb, projb, fc1b,
            fc2b)
    mats = (qkvw, projw, fc1w, fc2w)
    if x.device.type == "cpu":
        return fused_vit_stack_plain(x, *vecs, *mats, num_heads=num_heads,
                                     eps=eps, qk_norm=qk_norm)
    if x.device.type == "cuda":
        return _launch(x, vecs, mats, num_heads, eps, qk_norm)
    raise RuntimeError(f"fused_vit_stack: no route for device {x.device}")


def supports_fused_vit(vision_cfg) -> bool:
    """LayerNorm blocks with a biased fused QKV (the 300M/6B-448 layouts)."""
    return (getattr(vision_cfg, "norm_type", "layer_norm") == "layer_norm"
            and getattr(vision_cfg, "qkv_bias", True))


def pack_vit_stack(vision_model, dtype=torch.bfloat16) -> dict:
    """models.internvit.InternVisionModel -> the stack's keyword arguments.
    Per-layer weights are already stacked [L, ...]. An encoder whose four
    kernels are all int8 would need the w8a8 mode (not ported); a partly
    quantized one is dequantized to `dtype`, as the JAX packer does."""
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
    sites = (("qkvw", att.qkv), ("projw", att.proj),
             ("fc1w", enc.mlp.fc1), ("fc2w", enc.mlp.fc2))
    quant = ["kernel_q" in d._buffers for _, d in sites]
    if all(quant):
        raise NotImplementedError(
            "int8 encoder kernels need the w8a8 fused ViT, not ported yet")
    for name, dense in sites:
        if "kernel_q" in dense._buffers:
            w = dense.kernel_q.float() * dense.kernel_scale.float()
        else:
            w = dense.kernel.detach()
        out[name] = w.to(dtype).contiguous()
    return out
