"""Eager PyTorch twins of vlaser_tpu/kernels/ops.py: norms, rotary,
pixel-shuffle, masks and the reference attention.

Each follows the JAX function's numerics (fp32 statistics inside bf16
flows, the same rounding points) so the CPU tests can hold the two packages
to fp32 tolerances. `bicubic_resize_2d` is not ported yet: the 448px serving
tile never interpolates its position embedding.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm with fp32 statistics; plus_one scales by (1 + weight)."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = weight + 1.0 if plus_one else weight
    return (w * xf.to(dtype)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * weight + bias).to(dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables: positions [..., S] -> [..., S, head_dim]."""
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32,
                       device=positions.device)
    inv_freq = 1.0 / (theta ** (idx / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D] (or [S, D]). Rotate-half."""
    dtype = x.dtype
    xf = x.float()
    if cos.dim() == x.dim() - 1:
        cos = cos[..., :, None, :]
        sin = sin[..., :, None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(dtype)


def pixel_shuffle(x: torch.Tensor, scale_factor: float = 0.5,
                  version: str = "v2") -> torch.Tensor:
    """[N, W, H, C] -> [N, H*s, W*s, C/s^2] with InternVL's permute order."""
    n, w, h, c = x.shape
    x = x.reshape(n, w, int(h * scale_factor), int(c / scale_factor))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(n, int(h * scale_factor), int(w * scale_factor),
                  int(c / (scale_factor ** 2)))
    if version == "v2":
        x = x.permute(0, 2, 1, 3)
    return x


def make_attention_mask(
    *,
    batch: int,
    q_len: int,
    kv_len: int,
    causal: bool = False,
    q_offset: int = 0,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_levels: Optional[torch.Tensor] = None,
    kv_levels: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    device=None,
) -> Optional[torch.Tensor]:
    """Boolean [B, Sq, Skv] mask (True = attend): causal/window on global
    positions (q_offset an int or a [B] tensor of per-row offsets), equal
    nonzero segment ids, kv_level <= q_level, kv_valid."""
    allowed = None

    def _and(a, b):
        return b if a is None else a & b

    if causal or window is not None:
        qidx = torch.arange(q_len, device=device)
        if torch.is_tensor(q_offset) and q_offset.dim() == 1:
            # per-row offsets: [B, Sq, 1] global q positions
            qpos = q_offset.to(device)[:, None, None] + qidx[None, :, None]
        else:
            qpos = (q_offset + qidx[:, None])[None]
        kpos = torch.arange(kv_len, device=device)[None, None, :]
        if causal:
            allowed = _and(allowed, qpos >= kpos)
        if window is not None:
            allowed = _and(allowed, qpos - kpos <= window)
    if q_segment_ids is not None or kv_segment_ids is not None:
        assert q_segment_ids is not None and kv_segment_ids is not None
        same = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        allowed = _and(allowed, same & (kv_segment_ids != 0)[:, None, :])
    if q_levels is not None or kv_levels is not None:
        assert q_levels is not None and kv_levels is not None
        allowed = _and(allowed, kv_levels[:, None, :] <= q_levels[:, :, None])
    if kv_valid is not None:
        allowed = _and(allowed, kv_valid[:, None, :])
    if allowed is not None and allowed.shape[0] == 1 and batch > 1:
        allowed = allowed.expand(batch, q_len, kv_len)
    return allowed


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Skv, KVH, D] (GQA), mask [B, Sq, Skv] bool.
    fp32 softmax regardless of the input dtype."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    assert h % kvh == 0
    groups = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = (q.float() * scale).reshape(b, sq, kvh, groups, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits,
                             torch.full((), NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
