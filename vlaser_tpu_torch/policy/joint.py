"""Joint mixture transformer (port of vlaser_tpu/policy/joint.py): the VLM
mixture and the action expert attend in one shared attention per layer.

Both mixtures hold their layer weights stacked [L, ...] under
`layers.vlm` / `layers.expert` (the JAX scan layout); the expert stack is
what `policy.fused_infer.pack_expert_stack` hands to the fused kernel.
Modes: `train`, `vlm_prefix`, `prefix`, `suffix`, `vlm_only` (a causal
pass of the VLM mixture under segment masks: `forward_vlm`) and
`vlm_cached` (the same over fixed [L, B, total, KVH, D] K/V buffers,
written in place at a scalar offset: `infer_text`), for Qwen2, Qwen3 and
Gemma mixtures (Qwen3, the InternVL3.5 backbone: a per-head q/k RMSNorm
before rope; the PaliGemma VLA: tanh-GELU MLPs, plus-one RMSNorms in the
layers, the VLM's attention softcap on every mode; the final per-mixture
norms are plain RMSNorms, as in JAX). `adaptive_mode` ("adaln" |
"adaln_zero") gives the expert time-conditioned norms (and, for
adaln_zero, sigmoid-gated residual scales) on the rows a condition reaches:
the action rows (level 2) of `train` and every row of `suffix`; the tied
proprio row and the whole `prefix` pass keep the plain norms.
Attention applies the VLA block mask (equal nonzero segments, kv_level <=
q_level) through `kernels.flash_attention.attention_fn(impl=attn_impl)`,
routed once per call: with "auto" the flash kernel takes a CUDA tensor
exactly where the JAX dispatch takes Pallas (the batch-32 train pass), and
the eager reference takes the serving sizes. `remat=True` checkpoints each
layer of mode `train` (the JAX `nn.remat`, train mode only).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..kernels.flash_attention import attention_fn
from ..inference.kv_cache import write_kv
from ..models.layers import (AdaptiveLayerscale, AdaptiveRMSNorm, Dense,
                             RMSNorm, gated_mlp, gelu_tanh, w8a8_group)

_ACT = {"silu": F.silu, "gelu_tanh": gelu_tanh}


class MixtureMLP(nn.Module):
    def __init__(self, cfg, L, pd, cd, device):
        super().__init__()
        C, I = cfg.hidden_size, cfg.intermediate_size
        self.act = _ACT[cfg.mlp_act]
        self.gate_proj = Dense(C, I, False, (L,), pd, cd, device)
        self.up_proj = Dense(C, I, False, (L,), pd, cd, device)
        self.down_proj = Dense(I, C, False, (L,), pd, cd, device)

    def forward(self, x, l):
        return gated_mlp(x, self.gate_proj, self.up_proj, self.down_proj,
                         self.act, l)


class MixtureBlock(nn.Module):
    """One mixture's stacked per-layer weights (Qwen2 layer layout), with
    the adaLN norms and adaLN-Zero gates of `adaptive_mode` over a
    `cond_dim`-wide condition."""

    def __init__(self, cfg, L, pd=torch.float32, cd=torch.bfloat16,
                 device=None, adaptive_mode: str = "", cond_dim: int = 256):
        super().__init__()
        if cfg.mlp_act not in _ACT:
            raise NotImplementedError(
                f"mixture MLP activation {cfg.mlp_act!r} is not ported")
        if adaptive_mode not in ("", "adaln", "adaln_zero"):
            raise ValueError(f"unknown adaptive_mode {adaptive_mode!r}")
        self.cfg, self.adaptive_mode = cfg, adaptive_mode
        C, eps, one = cfg.hidden_size, cfg.rms_norm_eps, cfg.rms_plus_one
        self.input_layernorm = RMSNorm(C, eps, (L,), pd, device, one)
        self.post_attention_layernorm = RMSNorm(C, eps, (L,), pd, device, one)
        if adaptive_mode:
            ada = lambda: AdaptiveRMSNorm(C, eps, cond_dim, (L,), pd, cd,
                                          device)
            self.ada_input_norm, self.ada_post_norm = ada(), ada()
        if adaptive_mode == "adaln_zero":
            gate = lambda: AdaptiveLayerscale(cond_dim, C, (L,), pd, cd,
                                              device)
            self.post_adaptive_scale = gate()
            self.final_adaptive_scale = gate()
        bias = cfg.attention_bias
        # the heads this rank computes (core/tensor_parallel may cut them)
        self.heads, self.kv_heads = cfg.num_heads, cfg.num_kv_heads
        self.head_dim = cfg.head_dim
        self.q_proj = Dense(C, cfg.q_dim, bias, (L,), pd, cd, device)
        self.k_proj = Dense(C, cfg.kv_dim, bias, (L,), pd, cd, device)
        self.v_proj = Dense(C, cfg.kv_dim, bias, (L,), pd, cd, device)
        self.o_proj = Dense(cfg.q_dim, C, False, (L,), pd, cd, device)
        if cfg.qk_norm:  # Qwen3: per-head RMSNorm over head_dim before rope
            self.q_norm = RMSNorm(cfg.head_dim, eps, (L,), pd, device)
            self.k_norm = RMSNorm(cfg.head_dim, eps, (L,), pd, device)
        self.mlp = MixtureMLP(cfg, L, pd, cd, device)

    def _norm(self, plain, ada, x, l, cond, blend):
        """plain(x), or the adaLN norm where `cond` reaches: every row when
        `blend` is None, else the rows it marks."""
        if not self.adaptive_mode or cond is None:
            return plain(x, l)
        a = ada(x, cond, l)
        return a if blend is None else torch.where(blend, a, plain(x, l))

    def _scale(self, gate, x, l, cond, blend):
        """The adaLN-Zero gate on a residual branch, where `cond` reaches."""
        if self.adaptive_mode != "adaln_zero" or cond is None:
            return x
        s = gate(x, cond, l)
        return s if blend is None else torch.where(blend, s, x)

    def qkv(self, x, cos, sin, l, cond=None, blend=None):
        cfg = self.cfg
        b, s, _ = x.shape
        h = self._norm(self.input_layernorm, getattr(self, "ada_input_norm",
                                                     None), x, l, cond, blend)
        q, k, v = w8a8_group(h, (self.q_proj, self.k_proj, self.v_proj), l)
        q = q.reshape(b, s, self.heads, cfg.head_dim)
        k = k.reshape(b, s, self.kv_heads, cfg.head_dim)
        v = v.reshape(b, s, self.kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q, k = self.q_norm(q, l), self.k_norm(k, l)
        return ops.apply_rope(q, cos, sin), ops.apply_rope(k, cos, sin), v

    def post_attn(self, x, attn_out, l, cond=None, blend=None):
        b, s = attn_out.shape[:2]
        o = self.o_proj(attn_out.reshape(b, s, -1), l)
        x = x + self._scale(getattr(self, "post_adaptive_scale", None), o, l,
                            cond, blend)
        m = self.mlp(self._norm(self.post_attention_layernorm,
                                getattr(self, "ada_post_norm", None), x, l,
                                cond, blend), l)
        return x + self._scale(getattr(self, "final_adaptive_scale", None),
                               m, l, cond, blend)


class _Layers(nn.Module):
    def __init__(self, vlm_cfg, expert_cfg, pd, cd, device,
                 adaptive_mode="", cond_dim=256):
        super().__init__()
        L = vlm_cfg.num_layers
        self.vlm = MixtureBlock(vlm_cfg, L, pd, cd, device)
        self.expert = MixtureBlock(expert_cfg, L, pd, cd, device,
                                   adaptive_mode, cond_dim)


class JointModel(nn.Module):
    """Stacked joint layers + final per-mixture norms."""

    def __init__(self, vlm_cfg, expert_cfg, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 adaptive_mode: str = "", remat: bool = False,
                 attn_impl: str = "auto", time_hidden_size: int = 256):
        super().__init__()
        self.vlm_cfg, self.expert_cfg = vlm_cfg, expert_cfg
        self.remat, self.attn_impl = remat, attn_impl
        self.layers = _Layers(vlm_cfg, expert_cfg, param_dtype,
                              compute_dtype, device, adaptive_mode,
                              time_hidden_size)
        self.vlm_norm = RMSNorm(vlm_cfg.hidden_size, vlm_cfg.rms_norm_eps,
                                (), param_dtype, device)
        self.expert_norm = RMSNorm(expert_cfg.hidden_size,
                                   expert_cfg.rms_norm_eps, (), param_dtype,
                                   device)

    def _attend(self, seg_q, seg_kv, lev_q=None, lev_kv=None,
                causal=False, q_offset=0):
        """-> fn(q, k, v) with the VLA block mask (causal from q_offset when
        asked): route and mask picked once per call, not per layer."""
        b, sq, skv = seg_q.shape[0], seg_q.shape[1], seg_kv.shape[1]
        return attention_fn(
            b, sq, skv, self.layers.vlm.heads, seg_q.device,
            q_segment_ids=seg_q, kv_segment_ids=seg_kv, q_levels=lev_q,
            kv_levels=lev_kv, q_offset=q_offset, causal=causal,
            impl=self.attn_impl, softcap=self.vlm_cfg.attn_softcap)

    def forward(self, mode: str, *args):
        vlm, expert = self.layers.vlm, self.layers.expert
        L = self.vlm_cfg.num_layers
        if mode == "train":
            # vlm + [proprio | action] streams under the full block mask,
            # an optional adaLN condition [B, T] last;
            # -> (vlm_norm(x_vlm), expert_norm(x_pa))
            x_vlm, x_pa, cos_v, sin_v, cos_pa, sin_pa, seg, lev, *rest = args
            cond = rest[0] if rest else None
            sv = x_vlm.shape[1]
            attend = self._attend(seg, seg, lev, lev)
            # adaLN reaches the action rows only (level 2)
            blend = None if cond is None else (lev[:, sv:] == 2)[:, :, None]

            def layer(l, x_vlm, x_pa):
                qv, kv, vv = vlm.qkv(x_vlm, cos_v, sin_v, l)
                qp, kp, vp = expert.qkv(x_pa, cos_pa, sin_pa, l, cond, blend)
                out = attend(torch.cat([qv, qp], dim=1),
                             torch.cat([kv, kp], dim=1),
                             torch.cat([vv, vp], dim=1))
                return (vlm.post_attn(x_vlm, out[:, :sv], l),
                        expert.post_attn(x_pa, out[:, sv:], l, cond, blend))

            remat = self.remat and torch.is_grad_enabled()
            for l in range(L):
                if remat:
                    x_vlm, x_pa = checkpoint(layer, l, x_vlm, x_pa,
                                             use_reentrant=False)
                else:
                    x_vlm, x_pa = layer(l, x_vlm, x_pa)
            return self.vlm_norm(x_vlm), self.expert_norm(x_pa)
        if mode == "vlm_prefix":
            # vlm mixture alone: level-0 tokens never attend proprio, so this
            # equals the vlm rows of mode 'prefix'. -> rope'd K/V stacks.
            x, cos_v, sin_v, seg = args
            attend = self._attend(seg, seg)
            ks, vs = [], []
            for l in range(L):
                q, k, v = vlm.qkv(x, cos_v, sin_v, l)
                x = vlm.post_attn(x, attend(q, k, v), l)
                ks.append(k)
                vs.append(v)
            return torch.stack(ks), torch.stack(vs)
        if mode == "prefix":
            x_vlm, x_p, cos_v, sin_v, cos_p, sin_p, seg, lev = args
            sv = x_vlm.shape[1]
            attend = self._attend(seg, seg, lev, lev)
            ks, vs = [], []
            for l in range(L):
                qv, kv, vv = vlm.qkv(x_vlm, cos_v, sin_v, l)
                qp, kp, vp = expert.qkv(x_p, cos_p, sin_p, l)
                q = torch.cat([qv, qp], dim=1)
                k = torch.cat([kv, kp], dim=1)
                v = torch.cat([vv, vp], dim=1)
                out = attend(q, k, v)
                x_vlm = vlm.post_attn(x_vlm, out[:, :sv], l)
                x_p = expert.post_attn(x_p, out[:, sv:], l)
                ks.append(k)
                vs.append(v)
            return torch.stack(ks), torch.stack(vs)
        if mode == "suffix":
            (x, cos_a, sin_a, seg_q, seg_kv, lev_q, lev_kv, k_pre, v_pre,
             *rest) = args
            cond = rest[0] if rest else None  # reaches every action row
            attend = self._attend(seg_q, seg_kv, lev_q, lev_kv)
            for l in range(L):
                qa, ka, va = expert.qkv(x, cos_a, sin_a, l, cond)
                k = torch.cat([k_pre[l].to(ka.dtype), ka], dim=1)
                v = torch.cat([v_pre[l].to(va.dtype), va], dim=1)
                x = expert.post_attn(x, attend(qa, k, v), l, cond)
            return self.expert_norm(x)
        if mode == "vlm_only":
            # the vlm mixture alone, causal under segment masks (the text
            # head's forward) -> vlm_norm(x)
            x, cos_v, sin_v, seg = args
            attend = self._attend(seg, seg, causal=True)
            for l in range(L):
                q, k, v = vlm.qkv(x, cos_v, sin_v, l)
                x = vlm.post_attn(x, attend(q, k, v), l)
            return self.vlm_norm(x)
        if mode == "vlm_cached":
            # the causal vlm pass over K/V buffers [L, B, total, KVH, D]: each
            # layer writes its rope'd K/V at `offset` (in place), then its
            # queries (at offset ..) attend the buffer under kv_seg
            # -> (vlm_norm(x), k_bufs, v_bufs)
            x, cos_v, sin_v, seg_q, kv_seg, offset, k_bufs, v_bufs = args
            attend = self._attend(seg_q, kv_seg, causal=True,
                                  q_offset=int(offset))
            for l in range(L):
                q, k, v = vlm.qkv(x, cos_v, sin_v, l)
                write_kv(k_bufs[l], k, int(offset))
                write_kv(v_bufs[l], v, int(offset))
                out = attend(q, k_bufs[l].to(q.dtype), v_bufs[l].to(q.dtype))
                x = vlm.post_attn(x, out, l)
            return self.vlm_norm(x), k_bufs, v_bufs
        raise ValueError(mode)
