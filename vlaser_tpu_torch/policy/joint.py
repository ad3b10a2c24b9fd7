"""Joint mixture transformer (port of vlaser_tpu/policy/joint.py): the VLM
mixture and the action expert attend in one shared attention per layer.

Both mixtures hold their layer weights stacked [L, ...] under
`layers.vlm` / `layers.expert` (the JAX scan layout); the expert stack is
what `policy.fused_infer.pack_expert_stack` hands to the fused kernel.
Modes ported: `vlm_prefix`, `prefix`, `suffix`, for Qwen2 mixtures. The
other modes (`train`, `vlm_only`, `vlm_cached`), adaLN, and the Qwen3
(qk-norm) and Gemma mixtures are not ported yet.
Attention here is the eager reference with the VLA block mask (equal
nonzero segments, kv_level <= q_level), as the JAX package dispatches it at
these sizes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..models.layers import Dense, RMSNorm


class MixtureMLP(nn.Module):
    def __init__(self, cfg, L, pd, cd, device):
        super().__init__()
        C, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Dense(C, I, False, (L,), pd, cd, device)
        self.up_proj = Dense(C, I, False, (L,), pd, cd, device)
        self.down_proj = Dense(I, C, False, (L,), pd, cd, device)

    def forward(self, x, l):
        return self.down_proj(F.silu(self.gate_proj(x, l))
                              * self.up_proj(x, l), l)


class MixtureBlock(nn.Module):
    """One mixture's stacked per-layer weights (Qwen2 layer layout)."""

    def __init__(self, cfg, L, pd=torch.float32, cd=torch.bfloat16,
                 device=None):
        super().__init__()
        if cfg.qk_norm or cfg.mlp_act != "silu" or cfg.rms_plus_one:
            raise NotImplementedError(
                "Qwen3 qk-norm and Gemma mixtures are not ported yet")
        self.cfg = cfg
        C, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(C, eps, (L,), pd, device)
        self.post_attention_layernorm = RMSNorm(C, eps, (L,), pd, device)
        bias = cfg.attention_bias
        self.q_proj = Dense(C, cfg.q_dim, bias, (L,), pd, cd, device)
        self.k_proj = Dense(C, cfg.kv_dim, bias, (L,), pd, cd, device)
        self.v_proj = Dense(C, cfg.kv_dim, bias, (L,), pd, cd, device)
        self.o_proj = Dense(cfg.q_dim, C, False, (L,), pd, cd, device)
        self.mlp = MixtureMLP(cfg, L, pd, cd, device)

    def qkv(self, x, cos, sin, l):
        cfg = self.cfg
        b, s, _ = x.shape
        h = self.input_layernorm(x, l)
        q = self.q_proj(h, l).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(h, l).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = self.v_proj(h, l).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        return ops.apply_rope(q, cos, sin), ops.apply_rope(k, cos, sin), v

    def post_attn(self, x, attn_out, l):
        b, s = attn_out.shape[:2]
        x = x + self.o_proj(attn_out.reshape(b, s, -1), l)
        return x + self.mlp(self.post_attention_layernorm(x, l), l)


class _Layers(nn.Module):
    def __init__(self, vlm_cfg, expert_cfg, pd, cd, device):
        super().__init__()
        L = vlm_cfg.num_layers
        self.vlm = MixtureBlock(vlm_cfg, L, pd, cd, device)
        self.expert = MixtureBlock(expert_cfg, L, pd, cd, device)


class JointModel(nn.Module):
    """Stacked joint layers + final per-mixture norms."""

    def __init__(self, vlm_cfg, expert_cfg, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 adaptive_mode: str = ""):
        super().__init__()
        if adaptive_mode:
            raise NotImplementedError("adaLN mixtures are not ported yet")
        self.vlm_cfg, self.expert_cfg = vlm_cfg, expert_cfg
        self.layers = _Layers(vlm_cfg, expert_cfg, param_dtype,
                              compute_dtype, device)
        self.vlm_norm = RMSNorm(vlm_cfg.hidden_size, vlm_cfg.rms_norm_eps,
                                (), param_dtype, device)
        self.expert_norm = RMSNorm(expert_cfg.hidden_size,
                                   expert_cfg.rms_norm_eps, (), param_dtype,
                                   device)

    @staticmethod
    def _mask(seg_q, seg_kv, lev_q=None, lev_kv=None):
        """[B, Sq, Skv] VLA block mask, built once per call (not per layer)."""
        if lev_q is None:
            lev_q, lev_kv = torch.zeros_like(seg_q), torch.zeros_like(seg_kv)
        return ops.make_attention_mask(
            batch=seg_q.shape[0], q_len=seg_q.shape[1], kv_len=seg_kv.shape[1],
            q_segment_ids=seg_q, kv_segment_ids=seg_kv, q_levels=lev_q,
            kv_levels=lev_kv, device=seg_q.device)

    def _attend(self, q, k, v, mask):
        return ops.attention_reference(q, k, v, mask=mask,
                                       softcap=self.vlm_cfg.attn_softcap)

    def forward(self, mode: str, *args):
        vlm, expert = self.layers.vlm, self.layers.expert
        L = self.vlm_cfg.num_layers
        if mode == "vlm_prefix":
            # vlm mixture alone: level-0 tokens never attend proprio, so this
            # equals the vlm rows of mode 'prefix'. -> rope'd K/V stacks.
            x, cos_v, sin_v, seg = args
            mask = self._mask(seg, seg)
            ks, vs = [], []
            for l in range(L):
                q, k, v = vlm.qkv(x, cos_v, sin_v, l)
                x = vlm.post_attn(x, self._attend(q, k, v, mask), l)
                ks.append(k)
                vs.append(v)
            return torch.stack(ks), torch.stack(vs)
        if mode == "prefix":
            x_vlm, x_p, cos_v, sin_v, cos_p, sin_p, seg, lev = args
            sv = x_vlm.shape[1]
            mask = self._mask(seg, seg, lev, lev)
            ks, vs = [], []
            for l in range(L):
                qv, kv, vv = vlm.qkv(x_vlm, cos_v, sin_v, l)
                qp, kp, vp = expert.qkv(x_p, cos_p, sin_p, l)
                q = torch.cat([qv, qp], dim=1)
                k = torch.cat([kv, kp], dim=1)
                v = torch.cat([vv, vp], dim=1)
                out = self._attend(q, k, v, mask)
                x_vlm = vlm.post_attn(x_vlm, out[:, :sv], l)
                x_p = expert.post_attn(x_p, out[:, sv:], l)
                ks.append(k)
                vs.append(v)
            return torch.stack(ks), torch.stack(vs)
        if mode == "suffix":
            (x, cos_a, sin_a, seg_q, seg_kv, lev_q, lev_kv, k_pre,
             v_pre) = args
            mask = self._mask(seg_q, seg_kv, lev_q, lev_kv)
            for l in range(L):
                qa, ka, va = expert.qkv(x, cos_a, sin_a, l)
                k = torch.cat([k_pre[l].to(ka.dtype), ka], dim=1)
                v = torch.cat([v_pre[l].to(va.dtype), va], dim=1)
                out = self._attend(qa, k, v, mask)
                x = expert.post_attn(x, out, l)
            return self.expert_norm(x)
        if mode in ("train", "vlm_only", "vlm_cached"):
            raise NotImplementedError(f"joint mode {mode!r} is not ported yet")
        raise ValueError(mode)
