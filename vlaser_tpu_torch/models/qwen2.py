"""Qwen2.5-style causal LM (port of vlaser_tpu/models/qwen2.py): the
Vlaser chat model's language stack.

Every layer's weights are stacked [L, ...] under `model.layers` (the JAX
scan layout, and the names of the JAX parameter tree), so
`inference.fused_runner.pack_qwen2_stack` hands them to the fused decode
stack without copying layers together. The KV cache (`inference.kv_cache`)
is written in place. Attention goes through
`kernels.flash_attention.attention_fn(impl=attn_impl)`, routed once per
call: with "auto" the flash kernel takes a CUDA tensor where the JAX
dispatch takes Pallas (a prefill of >= 2048 query tokens), the eager
reference takes the rest (decode steps, short prompts). RMSNorm takes its
kernel at >= 2048 rows in the same way (`models.layers.RMSNorm`).

Ported: Qwen2 (q/k/v bias, GQA, rope, SiLU MLP), Qwen3's per-head q/k
RMSNorm, tied or untied heads, the sliding window (`sliding_window`: on
the causal path every layer's attention sees keys at most that many
slots back, flash-attn's left window, as in JAX). Not ported (they raise
NotImplementedError): MoE layers, context parallelism, Phi3 longrope
(`rope_cos_sin_su`), the Gemma family's options (plus-one RMSNorm,
tanh-GELU MLP, embedding scale, softcap, query pre-attention scale).
`remat=True` wraps each decoder layer in `torch.utils.checkpoint` when a
gradient is being taken without a cache (the JAX `nn.remat` over the
scanned layer), so the backward recomputes a layer's activations instead
of keeping them. A cache with per-row offsets (`KVCache.length` a [B] tensor,
the continuous-batching engine) writes K/V at each row's offset; a
one-token step then attends under the segment mask alone (every valid
cached slot is in the past), a multi-token block causally at the per-row
offsets, on the eager reference as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..inference.kv_cache import KVCache, write_kv
from ..kernels import ops
from ..kernels.flash_attention import attention_fn
from .layers import (Dense, Embed, RMSNorm, gated_mlp, layer_slices,
                     w8a8_group)


class Qwen2Attention(nn.Module):
    def __init__(self, cfg, L, pd, cd, device):
        super().__init__()
        C, bias = cfg.hidden_size, cfg.attention_bias
        self.q_proj = Dense(C, cfg.q_dim, bias, (L,), pd, cd, device)
        self.k_proj = Dense(C, cfg.kv_dim, bias, (L,), pd, cd, device)
        self.v_proj = Dense(C, cfg.kv_dim, bias, (L,), pd, cd, device)
        self.o_proj = Dense(cfg.q_dim, C, False, (L,), pd, cd, device)
        if cfg.qk_norm:  # Qwen3: per-head RMSNorm over head_dim before rope
            self.q_norm = RMSNorm(cfg.head_dim, cfg.rms_norm_eps, (L,), pd,
                                  device)
            self.k_norm = RMSNorm(cfg.head_dim, cfg.rms_norm_eps, (L,), pd,
                                  device)


class Qwen2MLP(nn.Module):
    def __init__(self, cfg, L, pd, cd, device):
        super().__init__()
        C, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Dense(C, I, False, (L,), pd, cd, device)
        self.up_proj = Dense(C, I, False, (L,), pd, cd, device)
        self.down_proj = Dense(I, C, False, (L,), pd, cd, device)

    def forward(self, x, l):
        return gated_mlp(x, self.gate_proj, self.up_proj, self.down_proj,
                         F.silu, l)


class Qwen2Layers(nn.Module):
    """All decoder layers, weights stacked [L, ...]."""

    def __init__(self, cfg, pd=torch.float32, cd=torch.bfloat16, device=None):
        super().__init__()
        L, C, eps = cfg.num_layers, cfg.hidden_size, cfg.rms_norm_eps
        self.cfg = cfg
        self.input_layernorm = RMSNorm(C, eps, (L,), pd, device)
        self.self_attn = Qwen2Attention(cfg, L, pd, cd, device)
        self.post_attention_layernorm = RMSNorm(C, eps, (L,), pd, device)
        self.mlp = Qwen2MLP(cfg, L, pd, cd, device)

    def forward(self, x, l, cos, sin, attend, cache: Optional[KVCache],
                q_offset):
        cfg, att = self.cfg, self.self_attn
        b, s, _ = x.shape
        h = self.input_layernorm(x, l)
        q, k, v = w8a8_group(h, (att.q_proj, att.k_proj, att.v_proj), l)
        q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q, k = att.q_norm(q, l), att.k_norm(k, l)
        q, k = ops.apply_rope(q, cos, sin), ops.apply_rope(k, cos, sin)
        if cache is not None:
            write_kv(cache.k[l], k, q_offset)
            write_kv(cache.v[l], v, q_offset)
            k, v = cache.k[l].to(q.dtype), cache.v[l].to(q.dtype)
        out = attend(q, k, v).reshape(b, s, cfg.q_dim)
        x = x + att.o_proj(out, l)
        return x + self.mlp(self.post_attention_layernorm(x, l), l)


class Qwen2Model(nn.Module):
    """Decoder stack + final norm (no embedding, no head)."""

    def __init__(self, cfg, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 remat: bool = False):
        super().__init__()
        if cfg.num_experts > 0 or cfg.context_parallel_axis is not None:
            raise NotImplementedError(
                "MoE layers and context parallelism are not ported yet")
        if (cfg.rope_short_factor is not None or cfg.rms_plus_one
                or cfg.mlp_act != "silu" or cfg.embed_scale
                or cfg.attn_softcap is not None
                or cfg.query_pre_attn_scalar is not None):
            raise NotImplementedError(
                "Phi3 longrope and the Gemma options are not ported yet")
        self.cfg, self.compute_dtype, self.remat = cfg, compute_dtype, remat
        self.layers = Qwen2Layers(cfg, param_dtype, compute_dtype, device)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, (),
                            param_dtype, device)

    def forward(self, inputs_embeds, positions, seg_ids=None, levels=None,
                cache: Optional[KVCache] = None, causal: bool = True,
                attn_impl: str = "auto"):
        """-> (hidden [B, S, H], the cache advanced by S or None)."""
        cfg = self.cfg
        b, s, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        if seg_ids is None:
            seg_ids = torch.ones((b, s), dtype=torch.int32, device=dev)
        cos, sin = ops.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        kw = dict(causal=causal, impl=attn_impl,
                  window=cfg.sliding_window if causal else None)
        q_offset = 0
        if cache is not None:
            q_offset = cache.length
            cache = cache.write_meta(seg_ids, levels)
            if torch.is_tensor(q_offset):
                # per-row offsets: a single query token attends every valid
                # cached slot (all lie in its past), so causal reduces to
                # the kv segment mask; a multi-token block (a speculative
                # verify) is causal at the [B] offsets
                if cfg.sliding_window is not None:
                    raise NotImplementedError(
                        "sliding window with per-row cache offsets")
                kw.update(causal=s > 1, window=None)
            mask_offset = q_offset
            if torch.is_tensor(q_offset) and s == 1:
                mask_offset = 0
            attend = attention_fn(
                b, s, cache.max_len, cfg.num_heads, dev,
                q_segment_ids=seg_ids, kv_segment_ids=cache.seg,
                q_levels=levels,
                kv_levels=None if levels is None else cache.lev,
                q_offset=mask_offset, **kw)
        else:
            attend = attention_fn(
                b, s, s, cfg.num_heads, dev, q_segment_ids=seg_ids,
                kv_segment_ids=seg_ids, q_levels=levels, kv_levels=levels,
                **kw)
        x = inputs_embeds.to(self.compute_dtype)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        with layer_slices(self):
            for l in range(cfg.num_layers):
                if remat:
                    x = checkpoint(self.layers, x, l, cos, sin, attend, None,
                                   0, use_reentrant=False)
                else:
                    x = self.layers(x, l, cos, sin, attend, cache, q_offset)
        return self.norm(x), cache


class Qwen2ForCausalLM(nn.Module):
    def __init__(self, cfg, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        if cfg.has_embed:
            self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size,
                                      param_dtype, compute_dtype, device)
        self.model = Qwen2Model(cfg, param_dtype, compute_dtype, device,
                                remat)
        if cfg.has_lm_head and not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, False, (),
                                 param_dtype, compute_dtype, device)

    def forward(self, input_ids=None, inputs_embeds=None, positions=None,
                seg_ids=None, cache: Optional[KVCache] = None,
                attn_impl: str = "auto", return_logits: bool = True):
        """-> (logits [B, S, V] fp32 or None, hidden, new cache)."""
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        b, s, _ = inputs_embeds.shape
        if positions is None:
            off = cache.length if cache is not None else 0
            base = torch.arange(s, device=inputs_embeds.device)
            positions = (base[None] + off[:, None] if torch.is_tensor(off)
                         else (base + off)[None].expand(b, s))
        hidden, cache = self.model(inputs_embeds, positions, seg_ids=seg_ids,
                                   cache=cache, attn_impl=attn_impl)
        logits = self.logits(hidden) if return_logits else None
        return logits, hidden, cache

    def embed(self, input_ids):
        return self.embed_tokens(input_ids)

    def logits(self, hidden):
        cfg = self.cfg
        if not cfg.has_lm_head:
            return hidden
        if cfg.tie_word_embeddings:
            return self.embed_tokens.attend(hidden)
        return self.lm_head(hidden).float()
