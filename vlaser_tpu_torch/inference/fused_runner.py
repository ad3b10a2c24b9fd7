"""Fused serving of the chat model (port of
vlaser_tpu/inference/fused_runner.py).

`make_fused_generate_fn` is `sampling.make_generate_fn` at batch 1, greedy:
a prompt of <= 13 tiles runs its ViT through `kernels.fused_vit
.fused_vit_stack` (the act_quant mode on a w8a8 tree, chosen by the
packer), the prefill is the model's own (w8a8 Dense, the flash and RMSNorm
kernels at >= 2048 rows), and every decode step is ONE
`kernels.fused_decode.fused_int8_stack` call over the whole KV cache, its
empty and padded slots masked. The embedding lookup, the final norm and the
int8 logits head stay outside the kernel, as in JAX. Requires an
int8-quantized LLM (`core.quant.quantize_for_serving`) without a per-head
q/k RMSNorm: `fused_int8_stack` does not compute Qwen3's, so a qk-norm LLM
raises NotImplementedError (the JAX runner takes one and drops the norms).
The stacks are packed from the model's weights when the fn is made: reload
weights -> make a new fn.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.tensor_parallel import refuse_cut
from ..kernels import ops
from ..kernels.fused_decode import NEG_INF, fused_int8_stack
from ..kernels.fused_vit import (fused_vit_stack, pack_vit_stack,
                                 supports_fused_vit)
from .kv_cache import KVCache
from .sampling import run_decode

STACK_ARGS = ("ln1", "ln2", "bq", "bk", "bv", "wq", "sq", "wk", "sk", "wv",
              "sv", "wo", "so", "wg", "sg", "wu", "su", "wd", "sd")


def pack_qwen2_stack(language_model) -> dict:
    """Qwen2ForCausalLM with int8 layer kernels -> the fused stack's
    arguments: int8 weights [L, K, N] and fp32 scales [L, 1, N] as they
    are stored (no copy), fp32 norms and biases (zeros without q/k/v bias),
    and the final norm."""
    refuse_cut(language_model, "pack_qwen2_stack")
    lay = language_model.model.layers
    att, mlp = lay.self_attn, lay.mlp
    f32 = lambda t: t.detach().float().contiguous()
    out = {}
    for name, dense in (("q", att.q_proj), ("k", att.k_proj),
                        ("v", att.v_proj), ("o", att.o_proj),
                        ("g", mlp.gate_proj), ("u", mlp.up_proj),
                        ("d", mlp.down_proj)):
        out["w" + name] = dense.kernel_q.contiguous()
        out["s" + name] = f32(dense.kernel_scale)
    for name, dense in (("bq", att.q_proj), ("bk", att.k_proj),
                        ("bv", att.v_proj)):
        w = out["w" + name[1]]
        out[name] = (f32(dense.bias) if dense.use_bias else torch.zeros(
            (w.shape[0], w.shape[-1]), dtype=torch.float32, device=w.device))
    out["ln1"] = f32(lay.input_layernorm.weight)
    out["ln2"] = f32(lay.post_attention_layernorm.weight)
    out["final_norm"] = f32(language_model.model.norm.weight)
    return out


def head_of(language_model):
    """-> (kind, int8 table, scale): the untied lm_head [H, V] or the tied
    embedding [V, H]."""
    lm = language_model
    if hasattr(lm, "lm_head"):
        return ("lm_head", lm.lm_head.kernel_q, lm.lm_head.kernel_scale)
    return ("tied", lm.embed_tokens.embedding_q,
            lm.embed_tokens.embedding_scale)


def _embed_lookup(embed, token):
    """int8 embedding row gather: ids [B] -> [B, H] bf16."""
    bf = torch.bfloat16
    return (embed.embedding_q[token].to(bf)
            * embed.embedding_scale[token].to(bf))


def _head_logits(head, hidden):
    """hidden [B, H] -> logits [B, V] fp32: bf16 operands (the int8 table is
    exact in bf16), fp32 products and sums, the per-channel scale on the
    output (an XLA dot in JAX; a plain matmul here)."""
    kind, tbl, sc = head
    h = hidden.to(torch.bfloat16).float()
    w = tbl.float()
    y = h @ (w if kind == "lm_head" else w.T)
    return y * sc.reshape(-1)[None, :].float()


def fused_decode_step(stack, embed, head, cfg, token, cache: KVCache, pos):
    """One greedy decode step at batch 1: embed -> fused stack over the
    cache -> cache append at `cache.length` -> final norm -> int8 logits
    head. `pos` [1] is the rope position (the prompt's true length + t;
    the write slot is after the bucket's padding). -> (logits [1, V] fp32,
    the cache advanced by one slot)."""
    x = _embed_lookup(embed, token)  # [1, H]
    cos, sin = ops.rope_cos_sin(pos.float(), cfg.head_dim, cfg.rope_theta)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ext_mask = torch.where(cache.seg[0] > 0, zero, zero + NEG_INF)[None, :]
    self_mask = torch.zeros((1, 1), dtype=torch.float32, device=x.device)
    x_out, k_new, v_new = fused_int8_stack(
        x, cos, sin, self_mask, ext_mask, *[stack[k] for k in STACK_ARGS],
        cache.k[:, 0], cache.v[:, 0], eps=cfg.rms_norm_eps)
    cache.k[:, 0, cache.length] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, 0, cache.length] = v_new[:, 0].to(cache.v.dtype)
    cache = cache.write_meta(torch.ones((1, 1), dtype=torch.int32,
                                        device=x.device))
    hidden = ops.rms_norm(x_out, stack["final_norm"], eps=cfg.rms_norm_eps)
    return _head_logits(head, hidden), cache


def _vit_fusable(cfg) -> bool:
    """Final-layer features of a LayerNorm ViT with a biased QKV."""
    return (cfg.select_layer in (-1, cfg.vision.num_layers)
            and supports_fused_vit(cfg.vision))


def fused_vit_eligible(model, pixel_values) -> bool:
    """True when a prompt's tiles run the fused encoder stack: <= 13 tiles
    (the dynamic-preprocess cap), final-layer features, a LayerNorm ViT
    with a biased QKV."""
    return (pixel_values is not None and pixel_values.shape[0] <= 13
            and _vit_fusable(model.cfg))


def fused_visual_features(model, pixel_values, vit_stack=None):
    """The prefill's ViT phase through the fused encoder stack: patch embed
    -> the whole encoder in one call (act_quant when the encoder is int8)
    -> pixel-shuffle + mlp1. `vit_stack`: `pack_vit_stack`'s output, packed
    now when not given."""
    vcfg = model.cfg.vision
    if vit_stack is None:
        vit_stack = pack_vit_stack(model.vision_model)
    emb = model.vit_embed(pixel_values)
    hidden = fused_vit_stack(
        emb.to(torch.bfloat16).contiguous(), **vit_stack,
        num_heads=vcfg.num_heads, eps=vcfg.layer_norm_eps,
        qk_norm=vcfg.qk_normalization)
    return model.project_features(hidden.to(emb.dtype))


def make_fused_generate_fn(model, *, max_new_tokens: int,
                           eos_token_ids: Sequence[int], pad_token_id: int):
    """-> generate(input_ids [1, N], seg_ids [1, N], pixel_values or None,
    generator=None) -> (tokens [1, max_new_tokens], emitted counts [1]),
    greedy (the generator is not used)."""
    llm = model.cfg.llm
    if llm.qk_norm or llm.num_experts > 0:
        raise NotImplementedError(
            "the fused decode stack has no per-head q/k RMSNorm (qk_norm) "
            "and no sparse MoE layer (num_experts)")
    lm = model.language_model
    stack = pack_qwen2_stack(lm)
    # an encoder the fused stack does not compute (RMSNorm, bias-free: the
    # InternViT-6B tier) is never packed; its tiles take the layer loop
    vit_stack = (pack_vit_stack(model.vision_model)
                 if _vit_fusable(model.cfg) else None)
    head = head_of(lm)

    @torch.no_grad()
    def generate(input_ids, seg_ids, pixel_values, generator=None):
        b, n = input_ids.shape
        if b != 1:
            raise ValueError("the fused decode path is single-stream")
        dev = input_ids.device
        cache = KVCache.create(llm.num_layers, 1, n + max_new_tokens,
                               llm.num_kv_heads, llm.head_dim,
                               torch.bfloat16, dev)
        lengths = (seg_ids != 0).sum(1)
        feats = None
        if fused_vit_eligible(model, pixel_values):
            feats = fused_visual_features(model, pixel_values, vit_stack)
        logits, _, cache = model.prefill(input_ids, pixel_values, seg_ids,
                                         cache, visual_features=feats)
        token = logits[0, lengths - 1].argmax(-1)
        state = {"cache": cache}

        def step(tok, t):
            lg, state["cache"] = fused_decode_step(
                stack, lm.embed_tokens, head, llm, tok, state["cache"],
                lengths + t)
            return lg

        return run_decode(step, token, lengths, max_new_tokens,
                          eos_token_ids, pad_token_id,
                          lambda lg, done: lg.argmax(-1))

    return generate
