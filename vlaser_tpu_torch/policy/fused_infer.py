"""Fused serving paths of the control step (port of
vlaser_tpu/policy/fused_infer.py).

`make_fused_infer_action` (batch 1): the ViT encoder runs through
`kernels.fused_vit.fused_vit_stack` (its act_quant mode on a w8a8 tree,
chosen by the packer), the VLM half of the prefix through the plain joint
stack (w8a8 Dense on a w8a8 tree), and the proprio token plus every Euler
step through `kernels.fused_decode.fused_int8_stack`: step 0 merges the
proprio row with the action rows (R = 1 + 4) against the vlm-only cache,
steps 1..N-1 run the action rows (R = 4) against the [vlm | proprio]
cache. `make_batched_infer_action` (any batch, one tile per sample): the
fused ViT stack at batch B, then `PiZeroVLA.infer_action_from_embeds`
(the joint prefix and the denoise loop in plain PyTorch). Semantics match
`PiZeroVLA.infer_action`; only how the stacks execute differs. The fused
ViT takes one 448 px tile per sample and the full LayerNorm InternViT
encoder: anything else (the paligemma backbone's SigLIP included) raises
NotImplementedError on both paths (the JAX batched
path falls back to its compiled plain `infer_action` there; a caller of
the port that wants the plain encoder calls `model.infer_action`). So does
a qk-norm (Qwen3) mixture: `fused_int8_stack` has no per-head q/k RMSNorm,
and the JAX b1 path, which sends such an expert through it, drops the
norms. The batched path refuses it too, so that the fused serving route
takes exactly the configs its kernels compute. Both paths refuse the
ablations as well: an adaLN / adaLN-Zero expert (the stack has no adaptive
norms or gates) and a vision-in-expert model (the second tower's tokens
are not in the packed prefix), where the JAX b1 path asserts (the JAX
batched path asserts on vision-in-expert only).
"""

from __future__ import annotations

import torch

from ..core.quant import quantize_int8
from ..core.tensor_parallel import refuse_cut
from ..kernels import ops
from ..kernels.fused_decode import NEG_INF, fused_int8_stack
from ..kernels.fused_vit import (fused_vit_stack, pack_vit_stack,
                                 supports_fused_vit)
from .pizero import sinusoidal_pos_emb


def pack_expert_stack(model) -> dict:
    """Expert mixture stacked weights -> fused kernel layout: int8 weights
    [L, K, N] with fp32 [L, 1, N] scales (leaves under the quantization
    floor are quantized here), fp32 norms and biases."""
    refuse_cut(model.joint, "pack_expert_stack")
    p = model.joint.layers.expert

    def wpair(dense):
        if "kernel_q" in dense._buffers:
            return (dense.kernel_q.contiguous(),
                    dense.kernel_scale.float().contiguous())
        q, s = quantize_int8(dense.kernel.detach(), reduce_axis=-2)
        return q.contiguous(), s.contiguous()

    out = {}
    for name, dense in (("q", p.q_proj), ("k", p.k_proj), ("v", p.v_proj),
                        ("o", p.o_proj), ("g", p.mlp.gate_proj),
                        ("u", p.mlp.up_proj), ("d", p.mlp.down_proj)):
        out["w" + name], out["s" + name] = wpair(dense)
    for name, dense in (("bq", p.q_proj), ("bk", p.k_proj), ("bv", p.v_proj)):
        n = out["w" + name[1]].shape[-1]
        out[name] = (dense.bias.detach().float().contiguous()
                     if dense.use_bias else
                     torch.zeros(out["wq"].shape[0], n, dtype=torch.float32,
                                 device=out["wq"].device))
    f32 = lambda t: t.detach().float().contiguous()
    out["ln1"] = f32(p.input_layernorm.weight)
    out["ln2"] = f32(p.post_attention_layernorm.weight)
    out["final_norm"] = f32(model.joint.expert_norm.weight)
    return out


def _dense(dense, x):
    """Tiny bf16 Dense (the encoders/decoder around the stack)."""
    bf = torch.bfloat16
    return x.to(bf) @ dense.kernel.to(bf) + dense.bias.to(bf)


def _encode_actions(enc, action, time_emb):
    """ActionEncoder forward in bf16 (time_cond=True)."""
    emb = _dense(enc.linear_1, action)
    time_full = time_emb[:, None, :].to(emb.dtype).expand(
        *emb.shape[:-1], time_emb.shape[-1])
    emb = torch.cat([time_full, emb], dim=-1)
    return _dense(enc.linear_3, torch.nn.functional.silu(
        _dense(enc.linear_2, emb)))


def _refuse(cfg, what):
    """NotImplementedError for a config the fused serving route does not
    compute."""
    vcfg = cfg.vlm.vision
    if not (cfg.backbone == "internvl"
            and cfg.vlm.select_layer in (-1, vcfg.num_layers)
            and supports_fused_vit(vcfg)):
        raise NotImplementedError(
            f"{what} needs the internvl backbone's full LayerNorm ViT "
            "(fused_vit_stack)")
    if cfg.expert.qk_norm or cfg.vlm.llm.qk_norm:
        raise NotImplementedError(
            f"{what}: a qk-norm (Qwen3) mixture; fused_int8_stack has no "
            "per-head q/k RMSNorm")
    if cfg.adaptive_mode or cfg.vision_in_expert:
        raise NotImplementedError(
            f"{what}: the adaLN / vision-in-expert ablations are served by "
            "the plain infer_action only")


def make_fused_infer_action(model):
    """-> fn(input_ids, pixel_values, text_mask, proprios, noise) with
    `PiZeroVLA.infer_action` semantics, batch 1. The stacks are packed from
    the model's weights now: reload weights -> make a new fn."""
    cfg = model.cfg
    expert, vcfg = cfg.expert, cfg.vlm.vision
    _refuse(cfg, "fused path")
    n_p, R = cfg.num_proprio_tokens, cfg.num_action_tokens
    steps = cfg.num_inference_steps
    delta_t = 1.0 / steps
    bf = torch.bfloat16
    stack = pack_expert_stack(model)
    vit_stack = pack_vit_stack(model.vision_model)
    stack_args = [stack[k] for k in (
        "ln1", "ln2", "bq", "bk", "bv", "wq", "sq", "wk", "sk", "wv", "sv",
        "wo", "so", "wg", "sg", "wu", "su", "wd", "sd")]

    def run_stack(x_rows, cs, sn, selfm, extm, k_e, v_e):
        return fused_int8_stack(x_rows, cs, sn, selfm, extm, *stack_args,
                                k_e, v_e, eps=expert.rms_norm_eps)

    def decode_velocity(x_out):
        hidden = ops.rms_norm(x_out, stack["final_norm"],
                              eps=expert.rms_norm_eps)
        return _dense(model.action_decoder, hidden).float()[None]

    def encode_step(action, i):
        t = torch.full((1,), float(i), device=action.device) * delta_t
        time_emb = sinusoidal_pos_emb(t, expert.hidden_size,
                                      cfg.time_max_period)
        return _encode_actions(model.action_encoder, action.to(bf), time_emb)

    @torch.no_grad()
    def infer(input_ids, pixel_values, text_mask, proprios, noise):
        assert input_ids.shape[0] == 1, "fused path is batch 1"
        dev = input_ids.device
        if pixel_values.shape[0] != 1:
            raise NotImplementedError("fused path takes one image tile")
        # 1) vlm half of the prefix (level-0 tokens never attend proprio)
        emb = model.vit_embed(pixel_values)  # [1, 1+S_vit, C]
        hidden = fused_vit_stack(
            emb[0].to(bf).contiguous(), **vit_stack,
            num_heads=vcfg.num_heads, eps=vcfg.layer_norm_eps,
            qk_norm=vcfg.qk_normalization)
        embeds = model.fuse_vit_features(input_ids, hidden[None].to(emb.dtype))
        k_vlm, v_vlm = model.vlm_prefix_from_embeds(embeds, text_mask)
        k_vlm = k_vlm[:, 0].to(bf).contiguous()  # [L, Sv, KVH, D]
        v_vlm = v_vlm[:, 0].to(bf).contiguous()
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        vlm_mask = torch.where(text_mask[0] > 0, zero,
                               zero + NEG_INF)[None, :]

        # 2) step 0 merged with the proprio rows: [proprio | action] against
        # the vlm-only cache; proprio rows stay blind to the action rows
        x_p = _dense(model.proprio_encoder,
                     proprios.reshape(1, n_p, -1).to(bf))
        p_pos = torch.arange(1, n_p + 1, dtype=torch.float32, device=dev)
        cos_p, sin_p = ops.rope_cos_sin(p_pos, expert.head_dim,
                                        expert.rope_theta)
        a_pos = torch.arange(n_p + 1, n_p + R + 1, dtype=torch.float32,
                             device=dev)
        cos, sin = ops.rope_cos_sin(a_pos, expert.head_dim, expert.rope_theta)
        cos, sin = cos.to(bf), sin.to(bf)
        cos_pa = torch.cat([cos_p.to(bf), cos], dim=0)
        sin_pa = torch.cat([sin_p.to(bf), sin], dim=0)
        self_mask0 = torch.zeros((n_p + R, n_p + R), dtype=torch.float32,
                                 device=dev)
        self_mask0[:n_p, n_p:] = NEG_INF

        action = noise.float()
        x0 = torch.cat([x_p[0], encode_step(action, 0)[0]], dim=0)
        x_out0, k_pa, v_pa = run_stack(x0, cos_pa, sin_pa, self_mask0,
                                       vlm_mask, k_vlm, v_vlm)
        action = action + delta_t * decode_velocity(x_out0[n_p:])

        # 3) steps 1..N-1 against the [vlm | proprio] cache
        k_ext = torch.cat([k_vlm, k_pa[:, :n_p]], dim=1).contiguous()
        v_ext = torch.cat([v_vlm, v_pa[:, :n_p]], dim=1).contiguous()
        ext_mask = torch.cat([vlm_mask, torch.zeros(
            (1, n_p), dtype=torch.float32, device=dev)], dim=1)
        self_mask = torch.zeros((R, R), dtype=torch.float32, device=dev)
        for i in range(1, steps):
            x = encode_step(action, i)[0].contiguous()
            x_out, _, _ = run_stack(x, cos, sin, self_mask, ext_mask,
                                    k_ext, v_ext)
            action = action + delta_t * decode_velocity(x_out)
        if cfg.final_action_clip_value is not None:
            c = cfg.final_action_clip_value
            action = action.clamp(-c, c)
        return action[:, -cfg.horizon_steps:]

    return infer


def make_batched_infer_action(model):
    """-> fn(input_ids, pixel_values, text_mask, proprios, noise) with
    `PiZeroVLA.infer_action` semantics for B samples, one tile each: the
    ViT through the batched fused stack, then the joint prefix and the
    Euler steps in plain PyTorch. A config the fused ViT does not run (a
    cut encoder, RMSNorm or bias-free ViT), a qk-norm mixture or an
    ablation (adaLN, vision-in-expert) raises NotImplementedError. The
    stack is packed from the model's weights now."""
    cfg = model.cfg
    vcfg = cfg.vlm.vision
    _refuse(cfg, "batched path")
    vit_stack = pack_vit_stack(model.vision_model)
    bf = torch.bfloat16

    @torch.no_grad()
    def infer(input_ids, pixel_values, text_mask, proprios, noise):
        if pixel_values.shape[0] != input_ids.shape[0]:
            raise NotImplementedError("batched path takes one tile per sample")
        emb = model.vit_embed(pixel_values)  # [B, 1+S_vit, C]
        hidden = fused_vit_stack(
            emb.to(bf).contiguous(), **vit_stack, num_heads=vcfg.num_heads,
            eps=vcfg.layer_norm_eps, qk_norm=vcfg.qk_normalization)
        embeds = model.fuse_vit_features(input_ids, hidden.to(emb.dtype))
        return model.infer_action_from_embeds(embeds, text_mask, proprios,
                                              noise)

    return infer
