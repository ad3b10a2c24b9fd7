"""PiZero-style flow-matching VLA, internvl backbone (port of
vlaser_tpu/policy/pizero.py).

`forward` is the flow-matching training loss: psi_t = (1 - (1 - sig_min)
t) x0 + t x1 through the joint `train` pass, then the mean of
(v_psi - (x1 - (1 - sig_min) x0))^2. `infer_action` is the plain oracle of
the serving path: one joint vlm+proprio prefix pass producing per-layer
K/V, then num_inference_steps Euler steps over the action suffix.
`attn_impl` and `remat` are the JAX constructor flags: they reach the ViT
and the joint stack. Not ported yet: the PaliGemma backbone,
vision-in-expert, adaLN and the text head (`infer_text`, `forward_vlm`).
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..models.internvit import InternVisionModel
from ..models.layers import Dense, Embed, layer_slices
from ..models.vlm import MLP1, scatter_image_embeds
from .joint import JointModel


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, max_period: float):
    """t [B] -> [B, dim], fp32."""
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=t.device)
    freq = torch.exp(-math.log(max_period) * idx / (half - 1))
    emb = t.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class ActionEncoder(nn.Module):
    """Linear -> [concat time] -> SiLU -> Linear (time_cond=True)."""

    def __init__(self, action_dim: int, width: int, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        d = lambda i, o: Dense(i, o, True, (), param_dtype, compute_dtype,
                               device)
        self.linear_1 = d(action_dim, width)
        self.linear_2 = d(2 * width, width)
        self.linear_3 = d(width, width)

    def forward(self, action, time_emb):
        emb = self.linear_1(action)
        time_full = time_emb[:, None, :].expand(
            *emb.shape[:-1], time_emb.shape[-1]).to(emb.dtype)
        emb = torch.cat([time_full, emb], dim=-1)
        return self.linear_3(F.silu(self.linear_2(emb)))


class PiZeroVLA(nn.Module):
    def __init__(self, cfg, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 remat: bool = False, attn_impl: str = "auto"):
        super().__init__()
        if cfg.backbone != "internvl":
            raise NotImplementedError("only the internvl backbone is ported")
        if cfg.vision_in_expert or cfg.adaptive_mode or cfg.use_lm_head:
            raise NotImplementedError(
                "vision-in-expert, adaLN and the lm head are not ported yet")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        vlm, expert = cfg.vlm, cfg.expert
        pd, cd = param_dtype, compute_dtype
        self.vision_model = InternVisionModel(vlm.vision, pd, cd, device,
                                              remat, attn_impl)
        self.mlp1 = MLP1(vlm.vit_proj_in_dim, vlm.llm.hidden_size, pd, cd,
                         device)
        self.embed_tokens = Embed(vlm.llm.vocab_size, vlm.llm.hidden_size,
                                  pd, cd, device)
        self.joint = JointModel(vlm.llm, expert, pd, cd, device,
                                remat=remat, attn_impl=attn_impl)
        self.proprio_encoder = Dense(
            cfg.cond_steps * cfg.proprio_dim // cfg.num_proprio_tokens,
            expert.hidden_size, True, (), pd, cd, device)
        self.action_encoder = ActionEncoder(cfg.action_dim, expert.hidden_size,
                                            pd, cd, device)
        self.action_decoder = Dense(expert.hidden_size, cfg.action_dim, True,
                                    (), pd, cd, device)

    @property
    def device(self) -> torch.device:
        return next(itertools.chain(self.parameters(),
                                    self.buffers())).device

    def set_attn_impl(self, impl: str) -> None:
        """Route the ViT's and the joint stack's attention ("auto" |
        "kernel" | "reference"), as the constructor flag does."""
        self.vision_model.encoder.attn_impl = impl
        self.joint.attn_impl = impl

    # -- embeddings ------------------------------------------------------
    def vit_embed(self, pixel_values):
        """Patch conv + CLS + pos-emb: the fused ViT stack's input."""
        return self.vision_model.embed(pixel_values)

    def fuse_vit_features(self, input_ids, vit_hidden):
        """[T, 1+S_vit, C] ViT hidden -> fused [B, S, llm_hidden]: CLS drop,
        pixel-shuffle, mlp1, IMG_CONTEXT scatter."""
        cfg = self.cfg.vlm
        tok = self.embed_tokens(input_ids)
        vit = vit_hidden[:, 1:, :]
        t, s, c = vit.shape
        side = int(s ** 0.5)
        vit = ops.pixel_shuffle(vit.reshape(t, side, side, c),
                                cfg.downsample_ratio, cfg.ps_version)
        vit = self.mlp1(vit.reshape(t, -1, vit.shape[-1]))
        return scatter_image_embeds(input_ids, tok, vit, None,
                                    cfg.img_context_token_id)

    def _image_text_embeds(self, input_ids, pixel_values):
        vit = self.vision_model(pixel_values,
                                select_layer=self.cfg.vlm.select_layer)
        return self.fuse_vit_features(input_ids, vit)

    def _positions(self, batch: int, device):
        cfg = self.cfg
        ar = lambda a, b: torch.arange(a, b, device=device)[None].expand(
            batch, b - a)
        n_p, n_a = cfg.num_proprio_tokens, cfg.num_action_tokens
        return (ar(1, cfg.max_image_text_tokens + 1), ar(1, n_p + 1),
                ar(n_p + 1, n_p + n_a + 1))

    def _meta(self, text_mask, include_action: bool):
        """(segments, levels) over [vlm | proprio (| action)]."""
        cfg = self.cfg
        b, dev = text_mask.shape[0], text_mask.device
        n_p = cfg.num_proprio_tokens
        n_pa = n_p + (cfg.num_action_tokens if include_action else 0)
        i32 = dict(dtype=torch.int32, device=dev)
        seg = torch.cat([text_mask.to(torch.int32), torch.ones(b, n_pa, **i32)],
                        dim=1)
        parts = [torch.zeros(b, cfg.max_image_text_tokens, **i32),
                 torch.ones(b, n_p, **i32)]
        if include_action:
            parts.append(torch.full((b, cfg.num_action_tokens), 2, **i32))
        return seg, torch.cat(parts, dim=1)

    def _rope(self, positions, theta):
        return ops.rope_cos_sin(positions, self.cfg.expert.head_dim, theta)

    def _time_embed(self, t):
        cfg = self.cfg
        return sinusoidal_pos_emb(t, cfg.expert.hidden_size,
                                  cfg.time_max_period)

    def _proprio(self, proprios):
        cfg = self.cfg
        b = proprios.shape[0]
        return self.proprio_encoder(
            proprios.reshape(b, cfg.num_proprio_tokens, -1)
            .to(self.compute_dtype))

    # -- flow-matching training forward -----------------------------------
    def forward(self, input_ids, pixel_values, text_mask, proprios, actions,
                t, x0):
        """ids [B, S_it], pixels [T, H, W, 3], text_mask [B, S_it] (1 =
        valid), proprios [B, cond_steps, proprio_dim], actions / x0 [B,
        num_action_tokens, action_dim], t [B] -> scalar fp32 loss."""
        cfg = self.cfg
        b, dev = input_ids.shape[0], input_ids.device
        x1 = actions
        tt = t[:, None, None]
        psi_t = (1.0 - (1.0 - cfg.flow_sig_min) * tt) * x0 + tt * x1
        with layer_slices(self):
            embeds_vlm = self._image_text_embeds(input_ids, pixel_values)
            action_embeds = self.action_encoder(psi_t.to(self.compute_dtype),
                                                self._time_embed(t))
            x_pa = torch.cat([self._proprio(proprios), action_embeds], dim=1)
            vlm_pos, p_pos, a_pos = self._positions(b, dev)
            cos_v, sin_v = self._rope(vlm_pos, cfg.vlm.llm.rope_theta)
            cos_pa, sin_pa = self._rope(torch.cat([p_pos, a_pos], dim=1),
                                        cfg.expert.rope_theta)
            seg, lev = self._meta(text_mask, include_action=True)
            _, pa_out = self.joint("train", embeds_vlm, x_pa, cos_v, sin_v,
                                   cos_pa, sin_pa, seg, lev)
            v_psi = self.action_decoder(
                pa_out[:, cfg.num_proprio_tokens:]).float()
        d_psi = (x1 - (1.0 - cfg.flow_sig_min) * x0).float()
        return ((v_psi - d_psi) ** 2).mean()

    # -- cached inference --------------------------------------------------
    def prefix_forward_from_embeds(self, embeds_vlm, text_mask, proprios):
        """-> per-layer K/V [L, B, S_it+1, KVH, D] over [vlm | proprio],
        segments, levels."""
        cfg = self.cfg
        b, dev = embeds_vlm.shape[0], embeds_vlm.device
        vlm_pos, p_pos, _ = self._positions(b, dev)
        cos_v, sin_v = self._rope(vlm_pos, cfg.vlm.llm.rope_theta)
        cos_p, sin_p = self._rope(p_pos, cfg.expert.rope_theta)
        seg, lev = self._meta(text_mask, include_action=False)
        k, v = self.joint("prefix", embeds_vlm, self._proprio(proprios),
                          cos_v, sin_v, cos_p, sin_p, seg, lev)
        return k, v, seg, lev

    def prefix_forward(self, input_ids, pixel_values, text_mask, proprios):
        return self.prefix_forward_from_embeds(
            self._image_text_embeds(input_ids, pixel_values), text_mask,
            proprios)

    def vlm_prefix_from_embeds(self, embeds_vlm, text_mask):
        """VLM half of the prefix alone -> rope'd K/V [L, B, S_it, KVH, D]."""
        cfg = self.cfg
        vlm_pos, _, _ = self._positions(embeds_vlm.shape[0], embeds_vlm.device)
        cos_v, sin_v = self._rope(vlm_pos, cfg.vlm.llm.rope_theta)
        return self.joint("vlm_prefix", embeds_vlm, cos_v, sin_v,
                          text_mask.to(torch.int32))

    def denoise_step(self, action, t, k_pre, v_pre, seg_pre, lev_pre):
        """One velocity evaluation of the action suffix."""
        cfg = self.cfg
        b, dev = action.shape[0], action.device
        x = self.action_encoder(action.to(self.compute_dtype),
                                self._time_embed(t))
        _, _, a_pos = self._positions(b, dev)
        cos_a, sin_a = self._rope(a_pos, cfg.expert.rope_theta)
        n_a = cfg.num_action_tokens
        seg_q = torch.ones(b, n_a, dtype=torch.int32, device=dev)
        lev_q = torch.full((b, n_a), 2, dtype=torch.int32, device=dev)
        out = self.joint("suffix", x, cos_a, sin_a, seg_q,
                         torch.cat([seg_pre, seg_q], dim=1), lev_q,
                         torch.cat([lev_pre, lev_q], dim=1), k_pre, v_pre)
        return self.action_decoder(out).float()

    def infer_action_from_embeds(self, embeds_vlm, text_mask, proprios, noise):
        cfg = self.cfg
        k_pre, v_pre, seg_pre, lev_pre = self.prefix_forward_from_embeds(
            embeds_vlm, text_mask, proprios)
        delta_t = 1.0 / cfg.num_inference_steps
        action = noise.float()
        b = action.shape[0]
        for i in range(cfg.num_inference_steps):
            t = torch.full((b,), float(i), device=action.device) * delta_t
            v = self.denoise_step(action, t, k_pre, v_pre, seg_pre, lev_pre)
            action = action + delta_t * v
        if cfg.final_action_clip_value is not None:
            c = cfg.final_action_clip_value
            action = action.clamp(-c, c)
        return action[:, -cfg.horizon_steps:]

    @torch.no_grad()
    def infer_action(self, input_ids, pixel_values, text_mask, proprios,
                     noise):
        """Prefix once, then num_inference_steps Euler steps."""
        return self.infer_action_from_embeds(
            self._image_text_embeds(input_ids, pixel_values), text_mask,
            proprios, noise)
