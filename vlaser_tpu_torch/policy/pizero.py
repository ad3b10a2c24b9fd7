"""PiZero-style flow-matching VLA, internvl and paligemma backbones (port
of vlaser_tpu/policy/pizero.py).

`forward` is the flow-matching training loss: psi_t = (1 - (1 - sig_min)
t) x0 + t x1 through the joint `train` pass, then the mean of
(v_psi - (x1 - (1 - sig_min) x0))^2. `infer_action` is the plain oracle of
the serving path: one joint vlm+proprio prefix pass producing per-layer
K/V, then num_inference_steps Euler steps over the action suffix.
`attn_impl` and `remat` are the JAX constructor flags: they reach the
vision tower and the joint stack. The paligemma backbone (open-pi-zero's
pi0) runs SigLIP and a biased linear projector in place of InternViT and
mlp1, divides the image features by sqrt(hidden) before the scatter and
multiplies the fused embeddings by sqrt(hidden) after it, and multiplies
the proprio and action tokens by sqrt(expert hidden) (`_scale_pa`).

The ablation options of the config: `adaptive_mode` ("adaln" |
"adaln_zero") feeds the flow time to the expert's adaptive norms as a
`time_hidden_size`-wide sinusoidal condition instead of concatenating it
into the action encoder; `vision_in_expert` adds a second trainable vision
tower whose features, projected to the expert's width
(`expert_img_mlp`, `expert_img_proj`), enter the expert stream ahead of
proprio as level-1 tokens (positions 1..num_image_token, proprio and
actions shifted after them), while the VLM-side image features are
detached; `use_lm_head` adds a bias-free head over the vocabulary:
`forward_vlm` gives causal text logits through the VLM mixture, and
`infer_text` decodes greedily over fixed K/V buffers (one causal prefill,
then one token a step). `infer_action_naive` is the no-cache oracle: the
full joint forward at every Euler step.
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
from ..models.siglip import SiglipVisionModel
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
    """Linear -> [concat time] -> SiLU -> Linear; time_cond=False (the adaLN
    variants) drops the concat."""

    def __init__(self, action_dim: int, width: int, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 time_cond: bool = True):
        super().__init__()
        d = lambda i, o: Dense(i, o, True, (), param_dtype, compute_dtype,
                               device)
        self.time_cond = time_cond
        self.linear_1 = d(action_dim, width)
        self.linear_2 = d(2 * width if time_cond else width, width)
        self.linear_3 = d(width, width)

    def forward(self, action, time_emb=None):
        emb = self.linear_1(action)
        if self.time_cond:
            time_full = time_emb[:, None, :].expand(
                *emb.shape[:-1], time_emb.shape[-1]).to(emb.dtype)
            emb = torch.cat([time_full, emb], dim=-1)
        return self.linear_3(F.silu(self.linear_2(emb)))


class PiZeroVLA(nn.Module):
    """`device` None means the CUDA card; the CPU only when asked for
    (device="cpu"). A box without a card raises rather than build there."""

    def __init__(self, cfg, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 remat: bool = False, attn_impl: str = "auto"):
        super().__init__()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "PiZeroVLA: no CUDA device; pass device='cpu' to build "
                    "on the CPU")
            device = torch.device("cuda")
        if cfg.backbone not in ("internvl", "paligemma"):
            raise NotImplementedError(f"backbone {cfg.backbone!r}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        vlm, expert = cfg.vlm, cfg.expert
        pd, cd = param_dtype, compute_dtype
        if cfg.backbone == "paligemma":
            self.vision_model = SiglipVisionModel(cfg.siglip, pd, cd, device,
                                                  remat, attn_impl)
            self.multi_modal_projector = Dense(
                cfg.siglip.hidden_size, vlm.llm.hidden_size, True, (), pd, cd,
                device)
        else:
            self.vision_model = InternVisionModel(vlm.vision, pd, cd, device,
                                                  remat, attn_impl)
            self.mlp1 = MLP1(vlm.vit_proj_in_dim, vlm.llm.hidden_size, pd,
                             cd, device)
        self.embed_tokens = Embed(vlm.llm.vocab_size, vlm.llm.hidden_size,
                                  pd, cd, device)
        self.joint = JointModel(vlm.llm, expert, pd, cd, device,
                                adaptive_mode=cfg.adaptive_mode or "",
                                remat=remat, attn_impl=attn_impl,
                                time_hidden_size=cfg.time_hidden_size)
        if cfg.vision_in_expert:
            # the second tower and its projector down to the expert's width
            self.vision_model_expert = InternVisionModel(
                vlm.vision, pd, cd, device, remat, attn_impl)
            self.expert_img_mlp = MLP1(vlm.vit_proj_in_dim,
                                       vlm.llm.hidden_size, pd, cd, device)
            self.expert_img_proj = Dense(vlm.llm.hidden_size,
                                         expert.hidden_size, True, (), pd,
                                         cd, device)
        self.proprio_encoder = Dense(
            cfg.cond_steps * cfg.proprio_dim // cfg.num_proprio_tokens,
            expert.hidden_size, True, (), pd, cd, device)
        self.action_encoder = ActionEncoder(
            cfg.action_dim, expert.hidden_size, pd, cd, device,
            time_cond=not cfg.adaptive_mode)
        self.action_decoder = Dense(expert.hidden_size, cfg.action_dim, True,
                                    (), pd, cd, device)
        if cfg.use_lm_head:
            self.lm_head = Dense(vlm.llm.hidden_size, vlm.llm.vocab_size,
                                 False, (), pd, cd, device)

    @property
    def device(self) -> torch.device:
        return next(itertools.chain(self.parameters(),
                                    self.buffers())).device

    def set_attn_impl(self, impl: str) -> None:
        """Route the ViT's and the joint stack's attention ("auto" |
        "kernel" | "reference"), as the constructor flag does."""
        self.vision_model.encoder.attn_impl = impl
        if self.cfg.vision_in_expert:
            self.vision_model_expert.encoder.attn_impl = impl
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
        if self.cfg.vision_in_expert:  # the VLM-side features are frozen
            vit = vit.detach()
        return scatter_image_embeds(input_ids, tok, vit, None,
                                    cfg.img_context_token_id)

    def _image_text_embeds(self, input_ids, pixel_values):
        cfg = self.cfg.vlm
        if self.cfg.backbone == "paligemma":
            tok = self.embed_tokens(input_ids)
            vit = self.multi_modal_projector(self.vision_model(pixel_values))
            vit = vit / self._const(cfg.llm.hidden_size ** 0.5, vit)
            if self.cfg.vision_in_expert:
                vit = vit.detach()
            fused = scatter_image_embeds(input_ids, tok, vit, None,
                                         cfg.img_context_token_id)
            return fused * self._const(cfg.llm.hidden_size ** 0.5, fused)
        vit = self.vision_model(pixel_values, select_layer=cfg.select_layer)
        return self.fuse_vit_features(input_ids, vit)

    @staticmethod
    def _const(value: float, like: torch.Tensor) -> float:
        """`value` rounded to like's dtype, as jnp.asarray(value, dtype)
        (a host scalar: no device tensor per call)."""
        return torch.tensor(value, dtype=like.dtype).item()

    def _scale_pa(self, x):
        """PaliGemma: proprio/action tokens x sqrt(expert hidden)."""
        if self.cfg.backbone == "paligemma":
            return x * self._const(self.cfg.expert.hidden_size ** 0.5, x)
        return x

    def _expert_image_feats(self, pixel_values):
        """[T, H, W, 3] -> [T, num_image_token, expert hidden] through the
        second tower."""
        cfg = self.cfg.vlm
        vit = self.vision_model_expert(pixel_values,
                                       select_layer=cfg.select_layer)[:, 1:]
        t, s, c = vit.shape
        side = int(s ** 0.5)
        vit = ops.pixel_shuffle(vit.reshape(t, side, side, c),
                                cfg.downsample_ratio, cfg.ps_version)
        vit = self.expert_img_mlp(vit.reshape(t, -1, vit.shape[-1]))
        return self.expert_img_proj(vit)

    @property
    def _n_expert_img(self) -> int:
        """Expert-stream image tokens ahead of proprio (vision-in-expert)."""
        return self.cfg.vlm.num_image_token if self.cfg.vision_in_expert \
            else 0

    def _pa_prefix(self, pixel_values, proprios):
        """The expert stream's rows before the actions: [(expert image) |
        proprio]."""
        x = self._proprio(proprios)
        if not self.cfg.vision_in_expert:
            return x
        feats = self._expert_image_feats(pixel_values)
        return torch.cat([feats.reshape(x.shape[0], -1, feats.shape[-1]), x],
                         dim=1)

    def _positions(self, batch: int, device):
        cfg = self.cfg
        ar = lambda a, b: torch.arange(a, b, device=device)[None].expand(
            batch, b - a)
        n_p = self._n_expert_img + cfg.num_proprio_tokens
        n_a = cfg.num_action_tokens
        return (ar(1, cfg.max_image_text_tokens + 1), ar(1, n_p + 1),
                ar(n_p + 1, n_p + n_a + 1))

    def _meta(self, text_mask, include_action: bool):
        """(segments, levels) over [vlm | (expert image) proprio
        (| action)]."""
        cfg = self.cfg
        b, dev = text_mask.shape[0], text_mask.device
        n_p = self._n_expert_img + cfg.num_proprio_tokens
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
        """-> (the action encoder's time embedding, the adaLN condition):
        one of the two is None."""
        cfg = self.cfg
        if cfg.adaptive_mode:
            return None, sinusoidal_pos_emb(
                t, cfg.time_hidden_size, cfg.time_max_period).to(
                    self.compute_dtype)
        return sinusoidal_pos_emb(t, cfg.expert.hidden_size,
                                  cfg.time_max_period), None

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
            v_psi = self._velocity_naive(
                embeds_vlm, self._pa_prefix(pixel_values, proprios),
                text_mask, psi_t, t)
        d_psi = (x1 - (1.0 - cfg.flow_sig_min) * x0).float()
        return ((v_psi - d_psi) ** 2).mean()

    def _velocity_naive(self, embeds_vlm, pa_prefix, text_mask, action, t):
        """The action rows' velocity through the full joint `train` pass over
        [vlm | (expert image) proprio | action] (the flow loss's, and each
        step of infer_action_naive)."""
        cfg = self.cfg
        b, dev = embeds_vlm.shape[0], embeds_vlm.device
        time_emb, cond = self._time_embed(t)
        action_embeds = self.action_encoder(action.to(self.compute_dtype),
                                            time_emb)
        x_pa = self._scale_pa(torch.cat([pa_prefix, action_embeds], dim=1))
        vlm_pos, p_pos, a_pos = self._positions(b, dev)
        cos_v, sin_v = self._rope(vlm_pos, cfg.vlm.llm.rope_theta)
        cos_pa, sin_pa = self._rope(torch.cat([p_pos, a_pos], dim=1),
                                    cfg.expert.rope_theta)
        seg, lev = self._meta(text_mask, include_action=True)
        extra = () if cond is None else (cond,)
        _, pa_out = self.joint("train", embeds_vlm, x_pa, cos_v, sin_v,
                               cos_pa, sin_pa, seg, lev, *extra)
        n_pre = self._n_expert_img + cfg.num_proprio_tokens
        return self.action_decoder(pa_out[:, n_pre:]).float()

    # -- cached inference --------------------------------------------------
    def prefix_forward_from_embeds(self, embeds_vlm, text_mask, proprios,
                                   pixel_values=None):
        """-> per-layer K/V [L, B, S_it+n_p, KVH, D] over [vlm | (expert
        image) proprio], segments, levels. pixel_values feeds the
        vision-in-expert tower only."""
        cfg = self.cfg
        b, dev = embeds_vlm.shape[0], embeds_vlm.device
        vlm_pos, p_pos, _ = self._positions(b, dev)
        cos_v, sin_v = self._rope(vlm_pos, cfg.vlm.llm.rope_theta)
        cos_p, sin_p = self._rope(p_pos, cfg.expert.rope_theta)
        seg, lev = self._meta(text_mask, include_action=False)
        k, v = self.joint("prefix", embeds_vlm,
                          self._scale_pa(self._pa_prefix(pixel_values,
                                                         proprios)),
                          cos_v, sin_v, cos_p, sin_p, seg, lev)
        return k, v, seg, lev

    def prefix_forward(self, input_ids, pixel_values, text_mask, proprios):
        return self.prefix_forward_from_embeds(
            self._image_text_embeds(input_ids, pixel_values), text_mask,
            proprios, pixel_values)

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
        time_emb, cond = self._time_embed(t)
        x = self._scale_pa(self.action_encoder(
            action.to(self.compute_dtype), time_emb))
        _, _, a_pos = self._positions(b, dev)
        cos_a, sin_a = self._rope(a_pos, cfg.expert.rope_theta)
        n_a = cfg.num_action_tokens
        seg_q = torch.ones(b, n_a, dtype=torch.int32, device=dev)
        lev_q = torch.full((b, n_a), 2, dtype=torch.int32, device=dev)
        extra = () if cond is None else (cond,)
        out = self.joint("suffix", x, cos_a, sin_a, seg_q,
                         torch.cat([seg_pre, seg_q], dim=1), lev_q,
                         torch.cat([lev_pre, lev_q], dim=1), k_pre, v_pre,
                         *extra)
        return self.action_decoder(out).float()

    def _clip_horizon(self, action):
        cfg = self.cfg
        if cfg.final_action_clip_value is not None:
            c = cfg.final_action_clip_value
            action = action.clamp(-c, c)
        return action[:, -cfg.horizon_steps:]

    def infer_action_from_embeds(self, embeds_vlm, text_mask, proprios, noise,
                                 pixel_values=None):
        """infer_action from fused VLM embeddings (pixel_values feeds the
        vision-in-expert tower only)."""
        cfg = self.cfg
        k_pre, v_pre, seg_pre, lev_pre = self.prefix_forward_from_embeds(
            embeds_vlm, text_mask, proprios, pixel_values)
        delta_t = 1.0 / cfg.num_inference_steps
        action = noise.float()
        b = action.shape[0]
        for i in range(cfg.num_inference_steps):
            t = torch.full((b,), float(i), device=action.device) * delta_t
            v = self.denoise_step(action, t, k_pre, v_pre, seg_pre, lev_pre)
            action = action + delta_t * v
        return self._clip_horizon(action)

    @torch.no_grad()
    def infer_action(self, input_ids, pixel_values, text_mask, proprios,
                     noise):
        """Prefix once, then num_inference_steps Euler steps."""
        return self.infer_action_from_embeds(
            self._image_text_embeds(input_ids, pixel_values), text_mask,
            proprios, noise, pixel_values)

    @torch.no_grad()
    def infer_action_naive(self, input_ids, pixel_values, text_mask,
                           proprios, noise):
        """The no-cache oracle: every Euler step runs the full joint
        [vlm | (expert image) proprio | action] forward."""
        cfg = self.cfg
        embeds_vlm = self._image_text_embeds(input_ids, pixel_values)
        pa_prefix = self._pa_prefix(pixel_values, proprios)
        delta_t = 1.0 / cfg.num_inference_steps
        action = noise.float()
        b = action.shape[0]
        for i in range(cfg.num_inference_steps):
            t = torch.full((b,), i * delta_t, device=action.device)
            action = action + delta_t * self._velocity_naive(
                embeds_vlm, pa_prefix, text_mask, action, t)
        return self._clip_horizon(action)

    # -- the text head (use_lm_head) ---------------------------------------
    def _text_embeds(self, input_ids, pixel_values):
        """-> (fused embeddings, rope tables of positions 1..S)."""
        b, s = input_ids.shape
        embeds = self._image_text_embeds(input_ids, pixel_values)
        pos = torch.arange(1, s + 1, device=input_ids.device)[None].expand(
            b, s)
        return embeds, self._rope(pos, self.cfg.vlm.llm.rope_theta)

    def forward_vlm(self, input_ids, pixel_values, text_mask):
        """Causal text logits [B, S, vocab] (fp32) through the VLM mixture
        under the prompt's segments (1 = valid), positions 1..S."""
        embeds, (cos, sin) = self._text_embeds(input_ids, pixel_values)
        hidden = self.joint("vlm_only", embeds, cos, sin,
                            text_mask.to(torch.int32))
        return self.lm_head(hidden).float()

    def text_prefill(self, input_ids, pixel_values, text_mask,
                     max_new_tokens: int):
        """infer_text's prefill: the prompt's causal pass writes its K/V into
        fresh [L, B, S + max_new_tokens, KVH, D] buffers. -> (the logits
        [B, vocab] fp32 of each row's last valid token, the decode state
        for text_step)."""
        llm = self.cfg.vlm.llm
        b, s = input_ids.shape
        dev = input_ids.device
        seg = text_mask.to(torch.int32)
        kv_seg = torch.cat([seg, torch.zeros((b, max_new_tokens),
                                             dtype=torch.int32, device=dev)],
                           1)
        shape = (llm.num_layers, b, s + max_new_tokens,
                 self.joint.layers.vlm.kv_heads, llm.head_dim)
        k_bufs = torch.zeros(shape, dtype=self.compute_dtype, device=dev)
        v_bufs = torch.zeros_like(k_bufs)
        embeds, (cos, sin) = self._text_embeds(input_ids, pixel_values)
        hidden, _, _ = self.joint("vlm_cached", embeds, cos, sin, seg, kv_seg,
                                  0, k_bufs, v_bufs)
        lengths = seg.sum(1)
        last = hidden[torch.arange(b, device=dev), lengths - 1]
        state = dict(k=k_bufs, v=v_bufs, kv_seg=kv_seg, lengths=lengths,
                     prompt=s)
        return self.lm_head(last).float(), state

    def text_step(self, tok, i: int, state):
        """New token i [B] (slot S + i, position length + 1 + i) against the
        buffers, written in place. -> its logits [B, vocab] fp32."""
        llm = self.cfg.vlm.llm
        offset = state["prompt"] + i
        cos, sin = self._rope((state["lengths"] + 1 + i)[:, None],
                              llm.rope_theta)
        kv_seg = state["kv_seg"]
        kv_seg[:, offset] = 1
        ones = torch.ones((tok.shape[0], 1), dtype=torch.int32,
                          device=tok.device)
        hidden, _, _ = self.joint(
            "vlm_cached", self.embed_tokens(tok[:, None]), cos, sin, ones,
            kv_seg, offset, state["k"], state["v"])
        return self.lm_head(hidden[:, 0]).float()

    @torch.no_grad()
    def infer_text(self, input_ids, pixel_values, text_mask,
                   max_new_tokens: int = 16, eos_token_id: int = 2):
        """Greedy text [B, max_new_tokens]: one causal prefill writes the
        prompt's K/V into [L, B, S + max_new_tokens, KVH, D] buffers, then
        each step runs one token against them. Token i is written at slot
        S + i and sits at position length + 1 + i (length: the row's valid
        prompt tokens, positions from 1). A row emits 0 from the step after
        it emitted eos_token_id, and 0 in place of an eos that comes first."""
        logits, state = self.text_prefill(input_ids, pixel_values, text_mask,
                                          max_new_tokens)
        tok = logits.argmax(-1).to(input_ids.dtype)
        done = tok == eos_token_id
        tok = torch.where(done, torch.zeros_like(tok), tok)
        out = [tok]
        for i in range(max_new_tokens - 1):  # the last step's is not emitted
            nxt = self.text_step(tok, i, state).argmax(-1).to(tok.dtype)
            done = done | (tok == eos_token_id)
            nxt = torch.where(done, torch.zeros_like(nxt), nxt)
            done = done | (nxt == eos_token_id)
            tok = nxt
            out.append(tok)
        return torch.stack(out, dim=1)
