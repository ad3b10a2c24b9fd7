"""InternVL-chat-style VLM (port of vlaser_tpu/models/vlm.py): the mlp1
projector, the static-shape IMG_CONTEXT scatter, and `InternVLChatModel`
(InternViT features fused into the Qwen2 LLM; the Vlaser-2B chat model).

Module names are the JAX parameter tree's (`vision_model`, `mlp1`,
`language_model/{embed_tokens,model,lm_head}`), so
`utils.convert.from_jax_variables` loads a JAX tree as it is. Padding tiles
(`image_flags` 0, the engine's tile buckets) are compacted out of the
scatter, as in JAX.
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .internvit import InternVisionModel
from .layers import Dense, LayerNorm
from .qwen2 import Qwen2ForCausalLM


class MLP1(nn.Module):
    """LayerNorm -> Linear -> GELU -> Linear."""

    def __init__(self, in_dim: int, out_dim: int, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.norm = LayerNorm(in_dim, 1e-5, (), param_dtype, device)
        self.fc1 = Dense(in_dim, out_dim, True, (), param_dtype,
                         compute_dtype, device)
        self.fc2 = Dense(out_dim, out_dim, True, (), param_dtype,
                         compute_dtype, device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.norm(x))))  # exact erf GELU


def scatter_image_embeds(input_ids: torch.Tensor, tok_embeds: torch.Tensor,
                         vit_embeds: torch.Tensor,
                         image_flags: Optional[torch.Tensor],
                         img_context_token_id: int) -> torch.Tensor:
    """Replace <IMG_CONTEXT> positions with ViT tokens, statically shaped.
    The source index is a cumsum over the WHOLE flattened batch, so the
    k-th context slot of the batch takes the k-th (flagged) ViT token.
    image_flags [T] (1 = real tile, 0 = padding) repeats over each tile's
    tokens; flagged tokens are compacted to the front in order (a scatter
    into a scratch row that the padding tokens share), the rest zero."""
    b, n, c = tok_embeds.shape
    t, ppt, _ = vit_embeds.shape
    compact = vit_embeds.reshape(t * ppt, c)
    if image_flags is not None:
        flags = image_flags.to(torch.int64).repeat_interleave(ppt)
        dest = torch.cumsum(flags, 0) - 1
        dest = torch.where(flags == 1, dest, t * ppt)  # dropped: scratch row
        compact = compact.new_zeros((t * ppt + 1, c)).index_copy_(
            0, dest, compact)[:t * ppt]
    sel = (input_ids == img_context_token_id).reshape(b * n)
    src = torch.cumsum(sel.to(torch.int64), 0) - 1
    gathered = compact[src.clamp(0, t * ppt - 1)]
    flat = tok_embeds.reshape(b * n, c)
    out = torch.where(sel[:, None], gathered.to(flat.dtype), flat)
    return out.reshape(b, n, c)


class InternVLChatModel(nn.Module):
    """Vision + projector + LLM. `device` None means the CUDA card; the CPU
    only when asked for (device="cpu"). A box without a card raises rather
    than build there. `attn_impl` routes the ViT's and the LLM's attention
    ("auto" | "kernel" | "reference"), and `remat` checkpoints each ViT
    and decoder layer while a gradient is taken, as the JAX constructor
    flags do."""

    def __init__(self, cfg, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 attn_impl: str = "auto", remat: bool = False):
        super().__init__()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "InternVLChatModel: no CUDA device; pass device='cpu' to "
                    "build on the CPU")
            device = torch.device("cuda")
        self.cfg, self.attn_impl = cfg, attn_impl
        self.vision_model = InternVisionModel(cfg.vision, param_dtype,
                                              compute_dtype, device,
                                              remat=remat,
                                              attn_impl=attn_impl)
        self.language_model = Qwen2ForCausalLM(cfg.llm, param_dtype,
                                               compute_dtype, device, remat)
        self.mlp1 = MLP1(cfg.vit_proj_in_dim, cfg.llm.hidden_size,
                         param_dtype, compute_dtype, device)

    def set_attn_impl(self, impl: str) -> None:
        """Route the ViT's and the LLM's attention ("auto" | "kernel" |
        "reference"), as the constructor flag does."""
        self.attn_impl = self.vision_model.encoder.attn_impl = impl

    @property
    def device(self) -> torch.device:
        return next(itertools.chain(self.parameters(),
                                    self.buffers())).device

    def extract_feature(self, pixel_values):
        """[T, H, W, 3] -> [T, num_image_token, llm_hidden]."""
        vit = self.vision_model(pixel_values,
                                select_layer=self.cfg.select_layer)
        return self.project_features(vit)

    def vit_embed(self, pixel_values):
        """Patch conv + CLS + pos-emb: the fused ViT stack's input."""
        return self.vision_model.embed(pixel_values)

    def project_features(self, vit_hidden):
        """CLS drop, pixel-shuffle x0.5, mlp1."""
        cfg = self.cfg
        vit = vit_hidden[:, 1:, :]
        t, s, c = vit.shape
        side = int(s ** 0.5)
        vit = ops.pixel_shuffle(vit.reshape(t, side, side, c),
                                cfg.downsample_ratio, cfg.ps_version)
        return self.mlp1(vit.reshape(t, -1, vit.shape[-1]))

    def fuse_embeddings(self, input_ids, pixel_values, image_flags=None,
                        visual_features=None):
        tok = self.language_model.embed(input_ids)
        if pixel_values is None and visual_features is None:
            return tok
        vit = visual_features
        if vit is None:
            vit = self.extract_feature(pixel_values)
        return scatter_image_embeds(input_ids, tok, vit, image_flags,
                                    self.cfg.img_context_token_id)

    def forward(self, input_ids, pixel_values, image_flags=None,
                seg_ids=None, positions=None, cache=None,
                return_logits: bool = True):
        """-> (logits, hidden, new cache)."""
        embeds = self.fuse_embeddings(input_ids, pixel_values, image_flags)
        return self.language_model(
            inputs_embeds=embeds, positions=positions, seg_ids=seg_ids,
            cache=cache, attn_impl=self.attn_impl,
            return_logits=return_logits)

    def prefill(self, input_ids, pixel_values, seg_ids, cache,
                visual_features=None, image_flags=None):
        embeds = self.fuse_embeddings(input_ids, pixel_values, image_flags,
                                      visual_features)
        return self.language_model(inputs_embeds=embeds, seg_ids=seg_ids,
                                   cache=cache, attn_impl=self.attn_impl)

    def decode_step(self, token, cache, positions=None, seg_ids=None):
        return self.language_model(input_ids=token, positions=positions,
                                   seg_ids=seg_ids, cache=cache,
                                   attn_impl=self.attn_impl)
