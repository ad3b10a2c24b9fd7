"""InternViT vision encoder (port of vlaser_tpu/models/internvit.py).

Public functions take NHWC pixels, as the JAX package does. The encoder's
per-layer weights are stacked [L, ...] under `encoder` (the JAX scan
layout), so `kernels.fused_vit.pack_vit_stack` reads them without copying
layers together. `forward` is the layer loop: the training path and the
oracle of the fused serving stack. Its attention goes through
`kernels.flash_attention.attention(impl=attn_impl)`; `remat=True` wraps each
layer in `torch.utils.checkpoint` (the JAX `nn.remat`), so the backward
recomputes a layer's activations instead of keeping them. An input whose
patch grid is not the config's gets its patch position embeddings resized
bicubically (`ops.bicubic_resize_2d`, the CLS row kept), as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..kernels.flash_attention import attention
from .layers import Block, Dense, LayerNorm, RMSNorm


class PatchEmbedding(Block):
    """Conv patch embed; weight in torch's OIHW layout."""

    def __init__(self, cfg, param_dtype, device):
        super().__init__(param_dtype, device)
        p = cfg.patch_size
        self._alloc("weight", (cfg.hidden_size, 3, p, p))
        self._alloc("bias", (cfg.hidden_size,))


class InternVisionEmbeddings(Block):
    def __init__(self, cfg, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__(param_dtype, device)
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self.patch_embedding = PatchEmbedding(cfg, param_dtype, device)
        self._alloc("class_embedding", (1, 1, cfg.hidden_size))
        self._alloc("position_embedding", (1, cfg.seq_len, cfg.hidden_size))

    def forward(self, pixel_values):
        """pixel_values [B, H, W, 3] -> [B, 1 + patches, C]."""
        cfg, cd = self.cfg, self.compute_dtype
        pe = self.patch_embedding
        x = pixel_values.to(cd).permute(0, 3, 1, 2)
        emb = F.conv2d(x, pe.weight.to(cd), stride=cfg.patch_size)
        emb = emb.permute(0, 2, 3, 1) + pe.bias.to(cd)
        b, h, w, c = emb.shape
        n_side = cfg.num_patches_per_side
        pos = self.position_embedding
        if (h, w) != (n_side, n_side):
            grid = pos[:, 1:].reshape(1, n_side, n_side, c)
            patch = ops.bicubic_resize_2d(grid, h, w).reshape(1, h * w, c)
            pos = torch.cat([pos[:, :1], patch.to(pos.dtype)], dim=1)
        patches = emb.reshape(b, h * w, c)
        cls = self.class_embedding.expand(b, 1, c).to(patches.dtype)
        x = torch.cat([cls, patches], dim=1)
        return x + pos.to(x.dtype)


class _Attn(nn.Module):
    """The fused qkv and proj; `heads`: the heads this rank computes
    (core/tensor_parallel may cut them: qkv then holds those heads' columns
    of q, k and v, in that order)."""

    def __init__(self, cfg, L, pd, cd, device):
        super().__init__()
        C = cfg.hidden_size
        self.heads = self.kv_heads = cfg.num_heads
        self.head_dim, self.qk_norm = cfg.head_dim, cfg.qk_normalization
        self.qkv = Dense(C, 3 * C, cfg.qkv_bias, (L,), pd, cd, device)
        self.proj = Dense(C, C, True, (L,), pd, cd, device)
        if cfg.qk_normalization:
            self.q_norm = RMSNorm(C, cfg.layer_norm_eps, (L,), pd, device)
            self.k_norm = RMSNorm(C, cfg.layer_norm_eps, (L,), pd, device)


class _MLP(nn.Module):
    def __init__(self, cfg, L, pd, cd, device):
        super().__init__()
        C, I = cfg.hidden_size, cfg.intermediate_size
        self.fc1 = Dense(C, I, True, (L,), pd, cd, device)
        self.fc2 = Dense(I, C, True, (L,), pd, cd, device)


class InternVisionEncoder(Block):
    """All InternVisionLayers, weights stacked [L, ...]."""

    def __init__(self, cfg, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 attn_impl: str = "auto"):
        super().__init__(param_dtype, device, stacked=True)
        L, C = cfg.num_layers, cfg.hidden_size
        self.cfg, self.attn_impl = cfg, attn_impl
        norm = (LayerNorm if cfg.norm_type == "layer_norm" else RMSNorm)
        self.norm1 = norm(C, cfg.layer_norm_eps, (L,), param_dtype, device)
        self.norm2 = norm(C, cfg.layer_norm_eps, (L,), param_dtype, device)
        self._alloc("ls1", (L, C))
        self._alloc("ls2", (L, C))
        self.attn = _Attn(cfg, L, param_dtype, compute_dtype, device)
        self.mlp = _MLP(cfg, L, param_dtype, compute_dtype, device)

    def layer(self, x, l: int):
        """InternVisionLayer l (pre-norm blocks with layer-scale)."""
        cfg = self.cfg
        b, s, C = x.shape
        h = self.norm1(x, l).to(x.dtype)
        qkv = self.attn.qkv(h, l)
        q, k, v = qkv.chunk(3, dim=-1)
        if cfg.qk_normalization:
            q = self.attn.q_norm(q, l)
            k = self.attn.k_norm(k, l)
        shape = (b, s, self.attn.heads, cfg.head_dim)
        out = attention(q.reshape(shape), k.reshape(shape), v.reshape(shape),
                        causal=False, impl=self.attn_impl)
        h = self.attn.proj(out.reshape(b, s, -1), l)
        x = x + h * self.leaf("ls1", l).to(h.dtype)
        h = self.norm2(x, l).to(x.dtype)
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(h, l)), l)  # exact erf GELU
        return x + h * self.leaf("ls2", l).to(h.dtype)


class InternVisionModel(nn.Module):
    """Hidden states at `select_layer` (-1 = final layer output)."""

    def __init__(self, cfg, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 remat: bool = False, attn_impl: str = "auto"):
        super().__init__()
        self.cfg, self.remat = cfg, remat
        self.embeddings = InternVisionEmbeddings(cfg, param_dtype,
                                                 compute_dtype, device)
        self.encoder = InternVisionEncoder(cfg, param_dtype, compute_dtype,
                                           device, attn_impl)

    def embed(self, pixel_values):
        """Patch conv + CLS + pos-emb: the fused stack's input."""
        return self.embeddings(pixel_values)

    def forward(self, pixel_values, select_layer: int = -1):
        n = self.cfg.num_layers
        stop = n if select_layer in (-1, n) else select_layer + n + 1
        x = self.embeddings(pixel_values)
        remat = self.remat and torch.is_grad_enabled()
        for l in range(stop):
            if remat:
                x = checkpoint(self.encoder.layer, x, l, use_reentrant=False)
            else:
                x = self.encoder.layer(x, l)
        return x
