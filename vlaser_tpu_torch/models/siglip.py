"""SigLIP vision tower, the PaliGemma VLA's (port of
vlaser_tpu/models/siglip.py).

Conv patch embed (valid padding, bias), a learned position embedding (no
CLS token), pre-LN encoder layers (LayerNorm -> MHA with biased q/k/v/out ->
residual, LayerNorm -> tanh-GELU MLP -> residual) and a final
post_layernorm; 224 px / 14 -> 256 tokens. Public functions take NHWC
pixels, as the JAX package does. Parameter names are the JAX tree's:
`patch_embedding` (weight in torch's OIHW layout), `position_embedding`,
`encoder.*` stacked [L, ...], `post_layernorm`. Attention goes through
`kernels.flash_attention.attention_fn(impl=attn_impl)` (16 heads x 72 at
So400m: the flash kernel's D = 72); `remat=True` wraps each layer in
`torch.utils.checkpoint` (the JAX `nn.remat`).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import attention_fn
from .internvit import PatchEmbedding
from .layers import Block, Dense, LayerNorm, gelu_tanh


class _SiglipAttn(nn.Module):
    def __init__(self, cfg, L, pd, cd, device):
        super().__init__()
        C = cfg.hidden_size
        mk = lambda: Dense(C, C, True, (L,), pd, cd, device)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            mk(), mk(), mk(), mk())


class SiglipEncoder(nn.Module):
    """All SiglipLayers, weights stacked [L, ...]."""

    def __init__(self, cfg, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 attn_impl: str = "auto"):
        super().__init__()
        L, C, I, eps = (cfg.num_layers, cfg.hidden_size,
                        cfg.intermediate_size, cfg.layer_norm_eps)
        pd, cd = param_dtype, compute_dtype
        self.cfg, self.attn_impl = cfg, attn_impl
        self.layer_norm1 = LayerNorm(C, eps, (L,), pd, device)
        self.self_attn = _SiglipAttn(cfg, L, pd, cd, device)
        self.layer_norm2 = LayerNorm(C, eps, (L,), pd, device)
        self.fc1 = Dense(C, I, True, (L,), pd, cd, device)
        self.fc2 = Dense(I, C, True, (L,), pd, cd, device)

    def layer(self, x, l: int, attend):
        cfg, att = self.cfg, self.self_attn
        b, s, C = x.shape
        h = self.layer_norm1(x, l).to(x.dtype)
        shape = (b, s, cfg.num_heads, cfg.head_dim)
        out = attend(att.q_proj(h, l).reshape(shape),
                     att.k_proj(h, l).reshape(shape),
                     att.v_proj(h, l).reshape(shape))
        x = x + att.out_proj(out.reshape(b, s, C), l)
        h = self.layer_norm2(x, l).to(x.dtype)
        return x + self.fc2(gelu_tanh(self.fc1(h, l)), l)


class SiglipVisionModel(Block):
    def __init__(self, cfg, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 remat: bool = False, attn_impl: str = "auto"):
        super().__init__(param_dtype, device)
        self.cfg, self.compute_dtype, self.remat = cfg, compute_dtype, remat
        self.patch_embedding = PatchEmbedding(cfg, param_dtype, device)
        self._alloc("position_embedding", (1, cfg.num_tokens, cfg.hidden_size))
        self.encoder = SiglipEncoder(cfg, param_dtype, compute_dtype, device,
                                     attn_impl)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                        (), param_dtype, device)

    def embed(self, pixel_values):
        """[B, H, W, 3] -> patches + position embedding [B, tokens, C]."""
        cfg, cd, pe = self.cfg, self.compute_dtype, self.patch_embedding
        x = pixel_values.to(cd).permute(0, 3, 1, 2)
        emb = torch.nn.functional.conv2d(x, pe.weight.to(cd),
                                         stride=cfg.patch_size)
        emb = emb.permute(0, 2, 3, 1) + pe.bias.to(cd)
        b, h, w, c = emb.shape
        x = emb.reshape(b, h * w, c)
        return x + self.position_embedding.to(x.dtype)

    def forward(self, pixel_values):
        """[B, H, W, 3] -> [B, num_tokens, hidden] in the compute dtype."""
        cfg = self.cfg
        x = self.embed(pixel_values)
        b, s = x.shape[:2]
        attend = attention_fn(b, s, s, cfg.num_heads, x.device, causal=False,
                              impl=self.encoder.attn_impl)
        remat = self.remat and torch.is_grad_enabled()
        for l in range(cfg.num_layers):
            if remat:
                x = checkpoint(self.encoder.layer, x, l, attend,
                               use_reentrant=False)
            else:
                x = self.encoder.layer(x, l, attend)
        return self.post_layernorm(x).to(self.compute_dtype)
