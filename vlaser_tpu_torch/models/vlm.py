"""InternVL-chat pieces used by the VLA (port of vlaser_tpu/models/vlm.py):
the mlp1 projector and the static-shape IMG_CONTEXT scatter.
`InternVLChatModel` is not ported yet."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LayerNorm


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
    k-th context slot of the batch takes the k-th (flagged) ViT token."""
    if image_flags is not None:
        raise NotImplementedError("padding tiles (image_flags) are not ported")
    b, n, c = tok_embeds.shape
    t, ppt, _ = vit_embeds.shape
    compact = vit_embeds.reshape(t * ppt, c)
    sel = (input_ids == img_context_token_id).reshape(b * n)
    src = torch.cumsum(sel.to(torch.int64), 0) - 1
    gathered = compact[src.clamp(0, t * ppt - 1)]
    flat = tok_embeds.reshape(b * n, c)
    out = torch.where(sel[:, None], gathered.to(flat.dtype), flat)
    return out.reshape(b, n, c)
