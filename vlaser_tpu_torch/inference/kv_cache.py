"""Static KV cache (port of vlaser_tpu/inference/kv_cache.py).

Buffers `k`, `v` are [L, B, max_len, KVH, D]; `seg` [B, max_len] int32
marks each slot's segment (0 = empty or padding), `lev` [B, max_len] int32
its VLA block level, and `length` is the next write offset, a Python int
shared by every row. Validity is data (segment 0), not shape, as in JAX.

Unlike the JAX pytree, the K/V buffers are written in place (`write_kv`):
a copy of a 3,592-slot Vlaser-2B cache per decoded token would be ~41 MB of
traffic for a one-slot change. `write_meta` returns a new cache object
whose `seg`/`lev` are updated in place too; `clone()` gives an independent
copy when two decoders must start from one prefilled cache. Per-row
offsets (the continuous-batching engine) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor    # [L, B, max_len, KVH, D]
    v: torch.Tensor    # [L, B, max_len, KVH, D]
    seg: torch.Tensor  # [B, max_len] int32; 0 = empty / padding
    lev: torch.Tensor  # [B, max_len] int32; VLA block levels (0 default)
    length: int        # next write offset

    @classmethod
    def create(cls, num_layers: int, batch: int, max_len: int,
               num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
               device=None) -> "KVCache":
        shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
        i32 = dict(dtype=torch.int32, device=device)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   seg=torch.zeros((batch, max_len), **i32),
                   lev=torch.zeros((batch, max_len), **i32), length=0)

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def write_meta(self, seg_ids: torch.Tensor,
                   levels: Optional[torch.Tensor] = None) -> "KVCache":
        """Record segment ids (and levels) for the next S slots; -> the
        cache advanced by S (call once per step)."""
        s = seg_ids.shape[1]
        if self.length + s > self.max_len:
            raise ValueError(f"KV cache full: {self.length} + {s} > "
                             f"{self.max_len}")
        self.seg[:, self.length:self.length + s] = seg_ids
        if levels is not None:
            self.lev[:, self.length:self.length + s] = levels
        return dataclasses.replace(self, length=self.length + s)

    def clone(self) -> "KVCache":
        return KVCache(self.k.clone(), self.v.clone(), self.seg.clone(),
                       self.lev.clone(), self.length)


def write_kv(buf: torch.Tensor, new: torch.Tensor, offset: int) -> None:
    """In place: buf [B, max, KVH, D] <- new [B, S, KVH, D] at `offset`."""
    buf[:, offset:offset + new.shape[1]] = new.to(buf.dtype)
