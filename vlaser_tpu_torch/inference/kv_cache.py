"""Static KV cache (port of vlaser_tpu/inference/kv_cache.py).

Buffers `k`, `v` are [L, B, max_len, KVH, D]; `seg` [B, max_len] int32
marks each slot's segment (0 = empty or padding), `lev` [B, max_len] int32
its VLA block level. `length` is the next write offset: a Python int shared
by every row, or a [B] int32 tensor of per-row offsets (the continuous-
batching engine, `serve/engine.py`: rows admitted at different times decode
at different fill depths). Validity is data (segment 0), not shape, as in
JAX.

Unlike the JAX pytree, the K/V buffers are written in place (`write_kv`):
a copy of a 3,592-slot Vlaser-2B cache per decoded token would be ~41 MB of
traffic for a one-slot change. `write_meta` returns a new cache object
whose `seg`/`lev` are updated in place too (a per-row `length` is a new
tensor, so a caller's reference to the old offsets stays valid); `clone()`
gives an independent copy when two decoders must start from one prefilled
cache. A per-row write starts at min(offset, max_len - S), the clamp of
JAX's dynamic_update_slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor    # [L, B, max_len, KVH, D]
    v: torch.Tensor    # [L, B, max_len, KVH, D]
    seg: torch.Tensor  # [B, max_len] int32; 0 = empty / padding
    lev: torch.Tensor  # [B, max_len] int32; VLA block levels (0 default)
    length: Union[int, torch.Tensor]  # next write offset, or [B] int32

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

    @property
    def per_row(self) -> bool:
        return torch.is_tensor(self.length)

    def write_meta(self, seg_ids: torch.Tensor,
                   levels: Optional[torch.Tensor] = None) -> "KVCache":
        """Record segment ids (and levels) for the next S slots; -> the
        cache advanced (call once per step).

        With per-row `length` every row writes S contiguous slots at its own
        offset and advances by its count of NONZERO incoming seg ids, so an
        inactive engine slot (seg 0) neither pollutes its metadata nor
        drifts. Each row's nonzero seg ids must be a contiguous prefix of
        the S slots (the engine writes all-or-nothing rows; a speculative
        block rolls `length` back itself)."""
        s = seg_ids.shape[1]
        if self.per_row:
            _write_rows_2d(self.seg, seg_ids, self.length)
            if levels is not None:
                _write_rows_2d(self.lev, levels, self.length)
            advance = (seg_ids != 0).sum(1, dtype=torch.int32)
            return dataclasses.replace(self, length=self.length + advance)
        if self.length + s > self.max_len:
            raise ValueError(f"KV cache full: {self.length} + {s} > "
                             f"{self.max_len}")
        self.seg[:, self.length:self.length + s] = seg_ids
        if levels is not None:
            self.lev[:, self.length:self.length + s] = levels
        return dataclasses.replace(self, length=self.length + s)

    def insert_rows(self, small: "KVCache", rows: torch.Tensor,
                    lengths: torch.Tensor, src=None) -> "KVCache":
        """Copy prefilled rows of `small` (rows `src`, by default its first
        len(rows)) into this per-row cache at slot indices `rows` [n], in
        place; -> the cache with those rows' lengths set to `lengths` [n].
        The whole of each row's seg / lev is rewritten: a freed slot's
        stale segment ids past the new prompt must never be attended
        again."""
        n, nb = rows.shape[0], small.max_len
        src = slice(0, n) if src is None else src
        self.k[:, rows, :nb] = small.k[:, src].to(self.k.dtype)
        self.v[:, rows, :nb] = small.v[:, src].to(self.v.dtype)
        for buf, new in ((self.seg, small.seg), (self.lev, small.lev)):
            row = torch.zeros((n, self.max_len), dtype=torch.int32,
                              device=buf.device)
            row[:, :nb] = new[src]
            buf[rows] = row
        length = self.length.clone()
        length[rows] = lengths.to(torch.int32)
        return dataclasses.replace(self, length=length)

    def clone(self) -> "KVCache":
        length = (self.length.clone() if self.per_row else self.length)
        return KVCache(self.k.clone(), self.v.clone(), self.seg.clone(),
                       self.lev.clone(), length)


def _row_slots(offsets: torch.Tensor, s: int, max_len: int) -> torch.Tensor:
    """[B] offsets -> [B, S] slot indices of S contiguous slots a row,
    each start clamped to [0, max_len - S] (dynamic_update_slice's rule)."""
    start = offsets.long().clamp(0, max_len - s)
    return start[:, None] + torch.arange(s, device=offsets.device)[None]


def _write_rows_2d(buf: torch.Tensor, new: torch.Tensor,
                   offsets: torch.Tensor) -> None:
    """In place: buf [B, max] <- new [B, S] at per-row positions offsets."""
    b, s = new.shape
    rows = torch.arange(b, device=buf.device)[:, None]
    buf[rows, _row_slots(offsets, s, buf.shape[1])] = new.to(buf.dtype)


def write_kv(buf: torch.Tensor, new: torch.Tensor, offset) -> None:
    """In place: buf [B, max, KVH, D] <- new [B, S, KVH, D] at `offset`, an
    int, or a [B] tensor that writes each row at its own position."""
    if torch.is_tensor(offset):
        b, s = new.shape[:2]
        rows = torch.arange(b, device=buf.device)[:, None]
        buf[rows, _row_slots(offset, s, buf.shape[1])] = new.to(buf.dtype)
        return
    buf[:, offset:offset + new.shape[1]] = new.to(buf.dtype)
