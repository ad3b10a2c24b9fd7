"""Prompt-lookup speculative decoding (port of
vlaser_tpu/inference/speculative.py): draft-free multi-token greedy decode.

1. *Draft*: the last `ngram` committed tokens are looked up in the whole
   prompt + generated context; the K tokens that followed their most
   recent earlier occurrence are the draft (prompt lookup, no draft model).
2. *Verify*: one cached forward over [cur, d1..dK] (a multi-token step at
   the cache's scalar offset, causal within the block).
3. *Accept*: the longest prefix where draft[i] == argmax(logits[i]), plus
   the one bonus token at the first mismatch. Committed tokens are always
   the verified argmaxes, so the output is token for token that of greedy
   decode (`sampling.make_generate_fn(temperature=0)`); drafts only decide
   how many tokens a pass yields (1..K+1).
4. *Rollback*: the slots written for rejected drafts get segment 0 and the
   cache's `length` is rewound, so the next pass overwrites them and
   attention never sees them.

JAX runs the loop on the device (`lax.while_loop`); here it is a host loop
that reads two numbers a pass (the tokens committed and the EOS flag), in
place of the device-side loop condition. Single stream (B = 1) only, as in
JAX; `lookup_draft` also takes [B, N] rows (the engine's per-slot drafts).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .kv_cache import KVCache


def lookup_draft(buf: torch.Tensor, total_len, ngram: int, k: int):
    """Find the most recent earlier occurrence of the trailing `ngram` of
    buf[:total_len] and return the `k` tokens that followed it.

    buf [N] (or [B, N] with total_len [B]): the logical sequence (prompt +
    committed tokens, pad after). -> (draft [k] (or [B, k]), found bool).
    When no match exists the draft is whatever follows position 0 —
    harmless, verification rejects it. Slices clamp as JAX's dynamic_slice
    does."""
    single = buf.dim() == 1
    rows = buf[None] if single else buf
    b, n = rows.shape
    dev = rows.device
    tl = torch.as_tensor(total_len, device=dev).long().reshape(-1)
    tl = tl.expand(b)
    w = n - ngram - k  # candidate window
    p0 = (tl - ngram).clamp(0, n - ngram)
    pattern = rows.gather(1, p0[:, None] + torch.arange(ngram, device=dev))
    cond = torch.ones((b, w), dtype=torch.bool, device=dev)
    for j in range(ngram):
        cond &= rows[:, j:j + w] == pattern[:, j:j + 1]
    idx = torch.arange(w, device=dev)
    # strictly earlier than the trailing occurrence itself
    cond &= idx[None] < (tl - ngram)[:, None]
    best = torch.where(cond, idx[None], -1).amax(1)
    found = best >= 0
    start = (best.clamp(min=0) + ngram).clamp(0, n - k)
    draft = rows.gather(1, start[:, None] + torch.arange(k, device=dev))
    if single:
        return draft[0], found[0]
    return draft, found


def make_speculative_generate_fn(model, *, max_new_tokens: int,
                                 eos_token_ids: Sequence[int],
                                 pad_token_id: int, draft_len: int = 8,
                                 ngram: int = 2, cache_dtype=torch.bfloat16,
                                 force_no_match: bool = False):
    """-> fn(input_ids [1, N], seg_ids [1, N], pixel_values or None,
    generator=None) -> (tokens [1, max_new_tokens], emitted counts [1]):
    the `make_generate_fn` interface, greedy and batch 1 only. Tokens equal
    make_generate_fn(temperature=0)'s; only the number of model passes
    differs. `fn.with_stats` returns (tokens, counts, tokens emitted,
    verify passes).

    force_no_match=True rejects every draft (one bonus token a pass) while
    still paying the lookup, the K+1-row verify and the rollback: the
    decoder's worst case, with tokens unchanged."""
    llm = model.cfg.llm
    k = int(draft_len)
    if k < 1 or ngram < 1:
        raise ValueError("draft_len and ngram must be >= 1")

    @torch.no_grad()
    def generate(input_ids, seg_ids, pixel_values, generator=None):
        del generator  # greedy
        b, n = input_ids.shape
        if b != 1:
            raise ValueError("speculative decode is the single-stream "
                             "latency path (batch 1)")
        dev = input_ids.device
        eos = torch.as_tensor(list(eos_token_ids), device=dev)
        nbuf = n + max_new_tokens + k + 1
        cache = KVCache.create(llm.num_layers, b, nbuf, llm.num_kv_heads,
                               llm.head_dim, cache_dtype, dev)
        length = int((seg_ids[0] != 0).sum())  # prompt tokens
        logits, _, cache = model.prefill(input_ids, pixel_values, seg_ids,
                                         cache)
        first = logits[0, length - 1].argmax(-1)
        # the logical sequence: the prompt (right-padded, so buf[:length]
        # is the real prompt) + the generated tokens
        buf = torch.full((nbuf,), pad_token_id, dtype=torch.int64,
                         device=dev)
        buf[:n] = input_ids[0]
        buf[length] = first
        done = bool((first == eos).any())
        # g: committed generated tokens; g - 1 of them are in the cache
        g, passes = 1, 0
        idx = torch.arange(k + 1, device=dev)
        while not done and g < max_new_tokens:
            total = length + g
            draft, _ = lookup_draft(buf, total, ngram, k)
            block = torch.cat([buf[total - 1:total], draft])[None]
            positions = (total - 1 + idx)[None]
            base = cache.length  # the slot offset before this pass
            logits, _, cache = model.decode_step(block, cache, positions)
            targets = logits[0].argmax(-1)
            match = (draft == targets[:k]).to(torch.int32)
            if force_no_match:
                match = torch.zeros_like(match)
            a = match.cumprod(0).sum()  # leading accepted drafts, 0..K
            committed = idx <= a
            is_eos = (targets[:, None] == eos[None]).any(-1)
            # cut after the first committed EOS (the EOS itself is emitted,
            # as make_generate_fn + trim_output emit it)
            hit = (is_eos & committed).to(torch.int32)
            committed &= (hit.cumsum(0) - hit) == 0
            buf[total:total + k + 1] = torch.where(
                committed, targets, buf[total:total + k + 1])
            m, done = torch.stack([committed.sum(),
                                   (is_eos & committed).any()]).tolist()
            done = bool(done)
            # rollback: keep the m of the K+1 written slots (cur + m - 1
            # accepted drafts), segment 0 on the rest until overwritten
            cache.seg[:, base + m:base + k + 1] = 0
            cache = dataclasses.replace(cache, length=base + m)
            g, passes = g + m, passes + 1
        tokens = buf[length:length + max_new_tokens]
        keep = torch.arange(max_new_tokens, device=dev) < g
        tokens = torch.where(keep, tokens, pad_token_id)[None]
        # make_generate_fn's count: the committed tokens themselves (a
        # model may argmax the pad id; trim_output cuts at EOS)
        num = torch.tensor([min(g, max_new_tokens)], device=dev)
        return tokens, num, g, passes

    def fn(input_ids, seg_ids, pixel_values, generator=None):
        tokens, num, _, _ = generate(input_ids, seg_ids, pixel_values,
                                     generator)
        return tokens, num

    fn.with_stats = generate
    return fn
