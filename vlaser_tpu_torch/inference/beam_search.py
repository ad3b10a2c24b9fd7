"""Beam search (port of vlaser_tpu/inference/beam_search.py): one prefill,
then `max_new_tokens - 1` eager steps over beam-expanded rows.

HF generate's greedy beam search (BeamSearchScorer): log-softmax beam
scores, 2K candidates a step, EOS candidates of rank < K become finished
hypotheses normalized by (prompt_len + generated_len) ** length_penalty,
and the live beams reorder the KV cache. The JAX searcher is one jitted
`lax.scan`; here the same steps run eagerly, always all of them (no early
exit), with the JAX constants and bookkeeping: NEG, the first-step EOS
demotion, the finished pool, the finalize.

One step differs from JAX: step t feeds token t - 1 at position
len + t - 1, where it stands in the sequence (HF's position ids, and the
greedy decoder's). The JAX searcher feeds it at len + t, one position late,
so its K = 1 search is not greedy decoding (ROADMAP queue 3); with that
position corrected the two searchers give the same beams.

Tie order follows JAX: `lax.top_k` breaks ties toward the lower index and
`jnp.argsort` is stable, so every top-k and sort here is a stable sort
(`_top`), never `torch.topk`, which promises no order among equal values.
The finished pool and demoted beams are full of NEG ties.

The cache reorder gathers rows of `k` / `v` ([L, B*K, S, KVH, D]) every
step. It writes into a second buffer of the same shape, allocated once,
and the two swap: no new allocation a step.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .kv_cache import KVCache

NEG = -1.0e9


def _top(x, k: int, dim: int = -1):
    """-> (values, indices) of the k largest along `dim`, ties to the lower
    index (lax.top_k's order; a stable descending sort)."""
    v, i = torch.sort(x, dim=dim, descending=True, stable=True)
    return v.narrow(dim, 0, k), i.narrow(dim, 0, k)


def _expand_beams(cache: KVCache, num_beams: int) -> KVCache:
    """Repeat each row K times: [B, ...] -> [B*K, ...] (k / v carry a
    leading layer dim)."""
    rep = lambda x, d: x.repeat_interleave(num_beams, dim=d)
    return dataclasses.replace(cache, k=rep(cache.k, 1), v=rep(cache.v, 1),
                               seg=rep(cache.seg, 0), lev=rep(cache.lev, 0))


def _reorder_cache(cache: KVCache, rows: torch.Tensor,
                   spare: KVCache) -> KVCache:
    """Gather the cache rows `rows` (flattened [B*K] indices) into `spare`'s
    buffers; -> the reordered cache (its buffers are spare's; the caller
    keeps the old ones as the next spare)."""
    for name in ("k", "v"):
        torch.index_select(getattr(cache, name), 1, rows,
                           out=getattr(spare, name))
    for name in ("seg", "lev"):
        torch.index_select(getattr(cache, name), 0, rows,
                           out=getattr(spare, name))
    return dataclasses.replace(cache, k=spare.k, v=spare.v, seg=spare.seg,
                               lev=spare.lev)


def _gather_rows(x, idx):
    """x [B, N, T], idx [B, M] -> x[b, idx[b, m], :]."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def make_beam_generate_fn(model, *, max_new_tokens: int, num_beams: int,
                          eos_token_ids: Sequence[int], pad_token_id: int,
                          length_penalty: float = 1.0,
                          cache_dtype=torch.bfloat16):
    """-> generate(input_ids [B, N], seg_ids [B, N], pixel_values or None,
    generator=None) -> (tokens [B, max_new_tokens], lengths [B]): the best
    beam of each row, ending with EOS then pads as HF's finalize does.
    `model` is an InternVLChatModel; `generator` is taken for the chat's
    call signature and unused (the search is greedy). Prompts are
    right-padded (seg 0); every row decodes from the bucket's end, as in
    JAX."""
    llm = model.cfg.llm
    K, T = num_beams, max_new_tokens

    @torch.no_grad()
    def generate(input_ids, seg_ids, pixel_values, generator=None):
        b, n = input_ids.shape
        dev = input_ids.device
        eos = torch.as_tensor(list(eos_token_ids), dtype=torch.int64,
                              device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        cache = KVCache.create(llm.num_layers, b, n + T, llm.num_kv_heads,
                               llm.head_dim, cache_dtype, dev)
        lengths = (seg_ids != 0).sum(1)  # [B]
        logits, _, cache = model.prefill(input_ids, pixel_values, seg_ids,
                                         cache)
        last = logits[torch.arange(b, device=dev), lengths - 1]  # [B, V]
        del logits
        cache = _expand_beams(cache, K)
        spare = dataclasses.replace(
            cache, k=torch.empty_like(cache.k), v=torch.empty_like(cache.v),
            seg=torch.empty_like(cache.seg), lev=torch.empty_like(cache.lev))
        logp0 = torch.log_softmax(last.float(), dim=-1)
        # first step: top-K tokens of beam 0 (HF starts beams 1.. at -1e9)
        scores0, tok0 = _top(logp0, K)  # [B, K]
        V = logp0.shape[-1]
        lens = lengths[:, None]
        tokens_buf = torch.full((b, K, T), pad_token_id, **i64)
        tokens_buf[:, :, 0] = tok0
        fin_tokens = torch.full((b, K, T), pad_token_id, **i64)
        is0_eos = torch.isin(tok0, eos)
        # first-step EOS candidates -> hypotheses of generated length 0 (HF
        # adds the prompt-only hypothesis); those beams are demoted
        fin0 = torch.where(is0_eos, scores0 / lens ** length_penalty, NEG)
        fin_scores = _top(fin0, K)[0]
        fin_lens = (fin_scores > NEG).long()
        fin_tokens[:, :, 0] = torch.where(fin_scores > NEG, eos[0],
                                          pad_token_id)
        beam_scores = torch.where(is0_eos, NEG, scores0)
        rank = torch.arange(2 * K, device=dev).expand(b, 2 * K)
        base = torch.arange(b, device=dev)[:, None] * K

        for t in range(1, T):
            prev_tok = tokens_buf[:, :, t - 1].reshape(b * K, 1)
            positions = (lens + t - 1).expand(b, K).reshape(b * K, 1)
            logits, _, cache = model.decode_step(prev_tok, cache, positions)
            logp = torch.log_softmax(logits[:, 0].float(),
                                     dim=-1).reshape(b, K, V)
            del logits
            cand = (beam_scores[:, :, None] + logp).reshape(b, K * V)
            top_v, top_i = _top(cand, 2 * K)  # [B, 2K]
            c_beam = top_i // V
            c_tok = top_i % V
            c_eos = torch.isin(c_tok, eos)

            # finished hypotheses: EOS candidates of rank < K, merged into
            # the top-K finished set (scores, token rows, lengths)
            hyp_norm = torch.where(
                c_eos & (rank < K),
                top_v / (lens + t + 1) ** length_penalty, NEG)
            all_scores = torch.cat([fin_scores, hyp_norm], 1)
            hyp_rows = _gather_rows(tokens_buf, c_beam)  # the source beams
            hyp_rows[:, :, t] = eos[0]
            all_tokens = torch.cat([fin_tokens, hyp_rows], 1)
            all_lens = torch.cat([fin_lens, torch.full((b, 2 * K), t + 1,
                                                       **i64)], 1)
            fin_scores, keep = _top(all_scores, K)
            fin_tokens = _gather_rows(all_tokens, keep)
            fin_lens = torch.gather(all_lens, 1, keep)

            # live beams: the first K non-EOS candidates in rank order
            live_key = torch.where(c_eos, 2 * K + rank, rank)
            live = torch.sort(live_key, dim=-1, stable=True).indices[:, :K]
            sel_v = torch.gather(top_v, 1, live)
            sel_beam = torch.gather(c_beam, 1, live)
            sel_tok = torch.gather(c_tok, 1, live)
            beam_scores = torch.where(torch.gather(c_eos, 1, live), NEG,
                                      sel_v)
            tokens_buf = _gather_rows(tokens_buf, sel_beam)
            tokens_buf[:, :, t] = sel_tok
            old = cache
            cache = _reorder_cache(cache, (base + sel_beam).reshape(b * K),
                                   spare)
            spare = old

        # finalize (HF): unfinished beams join the pool at full length
        live_norm = beam_scores / (lens + T) ** length_penalty
        all_scores = torch.cat([fin_scores, live_norm], 1)
        all_tokens = torch.cat([fin_tokens, tokens_buf], 1)
        all_lens = torch.cat([fin_lens, torch.full((b, K), T, **i64)], 1)
        best = _top(all_scores, 1)[1]  # [B, 1]: jnp.argmax's first max
        tokens = _gather_rows(all_tokens, best)[:, 0]
        out_len = torch.gather(all_lens, 1, best)[:, 0]
        tokens = torch.where(torch.arange(T, device=dev)[None] <
                             out_len[:, None], tokens, pad_token_id)
        return tokens, out_len

    return generate
