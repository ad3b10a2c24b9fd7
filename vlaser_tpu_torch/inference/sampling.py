"""Autoregressive generation (port of vlaser_tpu/inference/sampling.py):
one prefill, then a Python loop of `max_new_tokens - 1` decode steps.

The JAX generator is one jitted prefill + `lax.scan`; here the same steps
run eagerly, always all of them (a finished row keeps emitting the pad id,
as in the static scan), with the same liveness count, pad and EOS rules.
`make_generate_fn` is the plain decoder: every step is
`InternVLChatModel.decode_step` (the weight-only int8 Dense on a quantized
model). It serves sampled, penalised and batched requests, and it is the
oracle of the fused decoder (`inference/fused_runner.py`) on the card.
Sampling draws from an explicit `torch.Generator`; the JAX package's
Gumbel draws from a PRNG key give other tokens for the same seed, so only
greedy decoding (and the filters' kept sets) is compared across the two
packages. `sample_per_row` is the engine's per-slot sampler: a sampled
slot emits what a solo `make_generate_fn(temperature=...)` emits under a
generator of the same seed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .kv_cache import KVCache


def _apply_repetition_penalty(logits, seen, penalty: float):
    """HF RepetitionPenaltyLogitsProcessor: for every token already in the
    sequence, divide positive logits by `penalty`, multiply negative ones."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, pen, logits)


def _filter_logits(logits, temps, top_ks, top_ps, use_k: bool = True,
                   use_p: bool = True):
    """The sampling filters with per-row parameters (tensors, not Python
    numbers), in the logits' own dtype as in JAX: temperature scale, then
    the top-k threshold (the k-th largest scaled logit; k 0 = off), then
    the nucleus threshold on the filtered logits (a token is kept while the
    mass before it is under top_p; p 1 = off). Dropped tokens take -1e30.
    logits [B, V]; temps, top_ps [B] float; top_ks [B] int. A row of
    temperature 0 is scaled by 1 (its caller takes the argmax).

    `use_k` / `use_p` False (the host knows that no row has k > 0 / p < 1)
    skip that filter's full-vocabulary sort: it would keep every token, so
    the result is the same bits."""
    v, dt = logits.shape[-1], logits.dtype
    temps = temps.to(dt)
    scale = torch.where(temps > 0, temps, torch.ones_like(temps))
    lt = logits / scale[:, None]
    drop = torch.full((), -1e30, dtype=dt, device=lt.device)
    if use_k:
        lt = _top_k_filter(lt, top_ks, drop)
    if use_p:
        lt = _top_p_filter(lt, top_ps, drop)
    return lt


def _top_k_filter(lt, top_ks, drop):
    v = lt.shape[-1]
    srt = torch.sort(lt, dim=-1, descending=True).values
    kth = srt.gather(1, (top_ks.long() - 1).clamp(0, v - 1)[:, None])
    thr_k = torch.where(top_ks[:, None] > 0, kth,
                        torch.full_like(kth, -torch.inf))
    return torch.where(lt < thr_k, drop, lt)


def _top_p_filter(lt, top_ps, drop):
    srt = torch.sort(lt, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    keep = probs.cumsum(-1) - probs < top_ps.to(probs.dtype)[:, None]
    thr_p = torch.where(keep, srt, torch.inf).amin(-1, keepdim=True)
    thr_p = torch.where(top_ps[:, None] < 1.0, thr_p,
                        torch.full_like(thr_p, -torch.inf))
    return torch.where(lt < thr_p, drop, lt)


def _draw(logits, generator):
    """One categorical draw a row from the filtered logits [B, V]."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _sample(logits, generator: Optional[torch.Generator], temperature: float,
            top_k: int, top_p: float = 1.0):
    """logits [B, V] -> tokens [B] int64: greedy at temperature 0, else
    temperature, top-k and nucleus filtering (`_filter_logits`), then one
    categorical draw."""
    if temperature == 0.0:
        return logits.argmax(-1)
    b, dev = logits.shape[0], logits.device
    full = lambda x, dt: torch.full((b,), x, dtype=dt, device=dev)
    lt = _filter_logits(logits, full(temperature, torch.float32),
                        full(top_k, torch.int64),
                        full(top_p, torch.float32), use_k=top_k > 0,
                        use_p=top_p < 1.0)
    return _draw(lt, generator)


def sample_per_row(logits, generators: Sequence[Optional[torch.Generator]],
                   temps, top_ks, top_ps, use_k: bool = True,
                   use_p: bool = True):
    """Per-row sampling with per-row parameters (the engine's slots each
    carry their own; the vLLM SamplingParams role). logits [B, V];
    generators: one `torch.Generator` (or None) a row; temps / top_ps [B]
    float tensors, top_ks [B] int (0 = no top-k). -> [B] int64 tokens.

    A row with no generator takes the argmax, and so does a row of
    temperature 0 (its generator, if any, still draws, as JAX's key
    splits). A sampled row draws from its own generator on its own [1, V]
    filtered row, so it emits what `_sample` at B = 1 with that row's
    numbers and a generator in the same state emits (the filter is one
    code path; the draw one multinomial over one row). No host sync: the
    rows to draw are the host's list of generators. The JAX package draws
    Gumbel noise from a PRNG key: only the filter's kept set and the greedy
    rows compare across the packages. `use_k` / `use_p` as in
    `_filter_logits`: False when the host knows no row filters."""
    out = logits.argmax(-1)
    rows = [i for i, g in enumerate(generators) if g is not None]
    if not rows:
        return out
    lt = _filter_logits(logits, temps, top_ks, top_ps, use_k, use_p)
    drawn = out.clone()
    for i in rows:
        drawn[i:i + 1] = _draw(lt[i:i + 1], generators[i])
    return torch.where(temps > 0, drawn, out)


def _is_eos(token, eos):
    return (token[:, None] == eos[None, :]).any(-1)


def run_decode(step, token, lengths, max_new_tokens: int, eos_token_ids,
               pad_token_id: int, pick):
    """The shared decode loop of both generators: `token` [B] is the
    prefill's pick; step(token, t) -> logits [B, V] of decode step t at
    positions lengths + t; pick(logits, done) -> the next token. -> (tokens
    [B, max_new_tokens], emitted counts [B]) with the JAX scan's liveness
    rule (a row stops counting after its first EOS; an argmax'd pad id is
    a real token)."""
    eos = torch.as_tensor(list(eos_token_ids), device=token.device)
    done = _is_eos(token, eos)
    tokens, lives = [], []
    for t in range(max_new_tokens - 1):
        tokens.append(torch.where(done, pad_token_id, token))
        lives.append(~done)
        nxt = pick(step(token, t), done)
        done = done | _is_eos(nxt, eos)
        token = nxt
    tokens.append(torch.where(done, pad_token_id, token))
    lives.append(~done)
    tokens, lives = torch.stack(tokens, 1), torch.stack(lives, 1)
    return tokens, lives.sum(1)


def make_generate_fn(model, *, max_new_tokens: int,
                     eos_token_ids: Sequence[int], pad_token_id: int,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0, repetition_penalty: float = 1.0,
                     cache_dtype=torch.bfloat16):
    """-> generate(input_ids [B, N], seg_ids [B, N], pixel_values or None,
    generator=None) -> (tokens [B, max_new_tokens], emitted counts [B]).
    `model` is an InternVLChatModel. Prompts are right-padded (seg 0)."""
    llm = model.cfg.llm
    use_penalty = repetition_penalty != 1.0

    @torch.no_grad()
    def generate(input_ids, seg_ids, pixel_values, generator=None):
        b, n = input_ids.shape
        dev = input_ids.device
        cache = KVCache.create(llm.num_layers, b, n + max_new_tokens,
                               llm.num_kv_heads, llm.head_dim, cache_dtype,
                               dev)
        lengths = (seg_ids != 0).sum(1)
        logits, _, cache = model.prefill(input_ids, pixel_values, seg_ids,
                                         cache)
        last = logits[torch.arange(b, device=dev), lengths - 1]
        rows = torch.arange(b, device=dev)
        seen = None
        if use_penalty:
            # a max-scatter, so a token id that also pads the row stays seen
            seen = torch.zeros((b, llm.vocab_size), dtype=torch.int32,
                               device=dev).scatter_reduce(
                1, input_ids.long(), (seg_ids != 0).int(), "amax").bool()
            last = _apply_repetition_penalty(last, seen, repetition_penalty)
        token = _sample(last, generator, temperature, top_k, top_p)
        eos = torch.as_tensor(list(eos_token_ids), device=dev)
        if use_penalty:
            seen[rows, token] |= ~_is_eos(token, eos)
        state = {"cache": cache}

        def step(tok, t):
            lg, _, state["cache"] = model.decode_step(
                tok[:, None], state["cache"], (lengths + t)[:, None])
            lg = lg[:, 0]
            if use_penalty:
                lg = _apply_repetition_penalty(lg, seen, repetition_penalty)
            return lg

        def pick(lg, done):
            nxt = _sample(lg, generator, temperature, top_k, top_p)
            if use_penalty:
                seen[rows, nxt] |= ~(done | _is_eos(nxt, eos))
            return nxt

        return run_decode(step, token, lengths, max_new_tokens,
                          eos_token_ids, pad_token_id, pick)

    return generate


def trim_output(tokens, num, eos_token_ids: Sequence[int]) -> list:
    """Host-side: cut each row at its first EOS / its emitted count."""
    eos = set(int(e) for e in eos_token_ids)
    out = []
    for row, k in zip(torch.as_tensor(tokens).tolist(),
                      torch.as_tensor(num).tolist()):
        ids = []
        for t in row[:int(k)]:
            if t in eos:
                break
            ids.append(t)
        out.append(ids)
    return out
