"""Offline batch serving (port of vlaser_tpu/serve/offline.py): the whole
request list handed over at once, the vLLM `LLM.generate(prompts)` mode.

The JAX module compiles the entire schedule into one `lax.while_loop`:
admission (a batched prefill of every vacant slot from a device-resident
prompt buffer), chunked decode, per-row retirement and the output scatter.
Here the same schedule runs eagerly on the device tensors; the host reads
the slots' aliveness once a chunk (the outer loop's condition) and polls
it through `serve.engine._Liveness` inside a chunk. Greedy, and token for
token what `serve/engine.ContinuousBatchingEngine` and solo
`make_generate_fn` decode.

As in JAX:
- admission prefills every vacant slot in ONE [B, W] forward; a lane with
  nothing to admit replicates a (clipped) request row, and its
  <IMG_CONTEXT> tokens become pad and its tiles' flags 0, so that it
  cannot take scatter slots from an admitting lane (the dead-lane fix;
  without it an admitting lane behind an occupied image lane prefills
  with zero image features);
- one prompt width a dispatch by default (every prompt pads to the widest
  bucket); `max_width_groups` > 1 splits by bucket;
- pixels are a compact [n_img, T, ...] buffer with per-tile flags; text
  rows take row 0 with flags 0, so their zero tiles never scatter.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..inference.kv_cache import KVCache
from .engine import Completion, Request, _Liveness, _pick_bucket


def make_offline_runner(model, *, num_slots: int, max_len: int,
                        max_new_cap: int, eos_token_ids: Sequence[int],
                        pad_token_id: int, chunk_size: int = 32,
                        cache_dtype=torch.bfloat16):
    """-> run(prompts [R, W], seg [R, W], max_new [R], pixels [n_img, T, H,
    W, 3] | None, image_flags [R, T] | None, pix_index [R] | None) ->
    (tokens [R, max_new_cap] (pad-filled), lengths [R]), every tensor on
    the model's device. EOS is excluded and stops the row."""
    llm = model.cfg.llm
    if llm.sliding_window is not None:
        raise NotImplementedError("sliding-window models are unsupported")
    pad = int(pad_token_id)
    B, K = int(num_slots), int(chunk_size)
    ctx = getattr(model.cfg, "img_context_token_id", None)

    @torch.no_grad()
    def run(prompts, seg, max_new, pixels=None, image_flags=None,
            pix_index=None):
        R, W = prompts.shape
        dev = prompts.device
        # decode writes at each row's TRUE length, and run_offline checks
        # len(input_ids) + max_new_tokens <= max_len a request, so only the
        # prefill itself must fit
        if W > max_len:
            raise ValueError(
                f"prompt bucket width {W} exceeds max_len {max_len}")
        eos = torch.as_tensor(list(eos_token_ids), device=dev)
        is_eos = lambda t: (t[:, None] == eos[None]).any(-1)
        cache = KVCache.create(llm.num_layers, B, max_len, llm.num_kv_heads,
                               llm.head_dim, cache_dtype, dev)
        cache = dataclasses.replace(cache, length=torch.zeros(
            (B,), dtype=torch.int32, device=dev))
        lanes = torch.arange(B, device=dev)
        slot_req = torch.full((B,), -1, dtype=torch.int64, device=dev)
        last_tok = torch.full((B,), pad, dtype=torch.int64, device=dev)
        budget = torch.zeros((B,), dtype=torch.int64, device=dev)
        alive = torch.zeros((B,), dtype=torch.bool, device=dev)
        # one extra row: the target of every dropped scatter
        out_buf = torch.full((R + 1, max_new_cap), pad, dtype=torch.int64,
                             device=dev)
        out_len = torch.zeros((R + 1,), dtype=torch.int64, device=dev)
        next_req, alive_h = 0, np.zeros((B,), bool)

        while next_req < R or alive_h.any():
            # 1) admission: fill EVERY vacant slot from the queue in one
            # batched prefill (the host knows which slots are vacant)
            if (~alive_h).any() and next_req < R:
                vac = ~alive_h
                rank = np.cumsum(vac) - vac  # exclusive rank among vacant
                r_idx_h = next_req + rank
                admit_h = vac & (r_idx_h < R)
                r_safe = torch.as_tensor(np.clip(r_idx_h, 0, R - 1),
                                         device=dev)
                r_idx = torch.as_tensor(r_idx_h, device=dev)
                admit = torch.as_tensor(admit_h, device=dev)
                ids = prompts[r_safe]
                if ctx is not None:
                    ids = torch.where(admit[:, None] | (ids != ctx), ids,
                                      pad)
                segw = seg[r_safe]
                true_len = (segw != 0).sum(1)
                px = flags = None
                if pixels is not None:
                    px = pixels[pix_index[r_safe]]
                    px = px.reshape((-1,) + px.shape[2:])  # [B*T, ...]
                    flags = torch.where(admit[:, None], image_flags[r_safe],
                                        0).reshape(-1)
                small = KVCache.create(llm.num_layers, B, W,
                                       llm.num_kv_heads, llm.head_dim,
                                       cache_dtype, dev)
                logits, _, small = model.prefill(ids, px, segw, small,
                                                 image_flags=flags)
                first = logits[lanes, true_len - 1].argmax(-1)
                # merge the admitted lanes into the slot cache
                a = torch.as_tensor(np.nonzero(admit_h)[0], device=dev)
                cache = cache.insert_rows(small, a, true_len[a], src=a)

                mn = max_new[r_safe]
                first_eos = is_eos(first)
                done1 = first_eos | (mn <= 1)
                commit0 = admit & ~first_eos
                out_buf[torch.where(commit0, r_idx, R), 0] = first
                out_len[torch.where(admit, r_idx, R)] = torch.where(
                    first_eos, 0, 1)
                slot_req = torch.where(admit, torch.where(done1, -1, r_idx),
                                       slot_req)
                last_tok = torch.where(admit, first, last_tok)
                budget = torch.where(admit, mn - 1, budget)
                alive = torch.where(admit, ~done1, alive)
                next_req += int(admit_h.sum())

            # 2) chunked decode with retirement and the output scatter
            probe = _Liveness(dev)
            probe.push(alive)
            for _ in range(K):
                if probe.all_dead():
                    break
                seg1 = alive.to(torch.int32)[:, None]
                logits, _, cache = model.decode_step(
                    last_tok[:, None], cache, cache.length[:, None], seg1)
                nxt = logits[:, 0].argmax(-1)
                commit = alive & ~is_eos(nxt)
                # committed tokens land in their request rows; the others
                # aim at the scratch row
                rows = torch.where(commit, slot_req, R)
                cursor = torch.where(commit, out_len[slot_req.clamp(min=0)],
                                     0)
                out_buf[rows, cursor] = nxt
                out_len.index_put_((rows,), torch.ones_like(rows),
                                   accumulate=True)
                budget = budget - alive.to(budget.dtype)
                alive = alive & ~is_eos(nxt) & (budget > 0)
                last_tok = torch.where(alive, nxt, last_tok)
                probe.push(alive)
            # retired slots become vacant for the next admission
            slot_req = torch.where(alive, slot_req, -1)
            alive_h = alive.cpu().numpy()
        return out_buf[:R], out_len[:R]

    return run


def _width_groups(requests, prefill_buckets, max_groups):
    """Partition requests by prefill bucket, then merge adjacent buckets
    (cheapest extra padding first) until at most max_groups remain."""
    if not prefill_buckets or max_groups <= 1:
        return [list(requests)]
    groups: dict = {}
    for r in requests:
        b = _pick_bucket(len(r.input_ids), prefill_buckets)
        groups.setdefault(b, []).append(r)
    while len(groups) > max_groups:
        bs = sorted(groups)
        cost, i = min(((bs[j + 1] - bs[j]) * len(groups[bs[j]]), j)
                      for j in range(len(bs) - 1))
        groups[bs[i + 1]] = groups[bs[i]] + groups[bs[i + 1]]
        del groups[bs[i]]
    return [groups[b] for b in sorted(groups)]


def run_offline(model, requests: Sequence[Request], *, num_slots: int = 8,
                max_len: int = 1024, eos_token_ids: Sequence[int],
                pad_token_id: int, chunk_size: int = 32,
                cache_dtype=torch.bfloat16,
                prefill_buckets: Optional[Sequence[int]] = None,
                max_width_groups: int = 1) -> List[Completion]:
    """The engine's API over the offline schedule: pad the requests into
    dense device buffers, run, unpack Completions in request order. With
    prefill_buckets the prompt width is the widest prompt's bucket (up to
    max_len), and requests split into up to max_width_groups groups."""
    if not requests:
        raise ValueError("run_offline needs at least one request")
    for r in requests:
        if r.max_new_tokens < 1:
            raise ValueError(f"request {r.uid}: max_new_tokens must be >= 1")
        if r.temperature > 0.0:
            raise ValueError("run_offline is greedy-only; use "
                             "ContinuousBatchingEngine for sampled requests")
        if len(r.input_ids) + r.max_new_tokens > max_len:
            raise ValueError(f"request {r.uid}: prompt + max_new_tokens "
                             f"exceeds max_len {max_len}")
    dev = model.device
    on = lambda a, dt=torch.int64: torch.as_tensor(a, dtype=dt).to(dev)
    order = {id(r): i for i, r in enumerate(requests)}
    pending = []
    for group in _width_groups(requests, prefill_buckets, max_width_groups):
        lens = [len(r.input_ids) for r in group]
        W = (_pick_bucket(max(lens), prefill_buckets) if prefill_buckets
             else max(lens))
        cap = max(r.max_new_tokens for r in group)
        # the new-token cap rounds up to a power of two (the output width;
        # rows retire by budget)
        cap_b = 16
        while cap_b < cap:
            cap_b *= 2
        cap = min(cap_b, max(max_len - W, cap))
        R = len(group)
        prompts = np.full((R, W), pad_token_id, np.int64)
        seg = np.zeros((R, W), np.int32)
        max_new = np.zeros((R,), np.int64)
        tiles = [0 if r.pixel_values is None
                 else np.asarray(r.pixel_values).shape[0] for r in group]
        T = max(tiles)
        pixels = flags = pix_index = None
        if T > 0:
            # compact tiles: one row per image request (text rows map to
            # row 0 with all-zero flags)
            n_img = sum(1 for t in tiles if t > 0)
            sample = next(np.asarray(r.pixel_values) for r in group
                          if r.pixel_values is not None)
            pixels = np.zeros((n_img, T) + sample.shape[1:], np.float32)
            flags = np.zeros((R, T), np.int32)
            pix_index = np.zeros((R,), np.int64)
        img_row = 0
        for i, r in enumerate(group):
            n = len(r.input_ids)
            prompts[i, :n] = r.input_ids
            seg[i, :n] = 1
            max_new[i] = r.max_new_tokens
            if pixels is not None and r.pixel_values is not None:
                pixels[img_row, :tiles[i]] = np.asarray(r.pixel_values)
                flags[i, :tiles[i]] = 1
                pix_index[i] = img_row
                img_row += 1
        run = make_offline_runner(
            model, num_slots=num_slots, max_len=max_len,
            max_new_cap=int(cap), eos_token_ids=eos_token_ids,
            pad_token_id=pad_token_id, chunk_size=chunk_size,
            cache_dtype=cache_dtype)
        toks, lens_out = run(
            on(prompts), on(seg, torch.int32), on(max_new),
            None if pixels is None else on(pixels, torch.float32),
            None if flags is None else on(flags, torch.int32),
            None if pix_index is None else on(pix_index))
        pending.append((group, toks, lens_out))

    out: List[Optional[Completion]] = [None] * len(requests)
    for group, toks, lens_out in pending:
        toks, lens_out = toks.cpu().numpy(), lens_out.cpu().numpy()
        for i, r in enumerate(group):
            out[order[id(r)]] = Completion(
                r.uid, [int(t) for t in toks[i, :lens_out[i]]],
                len(r.input_ids))
    return out
