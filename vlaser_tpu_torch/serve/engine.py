"""Continuous-batching VLM serving engine (port of
vlaser_tpu/serve/engine.py, the vLLM role).

Requests join and leave a running decode batch as they arrive and finish,
so the card never idles on the longest request of a static batch:

- One decode batch of `num_slots` rows; each row ("slot") holds one
  in-flight request. The KV cache has per-row offsets
  (`KVCache.length` a [B] tensor): every slot decodes at its own fill depth
  (`inference/kv_cache.py`, `models/qwen2.py`).
- Admission is batched: a wave's requests group by (prompt bucket, tile
  bucket) and each group prefills as one [k, bucket] forward (k padded to a
  power of two by repeating its last request), then its rows are copied
  into the slot cache (`_insert`). Multi-tile prompts can bucket the tile
  count (`tile_buckets`): padding tiles carry image_flags 0.
- Decode runs in chunks of up to `chunk_size` steps between host syncs.
  Per-row aliveness (EOS, token budget) lives on the device, so dead rows
  stop writing (segment 0); the host replays the chunk's [K, B] token
  matrix through the same retirement rules. The JAX chunk is a
  `lax.while_loop` that stops once no row is alive; here the host polls a
  pinned copy of any(alive) through a CUDA event a step (`_Liveness`), so
  a chunk runs at most `LIVENESS_LAG` steps past the last death without
  one host sync a token. Tokens do not depend on it: dead rows are inert
  and the host never reads past a row's death.
- Greedy runs take a pipelined loop (`_run_pipelined`, `pipeline_depth`):
  chunk i+1 chains off chunk i's device tensors, and chunk i's tokens come
  back through a non-blocking copy into pinned memory that the host reads
  once its event has completed.

Unlike the JAX engine, which donates the cache and rebuilds pytrees, the
cache here is written in place: the slot cache's K/V by every step and
every insert, `seg` by every step (a speculative block then zeroes its
rejected slots in place). A stored prefix (`register_prefix`, the automatic
prefix store) is the K/V of a prefill's own small cache or a copy of it,
never a view of the slot cache, and `prefill_suffix` masks a copy of its
metadata, never the store.

Decoding is greedy by default and token-identical to solo
`make_generate_fn` decode. Sampled requests (temperature, top-k, top-p,
seed) ride the same batch: each slot draws from its own `torch.Generator`
seeded with the request's seed and emits what a solo
`make_generate_fn(temperature=...)` emits under a generator of that seed
(`inference/sampling.sample_per_row`). The engine keeps a generated token
equal to `pad_token_id` (it is a real model output).

Speculative decoding (`speculative_draft_len > 0`) verifies one
[num_slots, K+1] block a pass: per-slot prompt-lookup drafts
(`inference/speculative.lookup_draft`), a per-row causal block step and
per-row rollback. Committed tokens are the verified argmaxes, so outputs
are those of the plain engine. The adaptive policy (an acceptance EMA
against an occupancy-scaled threshold, bounded probes, exponential
back-off) is the JAX package's, unchanged. Greedy runs only.

Prefix caching: `register_prefix(ids, pixels)` prefills a shared prefix
once; a request with `prefix_id` carries only its tail, which admission
prefills as one multi-token cached forward against the stored prefix K/V.
`auto_prefix_block` turns on the automatic form (a block-hash chain seeded
by the pixels' digest, an LRU store with a minimum gain).

`mesh=` (tensor-parallel serving) is not ported and raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..inference.kv_cache import KVCache
from ..inference.sampling import sample_per_row
from ..inference.speculative import lookup_draft

# steps a chunk may queue past the newest any(alive) it has read; beyond
# that the host waits for the oldest step (the card is then the bottleneck)
LIVENESS_LAG = 2


@dataclasses.dataclass
class Request:
    uid: int
    input_ids: np.ndarray  # [n] int prompt (image tokens already expanded)
    pixel_values: Optional[np.ndarray] = None  # [T, H, W, 3] tiles
    max_new_tokens: int = 64
    # per-request sampling params; temperature 0.0 = greedy. A sampled
    # request reproduces a solo make_generate_fn(temperature, top_k, top_p)
    # run under a torch.Generator seeded with `seed`.
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # id from engine.register_prefix(); when set, input_ids holds ONLY the
    # tail after the shared prefix (text only: the image lives in the
    # prefix)
    prefix_id: Optional[int] = None


@dataclasses.dataclass
class Completion:
    uid: int
    token_ids: List[int]  # generated ids, EOS excluded
    prompt_len: int


@dataclasses.dataclass
class _Slot:
    req: Request
    last_token: int
    generated: List[int]
    rng: Optional[torch.Generator] = None  # sampled requests only
    prompt_len: int = 0  # prefix_len + tail for prefix-cached requests


class _PendingSlot:
    """A row admitted on the device whose first token the host has not
    replayed yet: it occupies the slot so a wave cannot admit twice."""

    __slots__ = ("req",)

    def __init__(self, req: Request):
        self.req = req


def _pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds the largest bucket {buckets[-1]}")


class Readback:
    """Device tensors copied to the host without blocking: into pinned
    memory behind a CUDA event on a card (`get` waits for the event), as
    they are on the CPU."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(tensors)

    def get(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


class _Liveness:
    """any(alive) of the steps a chunk has queued, read without a host sync
    a step: each push copies the flag into pinned memory behind an event;
    `all_dead` reads the flags whose events have completed (and waits for
    the oldest once more than LIVENESS_LAG steps are unread)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.pending: deque = deque()
        self.dead = False

    def push(self, alive: torch.Tensor) -> None:
        if not self.cuda:
            self.dead = not bool(alive.any())
            return
        h = torch.empty((), dtype=torch.bool, pin_memory=True)
        h.copy_(alive.any(), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.pending.append((ev, h))

    def all_dead(self) -> bool:
        if not self.cuda:
            return self.dead
        while self.pending:
            ev, h = self.pending[0]
            if len(self.pending) > LIVENESS_LAG:
                ev.synchronize()
            elif not ev.query():
                break
            self.pending.popleft()
            if not bool(h):
                self.dead = True
        return self.dead


class ContinuousBatchingEngine:
    """model: an InternVLChatModel (or any model with prefill/decode_step)
    holding its weights; the engine runs on the model's device."""

    def __init__(
        self,
        model,
        *,
        # the JAX package's scheduling defaults (its on-chip sweep): 16
        # slots, chunks of 64 steps, one chunk in flight
        num_slots: int = 16,
        max_len: int = 1024,
        eos_token_ids: Sequence[int],
        pad_token_id: int,
        prefill_buckets: Optional[Sequence[int]] = None,
        tile_buckets: Optional[Sequence[int]] = None,
        cache_dtype=torch.bfloat16,
        chunk_size: int = 64,
        speculative_draft_len: int = 0,
        speculative_ngram: int = 2,
        speculative_adaptive: bool = True,
        spec_threshold_base: float = 1.1,
        spec_threshold_slope: float = 0.05,
        spec_reprobe_every: int = 8,
        mesh=None,
        auto_prefix_block: Optional[int] = None,
        auto_prefix_max: int = 8,
        auto_prefix_min_gain: Optional[int] = None,
        pipeline_depth: int = 1,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh=) is not ported yet")
        llm = model.cfg.llm
        self.pipeline_depth = int(pipeline_depth)
        if self.pipeline_depth < 1 or chunk_size < 1:
            raise ValueError("pipeline_depth and chunk_size must be >= 1")
        if llm.sliding_window is not None:
            raise NotImplementedError(
                "continuous batching decodes with per-row offsets; "
                "sliding-window models are unsupported")
        self.model = model
        self.device = model.device
        self.mesh = None
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos = tuple(int(e) for e in eos_token_ids)
        self._eos_dev = torch.as_tensor(self.eos, device=self.device)
        self.pad_token_id = int(pad_token_id)
        self.cache_dtype = cache_dtype
        if prefill_buckets is None:
            b, buckets = 32, []
            while b < max_len:
                buckets.append(b)
                b *= 2
            buckets.append(max_len)
            prefill_buckets = buckets
        bad = [b for b in prefill_buckets if b > max_len]
        if bad:
            raise ValueError(
                f"prefill_buckets {bad} exceed max_len {max_len}: a prompt "
                "padded to such a bucket cannot fit the decode cache")
        self.prefill_buckets = tuple(sorted(set(prefill_buckets)))
        # admission-group size buckets (powers of two up to num_slots)
        kb, ks = 1, []
        while kb < num_slots:
            ks.append(kb)
            kb *= 2
        ks.append(num_slots)
        self._admit_kbuckets = tuple(sorted(set(ks)))
        self.tile_buckets = (None if tile_buckets is None
                             else tuple(sorted(set(tile_buckets))))
        self._llm = llm
        self.stats: Dict[str, int] = {}
        self.cache = self._fresh_cache()
        self._prefixes: Dict[int, dict] = {}
        self._next_prefix_id = 0
        # automatic prefix caching: see the JAX engine for the policy (the
        # hash chain is seeded by the pixels' digest; an entry is stored
        # only when it extends the store's aligned coverage by min_gain)
        self.auto_prefix_block = (None if auto_prefix_block is None
                                  else int(auto_prefix_block))
        if self.auto_prefix_block is not None and self.auto_prefix_block < 1:
            raise ValueError("auto_prefix_block must be >= 1")
        self.auto_prefix_max = int(auto_prefix_max)
        self.auto_prefix_min_gain = (
            None if self.auto_prefix_block is None
            else (int(auto_prefix_min_gain) if auto_prefix_min_gain
                  is not None else 4 * self.auto_prefix_block))
        self._auto: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._auto_pids: Dict[int, set] = {}
        self.auto_prefix_hits = 0
        self.auto_prefix_misses = 0
        self.chunk_size = int(chunk_size)
        # speculative decoding and its adaptive policy (the JAX package's:
        # a pessimistic start with bounded probes, exponential back-off of
        # the probe interval, an EMA of tokens a row a pass against
        # spec_threshold_base + spec_threshold_slope x live rows)
        self.spec_draft_len = int(speculative_draft_len)
        self.spec_ngram = int(speculative_ngram)
        self.speculative_adaptive = bool(speculative_adaptive)
        self.spec_threshold_base = float(spec_threshold_base)
        self.spec_threshold_slope = float(spec_threshold_slope)
        self.spec_reprobe_every = int(spec_reprobe_every)
        self.spec_chunks_run = 0
        self.plain_chunks_run = 0
        self.spec_last_ema: Optional[float] = None
        self._spec_plain_streak = 0
        self._spec_probe_interval = self.spec_reprobe_every
        if self.spec_draft_len > 0:
            if self.spec_ngram < 1:
                raise ValueError("speculative_ngram must be >= 1")
            # per-row token-history width
            self._spec_buf_width = self.max_len + self.spec_draft_len + 1

    # -- cache / slot management ----------------------------------------

    def _fresh_cache(self) -> KVCache:
        llm = self._llm
        cache = KVCache.create(llm.num_layers, self.num_slots, self.max_len,
                               llm.num_kv_heads, llm.head_dim,
                               self.cache_dtype, self.device)
        return dataclasses.replace(cache, length=torch.zeros(
            (self.num_slots,), dtype=torch.int32, device=self.device))

    def reset(self) -> None:
        self.cache = self._fresh_cache()

    def _dev(self, x, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def _prep_pixels(self, pixel_values):
        """Tile-bucket padding + image_flags (full prefill and prefix
        registration)."""
        if pixel_values is None:
            return None, None
        px = np.asarray(pixel_values)
        flags = None
        if self.tile_buckets is not None:
            t = px.shape[0]
            tb = _pick_bucket(t, self.tile_buckets)
            if tb > t:
                pad = np.zeros((tb - t,) + px.shape[1:], px.dtype)
                px = np.concatenate([px, pad], axis=0)
            flags = self._dev((np.arange(tb) < t).astype(np.int32),
                              torch.int32)
        return self._dev(px, torch.float32), flags

    # -- the model calls --------------------------------------------------

    def _prefill(self, ids, seg, pixels, flags, true_lens):
        """Batched admission prefill of ids [k, nb] (k same-bucket requests
        as one forward; rows are independent). -> (small cache, first
        tokens [k], last logits [k, V])."""
        llm = self._llm
        k, nb = ids.shape
        cache = KVCache.create(llm.num_layers, k, nb, llm.num_kv_heads,
                               llm.head_dim, self.cache_dtype, self.device)
        logits, _, cache = self.model.prefill(ids, pixels, seg, cache,
                                              image_flags=flags)
        last = logits[torch.arange(k, device=self.device), true_lens - 1]
        return cache, last.argmax(-1), last

    def _prefill_suffix(self, pref, plen: int, ids, seg, true_ms):
        """Prefill text tails ids [k, sb] against a stored prefix K/V as
        ONE cached multi-token forward. Each row's cache is prefix_bucket +
        tail_bucket wide: the prefix K/V at slots [0, prefix_bucket), its
        metadata masked at plen (one stored entry serves any matched prefix
        length; slots >= plen hold the storing request's own later tokens),
        then the tails at slots plen.. with rope positions plen + i. The
        mask is applied to this cache's copy, never to the store."""
        llm = self._llm
        k_rows, sb = ids.shape
        pb = pref["k"].shape[2]
        cache = KVCache.create(llm.num_layers, k_rows, pb + sb,
                               llm.num_kv_heads, llm.head_dim,
                               self.cache_dtype, self.device)
        cache.k[:, :, :pb] = pref["k"].to(cache.k.dtype)
        cache.v[:, :, :pb] = pref["v"].to(cache.v.dtype)
        keep = torch.arange(pb, device=self.device)[None] < plen
        cache.seg[:, :pb] = torch.where(keep, pref["seg"], 0)
        cache.lev[:, :pb] = torch.where(keep, pref["lev"], 0)
        # a scalar length: every row's tail writes at the same offset
        cache = dataclasses.replace(cache, length=int(plen))
        logits, _, cache = self.model.decode_step(ids, cache, None, seg)
        last = logits[torch.arange(k_rows, device=self.device), true_ms - 1]
        return cache, last.argmax(-1), last

    def _insert(self, small: KVCache, rows: Sequence[int], true_lens):
        """Copy a batched prefill's first len(rows) rows into the slot cache
        at slot indices `rows` (group padding rows are dropped)."""
        r = torch.as_tensor(list(rows), device=self.device)
        self.cache = self.cache.insert_rows(small, r, true_lens[:len(rows)])

    def _one_step(self, tokens, alive):
        """One decode step of every slot at its own offset; dead rows feed
        segment 0 (no metadata, no advance)."""
        seg = alive.to(torch.int32)[:, None]
        positions = self.cache.length[:, None]
        logits, _, self.cache = self.model.decode_step(
            tokens[:, None], self.cache, positions, seg)
        return logits[:, 0]

    def _is_eos(self, t):
        return (t[..., None] == self._eos_dev).any(-1)

    def _advance(self, tokens, alive, budget, nxt):
        """The device mirror of the host's retirement rules: a row that
        just emitted `nxt` dies on EOS or when its budget is spent; a dead
        row freezes its feed token."""
        budget = budget - alive.to(budget.dtype)
        alive = alive & ~self._is_eos(nxt) & (budget > 0)
        tokens = torch.where(alive, nxt, tokens)
        return tokens, alive, budget

    def _chunk_loop(self, kcap: int, alive, body):
        """Run body(step) -> alive up to kcap times, stopping (LIVENESS_LAG
        steps late at most) once no row is alive."""
        probe = _Liveness(self.device)
        probe.push(alive)
        steps = 0
        for step in range(kcap):
            if probe.all_dead():
                break
            alive = body(step)
            probe.push(alive)
            steps += 1
        self.stats["steps_run"] = self.stats.get("steps_run", 0) + steps

    def _decode_chunk(self, tokens, alive, budget, kcap: int):
        """-> (emitted [K, B], tokens, alive, budget): up to kcap greedy
        steps. Emitted rows past a row's death repeat garbage the host
        never reads; the row state stays on the device so the next chunk
        chains off it."""
        B = tokens.shape[0]
        buf = torch.zeros((self.chunk_size, B), dtype=torch.int64,
                          device=self.device)
        st = [tokens, alive, budget]

        def body(step):
            nxt = self._one_step(st[0], st[1]).argmax(-1)
            buf[step] = nxt
            st[:] = self._advance(st[0], st[1], st[2], nxt)
            return st[1]

        self._chunk_loop(kcap, alive, body)
        return (buf, *st)

    def _decode_chunk_hist(self, sbuf, totals, tokens, alive, budget,
                           kcap: int):
        """The plain greedy chunk that also appends each committed token to
        the draft history (adaptive speculation's fallback), so a later
        speculative chunk drafts from a current window."""
        B = tokens.shape[0]
        W = sbuf.shape[1]
        rows = torch.arange(B, device=self.device)
        out = torch.zeros((self.chunk_size, B), dtype=torch.int64,
                          device=self.device)
        st = [totals, tokens, alive, budget]

        def body(step):
            totals, tokens, alive, budget = st
            nxt = self._one_step(tokens, alive).argmax(-1)
            out[step] = nxt
            # dead rows do not advance totals: their write is invisible
            sbuf[rows, totals.clamp(0, W - 1)] = nxt
            totals = totals + alive.to(totals.dtype)
            st[:] = [totals, *self._advance(tokens, alive, budget, nxt)]
            return st[2]

        self._chunk_loop(kcap, alive, body)
        return (out, *st)

    def _decode_chunk_spec(self, sbuf, totals, tokens, alive, budget,
                           kcap: int):
        """-> (targets [P, B, Kd+1], counts [P, B], totals, tokens, alive,
        budget): up to kcap verify passes; pass p commits counts[p, b]
        tokens of row b, targets[p, b, :m] (acceptance, the EOS cut and the
        budget cap are prefix rules). Dead rows write segment-0 blocks and
        report 0. The history `sbuf` [B, W] is updated in place."""
        Kd, B = self.spec_draft_len, tokens.shape[0]
        dev = self.device
        W = sbuf.shape[1]
        idx = torch.arange(Kd + 1, device=dev)
        rows = torch.arange(B, device=dev)[:, None]
        slot = torch.arange(self.max_len, device=dev)[None]
        tg = torch.zeros((self.chunk_size, B, Kd + 1), dtype=torch.int64,
                         device=dev)
        ct = torch.zeros((self.chunk_size, B), dtype=torch.int64, device=dev)
        st = [totals, tokens, alive, budget]

        def body(p):
            totals, tokens, alive, budget = st
            draft = lookup_draft(sbuf, totals, self.spec_ngram, Kd)[0]
            block = torch.cat([tokens[:, None], draft], 1)
            positions = (totals - 1)[:, None] + idx[None]
            seg = alive.to(torch.int32)[:, None].expand(B, Kd + 1)
            base = self.cache.length
            logits, _, cache = self.model.decode_step(block, self.cache,
                                                      positions, seg)
            targets = logits.argmax(-1)
            match = (draft == targets[:, :Kd]).to(torch.int32)
            a = match.cumprod(1).sum(1)
            committed = idx[None] <= a[:, None]
            is_eos = self._is_eos(targets)
            hit = (is_eos & committed).to(torch.int32)
            committed &= (hit.cumsum(1) - hit) == 0
            committed &= idx[None] < budget[:, None]
            committed &= alive[:, None]
            m = committed.sum(1)
            # the history update at per-row totals (slices clamp as JAX's)
            cols = totals.clamp(0, W - Kd - 1)[:, None] + idx[None]
            sbuf[rows, cols] = torch.where(committed, targets,
                                           sbuf[rows, cols])
            # per-row rollback: keep m of the Kd+1 written slots
            stale = (slot >= (base + m)[:, None]) & (
                slot < (base + Kd + 1)[:, None])
            cache.seg.masked_fill_(stale, 0)
            self.cache = dataclasses.replace(cache,
                                             length=(base + m).to(torch.int32))
            last = targets.gather(1, (m - 1).clamp(min=0)[:, None])[:, 0]
            tokens = torch.where(m > 0, last, tokens)
            budget = budget - m.to(budget.dtype)
            alive = alive & ~(is_eos & committed).any(1) & (budget > 0)
            tg[p] = targets
            ct[p] = m
            st[:] = [totals + m.to(totals.dtype), tokens, alive, budget]
            return alive

        self._chunk_loop(kcap, alive, body)
        return (tg, ct, *st)

    def _admit_merge(self, tokens, alive, budget, rows, toks_new, max_news):
        """Splice an admission group's first tokens into the device row
        state. A row whose first token is EOS (or whose budget is already
        spent) starts dead: the host replay applies the same rule."""
        first_dead = self._is_eos(toks_new) | (max_news <= 1)
        tokens[rows] = toks_new
        alive[rows] = ~first_dead
        budget[rows] = (max_news - 1).to(budget.dtype)

    # -- prefix caching ---------------------------------------------------

    @torch.no_grad()
    def register_prefix(self, input_ids, pixel_values=None) -> int:
        """Prefill a shared prompt prefix once; -> a prefix_id for
        `Request.prefix_id`. Its [L, 1, bucket, KVH, D] K/V (the prefill's
        own cache, never the slot cache) stays on the device until
        release_prefix()."""
        ids_np = np.asarray(input_ids, np.int64).reshape(-1)
        n = int(ids_np.shape[-1])
        nb = _pick_bucket(n, self.prefill_buckets)
        ids = np.full((1, nb), self.pad_token_id, np.int64)
        ids[0, :n] = ids_np
        seg = np.zeros((1, nb), np.int32)
        seg[0, :n] = 1
        pixels, flags = self._prep_pixels(pixel_values)
        small, _, _ = self._prefill(self._dev(ids),
                                    self._dev(seg, torch.int32), pixels,
                                    flags, self._dev([n]))
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = dict(k=small.k, v=small.v, seg=small.seg,
                                   lev=small.lev, n=n, ids=ids_np)
        return pid

    def release_prefix(self, prefix_id: int) -> None:
        del self._prefixes[prefix_id]

    @staticmethod
    def _pixels_digest(pixel_values) -> bytes:
        """Content digest of the prompt's tiles, the hash chain's seed."""
        if pixel_values is None:
            return b""
        px = np.ascontiguousarray(np.asarray(pixel_values))
        h = hashlib.blake2b(digest_size=16)
        h.update(str(px.shape).encode() + str(px.dtype).encode())
        h.update(px.tobytes())
        return h.digest()

    def _auto_keys(self, ids: np.ndarray, digest: bytes) -> List[bytes]:
        """Cumulative block-hash chain: keys[j] identifies the first
        (j+1)*block tokens (+ pixel digest); only prefixes that leave >= 1
        tail token are keyed. Token ids hash as int32, as in JAX."""
        blk = self.auto_prefix_block
        nblocks = (len(ids) - 1) // blk
        h = hashlib.blake2b(digest, digest_size=16)
        keys = []
        ids32 = np.asarray(ids, np.int32)
        for j in range(nblocks):
            h.update(np.ascontiguousarray(
                ids32[j * blk:(j + 1) * blk]).tobytes())
            keys.append(h.digest())
        return keys

    def _img_end(self, ids: np.ndarray, pixel_values) -> int:
        """First position after the last <IMG_CONTEXT> token: a cached
        prefix of an image prompt must cover the whole image block."""
        if pixel_values is None:
            return 0
        tok = getattr(self.model.cfg, "img_context_token_id", None)
        if tok is None:
            return 0
        pos = np.nonzero(ids == tok)[0]
        return int(pos[-1]) + 1 if len(pos) else 0

    def _auto_match(self, ids: np.ndarray, pixel_values):
        """Longest registered block-aligned prefix of `ids` (same pixels):
        (prefix_id, matched_len), or None."""
        keys = self._auto_keys(ids, self._pixels_digest(pixel_values))
        img_end = self._img_end(ids, pixel_values)
        blk = self.auto_prefix_block
        for j in range(len(keys) - 1, -1, -1):
            P = (j + 1) * blk
            if P < img_end:
                break  # shorter prefixes cover even less of the image
            hit = self._auto.get(keys[j])
            if hit is None:
                continue
            pid, _ = hit
            sb = _pick_bucket(len(ids) - P, self.prefill_buckets)
            if self._prefixes[pid]["k"].shape[2] + sb > self.max_len:
                continue
            self._auto.move_to_end(keys[j])
            return pid, P
        return None

    def _auto_store(self, ids: np.ndarray, pixel_values, small: KVCache,
                    row: int, n: int) -> None:
        """Register row `row` of a batched full prefill as ONE stored entry
        keyed at every block boundary (a copy of that row: no forward, and
        no view of any cache that is written later). LRU-evicts keys past
        auto_prefix_max entries; an entry frees with its last key."""
        blk = self.auto_prefix_block
        Pmax = ((n - 1) // blk) * blk
        if Pmax < blk:
            return
        if Pmax < self._img_end(ids, pixel_values):
            return  # no aligned prefix covers the image block
        keys = self._auto_keys(ids, self._pixels_digest(pixel_values))
        fresh = [(j, k) for j, k in enumerate(keys) if k not in self._auto]
        for k in keys:
            if k in self._auto:
                self._auto.move_to_end(k)
        if not fresh:
            return
        # min gain: the store already covers everything below the first
        # fresh key; a new slab must beat it by >= min_gain tokens (a
        # prompt with no covered prefix always stores)
        covered = fresh[0][0] * blk
        if covered > 0 and Pmax - covered < self.auto_prefix_min_gain:
            return
        pb = _pick_bucket(Pmax, self.prefill_buckets)
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = dict(
            k=small.k[:, row:row + 1, :pb].clone(),
            v=small.v[:, row:row + 1, :pb].clone(),
            seg=small.seg[row:row + 1, :pb].clone(),
            lev=small.lev[row:row + 1, :pb].clone(),
            n=Pmax, ids=np.asarray(ids[:Pmax], np.int64))
        self._auto_pids[pid] = set()
        for j, k in fresh:
            self._auto[k] = (pid, (j + 1) * blk)
            self._auto_pids[pid].add(k)
        while len(self._auto_pids) > self.auto_prefix_max:
            k_old, (pid_old, _) = self._auto.popitem(last=False)
            refs = self._auto_pids[pid_old]
            refs.discard(k_old)
            if not refs:
                del self._auto_pids[pid_old]
                del self._prefixes[pid_old]

    # -- serving loop -----------------------------------------------------

    def _finish(self, slots, row: int, include_last: bool, done: list,
                on_token) -> None:
        """Retire slot `row`: its tokens (the last one too when
        include_last), cut at the first EOS, become a Completion."""
        st = slots[row]
        toks = list(st.generated)
        if include_last:
            toks.append(st.last_token)
            if on_token is not None and st.last_token not in self.eos:
                on_token(st.req.uid, st.last_token)
        out = []
        for t in toks:
            if t in self.eos:
                break
            out.append(t)
        done.append(Completion(st.req.uid, out, st.prompt_len))
        slots[row] = None

    def _build_wave(self, queue, slots, use_spec: bool) -> list:
        """Pop waiting requests into free slots, resolve explicit and
        automatic prefix reuse, check the cache fit. -> the wave as (row,
        req, n_total, (prefix_id, plen) | None, tail | None) tuples."""
        wave = []
        for row in range(self.num_slots):
            if slots[row] is not None or not queue:
                continue
            req = queue.popleft()
            ids_np = np.asarray(req.input_ids, np.int64)
            m = int(len(ids_np))
            pk, tail = None, None
            if req.prefix_id is not None:
                pref = self._prefixes[req.prefix_id]
                pk, tail = (req.prefix_id, pref["n"]), ids_np
                if req.pixel_values is not None:
                    raise ValueError(
                        f"request {req.uid}: a prefix_id tail is text-only "
                        "(put the image in the registered prefix)")
                n = pref["n"] + m
                sb = _pick_bucket(m, self.prefill_buckets)
                if pref["k"].shape[2] + sb > self.max_len:
                    raise ValueError(
                        f"request {req.uid}: prefix bucket "
                        f"{pref['k'].shape[2]} + tail bucket {sb} exceeds "
                        f"max_len {self.max_len}")
            else:
                n = m
                if self.auto_prefix_block is not None:
                    hit = self._auto_match(ids_np, req.pixel_values)
                    if hit is not None:
                        pid, P = hit
                        pk, tail = (pid, P), ids_np[P:]
                        self.auto_prefix_hits += 1
                    else:
                        self.auto_prefix_misses += 1
            # speculative blocks write Kd+1 slots at fill depths up to
            # n+max_new-1: the cache needs a draft_len margin
            margin = self.spec_draft_len if use_spec else 0
            if n + req.max_new_tokens + margin > self.max_len:
                raise ValueError(
                    f"request {req.uid}: {n}+{req.max_new_tokens}+{margin} "
                    f"(speculative margin) exceeds max_len {self.max_len}")
            wave.append((row, req, n, pk, tail))
        return wave

    def _dispatch_wave(self, wave):
        """Group a wave by compiled shape and run ONE batched [k, bucket]
        prefill + insert a group. Nothing here reads the device back.
        -> (admitted, tok_parts, sample_jobs): the wave in dispatch order,
        each group's first tokens on the device, and (admitted index,
        token, generator) for sampled rows."""
        groups: Dict[tuple, list] = {}
        for entry in wave:
            _, req, n, pk, tail = entry
            if pk is not None:
                sb = _pick_bucket(len(tail), self.prefill_buckets)
                key = ("sfx", pk[0], pk[1], sb)
            else:
                nb = _pick_bucket(n, self.prefill_buckets)
                if req.pixel_values is None:
                    tk = 0
                else:
                    t = int(np.asarray(req.pixel_values).shape[0])
                    tk = (t if self.tile_buckets is None
                          else _pick_bucket(t, self.tile_buckets))
                key = ("full", nb, tk)
            groups.setdefault(key, []).append(entry)

        admitted, tok_parts, sample_jobs = [], [], []
        # stores run after every group, so that a store's eviction cannot
        # drop a prefix another group of this wave matched
        store_jobs = []
        for key, members in groups.items():
            k_real = len(members)
            kb = _pick_bucket(k_real, self._admit_kbuckets)
            # pad by repeating the last request: its rows are dropped at
            # the insert, and every lane's softmax rows stay well formed
            padded = members + [members[-1]] * (kb - k_real)
            tns = np.array([e[2] for e in padded], np.int64)
            if key[0] == "sfx":
                _, pid, plen, sb = key
                ids = np.full((kb, sb), self.pad_token_id, np.int64)
                seg = np.zeros((kb, sb), np.int32)
                tms = np.zeros((kb,), np.int64)
                for i, (_, req, _, _, tail) in enumerate(padded):
                    ids[i, :len(tail)] = tail
                    seg[i, :len(tail)] = 1
                    tms[i] = len(tail)
                small, toks, last = self._prefill_suffix(
                    self._prefixes[pid], plen, self._dev(ids),
                    self._dev(seg, torch.int32), self._dev(tms))
            else:
                _, nb, tk = key
                ids = np.full((kb, nb), self.pad_token_id, np.int64)
                seg = np.zeros((kb, nb), np.int32)
                px_parts, fl_parts = [], []
                for i, (_, req, n, _, _) in enumerate(padded):
                    ids[i, :n] = req.input_ids
                    seg[i, :n] = 1
                    if tk:
                        px = np.asarray(req.pixel_values)
                        t = px.shape[0]
                        if tk > t:
                            px = np.concatenate([px, np.zeros(
                                (tk - t,) + px.shape[1:], px.dtype)], 0)
                        px_parts.append(px)
                        fl_parts.append((np.arange(tk) < t).astype(np.int32))
                pixels = (self._dev(np.concatenate(px_parts, 0),
                                    torch.float32) if tk else None)
                flags = (self._dev(np.concatenate(fl_parts, 0), torch.int32)
                         if tk else None)
                small, toks, last = self._prefill(
                    self._dev(ids), self._dev(seg, torch.int32), pixels,
                    flags, self._dev(tns))
                if self.auto_prefix_block is not None:
                    for i, (_, req, n, _, _) in enumerate(members):
                        store_jobs.append((np.asarray(req.input_ids,
                                                      np.int64),
                                           req.pixel_values, small, i, n))
            self._insert(small, [e[0] for e in members],
                         self._dev(tns[:k_real]))
            for i, (row, req, n, _, _) in enumerate(members):
                if req.temperature > 0.0:
                    gen = torch.Generator(device=self.device)
                    gen.manual_seed(int(req.seed))
                    tok = sample_per_row(
                        last[i:i + 1], [gen],
                        torch.tensor([req.temperature], device=self.device),
                        torch.tensor([req.top_k], device=self.device),
                        torch.tensor([req.top_p], device=self.device),
                        use_k=req.top_k > 0, use_p=req.top_p < 1.0)[0]
                    sample_jobs.append((len(admitted) + i, tok, gen))
            admitted.extend(members)
            tok_parts.append(toks[:k_real])
        for job in store_jobs:
            self._auto_store(*job)
        return admitted, tok_parts, sample_jobs

    @torch.no_grad()
    def _run_pipelined(self, requests: Sequence[Request],
                       use_spec: bool = False,
                       on_token=None) -> List[Completion]:
        """Greedy serving with a software-pipelined scheduler: every row
        state the device needs (tokens / alive / budget and the cache, plus
        the draft history when speculating) chains from chunk to chunk on
        the device; the host queues chunk i+1 before it reads chunk i back,
        then replays chunk i's emissions through the retirement rules.
        Admission lags one chunk (a freed slot refills after the replay
        that finds it). With use_spec, chunks are [B, Kd+1] verify passes
        and the adaptive policy decides a chunk from the EMA as of the
        last replayed speculative chunk."""
        queue = deque(requests)
        B = self.num_slots
        dev = self.device
        slots: list = [None] * B  # None | _PendingSlot | _Slot
        done: List[Completion] = []
        self.reset()
        self.stats = dict(waves=0, groups=0, admitted_rows=0, chunks=0,
                          kcap_sum=0, spec_chunks=0, steps_run=0,
                          steps_live=0)
        tokens = torch.full((B,), self.pad_token_id, dtype=torch.int64,
                            device=dev)
        alive = torch.zeros((B,), dtype=torch.bool, device=dev)
        budget = torch.zeros((B,), dtype=torch.int64, device=dev)
        if use_spec:
            W = self._spec_buf_width
            sbuf = torch.full((B, W), self.pad_token_id, dtype=torch.int64,
                              device=dev)
            stotals = torch.zeros((B,), dtype=torch.int64, device=dev)
        # the host's row state, exact as of the last replayed event
        h_alive = np.zeros((B,), bool)
        inflight: deque = deque()  # ("adm", admitted, readback) |
        #   ("chunk", readback, kcap) | ("spec", readback, kcap, probe_bar)

        def finish(row: int, include_last: bool) -> None:
            self._finish(slots, row, include_last, done, on_token)

        def commit(row, tok) -> bool:
            """One committed token through the retirement rules (the host
            mirror of `_advance`); -> the row is still alive."""
            st = slots[row]
            st.generated.append(st.last_token)
            if on_token is not None:
                on_token(st.req.uid, st.generated[-1])
            st.last_token = int(tok)
            if st.last_token in self.eos:
                finish(row, include_last=False)
                h_alive[row] = False
            elif len(st.generated) + 1 >= st.req.max_new_tokens:
                finish(row, include_last=True)
                h_alive[row] = False
            return h_alive[row]

        def replay(ev) -> None:
            if ev[0] == "adm":
                _, admitted, rb = ev
                toks_h = rb.get()[0]
                for i, (row, req, n, pk, tail) in enumerate(admitted):
                    slots[row] = _Slot(req, int(toks_h[i]), [], prompt_len=n)
                    if slots[row].last_token in self.eos or \
                            req.max_new_tokens <= 1:
                        finish(row, include_last=True)
                    else:
                        h_alive[row] = True
                return
            if ev[0] == "spec":
                _, rb, kcap, probe_bar = ev
                tg, ct = rb.get()
                acc_toks = acc_rowpasses = 0
                for p in range(min(tg.shape[0], kcap)):
                    live = [r for r in range(B)
                            if isinstance(slots[r], _Slot) and h_alive[r]]
                    if live:
                        self.stats["steps_live"] += 1
                        acc_rowpasses += len(live)
                        acc_toks += int(sum(ct[p, r] for r in live))
                    for row in live:
                        for j in range(int(ct[p, row])):
                            if not commit(row, tg[p, row, j]):
                                break
                if acc_rowpasses:
                    a = acc_toks / acc_rowpasses
                    if probe_bar is not None:
                        # a probe: success jumps the EMA to the measured
                        # rate and resets the interval; failure doubles it
                        if a >= probe_bar:
                            self.spec_last_ema = a
                            self._spec_probe_interval = \
                                self.spec_reprobe_every
                        else:
                            self.spec_last_ema = (
                                a if self.spec_last_ema is None
                                else 0.5 * self.spec_last_ema + 0.5 * a)
                            self._spec_probe_interval = min(
                                2 * self._spec_probe_interval,
                                16 * self.spec_reprobe_every)
                    else:
                        self.spec_last_ema = (
                            a if self.spec_last_ema is None
                            else 0.5 * self.spec_last_ema + 0.5 * a)
                self.spec_chunks_run += 1
                return
            _, rb, kcap = ev
            buf = rb.get()[0]  # later chunks are already queued
            for k in range(min(buf.shape[0], kcap)):
                live = False
                for row, st in enumerate(slots):
                    if st is None or isinstance(st, _PendingSlot) or \
                            not h_alive[row]:
                        continue
                    live = True
                    commit(row, buf[k, row])
                self.stats["steps_live"] += live

        def chunks_in_flight() -> int:
            return sum(1 for ev in inflight if ev[0] in ("chunk", "spec"))

        while queue or any(s is not None for s in slots) or inflight:
            # 1) keep the pipeline bounded: replay the oldest events while
            # newer chunks keep the device busy through the readback
            while chunks_in_flight() > self.pipeline_depth:
                replay(inflight.popleft())

            # 2) admit into host-known-free slots (the first tokens are
            # read at this event's replay)
            wave = self._build_wave(queue, slots, use_spec=use_spec)
            if wave:
                admitted, tok_parts, _ = self._dispatch_wave(wave)
                self.stats["waves"] += 1
                self.stats["groups"] += len(tok_parts)
                self.stats["admitted_rows"] += len(admitted)
                off = 0
                for toks in tok_parts:
                    k_real = int(toks.shape[0])
                    grp = admitted[off:off + k_real]
                    rows = self._dev([e[0] for e in grp])
                    mnews = self._dev([e[1].max_new_tokens for e in grp])
                    self._admit_merge(tokens, alive, budget, rows, toks,
                                      mnews)
                    if use_spec:
                        # the draft-history rows: the full prompt from the
                        # host (the prefix ids for prefix-cached tails),
                        # the first token appended on the device
                        hists = np.full((k_real, W), self.pad_token_id,
                                        np.int64)
                        hlens = np.zeros((k_real,), np.int64)
                        for i, (_, req, n, pk, tail) in enumerate(grp):
                            full = (np.concatenate([
                                self._prefixes[pk[0]]["ids"][:pk[1]],
                                np.asarray(tail, np.int64)])
                                if pk is not None
                                else np.asarray(req.input_ids, np.int64))
                            hists[i, :len(full)] = full
                            hlens[i] = len(full)
                        hl = self._dev(hlens)
                        sbuf[rows] = self._dev(hists)
                        sbuf[rows, hl] = toks
                        stotals[rows] = hl + 1
                    off += k_real
                for row, req, n, pk, tail in admitted:
                    slots[row] = _PendingSlot(req)
                inflight.append(("adm", admitted,
                                 Readback(torch.cat(tok_parts))))

            # 3) queue the next chunk off the device-resident state; a
            # pending admission counts as alive (its device merge applied
            # the first-token rule the replay will apply)
            rems, any_live = [], False
            for row, st in enumerate(slots):
                if isinstance(st, _PendingSlot):
                    any_live = True
                    rems.append(st.req.max_new_tokens - 1)
                elif st is not None and h_alive[row]:
                    any_live = True
                    rems.append(st.req.max_new_tokens
                                - (len(st.generated) + 1))
            if any_live:
                caps = [r for r in rems if r >= 1]
                # with requests waiting, sync near the earliest possible
                # retirement so that freed slots refill promptly
                kcap = max(1, min(min(caps) if (queue and caps)
                                  else self.chunk_size, self.chunk_size))
                run_spec = use_spec
                probe_bar = None
                if use_spec and self.speculative_adaptive:
                    thresh = self.spec_threshold_base + \
                        self.spec_threshold_slope * len(caps)
                    ema = self.spec_last_ema
                    if ema is None or ema < thresh:
                        if (ema is not None and self._spec_plain_streak
                                < self._spec_probe_interval):
                            run_spec = False
                        else:
                            # a bounded probe: 1 verify pass at more than
                            # half occupancy, 2 otherwise
                            probe_bar = thresh
                            kcap = min(kcap, 1 if len(caps)
                                       > self.num_slots // 2 else 2)
                self.stats["chunks"] += 1
                self.stats["kcap_sum"] += kcap
                if run_spec:
                    self.stats["spec_chunks"] += 1
                    tg, ct, stotals, tokens, alive, budget = \
                        self._decode_chunk_spec(sbuf, stotals, tokens, alive,
                                                budget, kcap)
                    self._spec_plain_streak = 0
                    inflight.append(("spec", Readback(tg, ct), kcap,
                                     probe_bar))
                elif use_spec:
                    self._spec_plain_streak += 1
                    self.plain_chunks_run += 1
                    buf, stotals, tokens, alive, budget = \
                        self._decode_chunk_hist(sbuf, stotals, tokens, alive,
                                                budget, kcap)
                    inflight.append(("chunk", Readback(buf), kcap))
                else:
                    buf, tokens, alive, budget = self._decode_chunk(
                        tokens, alive, budget, kcap)
                    inflight.append(("chunk", Readback(buf), kcap))
            elif inflight:
                # nothing runnable until an event lands: drain one
                replay(inflight.popleft())
        return done

    def run(self, requests: Sequence[Request],
            on_token=None) -> List[Completion]:
        """Serve every request to completion; -> completions in the order
        they finish (sort by uid for submission order).

        on_token: optional `(uid, token_id)` callback fired for every
        committed token at host-replay time; the streamed sequence of a uid
        equals its Completion.token_ids (EOS never emitted, retirement
        trims applied). It runs on the scheduler's thread."""
        for req in requests:
            if req.max_new_tokens < 1:
                raise ValueError(
                    f"request {req.uid}: max_new_tokens must be >= 1, "
                    f"got {req.max_new_tokens}")
        sampled_run = any(r.temperature > 0.0 for r in requests)
        # speculation accelerates greedy decode only
        use_spec = self.spec_draft_len > 0 and not sampled_run
        if not sampled_run:
            return self._run_pipelined(requests, use_spec=use_spec,
                                       on_token=on_token)
        return self._run_sampled(requests, on_token)

    @torch.no_grad()
    def _run_sampled(self, requests, on_token) -> List[Completion]:
        """The blocking loop of a run with sampled requests: admit a wave,
        read its first tokens, run one chunk for every occupied slot, read
        it back, replay it."""
        queue = deque(requests)
        B = self.num_slots
        slots: List[Optional[_Slot]] = [None] * B
        done: List[Completion] = []
        self.reset()
        self.stats = dict(steps_run=0)

        def finish(row: int, include_last: bool) -> None:
            self._finish(slots, row, include_last, done, on_token)

        while queue or any(s is not None for s in slots):
            # 1) admit waiting requests into free slots (grouped batched
            # prefills); the wave's first tokens come back in one read
            wave = self._build_wave(queue, slots, False)
            admitted, tok_parts, sample_jobs = self._dispatch_wave(wave)
            if admitted:
                wave_toks = torch.cat(tok_parts)
                gens = {}
                for idx, tok, gen in sample_jobs:
                    wave_toks[idx] = tok
                    gens[idx] = gen
                wave_toks = wave_toks.tolist()
                for i, (row, req, n, pk, tail) in enumerate(admitted):
                    tok = int(wave_toks[i])
                    slots[row] = _Slot(req, tok, [], gens.get(i),
                                       prompt_len=n)
                    if tok in self.eos or req.max_new_tokens <= 1:
                        finish(row, include_last=True)
            if not any(s is not None for s in slots):
                continue

            # 2) one decode chunk for every occupied slot
            tokens = np.full((B,), self.pad_token_id, np.int64)
            alive = np.zeros((B,), bool)
            budget = np.zeros((B,), np.int64)
            temps = np.zeros((B,), np.float32)
            top_ks = np.zeros((B,), np.int64)
            top_ps = np.ones((B,), np.float32)
            gens = [None] * B
            for row, st in enumerate(slots):
                if st is not None:
                    tokens[row] = st.last_token
                    alive[row] = True
                    budget[row] = st.req.max_new_tokens - (
                        len(st.generated) + 1)
                    if st.rng is not None:
                        gens[row] = st.rng
                        temps[row] = st.req.temperature
                        top_ks[row] = st.req.top_k
                        top_ps[row] = st.req.top_p
            # with requests waiting, sync at the earliest budget retirement;
            # otherwise run to the last one
            rem = budget[alive]
            kcap = max(1, min(int(rem.min()) if queue else int(rem.max()),
                              self.chunk_size))
            params = (self._dev(temps, torch.float32), self._dev(top_ks),
                      self._dev(top_ps, torch.float32))
            # a filter no live row asks for is skipped (same tokens)
            use = dict(use_k=bool((top_ks > 0).any()),
                       use_p=bool((top_ps < 1.0).any()))
            out = torch.zeros((self.chunk_size, B), dtype=torch.int64,
                              device=self.device)
            st_dev = [self._dev(tokens), self._dev(alive, torch.bool),
                      self._dev(budget)]

            def body(step):
                lg = self._one_step(st_dev[0], st_dev[1])
                nxt = sample_per_row(lg, gens, *params, **use)
                out[step] = nxt
                st_dev[:] = self._advance(*st_dev, nxt)
                return st_dev[1]

            self._chunk_loop(kcap, st_dev[1], body)
            toks = out.cpu().numpy()

            # 3) replay the chunk through the retirement rules (the device's
            # _advance), only the kcap rows the device ran
            for k in range(min(toks.shape[0], kcap)):
                for row, st in enumerate(slots):
                    if st is None or not alive[row]:
                        continue
                    st.generated.append(st.last_token)
                    if on_token is not None:
                        on_token(st.req.uid, st.generated[-1])
                    st.last_token = int(toks[k, row])
                    if st.last_token in self.eos:
                        finish(row, include_last=False)
                        alive[row] = False
                    elif len(st.generated) + 1 >= st.req.max_new_tokens:
                        finish(row, include_last=True)
                        alive[row] = False
        return done
