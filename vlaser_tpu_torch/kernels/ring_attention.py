"""Ring attention: context-parallel attention over a process group (port of
vlaser_tpu/kernels/ring_attention.py; no jax).

The sequence dim is split over the ranks of a `context` group; K/V chunks
travel around the ring over torch.distributed P2P (`batch_isend_irecv`,
one hop a step, rank j sending to j + 1 mod n, JAX's ppermute), and each
rank folds the chunk it holds into its queries' online softmax. The
backward reruns the ring in mirror: dq accumulates at home while dk / dv
travel with their k / v chunk and arrive home after n hops.

Semantics are kernels/flash_attention's (GQA, causal on global positions,
packed segment ids with 0 = padding, VLA levels, softcap), without the
sliding window. A row with no allowed key in any chunk gives 0.

The chunk step has two routes, by the device of q:
- CPU: the eager copy of JAX's `_chunk_parts` and backward body in fp32
  (an explicit [B, Sq, Sk] mask over global positions; partials (sum p v,
  row max, row sum) merged online).
- CUDA: the port's flash kernels. `flash_attention_fwd` gives each
  (q block, kv block) pair's out and lse, merged by their lse;
  `flash_attention_bwd` takes the rank's merged out and lse (its global
  ones) and gives the pair's dq, dk, dv. A contiguous chunk is one block,
  a zigzag slice two half-blocks; a pair's causal mask is the kernel's
  scalar q_offset (the blocks' start positions' difference), and a pair
  the causal mask leaves empty is skipped (its merge weight is 0). A
  chunk's memory stays O(S / n); no [Sq, Sk] logits exist.

Entry points:
- `ring_attention(q, k, v, group=...)`: per rank, on its slice.
- `context_parallel_attention(q, k, v, group=...)`: the logical sequence
  in and out (each rank takes its slice, the outputs are all-gathered; the
  gradients of the inputs are all-gathered in the backward).
- `virtual_ring(...)`: every rank of an n-rank ring in one process: the
  same per-rank loops, driven in lockstep with the chunks handed over in
  memory instead of over P2P (the card's check of the chunk route, where
  one machine holds one card).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .flash_attention import (LEVEL_BITS, LEVEL_MASK, flash_attention_bwd,
                              flash_attention_fwd, pack_meta)

NEG_INF = -1e30


def _chunk_mask(q_meta, kv_meta, q_pos, kv_pos, causal):
    """[B, Sq, Sk] bool mask between a q chunk and a kv chunk with explicit
    global positions (q_pos [Sq], kv_pos [Sk]): segment-equal, segment 0
    = padding, kv_level <= q_level, causal on the global positions."""
    q_seg, k_seg = q_meta >> LEVEL_BITS, kv_meta >> LEVEL_BITS
    allowed = (q_seg[:, :, None] == k_seg[:, None, :]) & (k_seg != 0)[:, None]
    allowed &= ((kv_meta & LEVEL_MASK)[:, None, :]
                <= (q_meta & LEVEL_MASK)[:, :, None])
    if causal:
        allowed &= (q_pos[:, None] >= kv_pos[None, :])[None]
    return allowed


def _blocks(rank: int, n: int, chunk: int, layout: str):
    """[(start row in the rank's slice, global start position, length)]:
    'contiguous' slice r holds [r * chunk, (r + 1) * chunk); 'zigzag'
    slice r holds half-blocks r and 2n - 1 - r (RingAttention's causal
    load balance)."""
    if layout == "contiguous":
        return [(0, rank * chunk, chunk)]
    if layout != "zigzag":
        raise ValueError(f"unknown ring layout {layout!r}")
    half = chunk // 2
    return [(0, rank * half, half), (half, (2 * n - 1 - rank) * half, half)]


def _positions(rank, n, chunk, layout, device=None):
    """Global positions [chunk] of a rank's sequence slice."""
    return torch.cat([torch.arange(g, g + m, device=device)
                      for _, g, m in _blocks(rank, n, chunk, layout)])


def _zig_positions(rank, n, chunk, device=None):
    return _positions(rank, n, chunk, "zigzag", device)


def zigzag_indices(n: int, seq_len: int):
    """Permutation taking a contiguous [S] sequence to the zigzag layout
    (rank r gets half-blocks r and 2n - 1 - r) and its inverse."""
    half = seq_len // (2 * n)
    order = []
    for r in range(n):
        order.extend(range(r * half, (r + 1) * half))
        order.extend(range((2 * n - 1 - r) * half, (2 * n - r) * half))
    fwd = np.asarray(order, np.int64)
    inv = np.empty_like(fwd)
    inv[fwd] = np.arange(seq_len, dtype=np.int64)
    return fwd, inv


def _chunk_parts(q, k, v, mask, scale, softcap):
    """Unnormalized partials of one kv chunk (fp32): q [B, Sq, H, D], k / v
    [B, Sk, KVH, D], mask [B, Sq, Sk] -> (o_un [B, Sq, H, D] = sum p v in
    the chunk-max frame, m [B, H, Sq] row max, l [B, H, Sq] row sum)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, sq, kvh, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf * scale, k.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    m5 = mask[:, None, None]
    logits = torch.where(m5, logits, NEG_INF)
    m = logits.amax(-1)
    p = torch.where(m5, torch.exp(logits - m[..., None]), 0.0)
    o_un = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return (o_un.reshape(b, sq, h, d), m.reshape(b, h, sq),
            p.sum(-1).reshape(b, h, sq))


def _chunk_grads(q, k, v, mask, lse, delta, dout, scale, softcap):
    """JAX's backward body for one kv chunk (fp32) -> (dq, dk, dv)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, sq, kvh, g, d)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(b, sq, kvh, g, d)
    raw = torch.einsum("bqkgd,bskd->bkgqs", qf * scale, kf)
    t = None
    if softcap is not None:
        t = torch.tanh(raw / softcap)
        raw = softcap * t
    m5 = mask[:, None, None]
    logits = torch.where(m5, raw, NEG_INF)
    p = torch.where(m5, torch.exp(logits - lse.reshape(b, kvh, g, sq, 1)),
                    0.0)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, vf)
    ds = p * (dp - delta.reshape(b, kvh, g, sq, 1))
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return dq.reshape(b, sq, h, d), dk, dv


def _pairs(rank, src, n, chunk, layout, causal):
    """The (q block, kv block) pairs of a chunk step that the causal mask
    leaves non-empty, each (q rows, kv rows, q_offset): slices of the
    rank's q slice and of the chunk, and the kernel's causal offset."""
    out = []
    for qs, qg, qm in _blocks(rank, n, chunk, layout):
        for ks, kg, km in _blocks(src, n, chunk, layout):
            if causal and qg + qm - 1 < kg:
                continue
            out.append((slice(qs, qs + qm), slice(ks, ks + km), qg - kg))
    return out


def _kernel_route(q) -> bool:
    """Whether the chunk steps take the flash kernels (a CUDA q). The CPU
    tests patch it to run the kernel route's blocks and lse merge on the
    kernels' plain versions."""
    return q.is_cuda


class _State:
    """A rank's running forward state: (acc, m, l) on the CPU route (JAX's
    frame), (out, lse) on the CUDA route (lse merge)."""

    def __init__(self, q):
        b, sq, h, d = q.shape
        self.cuda = _kernel_route(q)
        f32 = torch.float32
        self.acc = q.new_zeros((b, sq, h, d), dtype=f32)
        self.m = q.new_full((b, h, sq), NEG_INF, dtype=f32)
        self.l = q.new_zeros((b, h, sq), dtype=f32)

    def finish(self, dtype):
        """-> (out in dtype, lse [B, H, Sq] fp32)."""
        if self.cuda:  # acc is the normalized out, m the running lse
            return self.acc.to(dtype), self.m
        safe = self.l.clamp_min(1e-37)
        out = self.acc / safe.transpose(1, 2)[..., None]
        return out.to(dtype), self.m + torch.log(safe)


def _fwd_step(st: _State, q, kc, vc, q_meta, kvm, rank, src, n, layout,
              causal, scale, softcap):
    """Fold kv chunk `src` into rank `rank`'s running state."""
    chunk = q.shape[1]
    if not st.cuda:
        mask = _chunk_mask(q_meta, kvm,
                           _positions(rank, n, chunk, layout, q.device),
                           _positions(src, n, chunk, layout, q.device),
                           causal)
        o_un, mc, lc = _chunk_parts(q, kc, vc, mask, scale, softcap)
        m_new = torch.maximum(st.m, mc)
        alpha, beta = torch.exp(st.m - m_new), torch.exp(mc - m_new)
        st.acc = (st.acc * alpha.transpose(1, 2)[..., None]
                  + o_un * beta.transpose(1, 2)[..., None])
        st.l = st.l * alpha + lc * beta
        st.m = m_new
        return
    for qs, ks, off in _pairs(rank, src, n, chunk, layout, causal):
        o, lse = flash_attention_fwd(
            q[:, qs], kc[:, ks], vc[:, ks], q_meta[:, qs], kvm[:, ks],
            q_offset=off if causal else 0, causal=causal, scale=scale,
            softcap=softcap)
        run = st.m[:, :, qs]
        new = torch.logaddexp(run, lse)
        a = torch.exp(run - new).transpose(1, 2)[..., None]
        c = torch.exp(lse - new).transpose(1, 2)[..., None]
        st.acc[:, qs] = st.acc[:, qs] * a + o.float() * c
        st.m[:, :, qs] = new


def _bwd_step(q, kc, vc, q_meta, kvm, out, lse, delta, dout, rank, src, n,
              layout, causal, scale, softcap):
    """Chunk `src`'s share of rank `rank`'s backward -> (dq, dk, dv) fp32,
    dk / dv of the chunk's rows."""
    chunk = q.shape[1]
    if not _kernel_route(q):
        mask = _chunk_mask(q_meta, kvm,
                           _positions(rank, n, chunk, layout, q.device),
                           _positions(src, n, chunk, layout, q.device),
                           causal)
        return _chunk_grads(q, kc, vc, mask, lse, delta, dout, scale, softcap)
    dq = q.new_zeros(q.shape, dtype=torch.float32)
    dk = kc.new_zeros(kc.shape, dtype=torch.float32)
    dv = vc.new_zeros(vc.shape, dtype=torch.float32)
    for qs, ks, off in _pairs(rank, src, n, chunk, layout, causal):
        gq, gk, gv = flash_attention_bwd(
            q[:, qs], kc[:, ks], vc[:, ks], q_meta[:, qs], kvm[:, ks],
            off if causal else 0, out[:, qs], lse[:, :, qs].contiguous(),
            dout[:, qs].contiguous(), causal=causal, scale=scale,
            softcap=softcap)
        dq[:, qs] += gq.float()
        dk[:, ks] += gk.float()
        dv[:, ks] += gv.float()
    return dq, dk, dv


def _delta(out, dout):
    """rowsum(dO * O) -> [B, H, Sq] fp32 (the CPU route's; the CUDA
    backward kernel takes its own)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2)


# A rank's ring, forward or backward, is one generator (`_fwd_loop`,
# `_bwd_loop`) that a transport drives: it yields ("start", kind, chunk,
# tensors) to hand `tensors` (chunk `chunk`'s k / v / meta, or the dk / dv
# travelling with it) to the next rank, and gets a handle back; then
# ("finish", handle) to get the previous rank's tensors of the same kind,
# chunk - 1's. `_p2p` drives one rank over torch.distributed; `_lockstep`
# drives every rank of a ring in one process (virtual_ring).

class _Ring:
    """The ring's neighbours in a process group."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        ranks = dist.get_process_group_ranks(group)
        self.next = ranks[(self.rank + 1) % self.n]
        self.prev = ranks[(self.rank - 1) % self.n]

    def start(self, tensors: List[torch.Tensor]):
        """Send `tensors` to the next rank and receive the previous
        rank's; -> (requests, receive buffers)."""
        import torch.distributed as dist

        bufs = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, buf in zip(tensors, bufs):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self.next,
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, buf, self.prev, self.group))
        return dist.batch_isend_irecv(ops), bufs

    @staticmethod
    def finish(pending):
        reqs, bufs = pending
        for r in reqs:
            r.wait()
        return bufs


def _p2p(ring: _Ring, loop):
    """Drive one rank's loop over P2P; -> its result."""
    reply = None
    while True:
        try:
            msg = loop.send(reply)
        except StopIteration as done:
            return done.value
        reply = (ring.start(msg[3]) if msg[0] == "start"
                 else _Ring.finish(msg[1]))


def _lockstep(loops, n, chunk_of):
    """Drive the loops {rank: generator} of an n-rank ring in one process,
    one message of every rank a round (every rank yields the same
    sequence), a start's tensors handed to the next rank; -> {rank:
    result}. A rank missing from `loops` still sends: chunk_of(c) its k /
    v / meta chunk, zeros for a dk / dv (so a lone rank runs exactly its
    own steps, its dk / dv then without the other ranks' shares)."""
    replies = {r: None for r in loops}
    sent, done = {}, {}
    while len(done) < len(loops):
        for r, loop in loops.items():
            if r in done:
                continue
            try:
                msg = loop.send(replies[r])
            except StopIteration as out:
                done[r] = out.value
                continue
            if msg[0] == "start":
                _, kind, c, tensors = msg
                sent[(r, kind, c)] = tensors
                replies[r] = (kind, (c - 1) % n, tensors)
                continue
            kind, c, own = msg[1]
            prev = (r - 1) % n
            if prev in loops:
                replies[r] = sent.pop((prev, kind, c))
            elif kind == "kv":
                replies[r] = chunk_of(c)
            else:
                replies[r] = [torch.zeros_like(t) for t in own]
    return done


def _fwd_loop(q, k, v, q_meta, kv_meta, causal, scale, softcap, rank, n,
              layout):
    """Rank `rank`'s forward: n chunk steps; -> (out, lse)."""
    st = _State(q)
    kc, vc, kvm = k, v, kv_meta
    for j in range(n):
        src = (rank - j) % n
        pending = ((yield ("start", "kv", src, [kc, vc, kvm]))
                   if j < n - 1 else None)
        _fwd_step(st, q, kc, vc, q_meta, kvm, rank, src, n, layout, causal,
                  scale, softcap)
        if pending is not None:
            kc, vc, kvm = yield ("finish", pending)
    return st.finish(q.dtype)


def _bwd_loop(q, k, v, q_meta, kv_meta, out, lse, dout, causal, scale,
              softcap, rank, n, layout):
    """Rank `rank`'s backward, the forward's ring in mirror; -> (dq, dk,
    dv), dk / dv of the rank's own chunk (home after n hops)."""
    delta = None if _kernel_route(q) else _delta(out, dout)
    dq = q.new_zeros(q.shape, dtype=torch.float32)
    dk = k.new_zeros(k.shape, dtype=torch.float32)
    dv = v.new_zeros(v.shape, dtype=torch.float32)
    kc, vc, kvm = k, v, kv_meta
    for j in range(n):
        src = (rank - j) % n
        # k / v / meta move on before this step's grads are added; dk / dv
        # move after, so they travel with their chunk and end at home
        pending = ((yield ("start", "kv", src, [kc, vc, kvm]))
                   if j < n - 1 else None)
        gq, gk, gv = _bwd_step(q, kc, vc, q_meta, kvm, out, lse, delta,
                               dout, rank, src, n, layout, causal, scale,
                               softcap)
        dq += gq
        dk += gk
        dv += gv
        if n > 1:
            moved = yield ("start", "dkv", src, [dk, dv])
            dk, dv = yield ("finish", moved)
        if pending is not None:
            kc, vc, kvm = yield ("finish", pending)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_meta, kv_meta, causal, scale, softcap, ring,
                layout):
        out, lse = _p2p(ring, _fwd_loop(q, k, v, q_meta, kv_meta, causal,
                                        scale, softcap, ring.rank, ring.n,
                                        layout))
        ctx.save_for_backward(q, k, v, q_meta, kv_meta, out, lse)
        ctx.args = (causal, scale, softcap, ring, layout)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_meta, kv_meta, out, lse = ctx.saved_tensors
        causal, scale, softcap, ring, layout = ctx.args
        dq, dk, dv = _p2p(ring, _bwd_loop(
            q, k, v, q_meta, kv_meta, out, lse, dout.contiguous(), causal,
            scale, softcap, ring.rank, ring.n, layout))
        return dq, dk, dv, None, None, None, None, None, None, None


def _metas(b, s, device, q_segment_ids, kv_segment_ids, q_levels,
           kv_levels):
    if q_segment_ids is None:
        q_segment_ids = torch.ones((b, s), dtype=torch.int32, device=device)
    if kv_segment_ids is None:
        kv_segment_ids = q_segment_ids
    return (pack_meta(q_segment_ids, q_levels),
            pack_meta(kv_segment_ids, kv_levels))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group=None, q_segment_ids=None, kv_segment_ids=None,
                   q_levels=None, kv_levels=None, causal: bool = False,
                   scale: Optional[float] = None,
                   softcap: Optional[float] = None,
                   layout: str = "contiguous") -> torch.Tensor:
    """Per-rank ring attention over `group` (the default group when None):
    q [B, S_local, H, D], k / v [B, S_local, KVH, D] and the metadata are
    this rank's equal-length slice; layout 'contiguous' means slice i =
    global positions [i S_local, (i + 1) S_local), 'zigzag' slice i =
    half-blocks i and 2n - 1 - i (permute with zigzag_indices first)."""
    b, s, _, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    q_meta, kv_meta = _metas(b, s, q.device, q_segment_ids, kv_segment_ids,
                             q_levels, kv_levels)
    return _RingFn.apply(q, k, v, q_meta, kv_meta, causal, scale, softcap,
                         _Ring(group), layout)


class _Split(torch.autograd.Function):
    """The rank's slice of a tensor every rank holds whole; the backward
    all-gathers the slices' gradients (every rank's loss is the same)."""

    @staticmethod
    def forward(ctx, x, index, n, group):
        ctx.args = (n, group)
        c = x.shape[1] // n
        return x[:, index * c:(index + 1) * c].contiguous()

    @staticmethod
    def backward(ctx, g):
        n, group = ctx.args
        return _all_gather(g.contiguous(), n, group), None, None, None


class _Gather(torch.autograd.Function):
    """All ranks' slices -> the whole tensor; the backward keeps the rank's
    slice of the gradient."""

    @staticmethod
    def forward(ctx, x, index, n, group):
        ctx.args = (index, x.shape[1])
        return _all_gather(x.contiguous(), n, group)

    @staticmethod
    def backward(ctx, g):
        index, c = ctx.args
        return g[:, index * c:(index + 1) * c], None, None, None


def _all_gather(x, n, group):
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, 1)


def context_parallel_attention(q, k, v, *, group=None, q_segment_ids=None,
                               kv_segment_ids=None, q_levels=None,
                               kv_levels=None, causal: bool = False,
                               scale: Optional[float] = None,
                               softcap: Optional[float] = None,
                               layout: str = "contiguous") -> torch.Tensor:
    """The logical sequence in and out: q [B, S, H, D] (k / v, metadata
    alike) held whole by every rank of `group`; each rank runs the ring on
    its slice and the slices' outputs are gathered. layout 'zigzag'
    permutes the sequence into interleaved half-blocks before the ring and
    back after (with a causal mask every rank then carries an equal share
    of the lower triangle)."""
    import torch.distributed as dist

    n, index = dist.get_world_size(group), dist.get_rank(group)
    b, s = q.shape[:2]
    if q_segment_ids is None:
        q_segment_ids = torch.ones((b, s), dtype=torch.int32, device=q.device)
    if kv_segment_ids is None:
        kv_segment_ids = q_segment_ids
    metas = [q_segment_ids, kv_segment_ids, q_levels, kv_levels]
    inv = None
    if layout == "zigzag":
        assert s % (2 * n) == 0, (s, n)
        fwd_ix, inv_ix = zigzag_indices(n, s)
        fwd_ix = torch.as_tensor(fwd_ix, device=q.device)
        inv = torch.as_tensor(inv_ix, device=q.device)
        q, k, v = (x.index_select(1, fwd_ix) for x in (q, k, v))
        metas = [None if m is None else m.index_select(1, fwd_ix)
                 for m in metas]
    c = s // n
    part = lambda m: None if m is None else m[:, index * c:(index + 1) * c]
    out = ring_attention(
        *(_Split.apply(x, index, n, group) for x in (q, k, v)), group=group,
        q_segment_ids=part(metas[0]), kv_segment_ids=part(metas[1]),
        q_levels=part(metas[2]), kv_levels=part(metas[3]), causal=causal,
        scale=scale, softcap=softcap, layout=layout)
    out = _Gather.apply(out, index, n, group)
    return out if inv is None else out.index_select(1, inv)


def virtual_ring(q, k, v, n: int, *, dout=None, q_segment_ids=None,
                 kv_segment_ids=None, q_levels=None, kv_levels=None,
                 causal: bool = False, scale: Optional[float] = None,
                 softcap: Optional[float] = None,
                 layout: str = "contiguous", ranks=None):
    """An n-rank ring in one process: q / k / v [B, S, ...] the logical
    sequence (in `layout`'s order: zigzag_indices applied by the caller);
    every virtual rank runs the ring's own loops (`_fwd_loop`, and given
    `dout` `_bwd_loop`), driven in lockstep, chunks and dk / dv handed to
    the next rank in memory. -> {"out", "lse", and given dout "dq", "dk",
    "dv": {rank: its result}} (dk / dv of the rank's own chunk).
    `ranks`: run only these virtual ranks, each one still complete (the
    others' k / v chunks stand in; dk / dv then lack their shares)."""
    b, s, _, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    q_meta, kv_meta = _metas(b, s, q.device, q_segment_ids, kv_segment_ids,
                             q_levels, kv_levels)
    c = s // n
    sl = lambda x, r: x[:, r * c:(r + 1) * c]
    chunk_of = lambda r: [sl(k, r), sl(v, r), sl(kv_meta, r)]
    ranks = range(n) if ranks is None else ranks
    fwd = _lockstep({r: _fwd_loop(sl(q, r), sl(k, r), sl(v, r),
                                  sl(q_meta, r), sl(kv_meta, r), causal,
                                  scale, softcap, r, n, layout)
                     for r in ranks}, n, chunk_of)
    res = {"out": {r: o for r, (o, _) in fwd.items()},
           "lse": {r: lse for r, (_, lse) in fwd.items()}}
    if dout is None:
        return res
    bwd = _lockstep({r: _bwd_loop(sl(q, r), sl(k, r), sl(v, r),
                                  sl(q_meta, r), sl(kv_meta, r),
                                  res["out"][r], res["lse"][r],
                                  sl(dout, r).contiguous(), causal, scale,
                                  softcap, r, n, layout)
                     for r in ranks}, n, chunk_of)
    for i, key in enumerate(("dq", "dk", "dv")):
        res[key] = {r: g[i] for r, g in bwd.items()}
    return res
