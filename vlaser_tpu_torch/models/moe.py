"""Sparse Mixture-of-Experts MLP with Qwen3-MoE semantics (port of
vlaser_tpu/models/moe.py).

- Routing in fp32, as HF `Qwen3MoeSparseMoeBlock`: softmax over the router
  logits, top-k of the probabilities, optional renormalization
  (`norm_topk_prob`).
- Dispatch is the JAX package's scatter/gather: each (token, slot) writes
  its activation into an [E, C, H] buffer at its position within its
  expert (a cumsum over the slots in token-major order, so earlier tokens
  win capacity); the experts run as one batched gate/up/down product; each
  token gathers its k results back and sums them with its fp32 weights,
  then casts to the activation dtype.
- Capacity: `moe_capacity_factor=None` is lossless (C = T, HF parity);
  otherwise C = min(max(k, int(factor * T * k / E)), T), where T is the
  tokens of one call. A slot past C is dropped: it writes zeros into row
  C - 1 of its expert and combines with weight 0. C depends on T, so with
  a factor the output of a token depends on the other tokens of its call
  (how a prompt is chunked), as in JAX.
- Over batch ranks (`batch`, a BatchRanks that train/train_step.
  shard_train_state sets on a stack trained over data x fsdp x context:
  serving feeds every rank the same rows and sets none) a call
  is one rank's block of the global batch, which JAX's GSPMD step routes
  as one call: with a factor, T is the global token count (this rank's T
  times the batch ranks) and a slot's position within its expert is its
  global token-major position, this rank's exclusive cumsum plus the
  slots routed there from the global batch's earlier tokens (one
  all-gather of each row's [E] counts a layer; batch order is data-major,
  then fsdp, then context, as core/mesh.batch_shard and context_slice lay
  the rows and their slices out), so a rank keeps and drops exactly the
  slots one device does. The buffer keeps this rank's min(C, T) rows.
- The load-balancing loss (HF `load_balancing_loss_func`): each call of a
  layer yields router_f (the mean over tokens of the top-k one-hot counts,
  summed over the slots) and router_p (the mean softmax probability), both
  [E]. The JAX module sows them into `intermediates`; here a caller that
  wants them opens `collect_router_stats(model)`, and `router_aux_loss`
  combines a stack's [L, E] vectors. They are this call's means; over
  batch ranks train/losses.make_sft_loss takes the global batch's
  (router_f all-reduced, router_p a rank's share of the mean).

Weights keep the JAX names and layout, stacked [L, ...] as the port's
other layer weights: `gate` [L, H, E], `experts_gate_proj` /
`experts_up_proj` [L, E, H, F], `experts_down_proj` [L, E, F, H]. None is
named `kernel`, so the serving quantizer leaves them float, as the JAX one
does. The batched product is `torch.bmm` (the JAX package computes it in
XLA, outside any Pallas kernel).

Expert parallelism (a stack cut over the tensor axis by
core/tensor_parallel, its `tp` split holding experts lo:hi): the router
stays whole and fp32, so every rank routes, places and drops every slot
as one device does; a rank runs its own experts' rows of the buffer and
combines the slots routed to them, and the partial sums are all-reduced
over the tensor group (fp32) before the cast. In training the dispatch's
input and the slots' weights pass through the split's `enter` (identity
forward, all-reduce backward): each rank's experts and combine see only
part of them, so their gradients are summed over the group, while the
router's own read of the input and the aux loss's probabilities are
whole on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import Block


def router_aux_loss(router_f: torch.Tensor,
                    router_p: torch.Tensor) -> torch.Tensor:
    """HF load_balancing_loss_func over a stack's vectors: router_f /
    router_p [L, E] (or [E]) -> E * sum_e mean_L(f) * mean_L(p), a 0-dim
    fp32 tensor (HF concatenates every layer's logits before averaging,
    which equals this layer mean)."""
    f = torch.atleast_2d(router_f).mean(0)
    p = torch.atleast_2d(router_p).mean(0)
    return f.shape[-1] * (f * p).sum()


def capacity(cfg, tokens: int) -> int:
    """The slots a expert holds in a call of `tokens` tokens."""
    if cfg.moe_capacity_factor is None:
        return tokens  # lossless: an expert can at most receive every token
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    return min(max(k, int(cfg.moe_capacity_factor * tokens * k / E)), tokens)


@dataclasses.dataclass(frozen=True)
class BatchRanks:
    """The ranks that hold the other blocks of a MoE stack's global batch:
    `group` (None: the default group) of `size` ranks in batch order,
    `context` of them each holding a slice of the same rows."""
    group: object
    size: int
    context: int = 1


def prior_slots(oh: torch.Tensor, rows: int, batch: BatchRanks
                ) -> torch.Tensor:
    """oh [T k, E]: this rank's slots' one-hot experts in token-major
    order, `rows` rows of T / rows tokens. -> [rows, E]: the slots routed
    to each expert from the global batch's tokens ahead of each row's
    first token here (earlier row blocks; this block's earlier rows on
    the other context slices; this row on the earlier slices), less
    this rank's own earlier rows (its cumsum counts those)."""
    import torch.distributed as dist

    E = oh.shape[-1]
    counts = oh.reshape(rows, -1, E).sum(1)
    parts = [torch.empty_like(counts) for _ in range(batch.size)]
    dist.all_gather(parts, counts.contiguous(), group=batch.group)
    every = torch.stack(parts).reshape(batch.size // batch.context,
                                       batch.context, rows, E)
    block, c = divmod(dist.get_rank(batch.group), batch.context)
    here = every[block]  # [context, rows, E]
    before = lambda t: torch.cumsum(t, 0) - t  # over the rows
    return (every[:block].sum((0, 1, 2)) + before(here.sum(0))
            - before(here[c]) + here[:c].sum(0))


def moe_forward(cfg, x: torch.Tensor, gate, wg, wu, wd,
                compute_dtype, tp=None, batch: Optional[BatchRanks] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One MoE layer on x [B, S, H] with one layer's weights -> (y [B, S, H]
    in x's dtype, router_f [E], router_p [E]). tp: the expert-parallel
    split (wg / wu / wd then hold experts tp.lo:tp.hi). batch: the batch
    ranks whose global batch the capacity counts (the module docstring)."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    b, s, H = x.shape
    T = b * s
    xt = x.reshape(T, H)
    probs = torch.softmax(xt.float() @ gate.float(), dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    if cfg.norm_topk_prob:
        topw = topw / topw.sum(-1, keepdim=True)
    router_f = F.one_hot(topi, E).float().sum(1).mean(0)
    router_p = probs.mean(0)

    flat_e = topi.reshape(T * k)  # slot order (t0 s0), (t0 s1), (t1 s0)...
    # each slot's position within its expert: the earlier slots routed there
    oh = F.one_hot(flat_e, E)
    pos = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1)
    if (batch is not None and batch.size > 1
            and cfg.moe_capacity_factor is not None):
        C = capacity(cfg, T * batch.size)
        ahead = prior_slots(oh, b, batch)
        keep = pos + ahead[torch.arange(T * k, device=x.device) // (s * k),
                           flat_e] < C
        C = min(C, T)  # a kept slot's position here is below both
    else:
        C = capacity(cfg, T)
        keep = pos < C
    cd = compute_dtype
    # the dispatch's input: entered, as a rank's experts see part of it
    # (the router above reads it whole on every rank)
    xd = xt if tp is None else tp.enter(xt)
    xk = xd.to(cd).repeat_interleave(k, 0) * keep[:, None].to(cd)
    safe_pos = torch.where(keep, pos, C - 1)
    buf = xk.new_zeros((E, C, H)).index_put_((flat_e, safe_pos), xk,
                                             accumulate=True)
    w = topw.reshape(T * k) * keep.float()
    if tp is not None:  # this rank's experts and the slots routed to them
        buf = buf[tp.lo:tp.hi]
        w = tp.enter(w)  # a rank's combine sees only its experts' slots
        mine = (flat_e >= tp.lo) & (flat_e < tp.hi)
        w = w * mine.float()
        flat_e = torch.where(mine, flat_e - tp.lo, 0)
    h = F.silu(torch.bmm(buf, wg.to(cd))) * torch.bmm(buf, wu.to(cd))
    ye = torch.bmm(h, wd.to(cd))  # [E, C, H]
    y = (ye[flat_e, safe_pos].float() * w[:, None]).reshape(T, k, H).sum(1)
    if tp is not None:
        y = tp.reduce(y)
    return y.to(x.dtype).reshape(b, s, H), router_f, router_p


class MoEMLP(Block):
    """Every layer's sparse MLP, weights stacked [L, ...]; forward(x, l)
    runs layer l's."""

    tp = None  # core/tensor_parallel.TensorSplit ("experts")
    batch = None  # BatchRanks (train/train_step.shard_train_state)

    def __init__(self, cfg, L: int, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__(param_dtype, device, stacked=True)
        E, H = cfg.num_experts, cfg.hidden_size
        Fi = cfg.moe_intermediate_size or cfg.intermediate_size
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self._alloc("gate", (L, H, E))
        self._alloc("experts_gate_proj", (L, E, H, Fi))
        self._alloc("experts_up_proj", (L, E, H, Fi))
        self._alloc("experts_down_proj", (L, E, Fi, H))
        # a list while collect_router_stats is open: (router_f, router_p)
        # of each call, in call order
        self.router_stats: Optional[List] = None

    def forward(self, x, l: int):
        y, f, p = moe_forward(
            self.cfg, x, self.leaf("gate", l),
            self.leaf("experts_gate_proj", l), self.leaf("experts_up_proj", l),
            self.leaf("experts_down_proj", l), self.compute_dtype, self.tp,
            self.batch)
        if self.router_stats is not None:
            self.router_stats.append((f, p))
        return y


@contextlib.contextmanager
def collect_router_stats(model):
    """Within the block, every MoEMLP of `model` records its router
    vectors. The yielded list is filled when the block ends: one
    (router_f [n, E], router_p [n, E]) pair a MoE stack that ran, n its
    layer calls, the input of router_aux_loss (the JAX `intermediates`
    entries of the same forward)."""
    stacks = [m for m in model.modules() if isinstance(m, MoEMLP)]
    for m in stacks:
        m.router_stats = []
    out: List[Tuple[torch.Tensor, torch.Tensor]] = []
    try:
        yield out
    finally:
        for m in stacks:
            rec, m.router_stats = m.router_stats, None
            if rec:
                out.append((torch.stack([f for f, _ in rec]),
                            torch.stack([p for _, p in rec])))
