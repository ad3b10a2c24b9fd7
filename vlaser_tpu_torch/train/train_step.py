"""The train step (port of vlaser_tpu/train/train_step.py) on one device or
over a mesh (`shard_train_state`, ZeRO-3).

Each parameter group is clipped by its own global norm (unless its
`grad_clip` is None) and then takes an AdamW step (b1 0.9, b2 0.999, eps
1e-8, decoupled decay on every leaf): the JAX trainer puts
`clip_by_global_norm` inside each group's chain of `optax.multi_transform`,
so a group never sees another group's norm. torch.optim.AdamW computes
optax's adamw update; the learning rate of update i (from 0) is the
group's schedule(i), as optax counts. `frozen` parameters take gradients
but no update (optax.set_to_zero). The reported `grad_norm` is the norm
over every gradient the step took, frozen ones included, before clipping,
as the JAX step takes optax.global_norm of the whole gradient tree. With
`accum_steps` > 1 every batch tensor is [accum, micro, ...]: the micro
batches' gradients are summed in fp32 and divided by accum_steps, and the
loss is their mean (the JAX step's scan). `optimizer="adamw8bit"` puts
every group on train/optim8bit.AdamW8bit (the JAX adamw8bit chain) under
the same clip, schedule and grad_norm; `hwio` names its patch convs.

Over a mesh (`sharded`, a ShardedState of `shard_train_state`) the step
is the one-device step of the global batch, ZeRO-3 as XLA runs JAX's
sharded scan: every parameter that its rule splits over `fsdp` is held
as this rank's shard, at rest and through the step. A model reads its
weights through models/layers.Block.leaf, which all-gathers the one
leaf, or the one layer's slice of a stacked leaf, it is asked for; the
gather's backward reduce-scatters that slice's gradient over fsdp, so a
gradient is never whole beyond one layer. The state turns the model's
`remat` on: each layer's gathered weights then live only while the layer
runs, forward and recompute, and are never saved for the backward. The
loss function returns the rank's share of the global loss (train/losses,
policy/flow: sums over the batch ranks give the global loss), so the
gradients, summed in fp32 over the micro batches, are summed once over
the batch ranks left (data x context for a split leaf, data x fsdp x
context for a whole one; never tensor, whose ranks hold one replica of
the batch), and the loss with them. On a tensor axis the model is cut
first (core/tensor_parallel.shard_for_training): a leaf that tensor
ranks hold as copies, each seeing part of its gradient (the KV pick, a
q / k norm), is also summed over its holders. Norms and clips read the
global norms (each distinct part's squares once, summed over fsdp x
tensor); the optimizer steps the shards, so the AdamW moments are shards
too.

On a stage axis the loss is train/pipeline.make_pipeline_lm_loss: each
stage runs its chunk of the layer stacks on the same rows. A stacked
leaf that the rules (core/mesh.stageify_rules) put on stage is held as
this stage's [L / pp, ...] layers (fsdp-split within) and read by global
layer index (models/layers.Block._staged); its gradient is summed over
the batch ranks of its stage. Every other leaf (the embedding, the final
norm, the head, a stacked norm or bias the rules leave whole) is held
whole on every stage, and its gradient is summed over the batch ranks x
stage: a stage that does not use it contributes zero, so the tied
embedding gets its input share from stage 0 and its head share from the
last stage. Norms count a stage's layers on that stage and a whole leaf
once, so AdamW gives every stage the same whole leaves. A stage axis
with a context axis raises (no JAX recipe combines them).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..core import mesh as mesh_lib
from .optim8bit import AdamW8bit


@dataclass
class ParamGroup:
    params: List[nn.Parameter]
    schedule: Callable[[int], float]  # step -> learning rate
    weight_decay: float = 0.01
    grad_clip: Optional[float] = 1.0  # None: no clip


def grad_norm(params) -> torch.Tensor:
    """Global L2 norm (fp32, on device) of the parameters' gradients."""
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros((), device=params[0].device if params else None)
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))


def group_grad_norms(groups: Dict[str, ParamGroup]) -> Dict[str, torch.Tensor]:
    return {name: grad_norm(g.params) for name, g in groups.items()}


def _accumulate(loss_fn, batch, params, accum_steps: int):
    """Backward of each micro batch; -> the mean loss, with each p.grad
    the fp32 mean of the micro gradients in p's dtype."""
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    losses = []
    for i in range(accum_steps):
        micro = {k: (v[i] if torch.is_tensor(v) else v)
                 for k, v in batch.items()}
        for p in params:
            p.grad = None
        loss = loss_fn(micro)
        loss.backward()
        losses.append(loss.detach())
        for a, p in zip(acc, params):
            if p.grad is not None:
                a.add_(p.grad.float())
    for a, p in zip(acc, params):
        p.grad = (a / accum_steps).to(p.dtype)
    return torch.stack(losses).float().mean()


ADAM8BIT_OVER_FSDP = (
    "8-bit AdamW over fsdp > 1, tensor > 1 or stage > 1: a shard would "
    "split the kernel's 256-element blocks, and the JAX shard_train_state "
    "cannot place the 8-bit state either")


class _AllGather(torch.autograd.Function):
    """The whole tensor of every fsdp rank's shard (cut along `dim`); the
    backward sums the whole gradient over fsdp and keeps this rank's
    slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, shard, dim, n, group):
        import torch.distributed as dist

        ctx.args = (dim, n, group)
        parts = [torch.empty_like(shard) for _ in range(n)]
        dist.all_gather(parts, shard.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        dim, n, group = ctx.args
        parts = [c.contiguous() for c in g.chunk(n, dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=group)
        return out, None, None, None


def _bucketed_all_reduce(tensors: Sequence[torch.Tensor], group,
                         bucket_bytes: int = 256 * 2**20) -> None:
    """Sum each tensor over `group` in place, through flat buffers of at
    most `bucket_bytes` a dtype (a tensor larger than that goes alone)."""
    import torch.distributed as dist

    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        bucket, size = [], 0
        for t in ts + [None]:
            nb = 0 if t is None else t.numel() * t.element_size()
            if bucket and (t is None or size + nb > bucket_bytes):
                if len(bucket) == 1:
                    dist.all_reduce(bucket[0], group=group)
                else:
                    flat = torch.cat([b.reshape(-1) for b in bucket])
                    dist.all_reduce(flat, group=group)
                    off = 0
                    for b in bucket:
                        b.copy_(flat[off:off + b.numel()].view_as(b))
                        off += b.numel()
                bucket, size = [], 0
            if t is not None:
                bucket.append(t)
                size += nb


class ShardedState:
    """ZeRO-3 over a mesh: each parameter of `model` that its rule
    (core/mesh.tree_shardings) splits over `fsdp` is held as this rank's
    shard of that dim, the others whole. On a mesh with a tensor axis the
    model's leaves are already its tensor rank's (core/tensor_parallel:
    shard_for_training, or shard_for_serving): a leaf split over both is
    held as this rank's fsdp shard of its tensor shard, and `gather` gives
    the tensor shard back. On a stage axis a stacked leaf that its rule
    puts on stage is held as this stage's layers first (the module
    docstring). The shards stay in place: the model's Block
    that holds a split leaf reads it through `gather` (see the module
    docstring). `peak_gathered` counts the largest number of bytes of
    gathered weights alive at once (a gather's result is counted until
    its storage is freed).

    Sums (`reduce`) run over the ranks that hold another part of the batch
    and the same part of the leaf: a leaf split over fsdp (summed over
    fsdp by its gathers' backward) over its replicas, the ranks of its
    fsdp and tensor index; a whole leaf over the batch ranks
    (core/mesh.batch_group); a tensor copy (tensor_parallel.Plan.copies)
    over the same ranks times its holders; each within its stage for a
    leaf held on stage, else over every stage too. Norms (`grad_norms`)
    sum each distinct part's squares once over fsdp x tensor x stage: a
    leaf's squares count on the first rank of the ranks that hold it."""

    def __init__(self, model: nn.Module, mesh, rules=None):
        import torch.distributed as dist

        from ..models.layers import Block

        F_, T_ = mesh_lib.FSDP_AXIS, mesh_lib.TENSOR_AXIS
        S_, C_ = mesh_lib.STAGE_AXIS, mesh_lib.CONTEXT_AXIS
        self.stage = mesh_lib.axis_size(mesh, S_)
        if self.stage > 1 and mesh_lib.axis_size(mesh, C_) > 1:
            raise NotImplementedError(
                "a 'stage' axis with a 'context' axis: pipeline stages over "
                "a context-parallel stack are not ported (no JAX recipe or "
                "test combines them)")
        if mesh.size() != dist.get_world_size():
            raise ValueError("the mesh must span every rank of the group")
        self.mesh = mesh
        self.fsdp = mesh_lib.axis_size(mesh, F_)
        self.index = mesh_lib.axis_index(mesh, F_)
        self.tp = mesh_lib.axis_size(mesh, T_)
        self.t_index = mesh_lib.axis_index(mesh, T_)
        self.s_index = mesh_lib.axis_index(mesh, S_)
        self.group = mesh.get_group(F_) if self.fsdp > 1 else None
        self.s_group = mesh.get_group(S_) if self.stage > 1 else None
        self.world = dist.get_world_size()
        self.batch_group, self.ranks = mesh_lib.batch_group(mesh)
        f_dim = mesh.mesh_dim_names.index(F_)
        s_dim = (mesh.mesh_dim_names.index(S_) if self.stage > 1
                 else None)
        named = dict(model.named_parameters())
        placements = mesh_lib.tree_shardings(
            named, mesh, rules if rules is not None
            else mesh_lib.default_param_rules())
        self.dims = {}  # id(p) -> the dim split over fsdp, or None
        self.staged = {}  # id(p) -> whether p is held as a stage's layers
        for name, p in named.items():
            pl = placements[name][f_dim]
            self.dims[id(p)] = (pl.dim if self.fsdp > 1 and pl.is_shard()
                                else None)
            sp = placements[name][s_dim] if s_dim is not None else None
            self.staged[id(p)] = bool(sp is not None and sp.is_shard()
                                      and sp.dim == 0)
        self.params = list(named.values())
        self.split = [p for p in self.params if self.dims[id(p)] is not None]
        tplan = getattr(model, "_tensor_plan", None)
        if self.tp > 1 and tplan is None:
            raise ValueError(
                "a tensor axis: cut the model first "
                "(core/tensor_parallel.shard_for_training) and make the "
                "optimizer's groups after the cut")
        self.layout = getattr(model, "_tensor_layout", {})
        cut = set(tplan.leaves) if tplan is not None else set()
        copies = tplan.copies if tplan is not None else {}
        # each leaf's reduction (the key of its group) and whether this
        # rank counts its squares in a norm
        self.route, self.owned = {}, {}
        keys = set()
        for name, p in named.items():
            split = self.dims[id(p)] is not None
            staged = self.staged[id(p)]
            g = copies.get(name) if self.tp > 1 else None
            held = g if g is not None else (1 if name in cut else self.tp)
            key = ("split" if split else "whole", g or 1,
                   staged or self.stage == 1)
            self.route[id(p)] = key
            keys.add(key)
            self.owned[id(p)] = ((split or self.index == 0)
                                 and self.t_index % held == 0
                                 and (staged or self.s_index == 0))
        self.groups = {("whole", 1, True): (self.batch_group, self.ranks)}
        for split, g, within in sorted(keys - {("whole", 1, True)}):
            def key(c, split=split, g=g, within=within):
                k = (c.get(T_, 0) // g,)  # the holders' block
                if split == "split":
                    k += (c[F_],)
                return k + ((c.get(S_, 0),) if within else ())
            self.groups[(split, g, within)] = mesh_lib.rank_group(
                mesh, f"reduce-{split}-{g}-{within}", key)
        # the ranks of one replica of the model: fsdp x tensor x stage
        self.model_group, self.model_ranks = mesh_lib.rank_group(
            mesh, "model", lambda c: tuple(
                v for a, v in c.items() if a not in (F_, T_, S_)))
        with torch.no_grad():
            for m in model.modules():
                for leaf, p in m._parameters.items():
                    if id(p) not in self.dims or not self.is_split(p):
                        continue
                    if not isinstance(m, Block):
                        raise TypeError(
                            f"{type(m).__name__}.{leaf}: a leaf split over "
                            "fsdp or stage must be read through Block.leaf")
                    if self.staged[id(p)]:
                        m._staged = dict(m._staged or {}, **{
                            leaf: self.s_index * (p.shape[0] // self.stage)})
                    d = self.dims[id(p)]
                    if d is not None:
                        m._gathered = dict(m._gathered or {},
                                           **{leaf: (d, self)})
                    p.data = self.local(p, p.data)
        if self.split:
            for m in model.modules():
                if isinstance(getattr(m, "remat", None), bool):
                    m.remat = True
        self._live: Dict[int, tuple] = {}
        self.peak_gathered = 0

    def is_split(self, p) -> bool:
        """Whether p is held as a part of its leaf (over fsdp or stage)."""
        return self.dims[id(p)] is not None or self.staged[id(p)]

    def local(self, p, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor shaped like p: its stage's
        layers, then its fsdp shard."""
        if self.staged[id(p)]:
            n = full.shape[0] // self.stage
            full = full.narrow(0, self.s_index * n, n).clone()
        d = self.dims[id(p)]
        if d is None:
            return full
        n = full.shape[d] // self.fsdp
        return full.narrow(d, self.index * n, n).clone()

    def cut(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's tensor shard of a one-device tensor of leaf `name`
        (itself for a leaf the tensor axis leaves whole)."""
        lay = self.layout.get(name)
        if lay is None or whole.dim() <= lay[0]:
            return whole
        from ..core.tensor_parallel import shard_leaf

        return shard_leaf(whole, lay[0], lay[2][self.t_index])

    def gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor of a shard split along `dim` (an all-gather over
        fsdp that every rank of the group calls; differentiable)."""
        whole = _AllGather.apply(shard, dim, self.fsdp, self.group)
        st = whole.untyped_storage()
        self._live[id(st)] = (weakref.ref(st), st.nbytes())
        live = 0
        for key, (ref, nbytes) in list(self._live.items()):
            if ref() is None:
                del self._live[key]
            else:
                live += nbytes
        self.peak_gathered = max(self.peak_gathered, live)
        return whole

    def full(self, p, shard: torch.Tensor, dst: Optional[int] = None
             ) -> Optional[torch.Tensor]:
        """The whole tensor over fsdp (and stage) of a shard shaped like
        p's, on every rank (dst None: all-gathers over fsdp and stage,
        which every rank calls) or on rank `dst` only (gathers over dst's
        fsdp and stage groups, whose ranks call them; None on every other
        rank)."""
        d, staged = self.dims[id(p)], self.staged[id(p)]
        if d is None and not staged:
            return shard
        shard = shard.detach().contiguous()
        if staged:  # the stage's layers whole over fsdp, then the stages'
            if d is not None:
                shard = _AllGather.apply(shard, d, self.fsdp, self.group)
            if dst is None:
                return _AllGather.apply(shard, 0, self.stage, self.s_group)
            return self._gather_to(shard, 0, self.stage, self.s_group, dst)
        if dst is None:
            return _AllGather.apply(shard, d, self.fsdp, self.group)
        return self._gather_to(shard, d, self.fsdp, self.group, dst)

    @staticmethod
    def _gather_to(shard, dim, n, group, dst):
        import torch.distributed as dist

        if dst not in dist.get_process_group_ranks(group):
            return None
        here = dist.get_rank() == dst
        parts = [torch.empty_like(shard) for _ in range(n)]
        dist.gather(shard, parts if here else None, dst=dst, group=group)
        return torch.cat(parts, dim) if here else None

    def whole_shape(self, name: str, p, shape) -> tuple:
        """The one-device shape of leaf `name` (p: its parameter, None for
        a buffer) held here as `shape`."""
        shape = list(shape)
        if p is not None and self.dims[id(p)] is not None:
            shape[self.dims[id(p)]] *= self.fsdp
        if p is not None and self.staged[id(p)]:
            shape[0] *= self.stage
        lay = self.layout.get(name)
        if lay is not None and len(shape) > lay[0]:
            shape[lay[0]] = lay[1]
        return tuple(shape)

    def whole(self, name: str, p, t: torch.Tensor
              ) -> Optional[torch.Tensor]:
        """The one-device tensor of leaf `name`'s local `t` (the leaf, or a
        state tensor of its shape; p: its parameter, None for a buffer) on
        rank 0, None on every other rank; every rank calls it. The fsdp
        shards are all-gathered, then rank 0's tensor group gathers the
        tensor shards to it, which it puts back at their columns (the
        strided ViT qkv un-strided, a KV copy written once a holder)."""
        import torch.distributed as dist

        t = t.detach()
        lay = self.layout.get(name)
        if lay is None or t.dim() <= lay[0]:
            if p is None:
                return t if dist.get_rank() == 0 else None
            return self.full(p, t, dst=0)
        if p is not None:
            t = self.full(p, t)
        dim, n, idx = lay
        group = self.mesh.get_group(mesh_lib.TENSOR_AXIS)
        if 0 not in dist.get_process_group_ranks(group):
            return None
        here = dist.get_rank() == 0
        parts = [torch.empty_like(t) for _ in range(self.tp)]
        dist.gather(t.contiguous(), parts if here else None, dst=0,
                    group=group)
        if not here:
            return None
        shape = list(t.shape)
        shape[dim] = n
        out = t.new_empty(shape)
        for i, part in zip(idx, parts):
            out.index_copy_(dim, i.to(out.device), part)
        return out

    def reduce(self, params: Sequence[nn.Parameter], extra=()) -> None:
        """Sum the parameters' gradients (and `extra` tensors, this rank's
        shares, over the batch ranks) in place, each leaf over its
        reduction's ranks (the class docstring)."""
        buckets: Dict[tuple, List[torch.Tensor]] = {}
        for p in params:
            buckets.setdefault(self.route[id(p)], []).append(p.grad)
        for key, grads in buckets.items():
            group, n = self.groups[key]
            if n > 1:
                _bucketed_all_reduce(grads, group)
        if extra and self.ranks > 1:
            _bucketed_all_reduce(list(extra), self.batch_group)

    def grad_norms(self, lists: Sequence[Sequence[nn.Parameter]]
                   ) -> List[torch.Tensor]:
        """The global L2 norm of each list's gradients: each distinct
        part's squares counted once, summed over fsdp x tensor x stage."""
        import torch.distributed as dist

        zero = torch.zeros((), device=self.params[0].device)
        sq = []
        for params in lists:
            total = zero
            for p in params:
                if p.grad is not None and self.owned[id(p)]:
                    total = total + torch.linalg.vector_norm(
                        p.grad.float()).square()
            sq.append(total)
        sq = torch.stack(sq)
        if self.model_ranks > 1:
            dist.all_reduce(sq, group=self.model_group)
        return list(sq.sqrt().unbind())

    def bytes_per_rank(self) -> int:
        """Bytes of the parameter shards this rank holds."""
        return sum(p.numel() * p.element_size() for p in self.params)


def shard_train_state(model: nn.Module, mesh, rules=None) -> ShardedState:
    """Hold `model`'s parameters at rest sharded over `mesh` by `rules`
    (core/mesh.default_param_rules when None): ZeRO-3 over fsdp, on a
    model already cut over the mesh's tensor axis
    (core/tensor_parallel.shard_for_training). Build the optimizer
    (make_train_step(sharded=...)) after this call, so that its moments
    are created as shards. A step's batch is split over the batch ranks,
    so each MoE stack's capacity counts their global batch
    (models/moe.BatchRanks)."""
    from ..models.moe import BatchRanks, MoEMLP

    state = ShardedState(model, mesh, rules)
    if state.ranks > 1:
        cp = mesh_lib.axis_size(mesh, mesh_lib.CONTEXT_AXIS)
        for m in model.modules():
            if isinstance(m, MoEMLP):
                m.batch = BatchRanks(state.batch_group, state.ranks, cp)
    return state


def make_train_step(loss_fn: Callable[[Dict], torch.Tensor],
                    groups: Dict[str, ParamGroup], accum_steps: int = 1,
                    frozen: Sequence[nn.Parameter] = (),
                    optimizer: str = "adamw",
                    hwio: Sequence[nn.Parameter] = (),
                    sharded: Optional[ShardedState] = None):
    """loss_fn(batch) -> scalar loss of the model that owns the groups'
    parameters (and the frozen ones); with `sharded`, this rank's share
    of the global batch's loss. Returns step(batch) -> {"loss",
    "grad_norm"} (0-dim fp32 tensors on the device: reading them syncs, so
    a loop reads them only when it logs). `step.optimizer`, `step.count`
    and `step.sharded` are exposed."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if (sharded is not None and optimizer == "adamw8bit"
            and sharded.fsdp * sharded.tp * sharded.stage > 1):
        raise NotImplementedError(ADAM8BIT_OVER_FSDP)
    params = [p for g in groups.values() for p in g.params]
    frozen = list(frozen)
    param_groups = [{"params": g.params, "weight_decay": g.weight_decay,
                     "lr": 0.0} for g in groups.values()]
    if optimizer == "adamw":
        fused = bool(params) and params[0].is_cuda
        optimizer = torch.optim.AdamW(param_groups, betas=(0.9, 0.999),
                                      eps=1e-8, fused=fused or None)
    elif optimizer == "adamw8bit":
        optimizer = AdamW8bit(param_groups, betas=(0.9, 0.999), eps=1e-8,
                              hwio=hwio)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")

    def grads(batch):
        for p in frozen:
            p.grad = None
        if accum_steps == 1:
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(batch)
            loss.backward()
            loss = loss.detach()
        else:
            loss = _accumulate(loss_fn, batch, params + frozen, accum_steps)
        # a leaf the loss never reached: a zero gradient, which optax's
        # decay still updates (and every rank reduces the same list)
        for p in params + (frozen if sharded is not None else []):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if sharded is not None:
            loss = loss.float().reshape(1)
            sharded.reduce(params + frozen, [loss])
            loss = loss[0]
        return loss

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        loss = grads(batch)
        if sharded is None:
            norms = group_grad_norms(groups)
            every = list(norms.values())
            if frozen:
                every.append(grad_norm(frozen))
        else:
            every = sharded.grad_norms([g.params for g in groups.values()]
                                       + ([frozen] if frozen else []))
            norms = dict(zip(groups, every))
        total = torch.linalg.vector_norm(torch.stack(every))
        for (name, g), pg in zip(groups.items(), optimizer.param_groups):
            if g.grad_clip is not None:
                # optax.clip_by_global_norm: g * clip / norm where norm >= clip
                n = norms[name]
                scale = torch.where(n < g.grad_clip, torch.ones_like(n),
                                    g.grad_clip / n)
                for p in g.params:
                    p.grad.mul_(scale.to(p.grad.dtype))
            pg["lr"] = g.schedule(step.count)
        optimizer.step()
        step.count += 1
        return {"loss": loss, "grad_norm": total}

    step.count = 0
    step.optimizer = optimizer
    step.sharded = sharded
    return step
