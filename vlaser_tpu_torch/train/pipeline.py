"""GPipe pipeline parallelism over a `stage` mesh axis (port of
vlaser_tpu/train/pipeline.py; no jax).

The layer stack is split into n contiguous chunks, stage r holding layers
[r L / n, (r + 1) L / n) of every [L, ...] stack, and the batch into M
contiguous microbatches (x.reshape(M, B // M, ...)). Stage 0 takes
microbatch t, each stage runs its chunk on it and sends the result to
stage r + 1, and the last stage's outputs come back to every stage
(GPipe: M + n - 1 steps of the schedule, bubble (n - 1) / (M + n - 1)).
Per-microbatch constants (rope tables, segment ids) are sliced on every
stage from the whole [B, ...] tensors and never ride the ring.

The JAX package runs M + n - 1 lockstep ticks of a scan on every device,
bubble ticks computing garbage that never reaches an output; here each
stage runs `stage_fn` exactly M times forward and M times backward, and
the outputs are the same. The whole schedule of a stage is one
torch.autograd.Function (_Schedule): its forward keeps each microbatch's
graph from its received input, its backward runs the microbatches'
backward passes in a fixed order (the last microbatch first, as JAX's
reversed scan) from the cotangents the next stage sends, and sends each
input's cotangent to the stage before. Both sides of every transfer walk
the same order, so no transfer waits on the autograd engine's order of
independent branches.

Transport is written out over torch.distributed's point-to-point ops on
the mesh's stage group (the ranks of one data, fsdp and tensor index):
isend / irecv, the sends left in flight while the stage computes its next
microbatch. Under a gloo group a CUDA tensor is staged through host
memory (gloo's transfers take host buffers); under NCCL device tensors go
directly. `WAITS` accumulates the host seconds a rank spent blocked in
receives (with SYNC_WAITS the stream is drained before and after each
wait, so that under NCCL the figure is the device's wait).

Three layers of API, as JAX's:
  - spmd_pipeline(stage_fn, ...): any per-stage function of the chunk's
    [L / n, ...] parameters.
  - pipeline_llm_forward(...): the port's Qwen2 decoder stack
    (models/qwen2.Qwen2Layers) through the pipeline.
  - make_pipeline_lm_loss(model, ...): the shifted CE of a port
    Qwen2ForCausalLM with its stack pipelined, the loss_fn of
    train/train_step.make_train_step over a stage-sharded state
    (train_step.shard_train_state with core/mesh.stageify_rules).
A stage axis with a context axis raises NotImplementedError.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core import mesh as mesh_lib

STAGE_AXIS = mesh_lib.STAGE_AXIS

WAITS = {"recv_s": 0.0, "recvs": 0}
SYNC_WAITS = False


def reset_waits() -> None:
    WAITS.update(recv_s=0.0, recvs=0)


# -- transport ----------------------------------------------------------------

class _Link:
    """This rank's neighbours on a stage group."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        ranks = dist.get_process_group_ranks(group)
        self.n, self.rank = len(ranks), dist.get_rank(group)
        self.prev = ranks[self.rank - 1] if self.rank > 0 else None
        self.next = ranks[self.rank + 1] if self.rank < self.n - 1 else None
        self.last = ranks[-1]
        self.host = dist.get_backend(group) == "gloo"

    @property
    def is_last(self) -> bool:
        return self.next is None

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host and t.is_cuda else t

    def send(self, t: torch.Tensor, dst: int):
        """Start sending t to rank dst; -> a handle for `wait`."""
        import torch.distributed as dist

        buf = self._wire(t.detach().contiguous())
        return dist.isend(buf, dst, group=self.group), buf

    @staticmethod
    def wait(handles) -> None:
        for req, _ in handles:
            req.wait()

    def recv(self, shape, like: torch.Tensor, src: int) -> torch.Tensor:
        """A tensor of `shape` and like's dtype from rank src, on like's
        device; the time blocked is added to WAITS."""
        import torch.distributed as dist

        buf = torch.empty(shape, dtype=like.dtype,
                          device="cpu" if self.host else like.device)
        sync = SYNC_WAITS and like.is_cuda
        if sync:
            torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        dist.irecv(buf, src, group=self.group).wait()
        if sync:
            torch.cuda.current_stream().synchronize()
        WAITS["recv_s"] += time.perf_counter() - t0
        WAITS["recvs"] += 1
        return buf.to(like.device)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """The last stage's t on every stage (t: a buffer of its shape
        elsewhere)."""
        import torch.distributed as dist

        buf = self._wire(t.detach().contiguous())
        dist.broadcast(buf, self.last, group=self.group)
        return buf.to(t.device)


def stage_link(mesh=None, axis: str = STAGE_AXIS) -> Optional[_Link]:
    """The stage group's link of `mesh` (the ambient one when None), or None
    without a stage axis larger than 1."""
    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    if mesh_lib.axis_size(mesh, axis) == 1:
        return None
    if mesh_lib.axis_size(mesh, mesh_lib.CONTEXT_AXIS) > 1:
        raise NotImplementedError(
            f"a '{axis}' axis with a 'context' axis: pipeline stages over a "
            "context-parallel stack are not ported (no JAX recipe or test "
            "combines them)")
    return _Link(mesh.get_group(axis))


# -- the schedule -------------------------------------------------------------

class _Schedule(torch.autograd.Function):
    """One stage's GPipe schedule (the module docstring). forward(ctx,
    plan, x, *params): plan = (stage_fn(h, t) -> this stage's output on
    microbatch t, M, link, replicate, whether the caller takes
    gradients). -> the last stage's outputs [B, ...]: on every stage with
    replicate, else on the last stage and a 0-dim zero elsewhere."""

    @staticmethod
    def forward(ctx, plan, x, *params):
        stage_fn, m, link, replicate, grad = plan
        mb = (x.shape[0] // m, *x.shape[1:])
        xs = x.detach().reshape(m, *mb)
        ins, outs, sent = [], [], []
        for t in range(m):
            if link.prev is None:
                h = xs[t].requires_grad_(ctx.needs_input_grad[1])
            else:
                h = link.recv(mb, x, link.prev).requires_grad_(True)
            with torch.set_grad_enabled(grad):
                y = stage_fn(h, t)
            ins.append(h)
            outs.append(y)
            if link.next is not None:
                sent.append(link.send(y, link.next))
        link.wait(sent)
        ctx.plan, ctx.ins, ctx.outs = plan, ins, outs
        ctx.params = params
        if link.is_last:
            out = torch.cat([y.detach() for y in outs])
        elif replicate:
            out = x.new_empty(x.shape)
        else:
            return x.new_zeros(())
        return link.broadcast(out) if replicate else out

    @staticmethod
    def backward(ctx, g):
        _, m, link, _, _ = ctx.plan
        params = ctx.params
        need = [p for p, n in zip(params, ctx.needs_input_grad[2:]) if n]
        acc = [None] * len(need)
        dx, sent = [None] * m, []
        for t in reversed(range(m)):
            y, h = ctx.outs[t], ctx.ins[t]
            if link.is_last:
                gy = g.reshape(m, *y.shape)[t]
            else:
                gy = link.recv(y.shape, y, link.next)
            wrt = ([h] if h.requires_grad else []) + need
            grads = torch.autograd.grad(y, wrt, gy, allow_unused=True)
            ctx.outs[t] = ctx.ins[t] = None  # this microbatch's graph
            if h.requires_grad:
                gh, grads = grads[0], grads[1:]
                if link.prev is not None:
                    sent.append(link.send(gh, link.prev))
                else:
                    dx[t] = gh
            for i, gp in enumerate(grads):
                if gp is not None:
                    acc[i] = gp if acc[i] is None else acc[i] + gp
        link.wait(sent)
        gx = torch.cat(dx) if dx[0] is not None else None
        it = iter(acc)
        return (None, gx, *(next(it) if n else None
                            for n in ctx.needs_input_grad[2:]))


def _tree_map(fn, tree):
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v) for v in tree)


def _leaves(tree):
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _leaves(v)]


def _run_stages(stage_fn: Callable[[torch.Tensor, int], torch.Tensor],
                x: torch.Tensor, params, n_microbatches: int, link,
                replicate: bool = True) -> torch.Tensor:
    """x [B, ...] through this stage's stage_fn(h, t) (t: the microbatch)
    on the GPipe schedule over `link` (None: one stage, the microbatches in
    turn); `params`: the tensors stage_fn reads whose gradients it takes.
    -> the outputs (see _Schedule)."""
    b = x.shape[0]
    assert b % n_microbatches == 0, (b, n_microbatches)
    if link is None:
        xs = x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
        return torch.cat([stage_fn(xs[t], t) for t in range(n_microbatches)])
    plan = (stage_fn, n_microbatches, link, replicate,
            torch.is_grad_enabled())
    return _Schedule.apply(plan, x, *params)


def spmd_pipeline(stage_fn: Callable[[Any, torch.Tensor, Any], torch.Tensor],
                  *, n_microbatches: int, axis: str = STAGE_AXIS, mesh=None):
    """Build run(stacked_params, x, consts) -> y running the layer stack as
    a pipeline over the mesh's `axis` (the ambient mesh when None; one
    stage without the axis).

    stacked_params: a tensor or a dict / list / tuple of tensors with a
    leading layer dim [L, ...], L divisible by the stage count; stage r
    runs its [r L / n, (r + 1) L / n) chunk (sliced here, so each stage's
    gradient is zero outside its chunk). x: [B, ...] activations, B
    divisible by n_microbatches; every stage passes its x (stage 0's
    rows are run; the others' give the shapes). consts: a tree of [B, ...]
    per-sample constants that follow their microbatch, or None.
    stage_fn(local_params, x_mb, consts_mb) applies this stage's chunk to
    one microbatch; its output has x_mb's shape and dtype. y: [B, ...],
    the last stage's outputs on every stage."""

    def run(stacked_params, x, consts):
        link = stage_link(mesh, axis)
        n, r = (link.n, link.rank) if link is not None else (1, 0)
        m = n_microbatches
        mb = x.shape[0] // m

        def chunk(a):
            c = a.shape[0] // n
            assert c * n == a.shape[0], (a.shape[0], n)
            return a.narrow(0, r * c, c)

        local = _tree_map(chunk, stacked_params)
        consts_mb = _tree_map(lambda a: a.reshape(m, mb, *a.shape[1:]),
                              consts)
        fn = lambda h, t: stage_fn(local, h, _tree_map(lambda a: a[t],
                                                       consts_mb))
        return _run_stages(fn, x, _leaves(local), m, link)

    return run


def pipeline_llm_forward(cfg, layers, x: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor, seg_ids: torch.Tensor, *,
                         n_microbatches: int, axis: str = STAGE_AXIS,
                         mesh=None, compute_dtype=torch.bfloat16,
                         remat: bool = True, attn_impl: str = "auto",
                         replicate: bool = True) -> torch.Tensor:
    """The Qwen2 decoder stack as a pipeline: `layers` (a port
    models/qwen2.Qwen2Layers, holding all L layers or, under a stage-sharded
    state, its stage's) runs this stage's layers [r L / n, (r + 1) L / n)
    on each microbatch of x [B, S, H] (cast to compute_dtype), with cos /
    sin [B, S, D] and seg_ids [B, S] sliced per microbatch, causal
    attention through kernels/flash_attention.attention_fn routed on the
    microbatch's shapes, and `remat` wrapping each layer in
    torch.utils.checkpoint as models/qwen2.Qwen2Model does. The embedding,
    final norm and head stay outside. -> [B, S, H] hidden states (see
    spmd_pipeline; replicate=False leaves them on the last stage, a 0-dim
    zero elsewhere, for a loss that only the last stage computes)."""
    from ..kernels.flash_attention import attention_fn
    from ..models.layers import layer_slices

    link = stage_link(mesh, axis)
    n, r = (link.n, link.rank) if link is not None else (1, 0)
    L = cfg.num_layers
    assert L % n == 0, (L, n)
    lo, hi = r * L // n, (r + 1) * L // n
    m = n_microbatches
    mb = x.shape[0] // m
    consts = [c.reshape(m, mb, *c.shape[1:]) for c in (cos, sin, seg_ids)]
    heads = layers.self_attn.heads

    def stage_fn(h, t):
        c_cos, c_sin, c_seg = (c[t] for c in consts)
        b, s = h.shape[:2]
        attend = attention_fn(b, s, s, heads, h.device, q_segment_ids=c_seg,
                              kv_segment_ids=c_seg, causal=True,
                              impl=attn_impl, window=cfg.sliding_window)
        with layer_slices(layers):
            for l in range(lo, hi):
                if remat and torch.is_grad_enabled():
                    h = checkpoint(layers, h, l, c_cos, c_sin, attend, None,
                                   0, use_reentrant=False)
                else:
                    h = layers(h, l, c_cos, c_sin, attend, None, 0)
        return h

    params = [p for p in layers.parameters() if p.requires_grad]
    return _run_stages(stage_fn, x.to(compute_dtype), params, m, link,
                      replicate)


class _FromLast(torch.autograd.Function):
    """The last stage's value of a scalar on every stage; the backward
    passes the cotangent on unchanged (to the last stage's loss, or to
    another stage's zero anchor of the schedule)."""

    @staticmethod
    def forward(ctx, value, link):
        return link.broadcast(value.detach().float().reshape(1))[0]

    @staticmethod
    def backward(ctx, g):
        return g, None


def make_pipeline_lm_loss(model, *, n_microbatches: int, mesh=None,
                          remat: bool = True, attn_impl: str = "auto",
                          axis: str = STAGE_AXIS):
    """-> loss_fn(batch) for train/train_step.make_train_step: the shifted
    CE of a port models/qwen2.Qwen2ForCausalLM whose decoder stack runs as
    a pipeline over the mesh's `axis` (pipeline_llm_forward), the JAX
    loss: embed, the pipelined stack, the final norm, the head (tied or
    untied), fp32 CE over valid = (seg[:, 1:] != 0) & (labels[:, 1:] >= 0),
    sum(ce * valid) / max(sum(valid), 1). The CE is train/losses.
    chunked_weighted_ce (the same value: the [N, V] logits never exist
    whole; vocab-parallel where the table is cut over tensor), its weight
    sum over the mesh's batch ranks, so each batch rank's loss is its
    share of the global loss. Only the last stage runs the norm and the
    head; the loss's value is broadcast to every stage, and the other
    stages' gradients reach their layers through the schedule only, so the
    embedding's input share comes from stage 0 and its head share (tied)
    from the last stage. batch: input_ids, labels, seg_ids [B, S] (this
    rank's rows), B divisible by n_microbatches."""
    from ..kernels import ops
    from .losses import IGNORE_TOKEN_ID, chunked_weighted_ce

    cfg = model.cfg

    def loss_fn(batch):
        ids, labels, seg = (batch["input_ids"], batch["labels"],
                            batch["seg_ids"])
        b, s = ids.shape
        link = stage_link(mesh, axis)
        x = model.embed(ids)
        pos = torch.arange(s, device=ids.device)[None].expand(b, s)
        cos, sin = ops.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
        h = pipeline_llm_forward(
            cfg, model.model.layers, x, cos, sin, seg,
            n_microbatches=n_microbatches, axis=axis, mesh=mesh,
            compute_dtype=model.model.compute_dtype, remat=remat,
            attn_impl=attn_impl, replicate=False)
        if link is not None and not link.is_last:
            return _FromLast.apply(h * 0.0, link)  # the schedule's anchor
        h = model.model.norm(h)
        if cfg.tie_word_embeddings:
            vocab, table, is_kernel = model.embed_tokens, "embedding", False
        else:
            vocab, table, is_kernel = model.lm_head, "kernel", True
        loss = chunked_weighted_ce(
            h, vocab.leaf(table), torch.where(labels >= 0, labels,
                                              IGNORE_TOKEN_ID),
            (seg != 0).float(), table_is_kernel=is_kernel,
            mesh=mesh if mesh is not None else mesh_lib.current_mesh(),
            tp=getattr(vocab, "tp", None))
        return loss if link is None else _FromLast.apply(loss, link)

    return loss_fn
