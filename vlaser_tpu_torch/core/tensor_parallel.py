"""Tensor and expert parallelism for serving and training: each rank of
the mesh's `tensor` axis holds plain local tensors (its shard of each
split leaf) and the collectives are written out, where the JAX package
lets GSPMD insert them from core/mesh.default_param_rules.

The collectives (every transport: NCCL on the card, gloo on the CPU or on
CUDA tensors) run in fp32 and are built from all_reduce alone; a cut
module calls them through its `TensorSplit`:

  enter       the input of a column-parallel layer: identity forward,
              all-reduce backward
  reduce      the output of a row-parallel layer: all-reduce forward,
              identity backward
  gather_out  the local columns of every rank side by side (the logits of
              a vocab-parallel head): each rank writes its block into
              zeros and the blocks are summed, exactly
  reduce_max  the per-row absmax of a row-parallel w8a8 input

The layout (`plan`) follows the tensor dims of default_param_rules at head
granularity, so that attention stays local to a rank:

- q / k / v and gate / up are column-parallel, o and down row-parallel.
  q splits where tensor divides the q heads; k and v split where it
  divides the KV heads, or, where the KV heads divide tensor, each rank
  holds the one KV head its q heads read (GSPMD splits head_dim there
  instead: the port keeps whole heads, so attention and the KV cache stay
  local). Where q does not split, or k / v fit neither rule, the four
  attention kernels stay whole on every rank (tree_shardings' rule for a
  dim the axis does not divide). The two mixtures of the joint model share
  one attention and so one decision.
- The ViT's fused qkv [L, C, 3C] takes each rank's heads' columns of q, k
  and v (a strided shard: a contiguous split would give rank 0 all of q);
  a ViT with q/k RMSNorm over the whole width keeps its attention whole.
- A column-parallel bias is held as its rank's slice; a row-parallel one
  whole, added after the all-reduce.
- The MLPs split where tensor divides the intermediate width; a MoE stack
  splits its experts [L, E, ...] where it divides E (expert parallelism:
  the router stays whole and fp32, every rank routes every token alike,
  runs its own experts and the combine's partial sums are all-reduced).
- `embed_tokens` is vocab-parallel and `lm_head` column-parallel with its
  logits gathered, where tensor divides the vocabulary; else both whole.
- Whatever the rules leave (norms, the projector, small encoders) stays
  whole.

A rank's int8 leaves (`kernel_q`, per-column `kernel_scale`) are cut as
their kernel; a row-parallel w8a8 layer quantizes its input with the row
absmax all-reduced over tensor (models/layers.Dense), so its int8 codes are
the one-device codes. `shard_model` cuts a model's own leaves in place
(meta leaves too: a model too large for one device is built on `meta`,
cut, then materialized); utils/convert.tensor_shards cuts a state the
same way. `shard_for_serving` also holds the leaves the rules split over
`fsdp` as this rank's shards of them (train/train_step.ShardedState;
models/layers.Block.leaf gathers them over fsdp only).

Training (`shard_for_training`, before the optimizer is built) cuts the
same layout; the collectives' backward passes are Megatron's f / g pair:
outside a split region the activations and their gradients are equal on
every rank of a tensor group, which holds one replica of the batch, so a
gradient is summed over the batch ranks (core/mesh.batch_group), never
over tensor. The exception is a leaf that several tensor ranks hold as
copies while each sees only part of its gradient (`Plan.copies`): the
KV "pick" layout's k / v columns (a head's copy on the ranks whose q
heads read it) and a Qwen3 q / k RMSNorm over head_dim (every rank's
heads); train/train_step.ShardedState sums such a gradient over the
holders and counts it once in the norm. A MoE stack passes its input and
its top-k weights through `enter` before the dispatch (a rank combines
only its experts' slots), the router reading the input as it is. The
layout of every rank (`model._tensor_layout`) is kept, so that a
checkpoint gathers whole leaves (utils/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import mesh as mesh_lib


# -- the collectives ------------------------------------------------------------

def all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """x summed (or op) over `group` in fp32, in x's dtype."""
    import torch.distributed as dist

    buf = x.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(buf, op=op or dist.ReduceOp.SUM, group=group)
    return buf.to(x.dtype)


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.args = (size, rank)
        n = x.shape[-1]
        full = x.new_zeros((*x.shape[:-1], n * size), dtype=torch.float32)
        full[..., rank * n:(rank + 1) * n] = x
        return all_reduce(full, group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        size, rank = ctx.args
        n = g.shape[-1] // size
        return g[..., rank * n:(rank + 1) * n], None, None, None


@dataclasses.dataclass(frozen=True)
class TensorSplit:
    """How a module's leaves are cut over the tensor group: `kind` "col" |
    "row" (a Dense), "vocab" (an Embed; `lo`:`hi` its rows), "experts" (a
    MoE stack; `lo`:`hi` its experts). `gather`: a column-parallel head
    whose output is gathered."""
    kind: str
    size: int
    rank: int
    group: object = None
    gather: bool = False
    lo: int = 0
    hi: int = 0

    def enter(self, x):
        return _CopyToTensor.apply(x, self.group)

    def reduce(self, y):
        return _ReduceFromTensor.apply(y, self.group)

    def gather_out(self, y):
        """[..., n] on each rank -> [..., n * size], rank r's block at
        [r * n, (r + 1) * n)."""
        return _GatherLast.apply(y, self.group, self.size, self.rank)

    def reduce_max(self, a):
        import torch.distributed as dist

        return all_reduce(a, self.group, dist.ReduceOp.MAX)


def tensor_group(mesh) -> Tuple[object, int, int]:
    """-> (process group, size, this rank's index) of the mesh's tensor
    axis (None, 1, 0 without one)."""
    size = mesh_lib.axis_size(mesh, mesh_lib.TENSOR_AXIS)
    if size == 1:
        return None, 1, 0
    return (mesh.get_group(mesh_lib.TENSOR_AXIS), size,
            mesh_lib.axis_index(mesh, mesh_lib.TENSOR_AXIS))


# -- the layout -----------------------------------------------------------------

def kv_layout(heads: int, kv_heads: int, tp: int) -> Optional[str]:
    """"split" (each rank its KV heads), "pick" (each rank the one KV head
    its q heads read) or None (the attention stays whole)."""
    if tp == 1 or heads % tp:
        return None
    if kv_heads % tp == 0:
        return "split"
    if tp % kv_heads == 0:
        return "pick"
    return None


def head_columns(rank: int, tp: int, heads: int, kv_heads: int,
                 head_dim: int, layout: str):
    """-> (q columns, k / v columns) of rank `rank` (index tensors)."""
    hq = heads // tp
    q = torch.arange(rank * hq * head_dim, (rank + 1) * hq * head_dim)
    if layout == "split":
        hk = kv_heads // tp
        kv = torch.arange(rank * hk * head_dim, (rank + 1) * hk * head_dim)
    else:
        h = rank // (tp // kv_heads)
        kv = torch.arange(h * head_dim, (h + 1) * head_dim)
    return q, kv


def _block(n: int, tp: int, rank: int) -> torch.Tensor:
    c = n // tp
    return torch.arange(rank * c, (rank + 1) * c)


@dataclasses.dataclass
class Plan:
    """leaves: {dotted leaf name: (dim, index)}, every name the leaf may
    have (a float kernel or its int8 form and scales); splits: {module name:
    (kind, gather, lo, hi)}; heads: {module name: (heads, kv_heads)}, the
    local head counts of an attention module; copies: {dotted leaf name:
    g}, a leaf (cut or whole) whose each part the g tensor ranks of a
    block [g j, g (j + 1)) hold as copies, each seeing part of its
    gradient (see the module docstring)."""
    leaves: Dict[str, Tuple[int, torch.Tensor]]
    splits: Dict[str, Tuple[str, bool, int, int]]
    heads: Dict[str, Tuple[int, int]]
    copies: Dict[str, int] = dataclasses.field(default_factory=dict)


def plan(model: nn.Module, tp: int, rank: int) -> Plan:
    """The layout of `model`'s leaves on tensor rank `rank` of `tp` (see
    the module docstring). Reads only the leaves' shapes, so a model on
    `meta` plans as well."""
    from ..models.internvit import _Attn, _MLP
    from ..models.layers import Dense, Embed
    from ..models.moe import MoEMLP
    from ..models.qwen2 import Qwen2Attention, Qwen2MLP
    from ..policy.joint import MixtureMLP, _Layers

    p = Plan({}, {}, {}, {})
    if tp == 1:
        return p
    mods = dict(model.named_modules())

    def cut(dense_name: str, kind: str, idx: torch.Tensor, gather=False):
        """A Dense cut column- (its outputs) or row-parallel (its
        inputs) by idx."""
        d = mods[dense_name]
        if d.has_lora:
            raise NotImplementedError(
                f"{dense_name}: a LoRA adapter over a tensor-parallel layer "
                "(merge it first; QLoRA over the tensor axis is not ported, "
                "and the JAX CLIs take no LoRA flag)")
        p.splits[dense_name] = (kind, gather, 0, 0)
        nd = len(d.kernel_shape)  # [..., in, out]; its int8 form alike
        dims = {"kernel": nd - (1 if kind == "col" else 2)}
        if kind == "col":  # bias [..., out], scales [..., 1, out]
            dims.update(bias=nd - 2, kernel_scale=nd - 1)
        dims["kernel_q"] = dims["kernel"]
        for leaf, dim in dims.items():
            p.leaves[f"{dense_name}.{leaf}"] = (dim, idx)

    def attention(names, heads, kv, hd, fused=False):
        """names: the modules holding q / k / v / o (or qkv / proj)."""
        lay = kv_layout(heads, kv, tp)
        if lay is None:
            return
        q, k = head_columns(rank, tp, heads, kv, hd, lay)
        for n in names:
            if fused:
                C = heads * hd
                cut(f"{n}.qkv", "col", torch.cat([q, q + C, q + 2 * C]))
                cut(f"{n}.proj", "row", q)
            else:
                for proj, idx, kind in (("q_proj", q, "col"),
                                        ("k_proj", k, "col"),
                                        ("v_proj", k, "col"),
                                        ("o_proj", q, "row")):
                    cut(f"{n}.{proj}", kind, idx)
                if lay == "pick":  # a KV head's copy on tp / kv ranks
                    for proj in ("k_proj", "v_proj"):
                        for leaf in ("kernel", "bias"):
                            p.copies[f"{n}.{proj}.{leaf}"] = tp // kv
                for norm in ("q_norm", "k_norm"):  # over head_dim: all
                    if hasattr(mods[n], norm):
                        p.copies[f"{n}.{norm}.weight"] = tp
            p.heads[n] = (heads // tp, k.numel() // hd)

    def mlp(name, up_names, down_name, inter):
        if inter % tp:
            return
        idx = _block(inter, tp, rank)
        for u in up_names:
            cut(f"{name}.{u}", "col", idx)
        cut(f"{name}.{down_name}", "row", idx)

    for name, m in mods.items():
        pre = f"{name}." if name else ""
        if isinstance(m, Qwen2Attention):
            attention([name], m.heads, m.kv_heads, m.head_dim)
        elif isinstance(m, _Layers):  # the joint's two mixtures: one attention
            v, e = m.vlm, m.expert
            if (v.heads, v.kv_heads, v.head_dim) == (e.heads, e.kv_heads,
                                                      e.head_dim):
                attention([f"{pre}vlm", f"{pre}expert"], v.heads, v.kv_heads,
                          v.head_dim)
        elif isinstance(m, _Attn):
            if not m.qk_norm:  # a q/k RMSNorm over the whole width
                attention([name], m.heads, m.heads, m.head_dim, fused=True)
        elif isinstance(m, (Qwen2MLP, MixtureMLP)):
            mlp(name, ("gate_proj", "up_proj"), "down_proj",
                m.gate_proj.kernel_shape[-1])
        elif isinstance(m, _MLP):
            mlp(name, ("fc1",), "fc2", m.fc1.kernel_shape[-1])
        elif isinstance(m, MoEMLP):
            E = m.experts_gate_proj.shape[1]
            if E % tp == 0:
                idx = _block(E, tp, rank)
                p.splits[name] = ("experts", False, int(idx[0]),
                                  int(idx[-1]) + 1)
                for leaf in ("experts_gate_proj", "experts_up_proj",
                             "experts_down_proj"):
                    p.leaves[f"{pre}{leaf}"] = (1, idx)
        elif isinstance(m, Embed) and name.endswith("embed_tokens"):
            V = m.num_embeddings
            if V % tp == 0:
                idx = _block(V, tp, rank)
                p.splits[name] = ("vocab", False, int(idx[0]),
                                  int(idx[-1]) + 1)
                for leaf in ("embedding", "embedding_q", "embedding_scale"):
                    p.leaves[f"{pre}{leaf}"] = (0, idx)
        elif isinstance(m, Dense) and name.endswith("lm_head"):
            V = m.kernel_shape[-1]
            if V % tp == 0:
                cut(name, "col", _block(V, tp, rank), gather=True)
    return p


def shard_leaf(t: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """t's entries `idx` along `dim`, a new contiguous tensor."""
    if t.device.type == "meta":
        shape = list(t.shape)
        shape[dim] = idx.numel()
        return torch.empty(shape, dtype=t.dtype, device="meta")
    return t.index_select(dim, idx.to(t.device)).contiguous()


def refuse_cut(module: nn.Module, what: str) -> None:
    """Raise if `module` holds a leaf cut over the tensor axis: the fused
    stacks read whole weights (a single-device route in both packages)."""
    if any(getattr(m, "tp", None) is not None for m in module.modules()):
        raise ValueError(f"{what}: the model is cut over the tensor axis; "
                         "the fused stacks are single-device (serve it "
                         "through the plain route)")


@torch.no_grad()
def shard_model(model: nn.Module, size: int, rank: int, group=None
                ) -> nn.Module:
    """Cut `model`'s leaves in place to tensor rank `rank` of `size` (see
    the module docstring) and give its modules their collectives over
    `group`. A model cut once is left as it is."""
    if getattr(model, "_tensor_plan", None) is not None or size == 1:
        return model
    plans = [plan(model, size, r) for r in range(size)]
    p = plans[rank]
    mods = dict(model.named_modules())
    layout = {}
    for key, (dim, idx) in p.leaves.items():
        mod_name, _, leaf = key.rpartition(".")
        mod = mods[mod_name]
        t = mod._parameters.get(leaf, mod._buffers.get(leaf))
        if t is None:
            continue
        layout[key] = (dim, t.shape[dim],
                       [pl.leaves[key][1] for pl in plans])
        new = shard_leaf(t.detach(), dim, idx)
        if leaf in mod._parameters:
            mod._parameters[leaf] = nn.Parameter(
                new, requires_grad=t.requires_grad)
        else:
            mod._buffers[leaf] = new
        mod._buffers.pop("kernel_qt", None)  # derived from kernel_q again
    for name, (kind, gather, lo, hi) in p.splits.items():
        mods[name].tp = TensorSplit(kind, size, rank, group, gather, lo, hi)
    for name, (h, kv) in p.heads.items():
        mods[name].heads, mods[name].kv_heads = h, kv
    model._tensor_plan = p
    # {leaf: (dim, whole size, every rank's index)}: a checkpoint's
    # gather (utils/checkpoint.py)
    model._tensor_layout = layout
    return model


def shard_for_serving(model: nn.Module, mesh) -> nn.Module:
    """The serving layout of `model` on `mesh`: its leaves cut over the
    tensor axis (shard_model), then those its rules split over fsdp held
    as this rank's shards of them (gathered one leaf at a time by
    Block.leaf). Each call on a model already laid out on `mesh` is a
    no-op; a model laid out on another mesh raises."""
    import torch.distributed as dist

    held = getattr(model, "_serving_mesh", None)
    if held is mesh:
        return model
    if held is not None:
        raise ValueError("the model is laid out on another mesh")
    if not dist.is_initialized() or mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span every rank of the process "
                         "group")
    group, size, rank = tensor_group(mesh)
    shard_model(model, size, rank, group)
    if mesh_lib.axis_size(mesh, mesh_lib.FSDP_AXIS) > 1:
        from ..train.train_step import ShardedState

        model._fsdp_state = ShardedState(model, mesh)
    model._serving_mesh = mesh
    return model


def shard_for_training(model: nn.Module, mesh) -> nn.Module:
    """The training layout of `model` on `mesh`: its leaves cut over the
    tensor axis as for serving (shard_model; a no-op without one). Call
    it before the optimizer's parameter groups are made, since a cut
    leaf is a new Parameter; train/train_step.shard_train_state then
    holds the fsdp shards and owns the gradient sums. A LoRA adapter over
    a cut layer raises."""
    group, size, rank = tensor_group(mesh)
    return shard_model(model, size, rank, group)


def local_kv_heads(model: nn.Module, default: int) -> int:
    """The KV heads of a rank's cache: those of the model's first
    attention module (`default`, the config's, when it holds none)."""
    from ..models.qwen2 import Qwen2Attention
    from ..policy.joint import MixtureBlock

    for m in model.modules():
        if isinstance(m, (Qwen2Attention, MixtureBlock)):
            return m.kv_heads
    return default
