"""Device mesh and sharding rules (port of vlaser_tpu/core/mesh.py; no
jax): a torch.distributed DeviceMesh and path-pattern rules that give each
parameter its DTensor placements.

Axes:
  data    -- batch sharding (pure DP)
  fsdp    -- parameter + optimizer-state sharding (ZeRO-equivalent); the
             batch shards over (data, fsdp) jointly
  stage   -- pipeline stages (the leading [L] dim of the layer stacks)
  context -- the sequence (ring attention)
  tensor  -- within-op model parallelism (QKV/MLP columns, vocab)

A spec is a plain tuple with one entry per leading dim: an axis name, a
tuple of axis names, or None (that dim is not split); () means replicated.
It equals `tuple(jax.sharding.PartitionSpec(...))` of the JAX rules.
Rules match the JAX parameter path ("params/a/b/kernel"), which
`path_str` builds from a port parameter name.

`make_mesh` builds a DeviceMesh over the process group's ranks with the
JAX axis order; `rank_group` / `batch_group` give the process groups of
ranks that share coordinates (the batch ranks: data x fsdp x context, one
group a (stage, tensor) index); `tree_shardings` turns the rules into one
DTensor `Placement` per mesh dimension for each parameter (Shard(d) where
the rule names that axis for dim d, Replicate elsewhere), and `shard_batch`
does the same for a batch's leaves. `set_mesh` makes a mesh ambient (the
context-parallel LLM reads its `context` group there), as jax.set_mesh.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Callable, Dict, Optional, Sequence, Tuple

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
CONTEXT_AXIS = "context"
TENSOR_AXIS = "tensor"
STAGE_AXIS = "stage"
AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)

BATCH_AXES = (DATA_AXIS, FSDP_AXIS)  # activation batch dim shards over both

Spec = Tuple
Rule = Tuple[str, Spec]


def path_str(name: str) -> str:
    """A port parameter name -> the JAX path string of the same leaf in
    the model's variables ("params/" + the name with "." -> "/"), with the
    converter's rename undone: a patch-embedding conv's "weight" (OIHW
    here) is the JAX "kernel" (HWIO; utils/convert.to_jax_params)."""
    from ..utils.convert import is_patch_conv

    if is_patch_conv(name):
        name = name[:-len("weight")] + "kernel"
    return "params/" + name.replace(".", "/")


def spec_for(path: str, rules: Sequence[Rule]) -> Spec:
    """The spec of the first rule whose pattern is found in `path`;
    () (replicated) when none is."""
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return ()


# Default rules for the transformer stacks. Layers are stacked, so weights
# have a leading [num_layers] dim: specs below start with None for it
# where the path holds 'layers/'.
def default_param_rules(fsdp_only: bool = False) -> Sequence[Rule]:
    t = None if fsdp_only else TENSOR_AXIS
    f = FSDP_AXIS
    return [
        # stacked LLM / expert / joint layers: [L, in, out] kernels
        (r"layers/.*(q_proj|k_proj|v_proj|gate_proj|up_proj)/kernel",
         (None, f, t)),
        (r"layers/.*(o_proj|down_proj)/kernel", (None, t, f)),
        # sparse MoE (models/moe.py): expert parallelism = the leading [E]
        # dim over the tensor axis; hidden over fsdp inside each expert.
        # The router stays replicated.
        (r"layers/.*experts_(gate|up)_proj", (None, t, f, None)),
        (r"layers/.*experts_down_proj", (None, t, None, f)),
        (r"layers/.*bias", ()),
        (r"layers/.*(norm|layernorm|scale)", ()),
        # ViT stacked layers (InternViT / SigLIP 'encoder'): qkv fused
        # [L, in, 3 * out]
        (r"encoder/.*qkv/kernel", (None, f, t)),
        (r"encoder/.*attn/proj/kernel", (None, t, f)),
        (r"encoder/.*fc1/kernel", (None, f, t)),
        (r"encoder/.*fc2/kernel", (None, t, f)),
        # embeddings / heads
        (r"embed_tokens/embedding", (t, f)),
        (r"lm_head/kernel", (f, t)),
        # projector: tensor-parallel columns only, no fsdp on the
        # contracting dim (the batch-sharded ViT output feeds it; ~9M
        # parameters, so replicating its state over fsdp is noise)
        (r"mlp1/.*kernel", (None, t)),
        # everything else (biases, norms, small encoders) replicated
    ]


def stageify_rules(rules: Sequence[Rule], axis: str = STAGE_AXIS
                   ) -> Sequence[Rule]:
    """Pipeline-parallel variant of a rule set: the leading [L] dim of the
    stacked LLM layers ('layers/' patterns) also shards over the stage
    axis. The ViT ('encoder/') and non-layer rules are unchanged."""
    out = []
    for pat, spec in rules:
        if pat.startswith(r"layers/") and spec and spec[0] is None:
            spec = (axis,) + tuple(spec[1:])
        out.append((pat, spec))
    return out


def batch_spec(extra_dims: int = 1) -> Spec:
    """[batch, ...] activations sharded over (data, fsdp)."""
    return (BATCH_AXES,) + (None,) * extra_dims


# ---------------------------------------------------------------------------
# The DeviceMesh
# ---------------------------------------------------------------------------

def make_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1, cp: int = 1,
              pp: int = 1, device_type: Optional[str] = None):
    """A (data, fsdp[, stage][, context], tensor) DeviceMesh over the
    ranks of the default process group (core/distributed.initialize);
    dp=-1 takes all remaining ranks. The stage and context axes appear
    only when pp / cp > 1, as in the JAX mesh. device_type: "cuda" or
    "cpu" (None: "cuda" under an NCCL group, else "cpu")."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "core.distributed.initialize (or "
                           "torch.distributed.init_process_group) first")
    n = dist.get_world_size()
    if dp == -1:
        assert n % (fsdp * tp * cp * pp) == 0, \
            f"{n} devices not divisible by fsdp*tp*cp*pp"
        dp = n // (fsdp * tp * cp * pp)
    assert dp * fsdp * tp * cp * pp == n, \
        f"mesh {dp}x{fsdp}x{pp}x{cp}x{tp} != {n}"
    shape, axes = [dp, fsdp], [DATA_AXIS, FSDP_AXIS]
    if pp > 1:
        shape.append(pp)
        axes.append(STAGE_AXIS)
    if cp > 1:
        shape.append(cp)
        axes.append(CONTEXT_AXIS)
    shape.append(tp)
    axes.append(TENSOR_AXIS)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (JAX's Mesh.shape)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, axis: str) -> int:
    """The size of `axis` (1 for an axis the mesh does not have)."""
    return mesh_shape(mesh).get(axis, 1) if mesh is not None else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (0 without the axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def context_slice(x, mesh, dim: int = 1, axis: str = CONTEXT_AXIS):
    """This rank's contiguous slice of a sequence dim split over `axis`
    (x itself without the axis)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    c = x.shape[dim] // n
    assert c * n == x.shape[dim], (x.shape[dim], n)
    return x.narrow(dim, axis_index(mesh, axis) * c, c)


def batch_shard(mesh) -> Tuple[int, int]:
    """-> (index, count) of this rank's block of batch rows: the batch
    shards over (data, fsdp), data major, as JAX's P(('data', 'fsdp')).
    The tensor (and context) index plays no part: the ranks of a tensor
    group feed the same rows."""
    f = axis_size(mesh, FSDP_AXIS)
    return (axis_index(mesh, DATA_AXIS) * f + axis_index(mesh, FSDP_AXIS),
            axis_size(mesh, DATA_AXIS) * f)


def rank_group(mesh, name: str, key: Callable[[Dict[str, int]], object]):
    """-> (process group, size) of the ranks whose coordinates ({axis:
    index}) give the same key(coords) as this rank's: (None, n) when that
    is every rank of the mesh (the default group; the mesh spans the
    process group), (None, 1) for this rank alone. new_group is
    collective, so every rank calls this at the same point; the groups
    are built once a mesh and `name`, and kept on the mesh."""
    import itertools

    import torch.distributed as dist

    cache = mesh.__dict__.setdefault("_rank_groups", {})
    if name in cache:
        return cache[name]
    names, ranks = mesh.mesh_dim_names, mesh.mesh
    blocks: Dict[object, list] = {}
    for idx in itertools.product(*(range(n) for n in ranks.shape)):
        k = key(dict(zip(names, idx)))
        blocks.setdefault(k, []).append(int(ranks[idx]))
    me = key(dict(zip(names, mesh.get_coordinate())))
    out = (None, len(blocks[me]))
    if len(blocks) > 1:
        for k in sorted(blocks, key=repr):  # one order on every rank
            g = dist.new_group(blocks[k]) if len(blocks[k]) > 1 else None
            if k == me:
                out = (g, len(blocks[k]))
    cache[name] = out
    return out


def batch_group(mesh):
    """-> (process group, size) of the batch ranks: data x fsdp (x
    context), one group for each (stage, tensor) index. Every sum over
    another part of the batch (a gradient, a loss's numerator or
    denominator) runs over them, never over tensor, whose ranks hold one
    replica of the batch, nor over stage, whose ranks run other layers of
    the same rows (train/pipeline.py). (None, 1) without a mesh."""
    if mesh is None:
        return None, 1
    return rank_group(mesh, "batch", lambda c: (c.get(STAGE_AXIS, 0),
                                                c.get(TENSOR_AXIS, 0)))


def _placements(spec: Spec, shape, mesh):
    """A spec -> one Placement per mesh dimension. A dim that the product
    of its axes does not divide, or one past the leaf's rank, stays whole
    (Replicate), as JAX's tree_shardings degrades it."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, names in enumerate(tuple(spec)):
        if names is None or d >= len(shape):
            continue
        names_t = names if isinstance(names, tuple) else (names,)
        if shape[d] % math.prod(sizes.get(a, 1) for a in names_t):
            continue
        for a in names_t:
            if a in sizes:
                out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


def tree_shardings(tree, mesh, rules: Sequence[Rule]):
    """{port parameter name: tensor (or shape)} -> {name: placements}, the
    rule of `path_str(name)`. The names are the port's, the shapes its
    layout; the one leaf whose layout differs from JAX's, a patch conv
    (OIHW here), matches no rule and is replicated either way."""
    out = {}
    for name, leaf in tree.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        out[name] = _placements(spec_for(path_str(name), rules), shape, mesh)
    return out


def shard_batch(tree, mesh):
    """{key: array} -> {key: placements}: the leading dim over (data,
    fsdp) where their product divides it, else replicated (scalars
    too)."""
    out = {}
    for key, leaf in tree.items():
        shape = tuple(getattr(leaf, "shape", ()))
        spec = (BATCH_AXES,) if shape else ()
        out[key] = _placements(spec, shape, mesh)
    return out


_ambient = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Make `mesh` the ambient mesh inside the block (jax.set_mesh): the
    context-parallel LLM takes its ring's group from it."""
    _ambient.append(mesh)
    try:
        yield mesh
    finally:
        _ambient.pop()


def current_mesh():
    """The innermost ambient mesh, or None."""
    return _ambient[-1] if _ambient else None
