"""JAX variables -> the port's flat state.

`from_jax_variables` takes the `params` (and optional `quant`: int8
weights, their scales and the w8a8 `kernel_aq` flags; and optional `lora`:
the activation-path factors `a` / `b` of train/lora.init_qlora_collection,
named `lora_a` / `lora_b` on their Dense) collections
of a vlaser_tpu model as nested dicts of numpy arrays (for example
`jax.tree_util.tree_map(np.asarray, variables)`) and returns
{dotted name: torch tensor} for `models.layers.load_state`. Names mirror the
JAX paths ("a/b/c" -> "a.b.c"); this is the only place where a layout
changes: the patch-embedding conv kernels (InternViT's and SigLIP's) go
from HWIO to torch's OIHW. `to_jax_params` is its inverse for float
parameters: a port model's state -> the JAX `params` tree of numpy arrays
(fp32), the input of utils/hf_convert's exporters.
`adam8bit_state_from_jax` carries the moments of a JAX 8-bit AdamW state
(train/optim8bit.py) across as the port's per-parameter AdamW8bit state.
`tensor_shards` gives one tensor rank's shards of the JAX variables
(core/tensor_parallel's layout: the strided ViT qkv, the int8 `kernel_q`
and per-column scales cut as their kernel), the state of a model cut by
core/tensor_parallel.shard_model. Nothing here imports jax.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# InternViT's (vision_model.embeddings.patch_embedding) and SigLIP's
# (vision_model.patch_embedding) conv kernels
_PATCH = ("embeddings.patch_embedding.kernel",
          "vision_model.patch_embedding.kernel")


def is_patch_conv(name: str) -> bool:
    """A port parameter name of a patch-embedding conv weight (OIHW here,
    HWIO in the JAX tree)."""
    return name.endswith("weight") and (
        name[:-len("weight")] + "kernel").endswith(_PATCH)


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, name)
        else:
            yield name, v


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: exact through fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for col in ("params", "quant", "lora"):
        for name, leaf in _flatten(variables.get(col, {})):
            t = _to_torch(leaf)
            if name.endswith(_PATCH):  # HWIO -> OIHW
                name, t = name[:-len("kernel")] + "weight", t.permute(3, 2, 0, 1)
            if col == "lora":
                mod, dot, leaf_name = name.rpartition(".")
                name = f"{mod}{dot}lora_{leaf_name}"
            out[name] = t.contiguous()
    return out


def tensor_shards(variables: Mapping, model, size: int, rank: int
                  ) -> Dict[str, torch.Tensor]:
    """The state of tensor rank `rank` of `size`: from_jax_variables of
    `variables`, each leaf that core/tensor_parallel.plan cuts for `model`
    (a port model of the same config, whole; on `meta` it costs nothing)
    cut to this rank's entries. Load it into that model after
    core/tensor_parallel.shard_model(model, size, rank)."""
    from ..core.tensor_parallel import plan, shard_leaf

    state = from_jax_variables(variables)
    cuts = plan(model, size, rank).leaves
    return {name: (shard_leaf(t, *cuts[name]) if name in cuts else t)
            for name, t in state.items()}


def to_jax_params(state: Mapping[str, torch.Tensor]) -> Dict:
    """{dotted name: float tensor} (a port model's state_dict) -> the
    nested JAX `params` tree of fp32 numpy arrays (the patch convs back to
    HWIO "kernel"s)."""
    tree: Dict = {}
    for name, t in state.items():
        if not t.is_floating_point():
            raise TypeError(f"{name}: {t.dtype} is not a float parameter")
        t = t.detach()
        if is_patch_conv(name):
            name, t = name[:-len("weight")] + "kernel", t.permute(2, 3, 1, 0)
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.float().cpu().contiguous().numpy()
    return tree


def adam8bit_state_from_jax(moments: Mapping, count: int
                            ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The moments of a JAX Adam8bitState (a params-shaped nested dict whose
    leaves are an Adam8bitLeaf's (m_q, m_scale, v_q, v_scale), or a small
    leaf's fp32 (m, v), as numpy) and its count -> {port parameter name:
    train/optim8bit.AdamW8bit state}. The 8-bit blocks are copied as they
    are: a patch conv's stay in the JAX leaf's HWIO order, in which
    AdamW8bit(hwio=...) steps them; a small leaf's moments take the port's
    layout."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, leaf in _flatten(moments):
        if name.endswith(_PATCH):
            name = name[:-len("kernel")] + "weight"
        st = {"step": torch.tensor(float(count))}
        if len(leaf) == 4:
            for k, a in zip(("m_q", "m_scale", "v_q", "v_scale"), leaf):
                st[k] = _to_torch(a)
        else:
            for k, a in zip(("m", "v"), leaf):
                t = _to_torch(a)
                st[k] = t.permute(3, 2, 0, 1).contiguous() if is_patch_conv(
                    name) else t
        out[name] = st
    return out


def load_optimizer_state(optimizer, model,
                         states: Mapping[str, Dict[str, torch.Tensor]]):
    """Put {parameter name: state} into `optimizer`'s per-parameter state,
    each tensor on its parameter's device (the count stays on the host)."""
    named = dict(model.named_parameters())
    for name, st in states.items():
        p = named[name]
        optimizer.state[p] = {k: v if k == "step" else v.to(p.device)
                              for k, v in st.items()}
    return optimizer
