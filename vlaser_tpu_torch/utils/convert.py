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
from HWIO to torch's OIHW.
Nothing here imports jax.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# InternViT's (vision_model.embeddings.patch_embedding) and SigLIP's
# (vision_model.patch_embedding) conv kernels
_PATCH = ("embeddings.patch_embedding.kernel",
          "vision_model.patch_embedding.kernel")


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
