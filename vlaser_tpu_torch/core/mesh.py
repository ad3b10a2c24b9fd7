"""Sharding-rule layer of the device mesh (port of the rule half of
vlaser_tpu/core/mesh.py; no jax).

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

The DeviceMesh half (`make_mesh`, `tree_shardings`, `shard_batch`) goes
with the torch.distributed layouts and is not here yet.
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

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
