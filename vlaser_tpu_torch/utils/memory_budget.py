"""Per-device memory budget arithmetic for training recipes (port of
vlaser_tpu/utils/memory_budget.py; no jax).

Proves, without allocating anything, whether a train-state layout fits a
device: the port's model built on the `meta` device gives every
parameter's shape, core/mesh's rules give its spec, and the shard's byte
count follows. The reference's equivalent knob is its ZeRO-1 recipe
(zero_stage1_config.json, internvl3_2b_dynamic_res_2nd_finetune_full.sh:67);
here ZeRO == sharding parameters / gradients / moments over the 'fsdp'
axis.

A leaf is `(path, shape, dtype)`: the JAX path string of the parameter
(`core.mesh.path_str`) and its shape in the JAX layout (a patch-embedding
conv is HWIO there, OIHW in the port), so that a rule splits the same dim
in both packages.
"""

from __future__ import annotations

import re
import types
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core import mesh as mesh_lib

Leaf = Tuple[str, Tuple[int, ...], torch.dtype]

GiB = 1024 ** 3


def _shard_denominator(spec, shape, mesh) -> int:
    """How many ways the leaf is split (a dim that its axes do not divide
    stays whole)."""
    denom = 1
    for d, names in enumerate(tuple(spec)[: len(shape)]):
        if names is None:
            continue
        names_t = names if isinstance(names, tuple) else (names,)
        size = int(np.prod([mesh.shape[n] for n in names_t]))
        if shape[d] % size == 0:
            denom *= size
    return denom


def sharded_bytes_per_device(leaves: Sequence[Leaf], mesh, rules) -> int:
    """Total bytes a device holds of `leaves` under path rules."""
    total = 0
    for path, shape, dtype in leaves:
        spec = mesh_lib.spec_for(path, rules)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        total += nbytes // _shard_denominator(spec, shape, mesh)
    return total


def count_params(leaves: Sequence[Leaf]) -> int:
    return sum(int(np.prod(shape)) for _, shape, _ in leaves)


def param_leaves(model: torch.nn.Module) -> List[Leaf]:
    """(path, shape, dtype) of every parameter of `model` (a model built on
    the `meta` device costs no memory), in the JAX layout."""
    from .convert import is_patch_conv

    out = []
    for name, t in model.named_parameters():
        shape = tuple(t.shape)
        if is_patch_conv(name):  # OIHW -> HWIO
            shape = tuple(shape[i] for i in (2, 3, 1, 0))
        out.append((mesh_lib.path_str(name), shape, t.dtype))
    return out


def _cast(leaves: Sequence[Leaf], dtype_bytes: int) -> List[Leaf]:
    dt = {4: torch.float32, 2: torch.bfloat16}[dtype_bytes]
    return [(p, s, dt) for p, s, _ in leaves]


def _drop_frozen(leaves: Sequence[Leaf], frozen_patterns) -> List[Leaf]:
    return [l for l in leaves
            if not any(re.search(p, l[0]) for p in frozen_patterns)]


def vla_train_budget(
    dp: int,
    fsdp: int,
    tp: int,
    per_device_batch: int = 1,
    param_bytes: int = 4,
    frozen_patterns: Sequence[str] = (),
    model_size: str = "2b",  # '2b' | '8b'
) -> Dict[str, float]:
    """Full-parameter Vlaser-2B/8B-VLA AdamW budget on a dp x fsdp x tp mesh.

    Returns GiB per device for params / grads / adam moments / a remat
    activation estimate, plus the total. The train state is
    scripts/train_vla.py's: fp32 params (param_bytes=4), fp32 grads and
    moments (AdamW), bf16 compute with per-layer remat. frozen_patterns
    remove grads and moments for matching paths (e.g. the frozen ViT
    recipe).

    The activation term is analytic: with per-layer remat over the joint
    stack, the live set at the backward of layer i is the checkpointed
    per-layer stream inputs (all layers) + one layer's internals
    (qkv / attention probs / mlp hidden in bf16), plus the un-remat'd ViT
    forward. It over-counts attention (the flash kernel never materializes
    S^2) -- a deliberate safety margin.
    """
    from ..core.config import (VLAConfig, action_expert_8b, vlaser_2b_vla,
                               vlaser_8b)

    if model_size == "8b":
        cfg = VLAConfig(vlm=vlaser_8b(151674 + 256), expert=action_expert_8b())
    else:
        cfg = vlaser_2b_vla()
    return _vla_budget(cfg, dp, fsdp, tp, per_device_batch, param_bytes,
                       frozen_patterns)


def _vla_budget(cfg, dp, fsdp, tp, per_device_batch=1, param_bytes=4,
                frozen_patterns=()) -> Dict[str, float]:
    """vla_train_budget's arithmetic for a VLAConfig."""
    from ..policy.pizero import PiZeroVLA

    model = PiZeroVLA(cfg, param_dtype=torch.float32,
                      compute_dtype=torch.bfloat16,
                      device=torch.device("meta"))
    leaves = param_leaves(model)
    S = cfg.max_image_text_tokens
    A = cfg.num_action_tokens
    mesh = _abstract_mesh(dp, fsdp, tp)
    rules = mesh_lib.default_param_rules()

    params_b = sharded_bytes_per_device(_cast(leaves, param_bytes), mesh,
                                        rules)
    trainable = _drop_frozen(leaves, frozen_patterns)
    grads_b = sharded_bytes_per_device(_cast(trainable, 4), mesh, rules)
    moments_b = 2 * grads_b

    # activation estimate (bf16 = 2 bytes), per device batch
    b = per_device_batch
    L = cfg.vlm.llm.num_layers
    h_v, h_e = cfg.vlm.llm.hidden_size, cfg.expert.hidden_size
    q_heads, hd = cfg.vlm.llm.num_heads, cfg.vlm.llm.head_dim
    Spa = cfg.num_proprio_tokens + A
    ckpt = L * b * (S * h_v + Spa * h_e) * 2  # remat'd per-layer stream inputs
    S_tot = S + Spa
    layer_live = b * (
        3 * S_tot * q_heads * hd  # q/k/v
        + q_heads * S_tot * S_tot  # attention probs (over-count vs flash)
        + 2 * S * cfg.vlm.llm.intermediate_size  # vlm mlp gate/up
        + 2 * Spa * cfg.expert.intermediate_size
    ) * 2
    vcfg = cfg.vlm.vision
    S_vit = (vcfg.image_size // vcfg.patch_size) ** 2 + 1
    vit_live = (
        vcfg.num_layers * b * S_vit * vcfg.hidden_size * 2 * 3
    )  # un-remat'd ViT forward (x, attn out, mlp) per layer
    acts_b = ckpt + layer_live + vit_live

    out = {
        "mesh": f"{dp}x{fsdp}x{tp}",
        "n_params": count_params(leaves),
        "params_gib": params_b / GiB,
        "grads_gib": grads_b / GiB,
        "moments_gib": moments_b / GiB,
        "acts_gib": acts_b / GiB,
    }
    out["total_gib"] = sum(v for k, v in out.items() if k.endswith("_gib"))
    return out


def _abstract_mesh(dp: int, fsdp: int, tp: int, pp: int = 1):
    """A mesh-shaped stand-in (only .shape is consulted)."""
    return types.SimpleNamespace(shape={
        mesh_lib.DATA_AXIS: dp,
        mesh_lib.FSDP_AXIS: fsdp,
        mesh_lib.TENSOR_AXIS: tp,
        mesh_lib.STAGE_AXIS: pp,
    })


def vlm_sft_budget(
    dp: int,
    fsdp: int,
    tp: int,
    pp: int = 1,
    cp: int = 1,
    per_device_batch: int = 1,
    seq_len: int = 4096,
    n_microbatches: int = 8,
    param_bytes: int = 4,
    frozen_patterns: Sequence[str] = (),
    model_size: str = "38b",  # '2b'|'8b'|'30b-a3b'|'38b'|'78b'|'100b'
    offload_optimizer: bool = False,
) -> Dict[str, float]:
    """Full-parameter VLM SFT AdamW budget on a dp x fsdp x (pp) x tp mesh.

    The 34B+ tier (internvl3_38b: InternViT-6B + Qwen2.5-32B -- the tier
    the reference trains with zero_stage3_config.json) adds the stage axis:
    the stacked layers' params / grads / moments split over `pp` stages
    (core/mesh.stageify_rules), composing with fsdp inside each stage. The
    activation arithmetic assumes a GPipe schedule: per-layer remat
    checkpoints for the local L/pp layers across the whole per-device
    batch, plus one microbatch's layer internals (flash attention is O(S)
    -- no S^2 probs term here, unlike the deliberately over-counting VLA
    estimate above).

    offload_optimizer is the analogue of the reference's
    zero_stage3_config_100b_1e7_offload.json (`offload_optimizer:
    device=cpu`): the Adam moments live in host RAM; the device total then
    excludes them and `host_offload_gib` reports the per-host bill.
    """
    from ..core.config import (internvl3_5_30b_a3b, internvl3_38b,
                               internvl3_78b, internvl_100b_class, vlaser_2b,
                               vlaser_8b)
    from ..models.vlm import InternVLChatModel

    cfg = {"2b": vlaser_2b, "8b": vlaser_8b, "38b": internvl3_38b,
           "30b-a3b": internvl3_5_30b_a3b, "78b": internvl3_78b,
           "100b": internvl_100b_class}[model_size]()
    model = InternVLChatModel(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.bfloat16,
                              device=torch.device("meta"))
    leaves = param_leaves(model)
    mesh = _abstract_mesh(dp, fsdp, tp, pp)
    rules = mesh_lib.default_param_rules()
    if pp > 1:
        rules = mesh_lib.stageify_rules(rules)

    params_b = sharded_bytes_per_device(_cast(leaves, param_bytes), mesh,
                                        rules)
    trainable = _drop_frozen(leaves, frozen_patterns)
    grads_b = sharded_bytes_per_device(_cast(trainable, 4), mesh, rules)
    moments_b = 2 * grads_b

    # context parallelism (ring attention) shards the sequence over the cp
    # axis: every per-token activation term divides by cp
    b, S = per_device_batch, seq_len // cp
    llm = cfg.llm
    L_local = llm.num_layers // pp if pp > 1 else llm.num_layers
    mb = max(1, b // n_microbatches) if pp > 1 else b
    ckpt = L_local * b * S * llm.hidden_size * 2
    # sparse MoE: each token activates k experts of moe_intermediate width
    mlp_width = (
        llm.num_experts_per_tok * (llm.moe_intermediate_size
                                   or llm.intermediate_size)
        if llm.num_experts > 0 else llm.intermediate_size
    )
    layer_live = mb * S * (
        3 * llm.num_heads * llm.head_dim  # q + attention O(S) live
        + 2 * llm.num_kv_heads * llm.head_dim
        + 2 * mlp_width  # gate/up
    ) * 2
    vcfg = cfg.vision
    S_vit = (vcfg.image_size // vcfg.patch_size) ** 2 + 1
    vit_live = vcfg.num_layers * b * S_vit * vcfg.hidden_size * 2 * 3
    acts_b = ckpt + layer_live + vit_live

    out = {
        "mesh": f"{dp}x{fsdp}x{pp}x{cp}x{tp}",
        "n_params": count_params(leaves),
        "params_gib": params_b / GiB,
        "grads_gib": grads_b / GiB,
        "moments_gib": 0.0 if offload_optimizer else moments_b / GiB,
        "acts_gib": acts_b / GiB,
    }
    out["total_gib"] = sum(v for k, v in out.items() if k.endswith("_gib"))
    if offload_optimizer:
        # per-host bill: 8 device shards of moments in one host's RAM (8 is
        # the devices a host drives in the reference recipe, kept for
        # parity with the JAX package)
        out["host_offload_gib"] = 8 * moments_b / GiB
    return out
