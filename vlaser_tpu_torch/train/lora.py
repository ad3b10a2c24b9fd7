"""LoRA over the port's flat state and modules (port of
vlaser_tpu/train/lora.py).

Two forms, as in the JAX package:
- weight-path LoRA over a flat {dotted name: tensor} state
  (`init_lora_params`, `apply_lora`, `merge_lora`): the effective kernel is
  W + (alpha / r) a @ b, materialized before the forward (and once, for an
  export);
- activation-path QLoRA (`init_qlora_collection`): each matching Dense,
  float or int8 (core/quant.py), gets the factors `lora_a` [in, r] and
  `lora_b` [r, out] ([L, in, r] / [L, r, out] on a stacked block) as
  parameters, and adds (x a) b to its output (models/layers.Dense) without
  ever forming the base weight plus the delta, so the int8 base stays int8.
  alpha / r is folded into a; b starts at 0, so the model starts at the
  base model's output. `merge_qlora_into_quant` is the export: dequantize,
  add a @ b, return a plain float state.

Target patterns are matched against "/"-joined paths of the kernel
("language_model/model/layers/self_attn/q_proj/kernel"), the JAX package's
names. Random draws come from an explicit `torch.Generator`; they are not
the JAX package's draws (tests carry the JAX factors across instead).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ..models.layers import LORA_FACTORS, Dense

# peft target_modules for Qwen2 (modeling_internvl_chat.py:133-135)
LLM_TARGETS = (
    r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)/kernel$",
)
# ViT targets (:114)
BACKBONE_TARGETS = (r"(qkv|attn/proj|fc1|fc2)/kernel$",)


def _matches(path: str, patterns: Sequence[str]) -> bool:
    return any(re.search(p, path) for p in patterns)


def _factors(shape, r: int, scale: float, dtype, generator, device):
    """a ~ N(0, 1/r^2) * scale, b = 0 for a kernel [..., in, out]."""
    *lead, din, dout = shape
    a = torch.randn((*lead, din, r), generator=generator,
                    dtype=torch.float32, device=device) / r * scale
    return a.to(dtype), torch.zeros((*lead, r, dout), dtype=dtype,
                                    device=device)


def init_lora_params(generator: Optional[torch.Generator],
                     state: Mapping[str, torch.Tensor],
                     target_patterns: Sequence[str] = LLM_TARGETS,
                     r: int = 128, dtype=torch.float32
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """-> {kernel name: {"a", "b"}} for every kernel of `state` (a flat
    {dotted name: tensor} state) whose path matches: a [..., in, r] ~
    N(0, 1/r^2), b [..., r, out] = 0, so the delta starts at zero."""
    lora = {}
    for name, leaf in state.items():
        if not _matches(name.replace(".", "/"), target_patterns):
            continue
        if leaf.dim() not in (2, 3):
            raise ValueError(f"LoRA target must be a kernel: {name}")
        a, b = _factors(leaf.shape, r, 1.0, dtype, generator, leaf.device)
        lora[name] = {"a": a, "b": b}
    return lora


def apply_lora(state: Mapping[str, torch.Tensor],
               lora: Mapping[str, Mapping[str, torch.Tensor]], alpha: float,
               r: int) -> Dict[str, torch.Tensor]:
    """-> the state with base + (alpha / r) a @ b in place of each adapted
    kernel (in the kernel's dtype); differentiable in the factors."""
    scale = alpha / r
    out = dict(state)
    for name, ab in lora.items():
        base = state[name]
        # [..., in, r] @ [..., r, out], batched over a stack
        out[name] = base + (scale * (ab["a"] @ ab["b"])).to(base.dtype)
    return out


@torch.no_grad()
def merge_lora(state, lora, alpha: float, r: int) -> Dict[str, torch.Tensor]:
    """One-shot merge for export (tools/merge_lora.py parity)."""
    return apply_lora(state, lora, alpha, r)


def count_lora_params(lora) -> int:
    """Elements of every factor: a {name: {"a", "b"}} tree or the
    {name: parameter} that init_qlora_collection returns."""
    if all(torch.is_tensor(v) for v in lora.values()):
        return sum(v.numel() for v in lora.values())
    return sum(t.numel() for ab in lora.values() for t in ab.values())


@torch.no_grad()
def init_qlora_collection(model: nn.Module,
                          target_patterns: Sequence[str] = LLM_TARGETS,
                          r: int = 128, alpha: float = 256.0,
                          dtype=torch.float32,
                          generator: Optional[torch.Generator] = None
                          ) -> Dict[str, nn.Parameter]:
    """Give every Dense of `model` whose kernel (float `kernel` or int8
    `kernel_q`) matches the patterns the activation-path factors `lora_a`
    (~ N(0, 1/r^2) * alpha / r) and `lora_b` (zeros), as parameters on the
    kernel's device. -> {dotted name: parameter} of the new factors (the
    JAX `lora` collection's leaves, `a` / `b` named `lora_a` / `lora_b`),
    the parameters a QLoRA step trains."""
    scale = alpha / r  # folded into a, as the JAX collection does
    out: Dict[str, nn.Parameter] = {}
    for mod_name, mod in model.named_modules():
        if not isinstance(mod, Dense):
            continue
        kernel = (mod._parameters.get("kernel")
                  if "kernel" in mod._parameters
                  else mod._buffers.get("kernel_q"))
        path = "/".join(filter(None, [mod_name.replace(".", "/"), "kernel"]))
        if kernel is None or not _matches(path, target_patterns):
            continue
        if kernel.dim() not in (2, 3):
            raise ValueError(f"LoRA target must be a kernel: {path}")
        a, b = _factors(kernel.shape, r, scale, dtype, generator,
                        kernel.device)
        for leaf, t in zip(LORA_FACTORS, (a, b)):
            mod.register_parameter(leaf, nn.Parameter(t))
            out[f"{mod_name}.{leaf}"] = getattr(mod, leaf)
    return out


@torch.no_grad()
def merge_qlora_into_quant(state: Mapping[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """Export: a flat state of a QLoRA model (its named parameters and
    buffers, or its state_dict) -> a plain float state. int8 kernels and
    embeddings are dequantized in fp32 (q * scale), each Dense's a @ b is
    added to its kernel in the kernel's dtype, and the w8a8 flags, scales
    and factors are dropped: `models.layers.load_state` loads the result
    into an unquantized model."""
    out: Dict[str, torch.Tensor] = {}
    for name, val in state.items():
        mod, dot, leaf = name.rpartition(".")
        if leaf in ("kernel_q", "embedding_q"):
            base = mod + dot + leaf[:-2]
            out[base] = val.float() * state[base + "_scale"]
        elif leaf not in ("kernel_scale", "embedding_scale", "kernel_aq",
                          "kernel_qt", *LORA_FACTORS):
            out[name] = val.detach().clone()
    for name, a in state.items():
        mod, dot, leaf = name.rpartition(".")
        if leaf != "lora_a":
            continue
        key = f"{mod}{dot}kernel"
        b = state[f"{mod}{dot}lora_b"]
        out[key] = out[key] + (a @ b).to(out[key].dtype)
    return out
