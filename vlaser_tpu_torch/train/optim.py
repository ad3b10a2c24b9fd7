"""Learning-rate schedules and the optimizer's parameter labels (port of
vlaser_tpu/train/optim.py). The optimizer itself is torch.optim's AdamW
(train/train_step.py)."""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Sequence, Tuple, Union

from torch import nn

from .train_step import ParamGroup


def cosine_warmup_restarts(
    max_lr: float,
    first_cycle_steps: int,
    cycle_mult: float = 1.0,
    min_lr: float = 1e-8,
    warmup_steps: int = 0,
    gamma: float = 1.0,
) -> Callable[[int], float]:
    """CosineAnnealingWarmupRestarts as a plain function of the step: per
    cycle, a linear warmup to max_lr * gamma^cycle, then a cosine to
    min_lr."""

    def schedule(step: int) -> float:
        step = float(step)
        if cycle_mult == 1.0:
            cycle = math.floor(step / first_cycle_steps)
            in_cycle = step - cycle * first_cycle_steps
            cycle_steps = float(first_cycle_steps)
        else:
            # closed form for geometric cycle growth
            cycle = math.floor(
                math.log1p(step / first_cycle_steps * (cycle_mult - 1.0))
                / math.log(cycle_mult))
            start = (first_cycle_steps * (cycle_mult ** cycle - 1.0)
                     / (cycle_mult - 1.0))
            in_cycle = step - start
            cycle_steps = first_cycle_steps * cycle_mult ** cycle
        peak = max_lr * gamma ** cycle
        warm = min(warmup_steps, cycle_steps - 1.0)
        if in_cycle < warm:
            return min_lr + (peak - min_lr) * in_cycle / max(warm, 1.0)
        progress = (in_cycle - warm) / max(cycle_steps - warm, 1.0)
        return min_lr + (peak - min_lr) * 0.5 * (1.0 + math.cos(
            math.pi * progress))

    return schedule


def warmup_cosine(max_lr: float, total_steps: int, warmup_ratio: float = 0.03,
                  min_ratio: float = 0.0) -> Callable[[int], float]:
    """HF Trainer-style cosine with warmup (the VLM SFT recipe: lr 2e-5,
    warmup_ratio 0.03), with optax.warmup_cosine_decay_schedule's
    semantics: linear from 0 to max_lr over max(1, int(total_steps *
    warmup_ratio)) steps, then a cosine to max_lr * min_ratio at
    total_steps (clamped to at least warmup + 1), flat after it."""
    warmup = max(1, int(total_steps * warmup_ratio))
    decay = max(total_steps, warmup + 1) - warmup
    alpha = min_ratio if max_lr != 0 else 0.0

    def schedule(step: int) -> float:
        if step < warmup:
            return max_lr * max(step, 0) / warmup
        c = min(step - warmup, decay)
        cos = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return max_lr * ((1.0 - alpha) * cos + alpha)

    return schedule


def label_params(model: nn.Module,
                 frozen_patterns: Sequence[str]) -> Dict[str, str]:
    """{parameter name: "train" | "frozen"}: a parameter is frozen when a
    pattern is found in its JAX path, "params/" + its name with "/" for
    "." ("params/vision_model/encoder/attn/qkv/kernel"), as the JAX
    optimizer labels its parameter tree."""
    return {name: ("frozen" if any(
        re.search(p, "params/" + name.replace(".", "/"))
        for p in frozen_patterns) else "train")
        for name, _ in model.named_parameters()}


def make_optimizer(model: nn.Module,
                   learning_rate: Union[float, Callable[[int], float]], *,
                   weight_decay: float = 0.01, grad_clip=1.0,
                   frozen_patterns: Sequence[str] = ()
                   ) -> Tuple[Dict[str, ParamGroup], List[nn.Parameter]]:
    """AdamW + clip with frozen-parameter labels, for make_train_step:
    -> ({"train": the trained parameters' group}, the frozen parameters).
    The clip covers the trained gradients only (None: no clip); the frozen
    parameters keep taking gradients, which the step counts in its
    grad_norm, and get no update and no decay (optax.set_to_zero)."""
    schedule = (learning_rate if callable(learning_rate)
                else lambda step: learning_rate)
    labels = label_params(model, frozen_patterns)
    named = dict(model.named_parameters())
    train = [named[n] for n, lab in labels.items() if lab == "train"]
    frozen = [named[n] for n, lab in labels.items() if lab == "frozen"]
    return {"train": ParamGroup(train, schedule, weight_decay,
                                grad_clip)}, frozen
