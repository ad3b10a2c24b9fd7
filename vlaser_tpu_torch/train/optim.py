"""Learning-rate schedules (port of vlaser_tpu/train/optim.py). The
optimizers themselves are torch.optim's (train/train_step.py)."""

from __future__ import annotations

import math
from typing import Callable


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
