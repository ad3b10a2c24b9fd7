"""Training / eval metrics (port of vlaser_tpu/train/metrics.py): the
reference's get_action_accuracy (a step counts only when every action
dimension is within the threshold) and the L1 of its eval loop."""

from __future__ import annotations

from typing import Sequence

import torch


def action_accuracy(gt: torch.Tensor, pred: torch.Tensor,
                    thresholds: Sequence[float] = (0.1, 0.2)) -> torch.Tensor:
    """gt, pred [B, horizon, action_dim] -> [len(thresholds)] fp32: the
    share of the B * horizon steps whose every dimension lies within the
    threshold."""
    diff = (gt - pred).abs().reshape(-1, gt.shape[-1])
    accs = []
    for th in thresholds:
        per_step = (diff < th).float().mean(1) >= 1.0
        accs.append(per_step.float().mean())
    return torch.stack(accs)


def action_l1(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return (gt - pred).abs().mean()
