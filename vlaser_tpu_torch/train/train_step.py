"""The train step (port of vlaser_tpu/train/train_step.py, one device, no
mesh).

Each parameter group is clipped by its own global norm and then takes an
AdamW step (b1 0.9, b2 0.999, eps 1e-8, decoupled decay on every leaf):
the JAX trainer puts `clip_by_global_norm` inside each group's chain of
`optax.multi_transform`, so a group never sees another group's norm.
torch.optim.AdamW computes optax's adamw update; the learning rate of update
i (from 0) is the group's schedule(i), as optax counts. The reported
`grad_norm` is the norm over every trained gradient before clipping.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import torch
from torch import nn


@dataclass
class ParamGroup:
    params: List[nn.Parameter]
    schedule: Callable[[int], float]  # step -> learning rate
    weight_decay: float = 0.01
    grad_clip: float = 1.0


def grad_norm(params) -> torch.Tensor:
    """Global L2 norm (fp32, on device) of the parameters' gradients."""
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros((), device=params[0].device if params else None)
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))


def group_grad_norms(groups: Dict[str, ParamGroup]) -> Dict[str, torch.Tensor]:
    return {name: grad_norm(g.params) for name, g in groups.items()}


def make_train_step(loss_fn: Callable[[Dict], torch.Tensor],
                    groups: Dict[str, ParamGroup], accum_steps: int = 1):
    """loss_fn(batch) -> scalar loss of the model that owns the groups'
    parameters. Returns step(batch) -> {"loss", "grad_norm"} (0-dim fp32
    tensors on the device: reading them syncs, so a loop reads them only
    when it logs). `step.optimizer` and `step.count` are exposed."""
    if accum_steps != 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    params = [p for g in groups.values() for p in g.params]
    fused = bool(params) and params[0].is_cuda
    optimizer = torch.optim.AdamW(
        [{"params": g.params, "weight_decay": g.weight_decay, "lr": 0.0}
         for g in groups.values()],
        betas=(0.9, 0.999), eps=1e-8, fused=fused or None)

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        for p in params:  # a leaf the loss never reached: a zero gradient,
            if p.grad is None:  # which optax's decay still updates
                p.grad = torch.zeros_like(p)
        norms = group_grad_norms(groups)
        total = torch.linalg.vector_norm(torch.stack(list(norms.values())))
        for (name, g), pg in zip(groups.items(), optimizer.param_groups):
            # optax.clip_by_global_norm: g * clip / norm where norm >= clip
            n = norms[name]
            scale = torch.where(n < g.grad_clip, torch.ones_like(n),
                                g.grad_clip / n)
            for p in g.params:
                p.grad.mul_(scale.to(p.grad.dtype))
            pg["lr"] = g.schedule(step.count)
        optimizer.step()
        step.count += 1
        return {"loss": loss.detach(), "grad_norm": total}

    step.count = 0
    step.optimizer = optimizer
    return step
