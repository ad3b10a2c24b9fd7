"""The train step (port of vlaser_tpu/train/train_step.py, one device, no
mesh).

Each parameter group is clipped by its own global norm (unless its
`grad_clip` is None) and then takes an AdamW step (b1 0.9, b2 0.999, eps
1e-8, decoupled decay on every leaf): the JAX trainer puts
`clip_by_global_norm` inside each group's chain of `optax.multi_transform`,
so a group never sees another group's norm. torch.optim.AdamW computes
optax's adamw update; the learning rate of update i (from 0) is the
group's schedule(i), as optax counts. `frozen` parameters take gradients
but no update (optax.set_to_zero). The reported `grad_norm` is the norm
over every gradient the step took, frozen ones included, before clipping,
as the JAX step takes optax.global_norm of the whole gradient tree. With
`accum_steps` > 1 every batch tensor is [accum, micro, ...]: the micro
batches' gradients are summed in fp32 and divided by accum_steps, and the
loss is their mean (the JAX step's scan).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn


@dataclass
class ParamGroup:
    params: List[nn.Parameter]
    schedule: Callable[[int], float]  # step -> learning rate
    weight_decay: float = 0.01
    grad_clip: Optional[float] = 1.0  # None: no clip


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


def _accumulate(loss_fn, batch, params, accum_steps: int):
    """Backward of each micro batch; -> the mean loss, with each p.grad
    the fp32 mean of the micro gradients in p's dtype."""
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    losses = []
    for i in range(accum_steps):
        micro = {k: (v[i] if torch.is_tensor(v) else v)
                 for k, v in batch.items()}
        for p in params:
            p.grad = None
        loss = loss_fn(micro)
        loss.backward()
        losses.append(loss.detach())
        for a, p in zip(acc, params):
            if p.grad is not None:
                a.add_(p.grad.float())
    for a, p in zip(acc, params):
        p.grad = (a / accum_steps).to(p.dtype)
    return torch.stack(losses).float().mean()


def make_train_step(loss_fn: Callable[[Dict], torch.Tensor],
                    groups: Dict[str, ParamGroup], accum_steps: int = 1,
                    frozen: Sequence[nn.Parameter] = ()):
    """loss_fn(batch) -> scalar loss of the model that owns the groups'
    parameters (and the frozen ones). Returns step(batch) -> {"loss",
    "grad_norm"} (0-dim fp32 tensors on the device: reading them syncs, so
    a loop reads them only when it logs). `step.optimizer` and
    `step.count` are exposed."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    params = [p for g in groups.values() for p in g.params]
    frozen = list(frozen)
    fused = bool(params) and params[0].is_cuda
    optimizer = torch.optim.AdamW(
        [{"params": g.params, "weight_decay": g.weight_decay, "lr": 0.0}
         for g in groups.values()],
        betas=(0.9, 0.999), eps=1e-8, fused=fused or None)

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        for p in frozen:
            p.grad = None
        if accum_steps == 1:
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(batch)
            loss.backward()
            loss = loss.detach()
        else:
            loss = _accumulate(loss_fn, batch, params + frozen, accum_steps)
        for p in params:  # a leaf the loss never reached: a zero gradient,
            if p.grad is None:  # which optax's decay still updates
                p.grad = torch.zeros_like(p)
        norms = group_grad_norms(groups)
        every = list(norms.values())
        if frozen:
            every.append(grad_norm(frozen))
        total = torch.linalg.vector_norm(torch.stack(every))
        for (name, g), pg in zip(groups.items(), optimizer.param_groups):
            if g.grad_clip is not None:
                # optax.clip_by_global_norm: g * clip / norm where norm >= clip
                n = norms[name]
                scale = torch.where(n < g.grad_clip, torch.ones_like(n),
                                    g.grad_clip / n)
                for p in g.params:
                    p.grad.mul_(scale.to(p.grad.dtype))
            pg["lr"] = g.schedule(step.count)
        optimizer.step()
        step.count += 1
        return {"loss": loss, "grad_norm": total}

    step.count = 0
    step.optimizer = optimizer
    return step
