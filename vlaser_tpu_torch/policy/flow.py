"""Flow-matching time sampling and the training loss function (port of
vlaser_tpu/policy/flow.py).

Randomness comes from an explicit `torch.Generator`, as the JAX package
takes explicit PRNG keys; the two give different numbers from one seed, so
a test that compares them feeds both the same t and x0.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def sample_fm_time(generator: Optional[torch.Generator], bsz: int,
                   sampling: str = "beta", alpha: float = 1.5,
                   beta: float = 1.0, t_max: float = 1.0 - 1e-3,
                   device=None) -> torch.Tensor:
    """-> t [bsz] fp32. "beta": t = t_max (1 - z), z ~ Beta(alpha, beta);
    "uniform": one stratified draw (u + i / bsz) mod (1 - 1e-5)."""
    if sampling == "uniform":
        u = torch.rand((), generator=generator, device=device)
        return (u + torch.arange(bsz, device=device) / bsz) % (1 - 1e-5)
    if sampling != "beta":
        raise ValueError(f"unknown flow time sampling {sampling!r}")
    if beta != 1.0:
        raise NotImplementedError("Beta(alpha, beta) draws need beta == 1")
    # Beta(alpha, 1) has CDF z^alpha, so z = u^(1/alpha) is an exact draw
    u = torch.rand(bsz, generator=generator, device=device)
    return t_max * (1.0 - u ** (1.0 / alpha))


def make_flow_loss(model, sampling: str = "beta",
                   generator: Optional[torch.Generator] = None):
    """-> loss_fn(batch) for train.train_step.make_train_step: draws t and
    x0 ~ N(0, I) from `generator` on the batch's device and returns the
    model's flow-matching loss. batch keys: input_ids, pixel_values,
    text_mask, proprios, actions (tensors on the model's device)."""
    cfg = model.cfg

    def loss_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        ids = batch["input_ids"]
        b, dev = ids.shape[0], ids.device
        t = sample_fm_time(generator, b, sampling, cfg.flow_alpha,
                           cfg.flow_beta, cfg.flow_t_max, device=dev)
        x0 = torch.randn((b, cfg.num_action_tokens, cfg.action_dim),
                         generator=generator, dtype=torch.float32, device=dev)
        return model(ids, batch["pixel_values"], batch["text_mask"],
                     batch["proprios"], batch["actions"], t, x0)

    return loss_fn
