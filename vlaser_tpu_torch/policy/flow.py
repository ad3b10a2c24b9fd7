"""Flow-matching time sampling and the training loss function (port of
vlaser_tpu/policy/flow.py).

Randomness comes from an explicit `torch.Generator`, as the JAX package
takes explicit PRNG keys; the two give different numbers from one seed, so
a test that compares them feeds both the same t and x0. Beta(alpha, 1)
times are drawn exactly as u^(1/alpha); any other Beta(alpha, beta) as
G_a / (G_a + G_b) of two Marsaglia-Tsang gamma draws (`sample_gamma`),
built from the generator's own normal and uniform draws on its device
(torch.distributions takes no generator).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def sample_gamma(generator: Optional[torch.Generator], shape: float,
                 n: int, device=None) -> torch.Tensor:
    """n draws of Gamma(shape, 1) (shape > 0), float64, by Marsaglia and
    Tsang's squeeze-and-reject method: d = a - 1/3, c = 1 / sqrt(9 d), draw
    x ~ N(0, 1) and u ~ U(0, 1) and keep d v, v = (1 + c x)^3, where v > 0
    and log u < x^2 / 2 + d - d v + d log v; the rows still rejected draw
    again. A shape below 1 draws Gamma(shape + 1) and multiplies it by
    u^(1 / shape)."""
    if shape <= 0:
        raise ValueError(f"gamma shape must be > 0, got {shape}")
    a = shape + 1.0 if shape < 1.0 else shape
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    f64 = dict(dtype=torch.float64, device=device)
    out = torch.empty(n, **f64)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        x = torch.randn(m, generator=generator, **f64)
        u = torch.rand(m, generator=generator, **f64)
        v = (1.0 + c * x) ** 3
        logv = torch.log(torch.where(v > 0, v, torch.ones_like(v)))
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * logv)
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if shape < 1.0:
        u = torch.rand(n, generator=generator, **f64)
        out = out * u ** (1.0 / shape)
    return out


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
    if beta == 1.0:
        # Beta(alpha, 1) has CDF z^alpha, so z = u^(1/alpha) is an exact draw
        u = torch.rand(bsz, generator=generator, device=device)
        return t_max * (1.0 - u ** (1.0 / alpha))
    if beta <= 0 or alpha <= 0:
        raise ValueError(f"Beta({alpha}, {beta}) needs positive parameters")
    ga = sample_gamma(generator, alpha, bsz, device)
    gb = sample_gamma(generator, beta, bsz, device)
    z = (ga / (ga + gb)).float()
    return t_max * (1.0 - z)


def make_flow_loss(model, sampling: str = "beta",
                   generator: Optional[torch.Generator] = None, mesh=None):
    """-> loss_fn(batch) for train.train_step.make_train_step: draws t and
    x0 ~ N(0, I) from `generator` on the batch's device and returns the
    model's flow-matching loss. batch keys: input_ids, pixel_values,
    text_mask, proprios, actions (tensors on the model's device).

    Over a mesh the batch is this rank's block of rows of the global batch
    (core/mesh.batch_shard): every rank draws the global batch's t and x0
    from the same generator and keeps its block's rows, and returns its
    share of the global mean (the block's mean over the number of
    blocks, the batch ranks), so the sharded step equals the one-device
    step. The ranks of a tensor group hold the same block: they draw and
    keep the same t and x0, and their loss is one share, not several."""
    from ..core.mesh import batch_shard

    cfg = model.cfg
    index, count = batch_shard(mesh) if mesh is not None else (0, 1)

    def loss_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        ids = batch["input_ids"]
        b, dev = ids.shape[0], ids.device
        rows = slice(index * b, (index + 1) * b)
        t = sample_fm_time(generator, b * count, sampling, cfg.flow_alpha,
                           cfg.flow_beta, cfg.flow_t_max, device=dev)[rows]
        x0 = torch.randn((b * count, cfg.num_action_tokens, cfg.action_dim),
                         generator=generator, dtype=torch.float32,
                         device=dev)[rows]
        loss = model(ids, batch["pixel_values"], batch["text_mask"],
                     batch["proprios"], batch["actions"], t, x0)
        return loss / count if count > 1 else loss

    return loss_fn
