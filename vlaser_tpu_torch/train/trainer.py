"""VLA flow-matching trainer (port of `VLATrainer` in
vlaser_tpu/train/trainer.py, one device, no mesh).

Two optimizer groups with their own cosine-warmup-restarts schedules:
"action" = the expert mixture, its final norm and the proprio/action
encoders and decoder; "vlm" = everything else. With `train_vlm=False` the
vlm group is frozen (`requires_grad=False`, no optimizer state), as the JAX
trainer maps it to `optax.set_to_zero`. Still to port, and raising
NotImplementedError when asked for: `optimizer_8bit`, model averaging
(EMA/SWA), `checkpoint_dir`, `metrics_path` and `evaluate`.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence

import torch

from ..policy.flow import make_flow_loss
from .optim import cosine_warmup_restarts
from .train_step import ParamGroup, make_train_step

logger = logging.getLogger("vlaser_tpu_torch.train")

ACTION_KEYS = ("expert", "action_encoder", "action_decoder",
               "proprio_encoder", "expert_norm")


@dataclass
class VLATrainConfig:
    lr_action: float = 5e-5
    lr_vlm: float = 5e-5
    first_cycle_steps: int = 10_000_000
    warmup_steps: int = 100
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    accum_steps: int = 1
    train_vlm: bool = True
    flow_sampling: str = "beta"
    optimizer_8bit: bool = False
    averaging: Optional[object] = None  # an AveragingConfig; mode None only
    log_every: int = 10
    save_every: int = 1000
    eval_thresholds: Sequence[float] = (0.1, 0.2)
    checkpoint_dir: Optional[str] = None
    mesh_fsdp: int = 1
    mesh_tp: int = 1
    metrics_path: Optional[str] = None


def _vla_param_groups(model, train_vlm: bool) -> Dict[str, str]:
    """{parameter name: "action" | "vlm" | "frozen"}: a name holding one of
    ACTION_KEYS is "action" (joint.layers.expert.*, joint.expert_norm.*,
    action_encoder.*, action_decoder.*, proprio_encoder.*)."""
    return {name: ("action" if any(k in name for k in ACTION_KEYS)
                   else "vlm" if train_vlm else "frozen")
            for name, _ in model.named_parameters()}


class VLATrainer:
    def __init__(self, model, cfg: VLATrainConfig,
                 generator: Optional[torch.Generator] = None):
        """model: a port PiZeroVLA on its device; generator: the source of
        flow times and noise (a fresh one seeded 0 on the model's device
        when None)."""
        if cfg.optimizer_8bit:
            raise NotImplementedError("8-bit AdamW is not ported yet")
        if cfg.averaging is not None and getattr(cfg.averaging, "mode",
                                                 None) is not None:
            raise NotImplementedError("model averaging is not ported yet")
        if cfg.checkpoint_dir or cfg.metrics_path:
            raise NotImplementedError(
                "checkpointing and the metrics log are not ported yet")
        if cfg.mesh_fsdp != 1 or cfg.mesh_tp != 1:
            raise NotImplementedError("the port trains on one device")
        self.model, self.cfg = model, cfg
        if generator is None:
            generator = torch.Generator(device=model.device)
            generator.manual_seed(0)
        self.generator = generator
        labels = _vla_param_groups(model, cfg.train_vlm)
        named = dict(model.named_parameters())
        self.groups: Dict[str, ParamGroup] = {}
        for group, lr in (("action", cfg.lr_action), ("vlm", cfg.lr_vlm)):
            params = [named[n] for n, lab in labels.items() if lab == group]
            if params:
                self.groups[group] = ParamGroup(
                    params, cosine_warmup_restarts(
                        lr, cfg.first_cycle_steps,
                        warmup_steps=cfg.warmup_steps),
                    cfg.weight_decay, cfg.grad_clip)
        for n, lab in labels.items():
            named[n].requires_grad_(lab != "frozen")
        self.step_fn = make_train_step(
            make_flow_loss(model, cfg.flow_sampling, generator), self.groups,
            accum_steps=cfg.accum_steps)

    @property
    def step(self) -> int:
        return self.step_fn.count

    def train_steps(self, batches: Iterator[Dict[str, torch.Tensor]],
                    num_steps: int):
        """Run up to num_steps steps; -> the last step's metrics."""
        cfg = self.cfg
        metrics = None
        t0 = time.perf_counter()
        self.model.train()
        for i, batch in enumerate(batches):
            if i >= num_steps:
                break
            metrics = self.step_fn(batch)
            step = i + 1
            if step % cfg.log_every == 0:
                logger.info("vla step %d loss %.4f gnorm %.3f (%.2fs/it)",
                            step, float(metrics["loss"]),
                            float(metrics["grad_norm"]),
                            (time.perf_counter() - t0) / cfg.log_every)
                t0 = time.perf_counter()
        return metrics

    def evaluate(self, batch, rng=None):
        raise NotImplementedError("VLATrainer.evaluate is not ported yet")
