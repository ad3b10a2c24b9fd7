"""Trainer loops (port of vlaser_tpu/train/trainer.py, one device, no
mesh).

`SFTTrainer` (the VLM SFT recipe, scripts/train_sft.py): AdamW on every
trained parameter, clipped by its global norm, under `warmup_cosine`; the
ViT frozen by default (`freeze_vision`), the LLM with `freeze_llm`.
Frozen parameters keep taking gradients, which `grad_norm` counts as the
JAX step's global norm does, and get no update (optax.set_to_zero). Still
to port, and raising NotImplementedError when asked for: `checkpoint_dir`
(utils/checkpoint.py), meshes of more than one device (the parallel
layouts) and the MoE router loss (models/moe.py).

`VLATrainer` (the flow-matching VLA): two optimizer groups with their own
cosine-warmup-restarts schedules: "action" = the expert mixture, its final
norm and the proprio/action encoders and decoder; "vlm" = everything else.
With `train_vlm=False` the vlm group is frozen (`requires_grad=False`, no
optimizer state). Still to port, and raising NotImplementedError when
asked for: `optimizer_8bit`, model averaging (EMA/SWA), `checkpoint_dir`,
`metrics_path` and `evaluate`.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Sequence

import torch

from ..policy.flow import make_flow_loss
from ..utils.monitoring import MetricsWriter, Timer
from .losses import make_sft_loss
from .optim import cosine_warmup_restarts, make_optimizer, warmup_cosine
from .train_step import ParamGroup, make_train_step

logger = logging.getLogger("vlaser_tpu_torch.train")

ACTION_KEYS = ("expert", "action_encoder", "action_decoder",
               "proprio_encoder", "expert_norm")


@dataclass
class TrainConfig:
    learning_rate: float = 2e-5
    total_steps: int = 1000
    warmup_ratio: float = 0.03
    weight_decay: float = 0.01
    grad_clip: Optional[float] = 1.0
    accum_steps: int = 1
    freeze_vision: bool = True  # the Vlaser SFT recipe: ViT frozen
    freeze_llm: bool = False
    log_every: int = 10
    save_every: int = 500
    checkpoint_dir: Optional[str] = None
    mesh_fsdp: int = 1
    mesh_tp: int = 1
    mesh_cp: int = 1
    moe_aux_coef: float = 0.0
    # a torch.profiler trace (chrome trace JSON) over the steps
    # [profile_start, profile_start + profile_steps)
    profile_dir: Optional[str] = None
    profile_start: int = 5
    profile_steps: int = 3
    metrics_path: Optional[str] = None  # JSONL scalar log (MetricsWriter)


def _to_device(batch: Dict, device) -> Dict:
    """numpy arrays or tensors -> tensors on the model's device (None
    kept)."""
    return {k: None if v is None else torch.as_tensor(v).to(device)
            for k, v in batch.items()}


class SFTTrainer:
    def __init__(self, model, cfg: TrainConfig):
        """model: a port InternVLChatModel on its device."""
        if cfg.checkpoint_dir:
            raise NotImplementedError(
                "checkpoint_dir: utils/checkpoint.py is not ported yet")
        if cfg.mesh_fsdp != 1 or cfg.mesh_tp != 1 or cfg.mesh_cp != 1:
            raise NotImplementedError(
                "the port trains on one device; the parallel layouts are "
                "not ported yet")
        self.model, self.cfg = model, cfg
        frozen = []
        if cfg.freeze_vision:
            frozen.append(r"vision_model/")
        if cfg.freeze_llm:
            frozen.append(r"language_model/")
        schedule = warmup_cosine(cfg.learning_rate, cfg.total_steps,
                                 cfg.warmup_ratio)
        self.groups, self.frozen = make_optimizer(
            model, schedule, weight_decay=cfg.weight_decay,
            grad_clip=cfg.grad_clip, frozen_patterns=tuple(frozen))
        for p in model.parameters():
            p.requires_grad_(True)
        self.step_fn = make_train_step(
            make_sft_loss(model, moe_aux_coef=cfg.moe_aux_coef), self.groups,
            accum_steps=cfg.accum_steps, frozen=self.frozen)

    @property
    def step(self) -> int:
        return self.step_fn.count

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.model.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def train(self, batches: Iterator[Dict],
              data_state_fn: Optional[Callable[[], Dict]] = None,
              preemption_guard=None):
        """Run a step for each batch, up to cfg.total_steps; -> the last
        step's metrics. data_state_fn is for checkpoints, which are not
        ported. preemption_guard: an object whose should_stop() ends the
        loop after the current step."""
        cfg, dev = self.cfg, self.model.device
        timer, prof, metrics = Timer(), None, None
        writer = MetricsWriter(cfg.metrics_path) if cfg.metrics_path else None
        self.model.train()
        try:
            for i, batch in enumerate(batches):
                if i >= cfg.total_steps:
                    break
                if cfg.profile_dir and i == cfg.profile_start:
                    prof = self._profiler()
                metrics = self.step_fn(_to_device(batch, dev))
                step = i + 1
                if prof is not None and step == (cfg.profile_start
                                                 + cfg.profile_steps):
                    prof = self._stop(prof)
                if (step == 1 or step % cfg.log_every == 0
                        or step == cfg.total_steps):
                    loss = float(metrics["loss"])
                    gnorm = float(metrics["grad_norm"])
                    logger.info("step %d loss %.4f gnorm %.3f (%.2fs/it)",
                                step, loss, gnorm, timer() / cfg.log_every)
                    if writer is not None:
                        writer.write(step, loss=loss, grad_norm=gnorm)
                if (preemption_guard is not None
                        and preemption_guard.should_stop()):
                    logger.warning("preemption: stopping at step %d", step)
                    break
        finally:
            if prof is not None:  # the loop ended inside the window
                self._stop(prof)
            if writer is not None:
                writer.close()
        return metrics

    def _stop(self, prof):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
        return None


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
