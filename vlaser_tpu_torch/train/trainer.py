"""Trainer loops (port of vlaser_tpu/train/trainer.py), on one device or
over a mesh.

`SFTTrainer` (the VLM SFT recipe, scripts/train_sft.py): AdamW on every
trained parameter, clipped by its global norm, under `warmup_cosine`; the
ViT frozen by default (`freeze_vision`), the LLM with `freeze_llm`.
Frozen parameters keep taking gradients, which `grad_norm` counts as the
JAX step's global norm does, and get no update (optax.set_to_zero). With
`checkpoint_dir` it saves (utils/checkpoint.py) every `save_every` steps,
when a preemption guard stops the loop, and after the last step, each
with `data_state_fn()`. Steps are counted across `train` calls and a
restore (`step`), as the schedule counts them. `moe_aux_coef` adds the MoE
router loss (train/losses.make_sft_loss).

`VLATrainer` (the flow-matching VLA): two optimizer groups with their own
cosine-warmup-restarts schedules: "action" = the expert mixture, its final
norm and the proprio/action encoders and decoder; "vlm" = everything else.
With `train_vlm=False` the vlm group is frozen (`requires_grad=False`, no
optimizer state). `optimizer_8bit` puts both groups on the block-wise
8-bit AdamW (train/optim8bit.py); `averaging` keeps an EMA / SWA of the
parameters after every step (train/model_averaging.py), which `evaluate`
runs `infer_action` under (action accuracy and L1, train/metrics.py);
`checkpoint_dir` saves every `save_every` steps (utils/checkpoint.py:
parameters, optimizer state and counter, no average, as the JAX trainer
saves); `metrics_path` logs every `log_every` steps. As in the JAX
trainer, `train_steps` numbers its steps from 1 in every call: averaging,
logging and saving see that count, the schedule the optimizer's own.

Meshes. `mesh_fsdp` and `mesh_tp` (both trainers) and `mesh_cp`
(SFTTrainer, whose model's LLM then needs
`context_parallel_axis="context"`) above 1, or a DeviceMesh handed in
(core/mesh.make_mesh over an initialized process group,
core/distributed.initialize), train over a (data, fsdp[, context],
tensor) mesh: the model is cut over tensor first
(core/tensor_parallel.shard_for_training: head-granular attention,
column / row-parallel MLPs, the vocab table in blocks, experts over
tensor), then the parameters, gradients and AdamW moments are held as
ZeRO-3 shards over fsdp, the forward and backward gathering one layer's
weights at a time (train/train_step.shard_train_state); each rank feeds
its local block of the global batch (its rows at core/mesh.batch_shard:
the ranks of a tensor group feed the same rows and draw the same flow
times and noise; context ranks feed the same rows and each keeps its
slice of the sequence), and the step equals the one-device step of the
global batch. The metrics log is written by rank 0. 8-bit AdamW over
fsdp or tensor above 1 raises NotImplementedError.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import torch

from ..core import mesh as mesh_lib
from ..core.distributed import process_index
from ..core.tensor_parallel import shard_for_training
from ..policy.flow import make_flow_loss
from ..utils.convert import is_patch_conv
from ..utils.monitoring import MetricsWriter, Timer
from .losses import make_sft_loss
from .metrics import action_accuracy, action_l1
from .model_averaging import AveragingConfig, ModelAveraging
from .optim import cosine_warmup_restarts, make_optimizer, warmup_cosine
from .train_step import (ADAM8BIT_OVER_FSDP, ParamGroup, make_train_step,
                         shard_train_state)

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


def build_mesh(mesh, fsdp: int = 1, tp: int = 1, cp: int = 1):
    """The trainers' mesh: the one handed in, else make_mesh(fsdp, tp, cp)
    when any is above 1 (as the JAX trainers build it), else None (one
    device, no process group needed). A stage axis raises: the trainers'
    losses run the whole stack on every rank, and a stage-sharded state
    sums its whole leaves over the stages (train/pipeline.py's loss with
    make_train_step trains over stage)."""
    if mesh is None and (fsdp > 1 or tp > 1 or cp > 1):
        mesh = mesh_lib.make_mesh(fsdp=fsdp, tp=tp, cp=cp)
    if mesh_lib.axis_size(mesh, mesh_lib.STAGE_AXIS) > 1:
        raise NotImplementedError(
            "a 'stage' axis: train through train/pipeline."
            "make_pipeline_lm_loss with train_step.make_train_step")
    return mesh



def _metrics_writer(path):
    return MetricsWriter(path) if path and process_index() == 0 else None


class SFTTrainer:
    def __init__(self, model, cfg: TrainConfig, mesh=None):
        """model: a port InternVLChatModel on its device (cut in place over
        the mesh's tensor axis); mesh: a DeviceMesh (built from
        cfg.mesh_fsdp / mesh_tp / mesh_cp when None and any is above 1)."""
        self.mesh = mesh = build_mesh(mesh, cfg.mesh_fsdp, cfg.mesh_tp,
                                      cfg.mesh_cp)
        if (mesh_lib.axis_size(mesh, mesh_lib.CONTEXT_AXIS) > 1
                and model.cfg.llm.context_parallel_axis is None):
            raise ValueError("a context axis needs a model whose LLM config "
                             "sets context_parallel_axis='context'")
        self.model, self.cfg = shard_for_training(model, mesh), cfg
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
        self.sharded = (shard_train_state(model, mesh) if mesh is not None
                        else None)
        self.step_fn = make_train_step(
            make_sft_loss(model, moe_aux_coef=cfg.moe_aux_coef, mesh=mesh),
            self.groups, accum_steps=cfg.accum_steps, frozen=self.frozen,
            sharded=self.sharded)

    @property
    def step(self) -> int:
        return self.step_fn.count

    def _step(self, batch):
        if self.mesh is None:
            return self.step_fn(batch)
        with mesh_lib.set_mesh(self.mesh):
            return self.step_fn(batch)

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
        """Run a step for each batch until `step` reaches cfg.total_steps;
        -> the last step's metrics. data_state_fn: the data stream's state
        for the checkpoints (PackedDataset.state_dict). preemption_guard: an
        object whose should_stop() ends the loop after the current step."""
        cfg, dev = self.cfg, self.model.device
        timer, prof, metrics = Timer(), None, None
        writer = _metrics_writer(cfg.metrics_path)
        saved = self.step
        self.model.train()
        try:
            for batch in batches:
                if self.step >= cfg.total_steps:
                    break
                if cfg.profile_dir and self.step == cfg.profile_start:
                    prof = self._profiler()
                metrics = self._step(_to_device(batch, dev))
                step = self.step
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
                if step % cfg.save_every == 0:
                    saved = self._save(data_state_fn)
                if (preemption_guard is not None
                        and preemption_guard.should_stop()):
                    logger.warning("preemption: stopping at step %d", step)
                    break
            if saved != self.step:  # the final (or preempted) step
                self._save(data_state_fn)
        finally:
            if prof is not None:  # the loop ended inside the window
                self._stop(prof)
            if writer is not None:
                writer.close()
        return metrics

    def _save(self, data_state_fn) -> int:
        if self.cfg.checkpoint_dir:
            from ..utils.checkpoint import save_checkpoint

            save_checkpoint(self.cfg.checkpoint_dir, self.step, self.model,
                            self.step_fn,
                            data_state_fn() if data_state_fn else None)
        return self.step

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
    optimizer_8bit: bool = False  # bnb AdamW8bit (train/optim8bit.py)
    averaging: AveragingConfig = field(default_factory=AveragingConfig)
    log_every: int = 10
    save_every: int = 1000
    eval_thresholds: Sequence[float] = (0.1, 0.2)
    checkpoint_dir: Optional[str] = None
    mesh_fsdp: int = 1
    mesh_tp: int = 1
    metrics_path: Optional[str] = None  # JSONL scalar log (MetricsWriter)


def _vla_param_groups(model, train_vlm: bool) -> Dict[str, str]:
    """{parameter name: "action" | "vlm" | "frozen"}: a name holding one of
    ACTION_KEYS is "action" (joint.layers.expert.*, joint.expert_norm.*,
    action_encoder.*, action_decoder.*, proprio_encoder.*)."""
    return {name: ("action" if any(k in name for k in ACTION_KEYS)
                   else "vlm" if train_vlm else "frozen")
            for name, _ in model.named_parameters()}


class _InferAction(torch.nn.Module):
    """The model's infer_action as a forward, for functional_call."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, *args):
        return self.model.infer_action(*args)


class VLATrainer:
    def __init__(self, model, cfg: VLATrainConfig,
                 generator: Optional[torch.Generator] = None, mesh=None):
        """model: a port PiZeroVLA on its device; generator: the source of
        flow times and noise (a fresh one seeded 0 on the model's device
        when None; every rank of a mesh draws the global batch's from
        it); mesh: a DeviceMesh (built from cfg.mesh_fsdp / mesh_tp when
        None and either is above 1; the model is cut in place over its
        tensor axis)."""
        self.mesh = mesh = build_mesh(mesh, cfg.mesh_fsdp, cfg.mesh_tp)
        if cfg.optimizer_8bit and (
                mesh_lib.axis_size(mesh, mesh_lib.FSDP_AXIS) > 1
                or mesh_lib.axis_size(mesh, mesh_lib.TENSOR_AXIS) > 1):
            raise NotImplementedError(ADAM8BIT_OVER_FSDP)
        self.model, self.cfg = shard_for_training(model, mesh), cfg
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
        self.sharded = (shard_train_state(model, mesh) if mesh is not None
                        else None)
        loss_fn = (make_flow_loss(model, cfg.flow_sampling, generator)
                   if mesh is None else make_flow_loss(
                       model, cfg.flow_sampling, generator, mesh=mesh))
        self.step_fn = make_train_step(
            loss_fn, self.groups, accum_steps=cfg.accum_steps,
            optimizer="adamw8bit" if cfg.optimizer_8bit else "adamw",
            hwio=[p for n, p in named.items() if is_patch_conv(n)],
            sharded=self.sharded)
        self.averaging = ModelAveraging(cfg.averaging)
        self._infer = _InferAction(model)

    @property
    def step(self) -> int:
        return self.step_fn.count

    def params(self) -> Dict[str, torch.Tensor]:
        """The parameters as the trainer holds them (shards over a mesh,
        which the model's forward gathers a leaf at a time)."""
        return dict(self.model.named_parameters())

    def save(self, step: int) -> str:
        """A checkpoint of step `step` under cfg.checkpoint_dir."""
        from ..utils.checkpoint import save_checkpoint

        return save_checkpoint(self.cfg.checkpoint_dir, step, self.model,
                               self.step_fn)

    def train_steps(self, batches: Iterator[Dict], num_steps: int):
        """Run up to num_steps steps over numpy or tensor batches (moved to
        the model's device); -> the last step's metrics."""
        cfg, dev = self.cfg, self.model.device
        metrics = None
        timer = Timer()
        writer = _metrics_writer(cfg.metrics_path)
        self.model.train()
        try:
            for i, batch in enumerate(batches):
                if i >= num_steps:
                    break
                metrics = self.step_fn(_to_device(batch, dev))
                step = i + 1  # the JAX trainer's count: from 1 in every call
                self.averaging.update(step, self.params())
                if step % cfg.log_every == 0:
                    loss = float(metrics["loss"])
                    gnorm = float(metrics["grad_norm"])
                    logger.info("vla step %d loss %.4f gnorm %.3f "
                                "(%.2fs/it)", step, loss, gnorm,
                                timer() / cfg.log_every)
                    if writer is not None:
                        writer.write(step, loss=loss, grad_norm=gnorm)
                if cfg.checkpoint_dir and step % cfg.save_every == 0:
                    self.save(step)
        finally:
            if writer is not None:
                writer.close()
        return metrics

    def eval_actions(self, params: Dict[str, torch.Tensor],
                     batch: Dict[str, torch.Tensor],
                     noise: torch.Tensor) -> torch.Tensor:
        """infer_action under `params` ({name: tensor}, the model's own for
        any name it lacks) -> actions [B, horizon, action_dim]."""
        with torch.no_grad():
            return torch.func.functional_call(
                self._infer, {f"model.{k}": v for k, v in params.items()},
                tuple(batch[k] for k in ("input_ids", "pixel_values",
                                         "text_mask", "proprios")) + (noise,))

    def eval_fn(self, params, batch, noise):
        """-> (action accuracy at cfg.eval_thresholds, L1) against
        actions[:, -horizon_steps:] (the JAX trainer's _eval_fn)."""
        pred = self.eval_actions(params, batch, noise)
        gt = batch["actions"][:, -self.model.cfg.horizon_steps:]
        return (action_accuracy(gt, pred, self.cfg.eval_thresholds),
                action_l1(gt, pred))

    def evaluate(self, batch: Dict, generator: Optional[torch.Generator] = None
                 ) -> Dict[str, Any]:
        """Actions from infer_action under the averaged parameters (the live
        ones without an average) and noise N(0, I) drawn from `generator`
        (a fresh one seeded 42 on the model's device when None)."""
        dev, mcfg = self.model.device, self.model.cfg
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(42)
        batch = _to_device(batch, dev)
        b = batch["input_ids"].shape[0]
        noise = torch.randn((b, mcfg.num_action_tokens, mcfg.action_dim),
                            generator=generator, device=dev)
        params = self.averaging.params_for_eval(self.params())
        self.model.eval()
        try:
            accs, l1 = self.eval_fn(params, batch, noise)
        finally:
            self.model.train()
        return {"action_accuracy": accs.cpu().numpy(), "l1": float(l1)}
