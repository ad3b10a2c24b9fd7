"""MPO (Mixed Preference Optimization): DPO + BCO quality + SFT losses (port
of vlaser_tpu/train/mpo.py), on one device or over a mesh.

Parity surface: internvl/train/internvl_chat_mpo.py (loss_type
'sigmoid,bco_pair' with sigmoid_loss_weight / bco_pair_loss_weight, plus SFT
CE on the chosen response) and trainer_dpo.py MultimodalDPOTrainer
(concatenated chosen / rejected forward :99, the RunningMoments reward
shift of BCO). The losses are functions of per-sequence log-probs. The
reference (frozen) policy is a copy of the initial parameters with storage
of its own; its log-probs come from the same model run on that copy
(torch.func.functional_call) under torch.no_grad(). The full logits of the
concatenated pair batch are formed, as the JAX loss forms them. Over a
mesh (`mesh_fsdp` or `mesh_tp` above 1, or a DeviceMesh handed in) the
model is cut over tensor, each rank feeds its block of the global batch's
pairs (a tensor group's ranks the same block), the reference copy is
held as the policy's own shards (its forward gathers them a leaf at a
time, as the policy's does), the log-probs read the gathered logits
(the head's gather slices their gradient back), each loss and metric is
the rank's share of its global value (means over the batch ranks'
blocks, the SFT term over the global weight sum) and the BCO running
mean takes every batch rank's rewards.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..core.mesh import batch_group
from ..core.tensor_parallel import shard_for_training
from .losses import weighted_ce_loss
from .optim import make_optimizer, warmup_cosine
from .train_step import make_train_step, shard_train_state
from .trainer import TrainConfig, build_mesh

IGNORE_TOKEN_ID = -100

logger = logging.getLogger("vlaser_tpu_torch.train")


@dataclass(frozen=True)
class MPOConfig:
    beta: float = 0.1
    sigmoid_loss_weight: float = 0.8
    bco_pair_loss_weight: float = 0.2
    sft_loss_weight: float = 1.0
    label_smoothing: float = 0.0


def sequence_logprobs(logits: torch.Tensor, labels: torch.Tensor,
                      average: bool = False) -> torch.Tensor:
    """logits [B, N, V], labels [B, N] (-100 off the response) -> [B] fp32
    sums (or means) of the response tokens' log-probs, shift by one."""
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_TOKEN_ID
    safe = torch.where(valid, shift_labels, 0).long()
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    tok = logp.gather(-1, safe[..., None])[..., 0] * valid
    s = tok.sum(-1)
    if average:
        return s / valid.sum(-1).clamp_min(1)
    return s


def dpo_sigmoid_loss(policy_chosen_lp, policy_rejected_lp, ref_chosen_lp,
                     ref_rejected_lp, beta: float,
                     label_smoothing: float = 0.0) -> torch.Tensor:
    """trl sigmoid DPO."""
    logits = (policy_chosen_lp - policy_rejected_lp) - (
        ref_chosen_lp - ref_rejected_lp)
    return (-F.logsigmoid(beta * logits) * (1 - label_smoothing)
            - F.logsigmoid(-beta * logits) * label_smoothing).mean()


def bco_pair_loss(policy_chosen_lp, policy_rejected_lp, ref_chosen_lp,
                  ref_rejected_lp, beta: float, delta):
    """BCO pair loss with the running reward shift `delta` (trl bco_pair).
    -> (loss, the [2B] chosen and rejected rewards)."""
    chosen_r = beta * (policy_chosen_lp - ref_chosen_lp)
    rejected_r = beta * (policy_rejected_lp - ref_rejected_lp)
    loss = (-F.logsigmoid(chosen_r - delta)).mean() + (
        -F.logsigmoid(-(rejected_r - delta))).mean()
    return loss, torch.cat([chosen_r, rejected_r])


class RunningMoments:
    """Running mean of rewards for the BCO shift (trainer_dpo.py:30)."""

    def __init__(self):
        self.mean = 0.0
        self.count = 1e-8

    def update(self, values) -> float:
        v = np.asarray(values)
        n = v.size
        self.mean = (self.mean * self.count + v.sum()) / (self.count + n)
        self.count += n
        return float(self.mean)


def make_mpo_loss(model, cfg: MPOConfig, mesh=None):
    """-> loss_fn(ref_params, batch, delta) -> (loss, metrics): the model
    (which holds the policy's parameters) on the concatenated [chosen;
    rejected] batch, as concatenated_forward:99 runs it, and again on
    `ref_params` ({parameter name: tensor}) without a graph.

    batch: chosen_ / rejected_ {input_ids, labels, seg_ids} and the shared
    pixel_values / image_flags (each side takes the pair's tiles). mesh:
    the loss and the scalar metrics are this rank's shares (they sum over
    the ranks to the global values); `rewards` stay the rank's own."""
    ranks = batch_group(mesh)[1]
    share = (lambda x: x / ranks) if ranks > 1 else (lambda x: x)

    def loss_fn(ref_params: Dict[str, torch.Tensor], batch, delta):
        cat = lambda k: torch.cat([batch[f"chosen_{k}"],
                                   batch[f"rejected_{k}"]], 0)
        ids, labels, seg = cat("input_ids"), cat("labels"), cat("seg_ids")
        pixels = torch.cat([batch["pixel_values"]] * 2, 0)
        flags = torch.cat([batch["image_flags"]] * 2, 0)
        b = batch["chosen_input_ids"].shape[0]
        with torch.no_grad():  # first: its logits are freed before ours
            ref_logits, _, _ = torch.func.functional_call(
                model, ref_params, (ids, pixels, flags), {"seg_ids": seg})
            ref_lp = sequence_logprobs(ref_logits, labels)
            del ref_logits
        logits, _, _ = model(ids, pixels, flags, seg_ids=seg)
        lp = sequence_logprobs(logits, labels)
        pc, pr, rc, rr = lp[:b], lp[b:], ref_lp[:b], ref_lp[b:]
        l_dpo = dpo_sigmoid_loss(pc, pr, rc, rr, cfg.beta,
                                 cfg.label_smoothing)
        l_bco, rewards = bco_pair_loss(pc, pr, rc, rr, cfg.beta, delta)
        l_sft = weighted_ce_loss(logits[:b], batch["chosen_labels"],
                                 mesh=mesh)
        l_dpo, l_bco = share(l_dpo), share(l_bco)
        loss = (cfg.sigmoid_loss_weight * l_dpo
                + cfg.bco_pair_loss_weight * l_bco
                + cfg.sft_loss_weight * l_sft)
        metrics = {
            "dpo_loss": l_dpo, "bco_loss": l_bco, "sft_loss": l_sft,
            "reward_margin": share(
                (cfg.beta * ((pc - rc) - (pr - rr))).mean()),
            "reward_accuracy": share(((pc - rc) > (pr - rr)).float().mean()),
            "rewards": rewards,
        }
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


class MPOTrainer:
    """The MPO loop (internvl_chat_mpo.py recipe): a frozen reference copy
    of the initial parameters, the concatenated-forward step, the BCO
    running reward shift updated on the host between steps. The optimizer
    is SFTTrainer's (AdamW, clip, warmup_cosine, the ViT frozen with
    freeze_vision); `grad_norm` counts the frozen ViT's gradients, as
    optax.global_norm does in the JAX step."""

    def __init__(self, model, cfg: MPOConfig, train_cfg=None, mesh=None):
        """model: a port InternVLChatModel on its device (cut in place over
        the mesh's tensor axis); train_cfg: a trainer.TrainConfig (its
        defaults when None); mesh: a DeviceMesh (built from
        train_cfg.mesh_fsdp / mesh_tp when None and either is above 1)."""
        self.model, self.cfg = model, cfg
        self.train_cfg = tc = train_cfg or TrainConfig()
        self.mesh = mesh = build_mesh(mesh, tc.mesh_fsdp, tc.mesh_tp)
        shard_for_training(model, mesh)
        schedule = warmup_cosine(tc.learning_rate, tc.total_steps,
                                 tc.warmup_ratio)
        frozen = (r"vision_model/",) if tc.freeze_vision else ()
        self.groups, self.frozen = make_optimizer(
            model, schedule, weight_decay=tc.weight_decay,
            grad_clip=tc.grad_clip, frozen_patterns=frozen)
        for p in model.parameters():
            p.requires_grad_(True)
        self.sharded = (shard_train_state(model, mesh) if mesh is not None
                        else None)
        # a real copy: the live parameters change in place every step
        self.ref_params = {n: p.detach().clone()
                           for n, p in model.named_parameters()}
        self.running = RunningMoments()
        mpo_loss, aux = make_mpo_loss(model, cfg, mesh), {}

        def loss_fn(batch):
            loss, metrics = mpo_loss(self.ref_params, batch, batch["delta"])
            aux.update(metrics)
            return loss

        self._aux = aux
        self.step_fn = make_train_step(loss_fn, self.groups,
                                       frozen=self.frozen,
                                       sharded=self.sharded)

    @property
    def step(self) -> int:
        return self.step_fn.count

    def _global_metrics(self, metrics, rewards):
        """Sum the batch ranks' shares of the scalar metrics in place; ->
        every batch rank's rewards (the global batch's, [chosen; rejected]
        of each in rank order; a tensor group's ranks hold the same)."""
        import torch.distributed as dist

        group, n = batch_group(self.mesh)
        if n == 1:
            return rewards
        keys = ("dpo_loss", "bco_loss", "sft_loss", "reward_margin",
                "reward_accuracy")
        flat = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(flat, group=group)
        metrics.update(zip(keys, flat.unbind()))
        parts = [torch.empty_like(rewards) for _ in range(n)]
        dist.all_gather(parts, rewards.contiguous(), group=group)
        return torch.cat(parts)

    def train(self, batches: Iterator[Dict], num_steps: int):
        """Run up to num_steps steps; -> the last step's metrics (loss,
        grad_norm, the three losses, reward margin and accuracy)."""
        dev = self.model.device
        metrics = None
        self.model.train()
        for i, batch in enumerate(batches):
            if i >= num_steps:
                break
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            batch["delta"] = torch.tensor(self.running.mean,
                                          dtype=torch.float32, device=dev)
            metrics = dict(self.step_fn(batch), **self._aux)
            rewards = metrics.pop("rewards")
            if self.sharded is not None:
                rewards = self._global_metrics(metrics, rewards)
            self.running.update(rewards.cpu().numpy())
            step = i + 1
            if (step == 1 or step % self.train_cfg.log_every == 0
                    or step == num_steps):
                logger.info(
                    "mpo step %d loss %.4f dpo %.4f bco %.4f sft %.4f acc "
                    "%.3f", step, float(metrics["loss"]),
                    float(metrics["dpo_loss"]), float(metrics["bco_loss"]),
                    float(metrics["sft_loss"]),
                    float(metrics["reward_accuracy"]))
        return metrics
