"""RoboTwin closed-loop evaluation harness (port of
vlaser_tpu/eval/robotwin_eval.py).

Parity surface: RoboTwin/script/eval_policy_qwen_vae_layer2_head_8_parallel_
decoding.py — main/eval_policy (:66, :238): per-task loop over seeds
100000*(1+seed)+episode, expert pre-check gating (the scripted expert must
succeed before the policy is scored, :276-303), policy rollout via the
one-pass parallel-decoding model, success-rate JSON logs; and the env-side
control flow (envs/_base_task.py:2656-2760): one forward per control step ->
8x14 action chunk -> per-action joint-position stepping.

SAPIEN/RoboTwin stay host-side; env interactions go through a small protocol
(reset_with_seed / play_expert_once / check_success / get_observation /
step_qpos) so real RoboTwin envs or test mocks plug in equally. The JAX
policy jit-compiles `model.apply`; `RoboTwinPolicy` here runs the torch
module under `torch.no_grad()` on the model's device. `eval_policy` and
the config are copies.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Protocol

import numpy as np
import torch

from ..models.layers import load_state

logger = logging.getLogger("vlaser_tpu_torch.eval")


class RoboTwinEnvProtocol(Protocol):
    def reset_with_seed(self, seed: int) -> None: ...
    def play_expert_once(self) -> bool: ...  # scripted demo; True on success
    def get_observation(self) -> Dict[str, Any]: ...  # {image, qpos, instruction}
    def step_qpos(self, qpos_target: np.ndarray) -> None: ...
    def check_success(self) -> bool: ...


@dataclass
class RoboTwinEvalConfig:
    task_name: str = "beat_block_hammer"
    test_num: int = 50
    seed: int = 0
    step_lim: int = 400
    chunk_exec: int = 8  # execute full chunk per forward
    results_dir: Optional[str] = None


class RoboTwinPolicy:
    """One-pass control policy around ParallelDecodingVLA
    (_base_task.py:2566-2656 get_internvl_actions_parallel_decoding).
    params: an optional flat state (utils/convert.from_jax_variables or a
    port state) loaded into `model`; None keeps its weights. The policy
    runs on the model's device."""

    def __init__(self, model, params: Optional[Mapping], builder, tokenizer,
                 image_normalizer):
        if params is not None:
            load_state(model, params)
        self.model = model
        self.builder = builder
        self.tokenizer = tokenizer
        self.normalize = image_normalizer
        self.device = model.device

    @torch.no_grad()
    def get_actions(self, image: np.ndarray, qpos: np.ndarray,
                    instruction: str) -> np.ndarray:
        max_text = self.builder.cfg.max_text_tokens
        ids = self.tokenizer(instruction, add_special_tokens=False)["input_ids"]
        text = np.zeros((1, max_text), np.int64)
        text[0, : min(len(ids), max_text)] = ids[:max_text]
        input_ids, mask = self.builder.build(text, qpos[None])
        pix = self.normalize(image[None]).astype(np.float32)
        dev = self.device
        chunk = self.model(torch.from_numpy(input_ids).to(dev),
                           torch.from_numpy(pix).to(dev),
                           torch.from_numpy(mask).to(dev))
        return chunk[0].float().cpu().numpy()  # [chunk, 14] joint deltas


def eval_policy(
    cfg: RoboTwinEvalConfig,
    env: RoboTwinEnvProtocol,
    policy: RoboTwinPolicy,
) -> Dict[str, Any]:
    succ = 0
    evaluated = 0
    episodes = []
    for ep in range(cfg.test_num):
        seed = 100000 * (1 + cfg.seed) + ep
        env.reset_with_seed(seed)
        # expert-check gating: skip seeds the scripted expert cannot solve
        if not env.play_expert_once():
            episodes.append({"seed": seed, "skipped": True})
            continue
        env.reset_with_seed(seed)
        evaluated += 1
        steps = 0
        success = False
        while steps < cfg.step_lim and not success:
            obs = env.get_observation()
            chunk = policy.get_actions(
                obs["image"], obs["qpos"], obs["instruction"]
            )
            qpos = np.asarray(obs["qpos"], np.float64)
            for a in chunk[: cfg.chunk_exec]:
                qpos = qpos + a  # delta joint control (_base_task.py:2726-2760)
                env.step_qpos(qpos)
                steps += 1
                if env.check_success():
                    success = True
                    break
        succ += int(success)
        episodes.append({"seed": seed, "success": success, "steps": steps})
        logger.info("robotwin %s ep %d seed %d success=%s",
                    cfg.task_name, ep, seed, success)
    summary = {
        "task": cfg.task_name,
        "test_num": cfg.test_num,
        "evaluated": evaluated,
        "success_rate": succ / max(evaluated, 1),
        "episodes": episodes,
    }
    if cfg.results_dir:
        os.makedirs(cfg.results_dir, exist_ok=True)
        with open(os.path.join(cfg.results_dir, f"{cfg.task_name}.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return summary
