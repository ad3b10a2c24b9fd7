"""Closed-loop SimplerEnv evaluation harness.

Parity surface: src/agent/eval.py EvalAgent (:21-213) — per-episode loop:
adapter.preprocess -> policy infer -> adapter.postprocess -> env.step x
act_steps, success bookkeeping, optional video frames; and
run_variant_aggregation (:215-420) — sweep over environment variant configs
(backgrounds, lightings, camera setups, urdf versions) averaging success.

SAPIEN/SimplerEnv are host-side sim processes (SURVEY.md §2.9.6); imports are
lazy so the framework works without them and tests can inject mock envs.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger("vlaser_tpu_torch.eval")


@dataclass
class EvalConfig:
    task: str = "widowx_carrot_on_plate"
    n_eval_episode: int = 240
    act_steps: int = 4
    max_steps: Optional[int] = None  # default: env's episode horizon
    seed: int = 42
    record_video_dir: Optional[str] = None
    results_path: Optional[str] = None


def make_simpler_env(task: str, **overrides):
    """simpler_env.make(task) (SimplerEnv/simpler_env/__init__.py:1-60)."""
    import simpler_env

    return simpler_env.make(task, **overrides)


def get_image_from_obs(env, obs) -> np.ndarray:
    from simpler_env.utils.env.observation_utils import (
        get_image_from_maniskill2_obs_dict,
    )

    return get_image_from_maniskill2_obs_dict(env, obs)


def run_episode(
    env,
    policy,  # serve.policy_server.PolicyServer
    instruction: str,
    *,
    act_steps: int = 4,
    max_steps: Optional[int] = None,
    get_image: Callable = None,
    video_frames: Optional[List[np.ndarray]] = None,
    reset_options: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One closed-loop rollout; returns {success, steps}."""
    obs, _ = env.reset(options=reset_options) if reset_options is not None \
        else env.reset()
    policy.reset(instruction)
    get_image = get_image or (lambda env, obs: get_image_from_obs(env, obs))
    success = False
    truncated = False
    steps = 0
    limit = max_steps if max_steps is not None else 10_000
    while not truncated and steps < limit:
        image = get_image(env, obs)
        if video_frames is not None:
            video_frames.append(image)
        env_actions = policy.step(obs, image)
        for a in env_actions[:act_steps]:
            obs, reward, terminated, truncated, info = env.step(a)
            steps += 1
            success = bool(info.get("success", terminated and reward > 0))
            if truncated or success:
                break
        if success:
            break
    return {"success": success, "steps": steps}


class EvalRunner:
    """EvalAgent analogue: N episodes on one task, success-rate summary."""

    def __init__(self, cfg: EvalConfig, policy, env=None,
                 get_instruction: Optional[Callable] = None,
                 get_image: Optional[Callable] = None,
                 episode_options: Optional[Sequence[Dict[str, Any]]] = None):
        self.cfg = cfg
        self.policy = policy
        self.env = env if env is not None else make_simpler_env(cfg.task)
        self.get_instruction = get_instruction or (
            lambda env: env.unwrapped.get_language_instruction()
        )
        self.get_image = get_image
        # protocol-defined per-episode reset options (episodes_for_spec);
        # overrides n_eval_episode when given
        self.episode_options = episode_options

    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        results = []
        n = (len(self.episode_options) if self.episode_options is not None
             else cfg.n_eval_episode)
        for ep in range(n):
            if hasattr(self.env.unwrapped, "seed"):
                self.env.unwrapped.seed(cfg.seed + ep)
            frames: Optional[List[np.ndarray]] = (
                [] if cfg.record_video_dir else None
            )
            opts = (self.episode_options[ep]
                    if self.episode_options is not None else None)
            instruction = self.get_instruction(self.env)
            res = run_episode(
                self.env, self.policy, instruction,
                act_steps=cfg.act_steps, max_steps=cfg.max_steps,
                get_image=self.get_image, video_frames=frames,
                reset_options=opts,
            )
            results.append(res)
            logger.info(
                "episode %d/%d success=%s steps=%d",
                ep + 1, n, res["success"], res["steps"],
            )
            if frames:
                self._save_video(frames, ep, res["success"])
        summary = {
            "task": cfg.task,
            "n_episodes": len(results),
            "success_rate": float(np.mean([r["success"] for r in results])),
            "avg_steps": float(np.mean([r["steps"] for r in results])),
        }
        if cfg.results_path:
            os.makedirs(os.path.dirname(cfg.results_path) or ".", exist_ok=True)
            with open(cfg.results_path, "w") as f:
                json.dump(summary, f, indent=2)
        return summary

    def _save_video(self, frames, ep, success):
        try:
            import imageio

            os.makedirs(self.cfg.record_video_dir, exist_ok=True)
            path = os.path.join(
                self.cfg.record_video_dir,
                f"ep{ep}_{'success' if success else 'fail'}.mp4",
            )
            imageio.mimsave(path, frames, fps=10)
        except Exception as e:  # video is best-effort
            logger.warning("video save failed: %s", e)


def run_variant_aggregation(
    base_cfg: EvalConfig,
    policy,
    variants: Sequence[Dict[str, Any]],
    env_factory: Callable[[Dict[str, Any]], Any] = None,
    **runner_kw,
) -> Dict[str, Any]:
    """Sweep environment variants (eval.py:215: backgrounds/lightings/
    camera-setups/urdf grids for fractal VA protocol), average success."""
    env_factory = env_factory or (
        lambda v: make_simpler_env(base_cfg.task, **v)
    )
    per_variant = []
    for v in variants:
        env = env_factory(v)
        runner = EvalRunner(base_cfg, policy, env=env, **runner_kw)
        s = runner.run()
        s["variant"] = v
        per_variant.append(s)
    return {
        "task": base_cfg.task,
        "variant_aggregation_success": float(
            np.mean([s["success_rate"] for s in per_variant])
        ),
        "per_variant": per_variant,
    }


def fractal_variant_specs(task: str, protocol: str = "va"):
    """Full per-task environment grids for the fractal protocols.

    protocol='va' -> variant aggregation (variant_aggressive_config.py:10-454)
    protocol='vm' -> visual matching (:455-861). Returns the concrete env
    specs the sweep iterates; see eval/variant_configs.py for the data.
    """
    from .variant_configs import (
        enumerate_env_specs,
        variant_aggregation_families,
        visual_matching_families,
    )

    fams = (
        variant_aggregation_families(task)
        if protocol == "va"
        else visual_matching_families(task)
    )
    return list(enumerate_env_specs(fams))


def episodes_for_spec(spec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Concrete env.reset(options=...) dicts for one env spec: the product of
    robot pose grid x object init grid / episode range
    (variant_aggressive_config.py get_env:956-975 option naming)."""
    out = []
    for rx in spec["robot_init_xs"]:
        for ry in spec["robot_init_ys"]:
            for rq in spec["robot_init_quats"]:
                base = {
                    "robot_init_options": {
                        "init_xy": np.array([rx, ry]),
                        "init_rot_quat": np.asarray(rq),
                    }
                }
                if spec["obj_variation_mode"] == "xy":
                    for ox in spec["obj_init_xs"]:
                        for oy in spec["obj_init_ys"]:
                            out.append({
                                **base,
                                "obj_init_options": {
                                    "init_xy": np.array([ox, oy])
                                },
                            })
                else:
                    lo, hi = spec["obj_episode_range"]
                    for ep in range(lo, hi):
                        out.append({
                            **base,
                            "obj_init_options": {"episode_id": ep},
                        })
    return out


def build_env_from_spec(spec: Dict[str, Any], task: str, *,
                        robot: str = "google_robot_static",
                        control_freq: int = 3, sim_freq: int = 513,
                        overlay_root: Optional[str] = None):
    """gym.make with the spec's build kwargs (get_env:904-954): raytracing
    prepends shader_dir=rt; VM overlay path resolves under overlay_root."""
    import gymnasium as gym

    build_kwargs = dict(spec["build_kwargs"])
    if spec.get("enable_raytracing"):
        build_kwargs = {"shader_dir": "rt", **build_kwargs}
    kwargs = dict(
        obs_mode="rgbd",
        robot=robot,
        sim_freq=sim_freq,
        control_freq=control_freq,
        control_mode="arm_pd_ee_delta_pose_align_interpolate_by_planner_gripper_pd_joint_target_delta_pos_interpolate_by_planner",
        max_episode_steps=spec["max_episode_steps"],
        scene_name=spec["scene_name"],
        camera_cfgs={"add_segmentation": True},
    )
    if spec.get("rgb_overlay") and overlay_root:
        kwargs["rgb_overlay_path"] = os.path.join(overlay_root,
                                                  spec["rgb_overlay"])
        kwargs["rgb_overlay_cameras"] = ["overhead_camera"]
    return gym.make(spec["env_name"], **build_kwargs, **kwargs)


def run_fractal_protocol(
    base_cfg: EvalConfig,
    policy,
    task: str,
    protocol: str = "va",
    env_factory: Callable[[Dict[str, Any]], Any] = None,
    **runner_kw,
) -> Dict[str, Any]:
    """VM/VA sweep over the full per-task grid, averaging success across env
    specs (EvalAgent.run_variant_aggregation, eval.py:215-420)."""
    specs = fractal_variant_specs(task, protocol)
    env_factory = env_factory or (lambda spec: build_env_from_spec(spec, task))
    per_variant = []
    for spec in specs:
        env = env_factory(spec)
        runner = EvalRunner(
            base_cfg, policy, env=env,
            episode_options=episodes_for_spec(spec), **runner_kw,
        )
        s_ = runner.run()
        s_["spec"] = {k: spec[k] for k in
                      ("env_name", "scene_name", "build_kwargs")}
        per_variant.append(s_)
        if hasattr(env, "close"):
            env.close()
    return {
        "task": task,
        "protocol": protocol,
        "aggregate_success": float(
            np.mean([s_["success_rate"] for s_ in per_variant])
        ),
        "per_variant": per_variant,
    }
