"""SimplerEnv adapters: observations -> model inputs, actions -> env actions
(the base adapter, `BridgeSimplerAdapter` and `EDRSimplerAdapter` of
vlaser_tpu/envs/adapters.py, copied unchanged; host-side numpy).

- normalize/denormalize bound (p01/p99 -> [-1, 1]) and gaussian, from
  dataset statistics;
- `preprocess`: LANCZOS resize, uint8 frame, proprio normalization;
  `postprocess`: denormalize all but the gripper, euler -> axis-angle,
  the robot's gripper rule;
- Bridge (WidowX): top-down rotation frame, binary gripper 2*(a>0.5)-1;
- EDR (Google Robot / fractal): euler proprio from the xyzw quaternion,
  gripper closedness, a sticky gripper held for 15 actions.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np

from .geometry import euler2axangle, mat2euler, quat2euler, quat2mat


def normalize_bound(x, low, high, clip_min=-1.0, clip_max=1.0):
    return np.clip(2.0 * (x - low) / (high - low + 1e-8) - 1.0, clip_min,
                   clip_max)


def denormalize_bound(x, low, high, clip_min=-1.0, clip_max=1.0):
    x = np.clip(x, clip_min, clip_max)
    return 0.5 * (x + 1.0) * (high - low) + low


def normalize_gaussian(x, mean, std):
    return (x - mean) / (std + 1e-8)


def denormalize_gaussian(x, mean, std):
    return x * std + mean


class SimplerAdapter:
    """Base adapter for SimplerEnv robots."""

    def __init__(
        self,
        dataset_statistics_path: Optional[str] = None,
        dataset_statistics: Optional[Dict] = None,
        image_size: Tuple[int, int] = (448, 448),
        action_normalization_type: str = "bound",
        proprio_normalization_type: str = "bound",
        proprio_dim: int = 7,
    ):
        assert action_normalization_type in ("bound", "gaussian")
        assert proprio_normalization_type in ("bound", "gaussian")
        if dataset_statistics is None:
            with open(dataset_statistics_path) as f:
                dataset_statistics = json.load(f)
        self.stats = dataset_statistics
        self.image_size = tuple(image_size)
        self.action_normalization_type = action_normalization_type
        self.proprio_normalization_type = proprio_normalization_type
        self.proprio_dim = proprio_dim

    def reset(self):
        pass

    def resize_image(self, image: np.ndarray) -> np.ndarray:
        """HxWx3 uint8 -> image_size, LANCZOS."""
        if image.shape[:2] == self.image_size[::-1]:
            return image
        try:
            import cv2

            return cv2.resize(image, self.image_size,
                              interpolation=cv2.INTER_LANCZOS4)
        except ImportError:
            from PIL import Image

            return np.asarray(
                Image.fromarray(image).resize(self.image_size, Image.LANCZOS))

    def preprocess_proprio(self, obs: Dict) -> np.ndarray:
        raise NotImplementedError

    def normalize_proprio(self, raw: np.ndarray) -> np.ndarray:
        s = self.stats["proprio"]
        if self.proprio_normalization_type == "bound":
            return normalize_bound(raw, np.array(s["p01"]), np.array(s["p99"]))
        return normalize_gaussian(raw, np.array(s["mean"]), np.array(s["std"]))

    def preprocess(self, obs: Dict, image: np.ndarray) -> Dict[str, np.ndarray]:
        """Returns {image [H,W,3] uint8, proprio [proprio_dim] f32}."""
        image = self.resize_image(image)
        proprio = self.normalize_proprio(self.preprocess_proprio(obs))
        return {"image": image, "proprio": proprio.astype(np.float32)}

    def postprocess_gripper(self, action: float) -> float:
        raise NotImplementedError

    def postprocess(self, actions: np.ndarray) -> np.ndarray:
        """[T, 7] normalized -> [T, 7] env actions (xyz, axangle, gripper)."""
        s = self.stats["action"]
        if self.action_normalization_type == "bound":
            raw_rest = denormalize_bound(
                actions[:, :-1], np.array(s["p01"])[:-1],
                np.array(s["p99"])[:-1])
        else:
            raw_rest = denormalize_gaussian(
                actions[:, :-1], np.array(s["mean"])[:-1],
                np.array(s["std"])[:-1])
        raw = np.concatenate([raw_rest, actions[:, -1:]], axis=1)
        out = np.zeros((len(raw), 7))
        for i, a in enumerate(raw):
            roll, pitch, yaw = a[3:6]
            axis, angle = euler2axangle(roll, pitch, yaw)
            grip = self.postprocess_gripper(float(a[-1]))
            out[i] = np.concatenate([a[:3], axis * angle, [grip]])
        return out


class BridgeSimplerAdapter(SimplerAdapter):
    """WidowX / Bridge: EE pose relative to a top-down frame; binary
    gripper."""

    DEFAULT_ROT = np.array([[0, 0, 1.0], [0, 1.0, 0], [-1.0, 0, 0]])

    def preprocess_proprio(self, obs: Dict) -> np.ndarray:
        proprio = np.asarray(obs["agent"]["eef_pos"])
        rm = quat2mat(proprio[3:7])
        rpy = mat2euler(rm @ self.DEFAULT_ROT.T)
        return np.concatenate([proprio[:3], rpy, [proprio[7]]])

    def postprocess_gripper(self, action: float) -> float:
        return 2.0 * (action > 0.5) - 1.0


class EDRSimplerAdapter(SimplerAdapter):
    """Google Robot / fractal: euler proprio from xyzw quat, gripper
    closedness, sticky gripper with 15 repeats (simpler.py:259-286)."""

    STICKY_REPEAT = 15

    def __init__(self, **kw):
        super().__init__(**kw)
        self.reset()

    def reset(self):
        self.sticky_action_is_on = False
        self.gripper_action_repeat = 0
        self.sticky_gripper_action = 0.0

    def preprocess_proprio(self, obs: Dict) -> np.ndarray:
        eef = np.asarray(obs["agent"]["eef_pos"])
        quat_xyzw = np.roll(eef[3:7], -1)
        if self.proprio_dim == 7:
            # xyzw -> wxyz for our quat2euler
            rot = quat2euler(np.roll(quat_xyzw, 1))
            rot = np.asarray(rot)
        else:
            rot = quat_xyzw
        gripper_closedness = 1.0 - eef[7]
        return np.concatenate([eef[:3], rot, [gripper_closedness]])

    def postprocess_gripper(self, action: float) -> float:
        action = action * 2.0 - 1.0  # [0,1] -> [-1,1], -1 close
        relative = -action
        if abs(relative) > 0.5 and not self.sticky_action_is_on:
            self.sticky_action_is_on = True
            self.sticky_gripper_action = relative
        if self.sticky_action_is_on:
            self.gripper_action_repeat += 1
            relative = self.sticky_gripper_action
        if self.gripper_action_repeat == self.STICKY_REPEAT:
            self.sticky_action_is_on = False
            self.gripper_action_repeat = 0
            self.sticky_gripper_action = 0.0
        return relative
