"""RLDS / Open-X-Embodiment data pipeline (tf.data on host CPU -> numpy feed);
the port's copy of vlaser_tpu/data/rlds.py. `tensorflow` is imported only
inside these functions (`_tf`, which hides every GPU from TF so that it
never claims the card), `tensorflow_datasets` only in
make_dataset_from_rlds.

Parity surface: Simpler/src/data/dataset.py —
- make_dataset_from_rlds (:258): restructure episodes to a standard schema
  {observation: {image_primary, proprio}, action, language_instruction},
  normalize action/proprio (bound p01/p99 or gaussian), dataset-statistics
  computation with JSON caching
- apply_trajectory_transforms (:33): window chunking (obs history window_size,
  action future horizon), per-transition padding masks, subsampling
- apply_frame_transforms (:179): image decode + resize (+ optional augment)
- make_interleaved_dataset (:497): weighted mixture over datasets, shuffle,
  repeat, batch
- agent/dataset.py TorchRLDSInterleavedDataset -> here a numpy iterator
  (VLATrainer.train_steps moves its batches to the model's device).

The reference's dlimp dependency is replaced by plain tf.data ops.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def _tf():
    import tensorflow as tf

    tf.config.set_visible_devices([], "GPU")
    return tf


@dataclass
class RLDSDatasetConfig:
    name: str
    data_dir: str = ""
    image_key: str = "image_primary"
    # standardize_fn: raw trajectory dict -> {observation:{image, proprio},
    # action, language_instruction}
    standardize_fn: Optional[Callable] = None
    action_normalization: str = "bound"  # bound | gaussian | none
    proprio_normalization: str = "bound"
    norm_mask: Optional[Sequence[bool]] = None  # dims to normalize (gripper off)
    statistics_path: Optional[str] = None
    weight: float = 1.0


def compute_dataset_statistics(ds, cache_path: Optional[str] = None) -> Dict:
    """p01/p99/mean/std over action and proprio; JSON-cached
    (dataset.py:258 stats cache behavior)."""
    if cache_path and os.path.exists(cache_path):
        with open(cache_path) as f:
            return json.load(f)
    actions, proprios = [], []
    for traj in ds.as_numpy_iterator():
        actions.append(traj["action"].reshape(-1, traj["action"].shape[-1]))
        if "proprio" in traj["observation"]:
            proprios.append(
                traj["observation"]["proprio"].reshape(
                    -1, traj["observation"]["proprio"].shape[-1]
                )
            )
    acts = np.concatenate(actions, 0)
    stats = {
        "action": {
            "p01": np.percentile(acts, 1, axis=0).tolist(),
            "p99": np.percentile(acts, 99, axis=0).tolist(),
            "mean": acts.mean(0).tolist(),
            "std": acts.std(0).tolist(),
        },
        "num_transitions": int(acts.shape[0]),
    }
    if proprios:
        pr = np.concatenate(proprios, 0)
        stats["proprio"] = {
            "p01": np.percentile(pr, 1, axis=0).tolist(),
            "p99": np.percentile(pr, 99, axis=0).tolist(),
            "mean": pr.mean(0).tolist(),
            "std": pr.std(0).tolist(),
        }
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        with open(cache_path, "w") as f:
            json.dump(stats, f)
    return stats


def _normalize(tensor, stats, kind: str, mask=None):
    tf = _tf()
    if kind == "none":
        return tensor
    if kind == "bound":
        lo = tf.constant(stats["p01"], tf.float32)
        hi = tf.constant(stats["p99"], tf.float32)
        normed = tf.clip_by_value(2.0 * (tensor - lo) / (hi - lo + 1e-8) - 1.0, -1, 1)
    else:
        mean = tf.constant(stats["mean"], tf.float32)
        std = tf.constant(stats["std"], tf.float32)
        normed = (tensor - mean) / (std + 1e-8)
    if mask is not None:
        m = tf.constant(np.asarray(mask, bool))
        normed = tf.where(m, normed, tensor)
    return normed


def make_dataset_from_rlds(
    cfg: RLDSDatasetConfig,
    *,
    train: bool = True,
    builder=None,
    trajectory_ds=None,
    statistics: Optional[Dict] = None,
):
    """-> (trajectory tf.data.Dataset, statistics dict).

    `trajectory_ds` lets tests inject synthetic episode datasets; otherwise
    `builder` (a tfds builder) or cfg.name/data_dir is used.
    """
    tf = _tf()
    if trajectory_ds is None:
        import tensorflow_datasets as tfds

        if builder is None:
            builder = tfds.builder(cfg.name, data_dir=cfg.data_dir)
        split = "train" if train else "val"
        ds = builder.as_dataset(split=split, shuffle_files=train)

        def to_traj(ep):
            steps = ep["steps"].batch(int(1e9)).get_single_element()
            return steps

        ds = ds.map(to_traj, num_parallel_calls=tf.data.AUTOTUNE)
    else:
        ds = trajectory_ds

    if cfg.standardize_fn is not None:
        ds = ds.map(cfg.standardize_fn, num_parallel_calls=tf.data.AUTOTUNE)

    if statistics is None:
        statistics = compute_dataset_statistics(ds, cfg.statistics_path)

    def normalize(traj):
        traj = dict(traj)
        traj["action"] = _normalize(
            tf.cast(traj["action"], tf.float32),
            statistics["action"], cfg.action_normalization, cfg.norm_mask,
        )
        obs = dict(traj["observation"])
        if "proprio" in obs and "proprio" in statistics:
            obs["proprio"] = _normalize(
                tf.cast(obs["proprio"], tf.float32),
                statistics["proprio"], cfg.proprio_normalization, None,
            )
        traj["observation"] = obs
        return traj

    return ds.map(normalize, num_parallel_calls=tf.data.AUTOTUNE), statistics


def goal_relabel_uniform(traj, max_goal_distance: Optional[int] = None,
                         seed: Optional[int] = None):
    """Uniform future-state goal relabeling: traj['task'] mirrors the
    observation at a uniformly sampled future index
    (src/data/utils/goal_relabeling.py:14-46)."""
    tf = _tf()
    traj_len = tf.shape(tf.nest.flatten(traj["observation"])[0])[0]
    if seed is None:
        rand = tf.random.uniform([traj_len])
    else:
        rand = tf.random.stateless_uniform([traj_len], seed=[seed, 0])
    low = tf.cast(tf.range(traj_len), tf.float32)
    if max_goal_distance is not None:
        high = tf.cast(
            tf.minimum(tf.range(traj_len) + max_goal_distance, traj_len),
            tf.float32,
        )
    else:
        high = tf.cast(traj_len, tf.float32)
    goal_idxs = tf.minimum(
        tf.cast(rand * (high - low) + low, tf.int32), traj_len - 1
    )
    goal = tf.nest.map_structure(
        lambda x: tf.gather(x, goal_idxs), traj["observation"]
    )
    traj = dict(traj)
    traj["task"] = {**traj.get("task", {}), **goal}
    return traj


def apply_trajectory_transforms(
    ds,
    *,
    window_size: int = 1,
    action_horizon: int = 4,
    subsample_length: Optional[int] = None,
    skip_unlabeled: bool = False,
    goal_relabeling_strategy: Optional[str] = None,
    goal_relabeling_kwargs: Optional[Dict] = None,
    seed: int = 0,
):
    """Chunk trajectories into per-frame windows (dataset.py:33-178):
    observation history of `window_size`, future action chunk of
    `action_horizon`, with validity masks at episode boundaries; optional
    unlabeled-episode skipping (dataset.py:103-110) and goal relabeling
    (dataset.py:134-141) before chunking."""
    tf = _tf()

    if skip_unlabeled:
        ds = ds.filter(
            lambda t: tf.math.reduce_any(t["language_instruction"] != "")
        )
    if goal_relabeling_strategy is not None:
        assert goal_relabeling_strategy == "uniform", goal_relabeling_strategy
        kw = goal_relabeling_kwargs or {}
        ds = ds.map(
            lambda t: goal_relabel_uniform(t, **kw),
            num_parallel_calls=tf.data.AUTOTUNE,
        )

    def chunk(traj):
        traj_len = tf.shape(traj["action"])[0]
        # history indices [t-window+1 ... t], clamped at 0
        hist = tf.range(traj_len)[:, None] + tf.range(
            -window_size + 1, 1
        )[None, :]
        hist = tf.maximum(hist, 0)
        # future action indices [t ... t+horizon-1], clamped at end
        fut = tf.range(traj_len)[:, None] + tf.range(action_horizon)[None, :]
        pad_mask = fut < traj_len
        fut = tf.minimum(fut, traj_len - 1)

        obs = {
            k: tf.gather(v, hist) for k, v in traj["observation"].items()
        }
        out = {
            "observation": obs,
            "action": tf.gather(traj["action"], fut),  # [T, horizon, dim]
            "action_pad_mask": pad_mask,
            "language_instruction": traj["language_instruction"],
        }
        if "task" in traj:  # per-transition goal (goal_relabel_uniform)
            out["task"] = traj["task"]
        return tf.data.Dataset.from_tensor_slices(out)

    ds = ds.flat_map(chunk)
    if subsample_length is not None:
        ds = ds.shuffle(1000, seed=seed).take(subsample_length)
    return ds


# image augmentation kwargs of the Vlaser-VLA recipe
# (src/agent/dataset.py:44-75; strong variant behind use_strong_data_aug)
AUGMENT_KWARGS_PRIMARY = dict(
    random_resized_crop=dict(scale=[0.8, 1.0], ratio=[0.9, 1.1]),
    random_brightness=[0.1],
    random_contrast=[0.9, 1.1],
    random_saturation=[0.9, 1.1],
    random_hue=[0.05],
    augment_order=[
        "random_resized_crop", "random_brightness", "random_contrast",
        "random_saturation", "random_hue",
    ],
)
AUGMENT_KWARGS_PRIMARY_STRONG = dict(
    random_resized_crop=dict(scale=[0.7, 1.0], ratio=[0.8, 1.2]),
    random_brightness=[0.2],
    random_contrast=[0.8, 1.2],
    random_saturation=[0.8, 1.2],
    random_hue=[0.1],
    augment_order=AUGMENT_KWARGS_PRIMARY["augment_order"],
)


def augment_image(image, seed, augment_kwargs: Dict):
    """dlimp-style stateless augmentation chain on a uint8 [H, W, 3] image.

    Ops and kwargs match dlimp.transforms.augment_image as configured by the
    recipe (random_resized_crop / brightness / contrast / saturation / hue,
    applied in augment_order with a shared per-frame seed)."""
    tf = _tf()
    seed = tf.cast(seed, tf.int32)
    img = tf.image.convert_image_dtype(image, tf.float32)
    h = tf.shape(img)[0]
    w = tf.shape(img)[1]
    for i, op in enumerate(augment_kwargs["augment_order"]):
        op_seed = seed + i  # distinct stream per op, deterministic per frame
        if op == "random_resized_crop":
            kw = augment_kwargs[op]
            u = tf.random.stateless_uniform([2], seed=op_seed)
            scale = kw["scale"][0] + u[0] * (kw["scale"][1] - kw["scale"][0])
            ratio = kw["ratio"][0] + u[1] * (kw["ratio"][1] - kw["ratio"][0])
            hf = tf.cast(h, tf.float32)
            wf = tf.cast(w, tf.float32)
            crop_h = tf.minimum(tf.sqrt(scale / ratio) * hf, hf)
            crop_w = tf.minimum(tf.sqrt(scale * ratio) * wf, wf)
            ch = tf.cast(crop_h, tf.int32)
            cw = tf.cast(crop_w, tf.int32)
            img = tf.image.stateless_random_crop(
                img, [ch, cw, 3], seed=op_seed
            )
            img = tf.image.resize(img, [h, w])
        elif op == "random_brightness":
            img = tf.image.stateless_random_brightness(
                img, augment_kwargs[op][0], seed=op_seed
            )
        elif op == "random_contrast":
            lo, hi = augment_kwargs[op]
            img = tf.image.stateless_random_contrast(img, lo, hi, seed=op_seed)
        elif op == "random_saturation":
            lo, hi = augment_kwargs[op]
            img = tf.image.stateless_random_saturation(img, lo, hi, seed=op_seed)
        elif op == "random_hue":
            img = tf.image.stateless_random_hue(
                img, augment_kwargs[op][0], seed=op_seed
            )
        else:
            raise ValueError(op)
    img = tf.clip_by_value(img, 0.0, 1.0)
    return tf.image.convert_image_dtype(img, tf.uint8, saturate=True)


def apply_frame_transforms(ds, *, resize: Optional[Sequence[int]] = None,
                           image_key: str = "image_primary",
                           train: bool = False,
                           image_augment_kwargs: Optional[Dict] = None):
    """Decode + resize (+ train-time augmentation) per frame
    (dataset.py:179-257; augmentation uses one shared seed per frame across
    the observation history, like the reference's aug_and_dropout)."""
    tf = _tf()

    def fr(frame):
        obs = dict(frame["observation"])
        img = obs[image_key]
        if img.dtype == tf.string:
            img = tf.map_fn(
                lambda x: tf.io.decode_image(x, 3, expand_animations=False),
                img, fn_output_signature=tf.uint8,
            )
        if resize is not None:
            img = tf.cast(
                tf.image.resize(
                    tf.cast(img, tf.float32), resize, method="lanczos3"
                ),
                tf.uint8,
            )
        if train and image_augment_kwargs:
            seed = tf.random.uniform(
                [2], maxval=tf.int32.max, dtype=tf.int32
            )
            img = tf.map_fn(
                lambda x: augment_image(x, seed, image_augment_kwargs),
                img, fn_output_signature=tf.uint8,
            )
        obs[image_key] = img
        frame = dict(frame)
        frame["observation"] = obs
        return frame

    return ds.map(fr, num_parallel_calls=tf.data.AUTOTUNE)


def make_interleaved_dataset(
    datasets: List,  # list of frame-level tf.data.Datasets
    weights: Optional[Sequence[float]] = None,
    *,
    shuffle_buffer_size: int = 200_000,  # reference default (train script);
    # lower it explicitly on small-RAM hosts
    batch_size: int = 32,
    seed: int = 0,
):
    """Weighted mixture + shuffle + repeat + batch (dataset.py:497-553)."""
    tf = _tf()
    datasets = [d.repeat() for d in datasets]
    if len(datasets) == 1:
        ds = datasets[0]
    else:
        w = np.asarray(
            weights if weights is not None else [1.0] * len(datasets), np.float64
        )
        w = (w / w.sum()).tolist()
        ds = tf.data.Dataset.sample_from_datasets(datasets, w, seed=seed)
    ds = ds.shuffle(shuffle_buffer_size, seed=seed)
    ds = ds.batch(batch_size, drop_remainder=True)
    return ds.prefetch(tf.data.AUTOTUNE)


class RLDSInterleavedIterator:
    """Numpy feed (TorchRLDSInterleavedDataset analogue,
    agent/dataset.py:14)."""

    def __init__(self, ds):
        self.ds = ds

    def __iter__(self):
        return self.ds.as_numpy_iterator()


# --- gripper/action relabel helpers (src/data/utils/data_utils.py) ---------


def binarize_gripper_actions(actions):
    """Continuous gripper -> {0,1}; in-between values take the NEXT settled
    state (reverse scan) (data_utils.py:307-344)."""
    tf = _tf()
    open_mask = actions > 0.95
    closed_mask = actions < 0.05
    in_between = tf.logical_not(tf.logical_or(open_mask, closed_mask))
    is_open = tf.cast(open_mask, tf.float32)

    def scan_fn(carry, i):
        return tf.cond(in_between[i], lambda: tf.cast(carry, tf.float32),
                       lambda: is_open[i])

    return tf.scan(scan_fn, tf.range(tf.shape(actions)[0]), actions[-1],
                   reverse=True)


def rel2abs_gripper_actions(actions):
    """Relative open/close impulses -> absolute 0=closed / 1=open state
    (data_utils.py:374-400; fractal gripper convention)."""
    tf = _tf()
    opening = actions < -0.1
    closing = actions > 0.1
    thresholded = tf.where(opening, 1, tf.where(closing, -1, 0))

    def scan_fn(carry, i):
        return tf.cond(thresholded[i] == 0, lambda: carry,
                       lambda: thresholded[i])

    start = -1 * thresholded[tf.argmax(thresholded != 0, axis=0)]
    start = tf.cond(start == 0, lambda: 1, lambda: start)
    new = tf.scan(scan_fn, tf.range(tf.shape(actions)[0]), start)
    return tf.cast(new, tf.float32) / 2 + 0.5


def invert_gripper_actions(actions):
    return 1 - actions


def relabel_actions(traj):
    """Movement actions = delta of reached proprio; drops the last step
    (data_utils.py:407-425; bridge protocol)."""
    tf = _tf()
    movement = (
        traj["observation"]["state"][1:, :6]
        - traj["observation"]["state"][:-1, :6]
    )
    truncated = tf.nest.map_structure(lambda x: x[:-1], traj)
    truncated["action"] = tf.concat(
        [movement, traj["action"][:-1, -1:]], axis=1
    )
    return truncated


def quaternion_to_euler(quaternion):
    """[x, y, z, w] -> (roll, pitch, yaw); matches
    tensorflow_graphics' euler.from_quaternion used by the fractal transform
    (oxe_standardization_transforms.py:42-61, 86-94)."""
    tf = _tf()
    x, y, z, w = tf.unstack(quaternion, axis=-1)
    sinr_cosp = 2 * (w * x + y * z)
    cosr_cosp = 1 - 2 * (x * x + y * y)
    roll = tf.atan2(sinr_cosp, cosr_cosp)
    sinp = tf.clip_by_value(2 * (w * y - z * x), -1.0, 1.0)
    pitch = tf.asin(sinp)
    siny_cosp = 2 * (w * z + x * y)
    cosy_cosp = 1 - 2 * (y * y + z * z)
    yaw = tf.atan2(siny_cosp, cosy_cosp)
    return tf.stack([roll, pitch, yaw], axis=-1)


# --- standardization transforms (oxe_standardization_transforms.py) --------


def bridge_standardize(traj):
    """bridge_dataset (oxe_standardization_transforms.py:27-41): binarize the
    gripper, relabel movement actions from reached state (drops last step),
    proprio = raw state."""
    tf = _tf()
    obs = dict(traj["observation"])
    action = tf.cast(traj["action"], tf.float32)
    action = tf.concat(
        [action[:, :6], binarize_gripper_actions(action[:, -1])[:, None]],
        axis=1,
    )
    inner = {
        "observation": {"state": tf.cast(obs["state"], tf.float32)},
        "action": action,
    }
    inner = relabel_actions(inner)
    n = tf.shape(inner["action"])[0]
    return {
        "observation": {
            "image_primary": obs["image_0"][:n],
            "proprio": inner["observation"]["state"],
        },
        "action": inner["action"],
        "language_instruction": traj["language_instruction"][:n],
    }


def fractal_standardize(traj):
    """fractal20220817_data = rt1_dataset_transform
    (oxe_standardization_transforms.py:63-98): gripper rel->abs, proprio =
    tool xyz + euler(quat) + gripper_closed."""
    tf = _tf()
    obs = traj["observation"]
    act = traj["action"]
    gripper = rel2abs_gripper_actions(
        tf.cast(act["gripper_closedness_action"], tf.float32)[:, 0]
    )
    action = tf.concat(
        [
            tf.cast(act["world_vector"], tf.float32),
            tf.cast(act["rotation_delta"], tf.float32),
            gripper[:, None],
        ],
        axis=-1,
    )
    pose = tf.cast(obs["base_pose_tool_reached"], tf.float32)
    proprio = tf.concat(
        [
            pose[:, :3],
            quaternion_to_euler(pose[:, 3:7]),
            tf.cast(obs["gripper_closed"], tf.float32),
        ],
        axis=-1,
    )
    return {
        "observation": {"image_primary": obs["image"], "proprio": proprio},
        "action": action,
        "language_instruction": traj["natural_language_instruction"]
        if "natural_language_instruction" in traj
        else obs.get("natural_language_instruction"),
    }


def droid_standardize(traj):
    """droid = droid_baseact_transform (src/data/utils/droid_utils.py:315-342):
    base-frame cartesian velocity + inverted gripper; random exterior-camera
    swap; proprio = cartesian position + gripper."""
    tf = _tf()
    obs = traj["observation"]
    act = traj["action_dict"]
    action = tf.concat(
        [
            tf.cast(act["cartesian_velocity"][:, :3], tf.float32),
            tf.cast(act["cartesian_velocity"][:, 3:6], tf.float32),
            1.0 - tf.cast(act["gripper_position"], tf.float32),
        ],
        axis=-1,
    )
    img1 = obs["exterior_image_1_left"]
    img2 = obs["exterior_image_2_left"]
    image = tf.cond(tf.random.uniform([]) > 0.5, lambda: img1, lambda: img2)
    proprio = tf.concat(
        [
            tf.cast(obs["cartesian_position"], tf.float32),
            tf.cast(obs["gripper_position"], tf.float32),
        ],
        axis=-1,
    )
    return {
        "observation": {"image_primary": image, "proprio": proprio},
        "action": action,
        "language_instruction": traj["language_instruction"],
    }


OXE_STANDARDIZATION_TRANSFORMS = {
    "bridge_dataset": bridge_standardize,
    "fractal20220817_data": fractal_standardize,
    "droid": droid_standardize,
}

# dataset mixes used by the Vlaser-VLA recipes (oxe_dataset_mixes.py:3-31)
OXE_SIMPLE_MIX = [("fractal20220817_data", 1.0), ("bridge_dataset", 1.0)]
OXE_SIMPLE2_MIX = [("fractal20220817_data", 1.5), ("bridge_dataset", 1.0)]
OXE_BRIDGE_FRACTAL_DROID_MIX = [
    ("fractal20220817_data", 1.5), ("bridge_dataset", 1.0), ("droid", 0.03),
]
BRIDGE_MIX = [("bridge_dataset", 1.0)]
FRACTAL_MIX = [("fractal20220817_data", 1.0)]
