"""The port's RLDS pipeline (vlaser_tpu_torch/data/rlds.py) against the JAX
package's (vlaser_tpu/data/rlds.py) on tests/test_rlds.py's synthetic
trajectories: statistics, normalized actions and proprio, windows, goal
relabels, frames, augmentation at fixed seeds, the standardize functions
and the interleaved batches must be equal, element for element (the two
run the same tf ops on the same inputs with the same seeds)."""

import importlib.util
import os

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from vlaser_tpu.data import rlds as jr  # noqa: E402
from vlaser_tpu_torch.data import rlds as pr  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "_jax_rlds_tests", os.path.join(os.path.dirname(__file__),
                                    "test_rlds.py"))
_jt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_jt)
synthetic = _jt._synthetic_traj_ds


def _same(a, b, path="batch"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert np.array_equal(a, b), path


def _take(ds, n):
    return [x for _, x in zip(range(n), ds.as_numpy_iterator())]


def _both(fn):
    """fn(module) for the JAX copy and the port's."""
    return fn(jr), fn(pr)


@pytest.mark.parametrize("norm", ["bound", "gaussian"])
def test_statistics_and_normalized_trajectories(tmp_path, norm):
    def run(mod):
        cfg = mod.RLDSDatasetConfig(
            name="synthetic", action_normalization=norm,
            proprio_normalization=norm, norm_mask=[True] * 6 + [False],
            statistics_path=str(tmp_path / f"{mod.__name__}.json"))
        ds, stats = mod.make_dataset_from_rlds(
            cfg, trajectory_ds=synthetic(seed=3)[0])
        return stats, _take(ds, 4)

    (sj, tj), (sp, tp) = _both(run)
    assert sj == sp and sj["num_transitions"] == 40
    for a, b in zip(tj, tp):
        _same(a, b)
    # the JSON cache: the port reads what it wrote
    cfg = pr.RLDSDatasetConfig(name="synthetic", statistics_path=str(
        tmp_path / f"{pr.__name__}.json"))
    _, again = pr.make_dataset_from_rlds(cfg, trajectory_ds=synthetic()[0])
    assert again == sp


def _frames(mod, **kw):
    cfg = mod.RLDSDatasetConfig(name="s", action_normalization="none",
                                proprio_normalization="none")
    ds, _ = mod.make_dataset_from_rlds(cfg, trajectory_ds=synthetic(
        n_traj=3, traj_len=9, seed=4)[0], statistics={"action": {}})
    return mod.apply_trajectory_transforms(ds, **kw)


@pytest.mark.parametrize("kw", [
    dict(window_size=2, action_horizon=3),
    dict(window_size=1, action_horizon=4, subsample_length=10, seed=7),
    dict(window_size=1, action_horizon=2, skip_unlabeled=True,
         goal_relabeling_strategy="uniform",
         goal_relabeling_kwargs={"max_goal_distance": 3, "seed": 1})])
def test_windows_match(kw):
    fj, fp = _both(lambda m: _take(_frames(m, **kw), 40))
    assert len(fj) == len(fp) > 0
    for a, b in zip(fj, fp):
        _same(a, b)


def test_frame_transforms_and_augmentation_match():
    fj, fp = _both(lambda m: _take(m.apply_frame_transforms(
        _frames(m, window_size=2, action_horizon=4), resize=(24, 24)), 12))
    for a, b in zip(fj, fp):
        _same(a, b)
    img = tf.constant(np.random.default_rng(0).integers(
        0, 255, (32, 32, 3), np.uint8))
    for kwargs in ("AUGMENT_KWARGS_PRIMARY", "AUGMENT_KWARGS_PRIMARY_STRONG"):
        assert getattr(jr, kwargs) == getattr(pr, kwargs)
        a, b = _both(lambda m: m.augment_image(
            img, tf.constant([3, 7]), getattr(m, kwargs)).numpy())
        _same(a, b)
        assert (a != img.numpy()).any()


def test_interleaved_batches_match():
    def run(mod):
        frames = []
        for seed in (1, 2):
            cfg = mod.RLDSDatasetConfig(name="s", action_normalization="none",
                                        proprio_normalization="none")
            out, _ = mod.make_dataset_from_rlds(
                cfg, trajectory_ds=synthetic(seed=seed)[0],
                statistics={"action": {}})
            f = mod.apply_trajectory_transforms(out, window_size=1,
                                                action_horizon=4)
            frames.append(mod.apply_frame_transforms(f, resize=(8, 8)))
        mixed = mod.make_interleaved_dataset(
            frames, weights=[0.7, 0.3], shuffle_buffer_size=64, batch_size=8,
            seed=5)
        it = iter(mod.RLDSInterleavedIterator(mixed))
        return [next(it) for _ in range(6)]

    bj, bp = _both(run)
    for a, b in zip(bj, bp):
        _same(a, b)
    assert bp[0]["observation"]["image_primary"].shape == (8, 1, 8, 8, 3)


def test_gripper_helpers_and_standardizers_match():
    acts = tf.constant([1.0, 0.6, 0.4, 0.0, 0.0, 0.5, 1.0], tf.float32)
    rel = tf.constant([0.0, 0.0, 1.0, 0.0, -1.0, 0.0], tf.float32)
    for fn, x in (("binarize_gripper_actions", acts),
                  ("rel2abs_gripper_actions", rel),
                  ("invert_gripper_actions", acts)):
        _same(*_both(lambda m: getattr(m, fn)(x).numpy()))
    rng = np.random.default_rng(1)
    q = rng.standard_normal((5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _same(*_both(lambda m: m.quaternion_to_euler(tf.constant(q)).numpy()))
    T = 6
    state = rng.standard_normal((T, 7)).astype(np.float32)
    bridge = lambda: {
        "observation": {"image_0": np.zeros((T, 8, 8, 3), np.uint8),
                        "state": tf.constant(state)},
        "action": tf.constant(np.concatenate(
            [rng.standard_normal((T, 6)).astype(np.float32),
             np.array([[1.0], [0.5], [0.0], [0.2], [1.0], [1.0]],
                      np.float32)], 1)),
        "language_instruction": tf.constant([b"x"] * T)}
    pose = np.concatenate([state[:, :3], q[:1].repeat(T, 0)], 1)
    fractal = lambda: {
        "observation": {
            "image": np.zeros((T, 8, 8, 3), np.uint8),
            "base_pose_tool_reached": tf.constant(pose),
            "gripper_closed": tf.constant(np.zeros((T, 1), np.float32)),
            "natural_language_instruction": tf.constant([b"y"] * T)},
        "action": {
            "world_vector": tf.constant(state[:, :3]),
            "rotation_delta": tf.constant(state[:, 3:6]),
            "gripper_closedness_action": tf.constant(state[:, 6:])}}
    for name, raw in (("bridge_dataset", bridge),
                      ("fractal20220817_data", fractal)):
        inp = raw()
        a, b = _both(lambda m: tf.nest.map_structure(
            lambda t: np.asarray(t), m.OXE_STANDARDIZATION_TRANSFORMS[name](
                dict(inp))))
        _same(a, b, name)
    assert sorted(jr.OXE_STANDARDIZATION_TRANSFORMS) == sorted(
        pr.OXE_STANDARDIZATION_TRANSFORMS)
    for mix in ("OXE_SIMPLE_MIX", "OXE_BRIDGE_FRACTAL_DROID_MIX", "BRIDGE_MIX",
                "FRACTAL_MIX"):
        assert getattr(jr, mix) == getattr(pr, mix)
