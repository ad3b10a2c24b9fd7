"""The port's VLA training recipe (vlaser_tpu_torch/train/trainer.py
VLATrainer with the 8-bit AdamW, model averaging, evaluate, checkpoints and
the metrics log; train/metrics.py; train/model_averaging.py) against the
JAX package's on the CPU at tiny_vla, same numpy-drawn weights, batches, t,
x0 and noise, fp32 compute on both sides.

Tolerances, each measured here and given with its reason:
- metrics: the same elementwise comparisons, so accuracies equal and L1
  within one fp32 rounding of its mean (summation order);
- averaging: fp32 within 2 ulp of each value (XLA may contract a * d + p *
  (1 - d) into one rounding);
- three 8-bit trainer steps at lr 1e-3: losses within 1e-5 and grad norms
  within 1e-4 relative (fp32 summation order, as test_torch_train.py);
  the 8-bit codes equal in all but 1e-3 of the entries (measured: 76 of
  ~0.4 M), each differing entry's decoded moment within one step at the
  table's top, 1/31 of its block's scale (measured 0.0323), and the
  scales within 1e-4 (measured 3.4e-5): a gradient that differs in its
  last bits moves a value across a midpoint (test_torch_optim8bit.py
  holds one step from one state code for code);
  parameters within 1e-6 on all but 0.1% of the elements and
  at most 3 whole steps (3 x 2 x lr) on those (Adam's g / (|g| + eps) at a
  gradient near its fp32 noise floor, as test_torch_train.py);
- evaluate: actions after 4 Euler steps within 1e-5 (fp32, summation
  order).
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlaser_tpu.train.trainer as jtrainer
from vlaser_tpu.core import mesh as mesh_lib
from vlaser_tpu.core.config import tiny_vla
from vlaser_tpu.policy.pizero import PiZeroVLA
from vlaser_tpu.train.metrics import action_accuracy as j_acc
from vlaser_tpu.train.metrics import action_l1 as j_l1
from vlaser_tpu.train.model_averaging import AveragingConfig as JAvgConfig
from vlaser_tpu.train.model_averaging import ModelAveraging as JAveraging
from vlaser_tpu.train.optim8bit import Adam8bitLeaf
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.policy.pizero import PiZeroVLA as TorchVLA
from vlaser_tpu_torch.train import trainer as ptrainer
from vlaser_tpu_torch.train.metrics import action_accuracy, action_l1
from vlaser_tpu_torch.train.optim8bit import dequant_signed, dequant_unsigned
from vlaser_tpu_torch.train.model_averaging import (AveragingConfig,
                                                    ModelAveraging)
from vlaser_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint
from vlaser_tpu_torch.utils.convert import from_jax_variables

B, LR, STEPS = 2, 1e-3, 3
KEYS = ("input_ids", "pixel_values", "text_mask", "proprios", "actions", "t",
        "x0")
ULP2 = 2 * 2.0 ** -23


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    S, img = cfg.max_image_text_tokens, cfg.vlm.vision.image_size
    ids = rng.integers(1, 400, (B, S)).astype(np.int32)
    ids[:, 2] = cfg.vlm.img_context_token_id
    mask = np.ones((B, S), np.int32)
    mask[0, -3:] = 0
    ids[mask == 0] = 0
    A = (B, cfg.num_action_tokens, cfg.action_dim)
    return dict(
        input_ids=ids, text_mask=mask,
        pixel_values=rng.standard_normal((B, img, img, 3)).astype(np.float32),
        proprios=rng.standard_normal(
            (B, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32),
        actions=rng.uniform(-1, 1, A).astype(np.float32),
        t=rng.uniform(0, 1, B).astype(np.float32),
        x0=rng.standard_normal(A).astype(np.float32))


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_vla(max_image_text_tokens=16)
    jmodel = PiZeroVLA(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    batches = [_batch(cfg, s) for s in range(STEPS)]
    jb = tuple(jnp.asarray(batches[0][k]) for k in KEYS)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *jb))
    rng = np.random.default_rng(1)

    def draw(path, s):  # norm scales 1 + N(0, 0.1^2), the rest N(0, 0.1^2)
        w = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return jnp.asarray(w + 1.0 if path[-1].key == "weight" else w)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, batches=batches,
                state=from_jax_variables(
                    jax.tree_util.tree_map(np.asarray, variables)))


def _port(setup):
    model = TorchVLA(setup["cfg"], compute_dtype=torch.float32, device="cpu")
    return load_state(model, setup["state"])


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _fixed_t_x0_loss(model, sampling, generator=None):
    """The flow loss on the batch's own t and x0 (both packages draw them
    from their own generators)."""
    return lambda b: model(*(b[k] for k in KEYS))


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# -- metrics and averaging ----------------------------------------------------

def test_action_metrics_match_jax():
    rng = np.random.default_rng(0)
    gt = rng.uniform(-1, 1, (8, 4, 7)).astype(np.float32)
    pred = (gt + rng.normal(0, 0.08, gt.shape)).astype(np.float32)
    pred[0] = gt[0]  # every dimension within any threshold
    th = (0.05, 0.1, 0.2)
    want = np.asarray(j_acc(jnp.asarray(gt), jnp.asarray(pred), th))
    got = action_accuracy(torch.from_numpy(gt), torch.from_numpy(pred), th)
    assert got.dtype == torch.float32 and got.shape == (3,)
    assert np.array_equal(got.numpy(), want)
    assert 0 < want[0] < want[1] < want[2] <= 1
    np.testing.assert_allclose(
        float(action_l1(torch.from_numpy(gt), torch.from_numpy(pred))),
        float(j_l1(jnp.asarray(gt), jnp.asarray(pred))), rtol=ULP2)


@pytest.mark.parametrize("mode", ["ema", "swa"])
def test_averaging_matches_jax(mode):
    """8 steps with start 2 and freq 2: the copy at step 2, updates at 4, 6
    and 8; the copy is storage of its own."""
    rng = np.random.default_rng(2)
    shapes = {"a": (33, 7), "b": (5,)}
    seq = [{k: rng.standard_normal(s).astype(np.float32) for k, s in
            shapes.items()} for _ in range(8)]
    jcfg = JAvgConfig(mode=mode, start=2, freq=2, ema_decay=0.9)
    ja, pa = JAveraging(jcfg), ModelAveraging(AveragingConfig(
        **dataclasses.asdict(jcfg)))
    live = {k: torch.zeros(s) for k, s in shapes.items()}
    for step, p in enumerate(seq, 1):
        ja.update(step, {k: jnp.asarray(v) for k, v in p.items()})
        for k, v in p.items():
            live[k].copy_(torch.from_numpy(v))  # updated in place
        pa.update(step, live)
        if step == 1:
            assert pa.avg_params is None
            assert pa.params_for_eval(live) is live
    assert pa.n_averaged == ja.n_averaged == 4
    for k, v in pa.avg_params.items():
        assert v.data_ptr() != live[k].data_ptr()
        want = np.asarray(ja.avg_params[k])
        np.testing.assert_allclose(v.numpy(), want, rtol=ULP2,
                                   atol=ULP2 * np.abs(want).max())
    st = pa.state_dict()
    pb = ModelAveraging(pa.cfg)
    pb.load_state_dict(st)
    assert pb.n_averaged == 4 and pb.params_for_eval(live) is st["avg_params"]


def test_averaging_off_by_default():
    cfg = ptrainer.VLATrainConfig()
    assert cfg.averaging == AveragingConfig() and cfg.averaging.mode is None
    assert jtrainer.VLATrainConfig().averaging.mode is None


# -- the 8-bit trainer against JAX's -------------------------------------------

def _jax_moments(opt_state):
    """{port name: Adam8bitLeaf or (m, v)} over both groups."""
    out = {}
    for group in ("action", "vlm"):
        adam = opt_state.inner_states[group].inner_state[1][0]
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                adam.moments, is_leaf=lambda x: isinstance(x, tuple))[0]:
            if isinstance(leaf, Adam8bitLeaf) or len(leaf) == 2:
                name = ".".join(str(getattr(k, "key", k)) for k in path)
                out[name.removeprefix("params.")] = jax.tree_util.tree_map(np.asarray, leaf)
    return out


@pytest.fixture(scope="module")
def jax_run(setup, tmp_path_factory):
    """JAX's VLATrainer, optimizer_8bit, 3 steps on fixed t and x0."""
    path = str(tmp_path_factory.mktemp("jax") / "metrics.jsonl")
    orig = jtrainer.make_flow_loss, jtrainer.shard_train_state
    jtrainer.make_flow_loss = lambda model, sampling: (
        lambda p, b, r: model.apply(p, *(b[k] for k in KEYS)))
    # one device: nothing to shard. The JAX shard_train_state raises on the
    # 8-bit state, whose small leaves' (m, v) is one zeros array twice,
    # which the donating step refuses: every leaf gets a buffer of its own
    # (ROADMAP queue 3)
    jtrainer.shard_train_state = lambda state, mesh: (
        jax.tree_util.tree_map(jnp.copy, state), None)
    try:
        jcfg = jtrainer.VLATrainConfig(
            lr_action=LR, lr_vlm=LR, warmup_steps=0, optimizer_8bit=True,
            log_every=1, metrics_path=path)
        tr = jtrainer.VLATrainer(
            setup["jmodel"], jax.tree_util.tree_map(jnp.copy,
                                                    setup["variables"]),
            jcfg, mesh=mesh_lib.make_mesh(devices=jax.devices()[:1]))
        state = tr.train_steps(iter(copy.deepcopy(setup["batches"])), STEPS)
    finally:
        jtrainer.make_flow_loss, jtrainer.shard_train_state = orig
    return dict(metrics=_metrics(path), params=from_jax_variables(
        jax.tree_util.tree_map(np.asarray, state.params)),
        moments=_jax_moments(state.opt_state), trainer=tr)


def _port_trainer(setup, monkeypatch, **kw):
    monkeypatch.setattr(ptrainer, "make_flow_loss", _fixed_t_x0_loss)
    return ptrainer.VLATrainer(_port(setup), ptrainer.VLATrainConfig(
        lr_action=LR, lr_vlm=LR, warmup_steps=0, optimizer_8bit=True, **kw))


def test_three_8bit_steps_match_jax(setup, jax_run, monkeypatch, tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    trainer = _port_trainer(setup, monkeypatch, log_every=1,
                            metrics_path=path)
    from vlaser_tpu_torch.train.optim8bit import AdamW8bit

    assert isinstance(trainer.step_fn.optimizer, AdamW8bit)
    hwio = trainer.step_fn.optimizer.hwio
    named = dict(trainer.model.named_parameters())
    assert hwio == {id(named["vision_model.embeddings.patch_embedding"
                            ".weight"])}
    trainer.train_steps(iter(setup["batches"]), STEPS)  # numpy batches
    got, want = _metrics(path), jax_run["metrics"]
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2, 3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
    n_off = n_all = n_codes = n_code_off = n8 = 0
    start = setup["state"]
    opt = trainer.step_fn.optimizer
    for name, p in named.items():
        w = jax_run["params"][name].numpy()
        assert not np.array_equal(w, start[name].numpy()), name
        diff = np.abs(p.detach().numpy() - w)
        assert diff.max() <= 3 * 2 * LR, name
        n_off += int((diff > 1e-6).sum())
        n_all += diff.size
        st, jst = opt.state[p], jax_run["moments"][name.replace(
            "patch_embedding.weight", "patch_embedding.kernel")]
        assert float(st["step"]) == STEPS
        if isinstance(jst, Adam8bitLeaf):
            n8 += 1
            for key, dec in (("m", dequant_signed), ("v", dequant_unsigned)):
                a, b = st[key + "_q"], _t(getattr(jst, key + "_q"))
                off = (a != b).numpy()
                n_code_off += int(off.sum())
                n_codes += off.size
                sa, sb = st[key + "_scale"], _t(getattr(jst, key + "_scale"))
                np.testing.assert_allclose(sa.numpy(), sb.numpy(), rtol=1e-4)
                da, db = dec(a, sa, a.shape), dec(b, sb, b.shape)
                r = (da - db).abs() / torch.maximum(sa, sb)
                assert (r <= 1 / 31).all(), (name, key)
        else:
            assert "m" in st and st["m"].numel() < 4096
    assert n8 >= 8
    assert n_off <= 1e-3 * n_all, (n_off, n_all)
    assert n_code_off <= 1e-3 * n_codes, (n_code_off, n_codes)


def test_evaluate_matches_jax_eval_fn(setup, jax_run, monkeypatch):
    """The inner function on the trained parameters and the same numpy
    noise: actions at fp32 tolerance; the port's metrics on JAX's actions
    equal to JAX's."""
    trainer = _port_trainer(setup, monkeypatch)
    jtr = jax_run["trainer"]
    params = {k: v.clone() for k, v in jax_run["params"].items()}
    batch = setup["batches"][1]
    cfg = setup["cfg"]
    noise = np.random.default_rng(9).standard_normal(
        (B, cfg.num_action_tokens, cfg.action_dim)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jtr.state.params
    j_actions = np.asarray(setup["jmodel"].apply(
        jparams, *(jbatch[k] for k in ("input_ids", "pixel_values",
                                       "text_mask", "proprios")),
        jnp.asarray(noise), method=setup["jmodel"].infer_action))
    j_accs, j_l1v = jtr._eval_fn(jparams, jbatch, jnp.asarray(noise))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    actions = trainer.eval_actions(params, tb, torch.from_numpy(noise))
    assert actions.shape == (B, cfg.horizon_steps, cfg.action_dim)
    np.testing.assert_allclose(actions.numpy(), j_actions, rtol=0, atol=1e-5)
    # the live parameters are untouched by an evaluation under others
    assert torch.equal(dict(trainer.model.named_parameters())[
        "action_decoder.kernel"], setup["state"]["action_decoder.kernel"])
    gt = tb["actions"][:, -cfg.horizon_steps:]
    accs = action_accuracy(gt, torch.from_numpy(j_actions),
                           trainer.cfg.eval_thresholds)
    assert np.array_equal(accs.numpy(), np.asarray(j_accs))
    np.testing.assert_allclose(float(action_l1(gt, torch.from_numpy(
        j_actions))), float(j_l1v), rtol=ULP2)
    out = trainer.evaluate(batch)
    assert sorted(out) == ["action_accuracy", "l1"]
    assert out["action_accuracy"].shape == (2,) and np.isfinite(out["l1"])
    again = trainer.evaluate(batch)  # noise from a generator seeded 42
    assert np.array_equal(out["action_accuracy"], again["action_accuracy"])
    assert out["l1"] == again["l1"]


def test_evaluate_runs_under_the_ema(setup, monkeypatch):
    trainer = _port_trainer(setup, monkeypatch, averaging=AveragingConfig(
        "ema", start=0, ema_decay=0.5))
    trainer.train_steps(iter(setup["batches"]), 2)
    avg = trainer.averaging.avg_params
    live = trainer.params()
    assert trainer.averaging.n_averaged == 2
    assert not torch.equal(avg["action_decoder.kernel"],
                           live["action_decoder.kernel"])
    batch = {k: torch.from_numpy(v) for k, v in setup["batches"][0].items()}
    noise = torch.randn(B, setup["cfg"].num_action_tokens,
                        setup["cfg"].action_dim,
                        generator=torch.Generator().manual_seed(42))
    want = trainer.eval_fn(avg, batch, noise)
    got = trainer.evaluate(setup["batches"][0])
    assert np.array_equal(got["action_accuracy"], want[0].numpy())
    assert got["l1"] == float(want[1])
    other = trainer.eval_fn(live, batch, noise)
    assert float(other[1]) != float(want[1])


# -- checkpoints, the metrics log and the per-call step count -----------------

def test_checkpoint_round_trip_is_bit_exact(setup, monkeypatch, tmp_path):
    ck = str(tmp_path / "ck")
    trainer = _port_trainer(setup, monkeypatch, checkpoint_dir=ck,
                            save_every=3)
    trainer.train_steps(iter(setup["batches"]), STEPS)
    assert latest_step(ck) == 3
    fresh = _port_trainer(setup, monkeypatch)
    restore_checkpoint(ck, fresh.model, fresh.step_fn)
    assert fresh.step == trainer.step == STEPS
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    a = dict(trainer.model.named_parameters())
    b = dict(fresh.model.named_parameters())
    for n in a:
        assert torch.equal(a[n], b[n]), n
    sa, sb = trainer.step_fn.optimizer.state, fresh.step_fn.optimizer.state
    n_codes = 0
    for p, st in sa.items():
        other = sb[b[names[id(p)]]]
        assert sorted(st) == sorted(other), names[id(p)]
        for k, v in st.items():
            assert v.dtype == other[k].dtype, (names[id(p)], k)
            assert torch.equal(v, other[k]), (names[id(p)], k)
            n_codes += v.dtype == torch.uint8
    assert n_codes >= 16
    # the restored trainer steps on exactly as the live one
    batch = setup["batches"][0]
    ma = trainer.train_steps(iter([batch]), 1)
    mb = fresh.train_steps(iter([batch]), 1)
    assert torch.equal(ma["loss"], mb["loss"])
    for n in a:
        assert torch.equal(a[n], b[n]), n


def test_train_steps_counts_from_one_in_every_call(setup, monkeypatch,
                                                   tmp_path):
    """The JAX trainer's `step = i + 1`: each call logs and saves by its own
    count, while the optimizer's counter (the schedule's) runs on."""
    ck, path = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    trainer = _port_trainer(setup, monkeypatch, checkpoint_dir=ck,
                            save_every=2, log_every=1, metrics_path=path)
    for _ in range(2):
        trainer.train_steps(iter(setup["batches"]), 2)
    assert [m["step"] for m in _metrics(path)] == [1, 2, 1, 2]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in _metrics(path))
    assert trainer.step == 4
    assert latest_step(ck) == 2  # the second call overwrote step 2
    fresh = _port_trainer(setup, monkeypatch)
    restore_checkpoint(ck, fresh.model, fresh.step_fn)
    assert fresh.step == 4
