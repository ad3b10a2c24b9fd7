"""The port's flow-matching train step (vlaser_tpu_torch) against the JAX
package on tiny_vla, same numpy-drawn weights, batch, t and x0, fp32
compute on both sides (attention and RMSNorm on their reference routes,
as both packages dispatch them on the CPU).

Tolerances: loss rtol 1e-5 (fp32, summation order only); gradients
atol 1e-5 x max|grad| of the leaf plus 1e-7; parameters after two AdamW
steps at lr 1e-3: atol 1e-6 on all but 0.1% of the elements, and at most
two whole steps (4e-3) on those. Adam divides by |g| + 1e-8, so where a
gradient sits at its leaf's fp32 noise floor the normalised step is set by
the noise."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vlaser_tpu.core.config import tiny_vla
from vlaser_tpu.policy.pizero import PiZeroVLA
from vlaser_tpu.train import train_step as jts
from vlaser_tpu.train.optim import cosine_warmup_restarts as j_sched
from vlaser_tpu.train.trainer import VLATrainConfig as JConfig
from vlaser_tpu.train.trainer import _vla_param_groups as j_groups
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.policy.flow import sample_fm_time
from vlaser_tpu_torch.policy.pizero import PiZeroVLA as TorchVLA
from vlaser_tpu_torch.train.optim import cosine_warmup_restarts
from vlaser_tpu_torch.train.train_step import make_train_step
from vlaser_tpu_torch.train.trainer import (VLATrainConfig, VLATrainer,
                                            _vla_param_groups)
from vlaser_tpu_torch.utils.convert import from_jax_variables

B = 2
LR = 1e-3
KEYS = ("input_ids", "pixel_values", "text_mask", "proprios", "actions", "t",
        "x0")


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    S, img = cfg.max_image_text_tokens, cfg.vlm.vision.image_size
    ids = rng.integers(1, 400, (B, S)).astype(np.int32)
    ids[:, 2] = cfg.vlm.img_context_token_id
    mask = np.ones((B, S), np.int32)
    mask[0, -3:] = 0  # a padded prompt tail
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
    batch = _batch(cfg)
    jb = tuple(jnp.asarray(batch[k]) for k in KEYS)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *jb))
    rng = np.random.default_rng(1)

    def draw(path, s):  # norm scales 1 + N(0, 0.1^2), the rest N(0, 0.1^2)
        w = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return jnp.asarray(w + 1.0 if path[-1].key == "weight" else w)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, batch=batch,
                jb=jb, state=from_jax_variables(
                    jax.tree_util.tree_map(np.asarray, variables)))


@pytest.fixture(scope="module")
def jax_loss_grads(setup):
    """The JAX loss and its gradient per parameter, in the port's names
    and layouts (one value_and_grad for both tests)."""
    jmodel, variables, jb = setup["jmodel"], setup["variables"], setup["jb"]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, *jb)))(variables["params"])
    return float(loss), from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, grads)})


def _port(setup, **kw):
    model = TorchVLA(setup["cfg"], compute_dtype=torch.float32,
                     device="cpu", **kw)
    return load_state(model, setup["state"])


def _tb(batch):
    return {k: torch.from_numpy(batch[k]) for k in KEYS}


def _loss(model, tb):
    return model(*(tb[k] for k in KEYS))


def test_loss_matches_jax(setup, jax_loss_grads):
    want = jax_loss_grads[0]
    got = _loss(_port(setup), _tb(setup["batch"]))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_every_gradient_matches_jax_grad(setup, jax_loss_grads):
    want = jax_loss_grads[1]
    model = _port(setup)
    _loss(model, _tb(setup["batch"])).backward()
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].grad
        w = w.numpy()
        if g is None:  # a leaf the loss never reaches (the final vlm norm)
            assert not w.any(), name
            continue
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max() + 1e-7,
                                   err_msg=name)


def test_two_trainer_steps_match_jax(setup):
    """Two steps of the two-group AdamW step (each group clipped by its
    own norm), warmup 0 and lr 1e-3 so the update shows, fixed t and x0."""
    jmodel, variables, jb = setup["jmodel"], setup["variables"], setup["jb"]
    jcfg = JConfig(lr_action=LR, lr_vlm=LR, warmup_steps=0)
    mk = lambda: optax.chain(
        optax.clip_by_global_norm(jcfg.grad_clip),
        optax.adamw(j_sched(LR, jcfg.first_cycle_steps, warmup_steps=0),
                    weight_decay=jcfg.weight_decay))
    # the optimizer VLATrainer builds (trainer.py), without its mesh
    tx = optax.multi_transform(
        {"action": mk(), "vlm": mk(), "frozen": optax.set_to_zero()},
        j_groups(variables, True))
    jstep = jts.make_train_step(
        lambda p, b, r: jmodel.apply(p, *b), tx, donate=False)
    jstate = jts.TrainState(variables, tx.init(variables), jnp.zeros(()))
    jlosses, jnorms = [], []
    for _ in range(2):
        jstate, m = jstep(jstate, jb, jax.random.PRNGKey(0))
        jlosses.append(float(m["loss"]))
        jnorms.append(float(m["grad_norm"]))

    model = _port(setup)
    trainer = VLATrainer(model, VLATrainConfig(lr_action=LR, lr_vlm=LR,
                                               warmup_steps=0))
    assert sorted(trainer.groups) == ["action", "vlm"]
    tb = _tb(setup["batch"])
    step = make_train_step(lambda b: _loss(model, b), trainer.groups)
    for i in range(2):
        m = step(tb)
        np.testing.assert_allclose(m["loss"].item(), jlosses[i], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), jnorms[i],
                                   rtol=1e-4)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params))
    start = setup["state"]
    n_off = n_all = 0
    for name, p in model.named_parameters():
        w = want[name].numpy()
        assert not np.array_equal(w, start[name].numpy()), name
        diff = np.abs(p.detach().numpy() - w)
        # an element whose gradient sits at the leaf's fp32 noise floor
        # (|g| ~ 1e-8, near Adam's eps) has its normalised step g/(|g|+eps)
        # set by that noise: it may differ by up to the whole step, 2 x lr
        assert diff.max() <= 2 * 2 * LR, name
        n_off += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_train_vlm_false_leaves_the_vlm_bit_unchanged(setup):
    model = _port(setup)
    trainer = VLATrainer(model, VLATrainConfig(lr_action=LR, warmup_steps=0,
                                               train_vlm=False))
    labels = _vla_param_groups(model, train_vlm=False)
    assert labels["joint.layers.expert.q_proj.kernel"] == "action"
    assert labels["joint.expert_norm.weight"] == "action"
    assert labels["vision_model.encoder.attn.qkv.kernel"] == "frozen"
    assert labels["joint.layers.vlm.q_proj.kernel"] == "frozen"
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {k: v for k, v in _tb(setup["batch"]).items()
             if k not in ("t", "x0")}
    m = trainer.train_steps(iter([batch]), 1)
    assert trainer.step == 1 and np.isfinite(m["loss"].item())
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            assert torch.equal(p.detach(), before[name]), name
            assert p.grad is None, name
        else:
            assert not torch.equal(p.detach(), before[name]), name


def test_remat_equals_no_remat(setup):
    tb = _tb(setup["batch"])
    out = {}
    for remat in (False, True):
        model = _port(setup, remat=remat)
        loss = _loss(model, tb)
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad for n, p in
                                      model.named_parameters()})
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for name, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][name], g, rtol=1e-6,
                                   atol=1e-9, msg=name)


def test_loss_falls_over_five_steps(setup):
    model = _port(setup)
    trainer = VLATrainer(model, VLATrainConfig(lr_action=LR, lr_vlm=LR,
                                               warmup_steps=0))
    tb = _tb(setup["batch"])
    step = make_train_step(lambda b: _loss(model, b), trainer.groups)
    losses = [step(tb)["loss"].item() for _ in range(5)]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.9 * losses[0], losses


def test_schedule_matches_jax():
    kw = dict(first_cycle_steps=100, warmup_steps=10, min_lr=1e-6)
    for mult in (1.0, 2.0):
        got = cosine_warmup_restarts(1e-3, cycle_mult=mult, **kw)
        want = j_sched(1e-3, cycle_mult=mult, **kw)
        for s in (0, 5, 10, 50, 99, 100, 105, 150, 400):
            np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-5,
                                       err_msg=f"step {s} mult {mult}")


def test_flow_time_sampler_statistics():
    """Beta(1.5, 1) through z = u^(1/alpha): E[t] = t_max (1 - 0.6); the
    stratified uniform variant covers [0, 1) evenly; Beta(1.5, 2) through
    two gamma draws: E[t] = t_max (1 - 1.5 / 3.5); a beta <= 0 raises."""
    g = torch.Generator().manual_seed(0)
    t = sample_fm_time(g, 20000, "beta", 1.5, 1.0, 0.999).numpy()
    assert t.min() >= 0.0 and t.max() <= 0.999
    np.testing.assert_allclose(t.mean(), 0.999 * (1 - 1.5 / 2.5), atol=0.01)
    u = sample_fm_time(g, 1000, "uniform").numpy()
    assert u.min() >= 0 and u.max() < 1
    np.testing.assert_allclose(u.mean(), 0.5, atol=0.02)
    t2 = sample_fm_time(g, 20000, "beta", 1.5, 2.0, 0.999).numpy()
    np.testing.assert_allclose(t2.mean(), 0.999 * (1 - 1.5 / 3.5), atol=0.01)
    with pytest.raises(ValueError):
        sample_fm_time(g, 4, "beta", 1.5, -1.0)
