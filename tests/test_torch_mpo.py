"""The port's MPO (vlaser_tpu_torch/train/mpo.py) against the JAX package
on the CPU: the loss terms against tests/test_mpo_golden.py's torch
oracles of trl's formulas and against vlaser_tpu.train.mpo (rtol 1e-6);
the MPO loss and its gradients at tiny_vlm, fp32 compute, the same weights
(JAX's init, carried across by utils/convert) and batches (loss and
metrics rtol 1e-5, the rewards atol 2e-5; gradients atol 1e-5 x
max|grad| + 1e-7, as test_torch_sft.py holds them); three MPOTrainer
steps against JAX's (the losses rtol 1e-5; the metrics and grad_norm
within test_torch_sft.py's trainer bounds, 2e-3 and 5e-3 relative; the
reward accuracy where the margins are not a tie; the ViT bit for bit
unchanged);
and the reference copy, which shares no storage with the live parameters
and stays bit for bit the initial parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_mpo_golden import (_torch_bco_pair, _torch_dpo_sigmoid,
                             _torch_get_batch_logps)

import vlaser_tpu.train.mpo as jmpo
from vlaser_tpu.core import mesh as mesh_lib
from vlaser_tpu.core.config import tiny_vlm
from vlaser_tpu.core.distributed import put_global_batch
from vlaser_tpu.models.vlm import InternVLChatModel as JVLM
from vlaser_tpu.train.trainer import TrainConfig as JConfig
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.models.vlm import InternVLChatModel
from vlaser_tpu_torch.train import mpo
from vlaser_tpu_torch.train.trainer import TrainConfig
from vlaser_tpu_torch.utils.convert import from_jax_variables

LR = 1e-3
N = 36


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lps(seed, b=4):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, generator=g) * 20 - 40 for _ in range(4)]


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_dpo_sigmoid_matches_trl_and_jax(label_smoothing):
    lp = _lps(0)
    got = mpo.dpo_sigmoid_loss(*lp, 0.1, label_smoothing)
    np.testing.assert_allclose(
        got.item(), _torch_dpo_sigmoid(*lp, 0.1, label_smoothing).item(),
        rtol=1e-6)
    np.testing.assert_allclose(got.item(), float(jmpo.dpo_sigmoid_loss(
        *[jnp.asarray(x.numpy()) for x in lp], 0.1, label_smoothing)),
        rtol=1e-6)


def test_bco_pair_matches_trl_and_jax():
    lp = _lps(1)
    delta = torch.tensor(0.37)
    got, rewards = mpo.bco_pair_loss(*lp, 0.1, delta)
    np.testing.assert_allclose(
        got.item(), _torch_bco_pair(*lp, 0.1, delta).item(), rtol=1e-6)
    want, wr = jmpo.bco_pair_loss(*[jnp.asarray(x.numpy()) for x in lp],
                                  0.1, jnp.float32(0.37))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(rewards.numpy(), np.asarray(wr), rtol=1e-6)


@pytest.mark.parametrize("average", [False, True])
def test_sequence_logprobs_matches_get_batch_logps_and_jax(average):
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(3, 9, 11, generator=g) * 3
    labels = torch.randint(0, 11, (3, 9), generator=g)
    labels[:, :3] = mpo.IGNORE_TOKEN_ID
    labels[1, 5:] = mpo.IGNORE_TOKEN_ID
    got = mpo.sequence_logprobs(logits, labels, average)
    np.testing.assert_allclose(
        got.numpy(), _torch_get_batch_logps(logits, labels, average).numpy(),
        rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jmpo.sequence_logprobs(
        jnp.asarray(logits.numpy()), jnp.asarray(labels.numpy()), average)),
        rtol=1e-6)


def test_running_moments_matches_jax():
    a, b = mpo.RunningMoments(), jmpo.RunningMoments()
    rng = np.random.default_rng(3)
    for _ in range(4):
        v = rng.standard_normal(6).astype(np.float32)
        assert a.update(v) == b.update(v)
    assert a.count == b.count


def _pair_batch(cfg, seed, b=1):
    """preference_collate's layout: chosen / rejected ids, labels (the
    prompt -100) and seg ids (1, a 0-padded tail), one tile a pair."""
    rng = np.random.default_rng(seed)
    img = cfg.vision.image_size
    out = {}
    prompt = rng.integers(1, 400, (b, 12))
    prompt[:, 1:1 + cfg.num_image_token] = cfg.img_context_token_id
    for side, n in (("chosen", N), ("rejected", N - 7)):
        ids = np.full((b, N), cfg.pad_token_id, np.int64)
        ids[:, :n] = rng.integers(1, 400, (b, n))
        ids[:, :12] = prompt
        labels = np.where(np.arange(N) < n, ids, -100)
        labels[:, :12] = -100
        seg = (np.arange(N) < n).astype(np.int32)[None].repeat(b, 0)
        out.update({f"{side}_input_ids": ids, f"{side}_labels": labels,
                    f"{side}_seg_ids": seg})
    out["pixel_values"] = rng.standard_normal((b, img, img, 3)).astype(
        np.float32)
    out["image_flags"] = np.ones((b,), np.int32)
    return out


def _setup():
    cfg = tiny_vlm()
    jmodel = JVLM(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    batch = _pair_batch(cfg, 0)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.asarray(batch["chosen_input_ids"]),
                            jnp.asarray(batch["pixel_values"]),
                            jnp.asarray(batch["image_flags"]))
    return cfg, jmodel, variables


def _port(cfg, variables):
    model = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu",
                              attn_impl="reference")
    return load_state(model, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))


def test_mpo_loss_and_gradients_match_jax():
    """One loss + backward with the reference parameters nudged away from
    the policy's (so the DPO and BCO terms are off their symmetric point)
    and a nonzero delta."""
    cfg, jmodel, variables = _setup()
    batch = _pair_batch(cfg, 1, b=2)
    g = np.random.default_rng(4)
    ref_vars = jax.tree_util.tree_map(
        lambda x: x + 0.01 * g.standard_normal(x.shape).astype(x.dtype),
        variables)
    jl = jmpo.make_mpo_loss(jmodel, jmpo.MPOConfig())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, wm), wg = jax.value_and_grad(
        lambda p: jl(p, ref_vars, jb, jnp.float32(0.05)), has_aux=True)(
        variables)
    model = _port(cfg, variables)
    ref = from_jax_variables(jax.tree_util.tree_map(np.asarray, ref_vars))
    loss, m = mpo.make_mpo_loss(model, mpo.MPOConfig())(
        ref, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.tensor(0.05))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for k in ("dpo_loss", "bco_loss", "sft_loss", "reward_accuracy"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(wm[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("reward_margin", "rewards"):  # beta x differences of fp32
        # log-prob sums near -150, summed in another order
        np.testing.assert_allclose(m[k].numpy(), np.asarray(wm[k]), rtol=0,
                                   atol=2e-5, err_msg=k)
    want_g = from_jax_variables(jax.tree_util.tree_map(np.asarray, wg))
    for name, p in model.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max() + 1e-7,
                                   err_msg=name)


def test_three_mpo_trainer_steps_match_jax():
    cfg, jmodel, variables = _setup()
    batches = [_pair_batch(cfg, 10 + i, b=2) for i in range(3)]
    mesh = mesh_lib.make_mesh(devices=jax.devices()[:1])
    jt = jmpo.MPOTrainer(jmodel, jax.tree_util.tree_map(jnp.array, variables),
                         jmpo.MPOConfig(),
                         JConfig(learning_rate=LR, total_steps=3), mesh=mesh)
    rng, jm = jax.random.PRNGKey(0), []
    for batch in batches:  # MPOTrainer.train's loop, its metrics kept
        rng, sub = jax.random.split(rng)
        delta = jnp.asarray(jt.running.mean, jnp.float32)
        jt.state, m = jt._step(jt.state, jt.ref_params,
                               put_global_batch(batch, jt.mesh), delta, sub)
        jt.running.update(np.asarray(m.pop("rewards")))
        jm.append({k: float(v) for k, v in m.items()})
    model = _port(cfg, variables)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    pt = mpo.MPOTrainer(model, mpo.MPOConfig(),
                        TrainConfig(learning_rate=LR, total_steps=3))
    pm = [{k: v.item() for k, v in pt.train(iter([b]), 1).items()}
          for b in batches]
    assert pt.step == 3
    np.testing.assert_allclose(pt.running.mean, jt.running.mean, rtol=2e-3)
    for p, j in zip(pm, jm):
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-5)
        for k in ("dpo_loss", "bco_loss", "sft_loss", "reward_margin"):
            np.testing.assert_allclose(p[k], j[k], rtol=2e-3, atol=1e-6,
                                       err_msg=k)
        if abs(j["reward_margin"]) > 1e-5:  # else a tie: the policy is the
            # reference (warmup's lr 0 at step 0), its margins rounding noise
            assert p["reward_accuracy"] == j["reward_accuracy"]
        np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=5e-3)
    assert abs(jm[2]["reward_margin"]) > 1e-3  # the policy moved
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                     jt.state.params))
    for name, p in model.named_parameters():
        if name.startswith("vision_model."):  # frozen: bit for bit
            assert torch.equal(p.detach(), before[name]), name
        else:
            assert np.abs(p.detach().numpy() - want[name].numpy()).max() \
                <= 2 * 3 * LR, name
    # the reference: its own storage, still the initial parameters
    live = {p.untyped_storage().data_ptr() for p in model.parameters()}
    assert not live & {t.untyped_storage().data_ptr()
                       for t in pt.ref_params.values()}
    assert sorted(pt.ref_params) == sorted(before)
    for n, t in pt.ref_params.items():
        assert t.dtype == before[n].dtype and torch.equal(t, before[n]), n
    # control: a reference that aliases the live parameters has moved
    alias = dict(model.named_parameters())
    assert not all(torch.equal(alias[n].detach(), before[n]) for n in alias)
