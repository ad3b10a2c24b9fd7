"""The port's SFT train step (vlaser_tpu_torch: train/losses.py,
train/optim.py, train/train_step.py, train/trainer.SFTTrainer, Qwen2 and
ViT remat) against the JAX package on the CPU at tiny_vlm, fp32 compute,
attention and RMSNorm on their reference routes (as both packages route
them on the CPU), the same weights (JAX's init, carried across by
utils/convert) and the same packed batches (PackedDataset._emit's layout:
contiguous segments whose positions restart at 0, a segment-0 padding tail
labelled -100, one tile a segment).

Tolerances: the chunked CE against the full CE in the port, rtol 1e-6 on
the value and rtol 2e-5 / atol 2e-6 on every gradient (as
tests/test_trainer.py::test_chunked_ce_matches_full); the port against
JAX, rtol 1e-5 on the loss and atol 1e-5 x max|grad| + 1e-7 on the
gradients (fp32 sums in another order through two frameworks); trainer
steps: losses within 2e-3 and grad norms within 5e-3 relative, the ViT bit
for bit unchanged, the trained parameters within 1e-6 but for 0.1% of the
elements (Adam's g / (|g| + eps) is noise-set where g sits at the fp32
floor), which stay within twice the summed learning rates."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core import mesh as mesh_lib
from vlaser_tpu.core.config import tiny_vlm
from vlaser_tpu.models.vlm import InternVLChatModel as JVLM
from vlaser_tpu.train.losses import make_sft_loss as j_full
from vlaser_tpu.train.losses import make_sft_loss_chunked as j_chunked
from vlaser_tpu.train.optim import _label_params as j_labels
from vlaser_tpu.train.optim import warmup_cosine as j_warmup_cosine
from vlaser_tpu.train.trainer import SFTTrainer as JTrainer
from vlaser_tpu.train.trainer import TrainConfig as JConfig
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.models.vlm import InternVLChatModel
from vlaser_tpu_torch.train.losses import (IGNORE_TOKEN_ID,
                                           make_sft_loss,
                                           make_sft_loss_chunked,
                                           weighted_ce_loss)
from vlaser_tpu_torch.train.optim import label_params, warmup_cosine
from vlaser_tpu_torch.train.trainer import SFTTrainer, TrainConfig
from vlaser_tpu_torch.utils.convert import _PATCH, from_jax_variables

N = 48  # packed tokens a batch
LR = 1e-3


def _packed(cfg, seed, lengths=(21, 17)):
    """One packed batch as PackedDataset._emit lays it out: B 1 x N,
    segments of `lengths` (each with one tile's image tokens after its
    first token), positions restarting at 0, the tail segment 0 with pad
    ids and labels -100."""
    rng = np.random.default_rng(seed)
    img = cfg.vision.image_size
    ids = np.full((N,), cfg.pad_token_id, np.int32)
    labels = np.full((N,), IGNORE_TOKEN_ID, np.int32)
    weights = np.zeros((N,), np.float32)
    seg = np.zeros((N,), np.int32)
    pos = np.zeros((N,), np.int32)
    ofs = 0
    for k, n in enumerate(lengths):
        s_ids = rng.integers(1, 400, n).astype(np.int32)
        s_ids[1:1 + cfg.num_image_token] = cfg.img_context_token_id
        s_lab = s_ids.copy()
        s_lab[:1 + cfg.num_image_token + 2] = IGNORE_TOKEN_ID  # the prompt
        ids[ofs:ofs + n], labels[ofs:ofs + n] = s_ids, s_lab
        weights[ofs:ofs + n] = rng.uniform(0.5, 1.5)
        seg[ofs:ofs + n], pos[ofs:ofs + n] = k + 1, np.arange(n)
        ofs += n
    return {"input_ids": ids[None], "labels": labels[None],
            "loss_weight": weights[None], "seg_ids": seg[None],
            "positions": pos[None],
            "pixel_values": rng.standard_normal(
                (len(lengths), img, img, 3)).astype(np.float32),
            "image_flags": np.ones((len(lengths),), np.int32)}


def _cfg(tie=False):
    cfg = tiny_vlm()
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, tie_word_embeddings=tie))


def _jax_variables(jmodel, batch):
    return jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"]),
                       jnp.asarray(batch["pixel_values"]),
                       jnp.asarray(batch["image_flags"]))



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny shapes: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(cfg, variables, **kw):
    model = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu",
                              attn_impl="reference", **kw)
    return load_state(model, from_jax_variables(_np(variables)))


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("tie", [False, True])
def test_chunked_ce_matches_full_and_jax(tie):
    cfg = _cfg(tie)
    jmodel = JVLM(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    batch = _packed(cfg, 0)
    variables = _jax_variables(jmodel, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    chunk = 8
    assert (N - 1) % chunk  # rows padded to a multiple of the chunk
    jl, jg = jax.value_and_grad(
        lambda p: j_chunked(jmodel, chunk=chunk)(p, jb, None))(variables)
    want = from_jax_variables(_np(jg))

    model = _port(cfg, variables)
    make_sft_loss(model)(_tb(batch)).backward()
    full = _grads(model)
    model.zero_grad(set_to_none=True)
    lf = make_sft_loss(model)(_tb(batch)).item()
    lc_t = make_sft_loss_chunked(model, chunk=chunk)(_tb(batch))
    lc_t.backward()
    lc, chunked = lc_t.item(), _grads(model)
    np.testing.assert_allclose(lc, lf, rtol=1e-6)
    np.testing.assert_allclose(lc, float(jl), rtol=1e-5)
    assert sorted(chunked) == sorted(full) == sorted(want)
    for name, g in chunked.items():
        np.testing.assert_allclose(g.numpy(), full[name].numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=name)
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max() + 1e-7,
                                   err_msg=name)


def test_weighted_ce_matches_jax_full_loss():
    cfg = _cfg()
    jmodel = JVLM(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    batch = _packed(cfg, 1)
    variables = _jax_variables(jmodel, batch)
    want = float(j_full(jmodel)(variables, {k: jnp.asarray(v) for k, v in
                                            batch.items()}, None))
    got = make_sft_loss(_port(cfg, variables))(_tb(batch))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    # every label ignored: 0, not NaN (the weight sum is clamped)
    logits = torch.randn(1, 5, 7)
    labels = torch.full((1, 5), IGNORE_TOKEN_ID)
    assert weighted_ce_loss(logits, labels).item() == 0.0


def test_remat_equals_no_remat():
    """remat (each ViT and decoder layer under torch.utils.checkpoint)
    recomputes the same activations: the loss and every gradient are bit
    for bit those of the model without it."""
    cfg = _cfg()
    jmodel = JVLM(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    batch = _packed(cfg, 2)
    variables = _jax_variables(jmodel, batch)
    out = []
    for remat in (False, True):
        model = _port(cfg, variables, remat=remat)
        loss = make_sft_loss_chunked(model, chunk=16)(_tb(batch))
        loss.backward()
        out.append((loss.detach(), _grads(model)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1) and sorted(g0) == sorted(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


@pytest.mark.parametrize("max_lr,total,ratio,min_ratio", [
    (2e-5, 1000, 0.03, 0.0), (1e-3, 3, 0.03, 0.0), (1.0, 10, 0.3, 0.1),
    (0.5, 1, 0.5, 0.2)])
def test_warmup_cosine_matches_optax(max_lr, total, ratio, min_ratio):
    want = j_warmup_cosine(max_lr, total, ratio, min_ratio)
    got = warmup_cosine(max_lr, total, ratio, min_ratio)
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-7 * max_lr, err_msg=str(step))


def test_freeze_labels_match_jax():
    cfg = _cfg()
    jmodel = JVLM(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    variables = _jax_variables(jmodel, _packed(cfg, 0))
    model = _port(cfg, variables)
    for pats in ((r"vision_model/",), (r"language_model/",),
                 (r"vision_model/", r"language_model/"), ()):
        want = {}
        for path, lab in jax.tree_util.tree_leaves_with_path(
                j_labels(variables, pats)["params"]):
            name = ".".join(k.key for k in path)
            if name.endswith(_PATCH):  # the conv, "weight" in the port
                name = name[:-len("kernel")] + "weight"
            want[name] = lab == "frozen"
        got = label_params(model, pats)
        assert sorted(got) == sorted(want)
        assert all((got[n] == "frozen") == bool(want[n]) for n in got), pats


def _read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _jax_trainer(cfg, jmodel, variables, batches, tmp_path, name, **kw):
    jcfg = JConfig(learning_rate=LR, total_steps=len(batches), log_every=1,
                   metrics_path=str(tmp_path / f"{name}_jax.jsonl"), **kw)
    mesh = mesh_lib.make_mesh(devices=jax.devices()[:1])
    # the JAX step donates its state: it takes copies
    trainer = JTrainer(jmodel, jax.tree_util.tree_map(jnp.array, variables),
                       jcfg, mesh=mesh)
    state = trainer.train(iter(batches))
    return _read_metrics(jcfg.metrics_path), from_jax_variables(
        _np(state.params))


def _port_trainer(cfg, variables, batches, tmp_path, name, **kw):
    model = _port(cfg, variables, remat=True)
    tcfg = TrainConfig(learning_rate=LR, total_steps=len(batches),
                       log_every=1,
                       metrics_path=str(tmp_path / f"{name}_port.jsonl"), **kw)
    trainer = SFTTrainer(model, tcfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m = trainer.train(iter(batches))
    assert trainer.step == len(batches) and np.isfinite(m["loss"].item())
    return _read_metrics(tcfg.metrics_path), model, before


def _hold_to_jax(jm, want, pm, model, before, lrs):
    assert [r["step"] for r in pm] == [r["step"] for r in jm]
    for p, j in zip(pm, jm):
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=2e-3)
        np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=5e-3)
    n_off = n_all = 0
    for name, p in model.named_parameters():
        w, p = want[name].numpy(), p.detach()
        if name.startswith("vision_model."):  # frozen: bit for bit
            assert torch.equal(p, before[name]), name
            assert np.array_equal(w, before[name].numpy()), name
            continue
        diff = np.abs(p.numpy() - w)
        assert diff.max() <= 2 * sum(lrs), name
        n_off += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_three_sft_trainer_steps_match_jax(tmp_path):
    """3 SFTTrainer steps (TrainConfig defaults but lr 1e-3: the ViT
    frozen, clip 1.0, warmup_cosine) on packed batches against the JAX
    SFTTrainer: losses, grad norms (the frozen ViT's gradients included),
    the ViT unchanged, the trained parameters close."""
    cfg = _cfg()
    jmodel = JVLM(cfg, compute_dtype=jnp.float32, attn_impl="reference",
                  remat=True)
    batches = [_packed(cfg, 10 + i, lengths) for i, lengths in
               enumerate(((21, 17), (30, 9), (12, 14, 15)))]
    variables = _jax_variables(jmodel, batches[0])
    jm, want = _jax_trainer(cfg, jmodel, variables, batches, tmp_path, "sft")
    pm, model, before = _port_trainer(cfg, variables, batches, tmp_path,
                                      "sft")
    sched = warmup_cosine(LR, 3)
    _hold_to_jax(jm, want, pm, model, before, [sched(i) for i in range(3)])


def test_accumulation_matches_jax(tmp_path):
    """accum_steps 2: batch leaves [2, micro, ...], the micro gradients
    summed in fp32 and halved, the loss their mean, against the JAX
    make_train_step(accum_steps=2) that its SFTTrainer builds."""
    cfg = _cfg()
    jmodel = JVLM(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    micro = [_packed(cfg, 20 + i, lengths) for i, lengths in
             enumerate(((21, 17), (30, 9), (25, 20), (19, 19)))]
    stack = lambda a, b: {k: np.stack([a[k], b[k]]) for k in a}
    batches = [stack(micro[0], micro[1]), stack(micro[2], micro[3])]
    variables = _jax_variables(jmodel, micro[0])
    jm, want = _jax_trainer(cfg, jmodel, variables, batches, tmp_path,
                            "accum", accum_steps=2)
    pm, model, before = _port_trainer(cfg, variables, batches, tmp_path,
                                      "accum", accum_steps=2)
    sched = warmup_cosine(LR, 2)
    _hold_to_jax(jm, want, pm, model, before, [sched(i) for i in range(2)])


def test_padding_rows_take_zero_finite_gradients():
    """Segment-0 rows (the packed tail, labels -100) attend nothing and
    reach no loss: the gradient at their input embeddings is exactly 0 and
    every gradient is finite."""
    cfg = _cfg()
    jmodel = JVLM(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    batch = _packed(cfg, 3)
    model = _port(cfg, _jax_variables(jmodel, batch))
    tb = _tb(batch)
    emb = model.fuse_embeddings(tb["input_ids"], tb["pixel_values"],
                                tb["image_flags"]).detach().requires_grad_()
    logits, _, _ = model.language_model(inputs_embeds=emb,
                                        positions=tb["positions"],
                                        seg_ids=tb["seg_ids"],
                                        attn_impl="reference")
    weighted_ce_loss(logits, tb["labels"], tb["loss_weight"]).backward()
    pad = tb["seg_ids"][0] == 0
    assert pad.sum() == N - 38
    assert torch.isfinite(emb.grad).all()
    assert (emb.grad[0, pad] == 0).all() and emb.grad[0, ~pad].abs().max() > 0
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)


def test_sft_trainer_raises_on_what_is_not_ported():
    cfg = _cfg()
    model = InternVLChatModel(cfg, device="cpu")
    for kw in (dict(checkpoint_dir="ckpt"), dict(mesh_fsdp=2),
               dict(mesh_cp=2), dict(moe_aux_coef=1e-3)):
        with pytest.raises(NotImplementedError):
            SFTTrainer(model, TrainConfig(**kw))


def test_sft_trainer_profiles_logs_and_stops_on_preemption(tmp_path):
    """numpy batches go to the model's device; a torch.profiler trace
    covers [profile_start, profile_start + profile_steps); a guard whose
    should_stop() turns true ends the loop after that step."""
    from vlaser_tpu_torch.models.layers import init_normal_

    cfg = _cfg()
    model = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu",
                              attn_impl="reference")
    init_normal_(model, torch.Generator().manual_seed(0), std=0.05)
    tcfg = TrainConfig(total_steps=5, log_every=1,
                       profile_dir=str(tmp_path / "prof"), profile_start=0,
                       profile_steps=1,
                       metrics_path=str(tmp_path / "m.jsonl"))

    class Guard:
        calls = 0

        def should_stop(self):
            self.calls += 1
            return self.calls >= 2

    trainer = SFTTrainer(model, tcfg)
    m = trainer.train(iter([_packed(cfg, 40 + i) for i in range(5)]),
                      preemption_guard=Guard())
    assert trainer.step == 2 and np.isfinite(m["loss"].item())
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert [r["step"] for r in _read_metrics(tcfg.metrics_path)] == [1, 2]
