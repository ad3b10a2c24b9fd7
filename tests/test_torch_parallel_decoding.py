"""The port's RoboTwin parallel-decoding VLA (vlaser_tpu_torch.policy.
parallel_decoding) against the JAX package's on the same tiny weights and
inputs: the layout and the builder, the forward on both attention routes,
the L1 loss and every gradient, the padding- and slot-inert properties,
the converter's round trip and grafting a ViT of another grid."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.config import tiny_vlm
from vlaser_tpu.policy import parallel_decoding as jpd
from vlaser_tpu_torch.core.config import tiny_vlm as torch_tiny_vlm
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.policy import parallel_decoding as tpd
from vlaser_tpu_torch.utils.convert import from_jax_variables, to_jax_params

TOKENS = {
    "bos": 1, "eos": 2, "soi": 400, "eoi": 401, "sot": 402, "eot": 403,
    "left_arm_soa": 404, "left_arm_eoa": 405, "right_arm_soa": 406,
    "right_arm_eoa": 407, "left_arm_sost": 408, "left_arm_eost": 409,
    "right_arm_sost": 410, "right_arm_eost": 411, "img_context": 500,
}
B, N_TEXT = 2, 5
FWD_ABS, LOSS_REL, GRAD_REL = 1e-4, 1e-5, 1e-3


def _cfgs(image_size=None):
    kw = dict(action_chunk=4, action_dim=6, state_dim=6, state_vocab_size=16,
              max_text_tokens=8, head_hidden=32)
    jv, tv = tiny_vlm(), torch_tiny_vlm()
    if image_size is not None:
        jv = dataclasses.replace(jv, vision=dataclasses.replace(
            jv.vision, image_size=image_size))
        tv = dataclasses.replace(tv, vision=dataclasses.replace(
            tv.vision, image_size=image_size))
    return (jpd.ParallelDecodingConfig(vlm=jv, **kw),
            tpd.ParallelDecodingConfig(vlm=tv, **kw))


def _inputs(cfg, builder, seed=0):
    rng = np.random.default_rng(seed)
    text = rng.integers(10, 100, (B, N_TEXT))
    qpos = rng.uniform(-1, 1, (B, cfg.state_dim))
    ids, mask = builder.build(text, qpos)
    img = cfg.vlm.vision.image_size
    px = rng.standard_normal((B, img, img, 3)).astype(np.float32)
    actions = rng.standard_normal(
        (B, cfg.action_chunk, cfg.action_dim)).astype(np.float32)
    return dict(ids=ids, mask=mask, px=px, actions=actions)


def _draw_variables(jmodel, x, seed=1):
    """Shapes by tracing init; norm scales 1 + N(0, 0.1^2), everything
    else N(0, 0.1^2) from a numpy seed."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x["ids"]), jnp.asarray(x["px"]),
        jnp.asarray(x["mask"])))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        w = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return jnp.asarray(w + 1.0 if path[-1].key == "weight" else w)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def pd():
    jcfg, tcfg = _cfgs()
    jmodel = jpd.ParallelDecodingVLA(jcfg, compute_dtype=jnp.float32,
                                     attn_impl="reference")
    jb = jpd.SequenceBuilder(jcfg, TOKENS, state_token_start=420,
                             pad_token_id=0)
    x = _inputs(jcfg, jb)
    variables = _draw_variables(jmodel, x)
    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    tmodel = tpd.ParallelDecodingVLA(tcfg, compute_dtype=torch.float32,
                                     device="cpu")
    load_state(tmodel, state)
    tb = tpd.SequenceBuilder(tcfg, TOKENS, state_token_start=420,
                             pad_token_id=0)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, variables=variables,
                tmodel=tmodel, state=state, x=x, jb=jb, tb=tb)


def _targs(x, ids=None):
    return (torch.from_numpy(np.asarray(ids if ids is not None
                                        else x["ids"])).long(),
            torch.from_numpy(x["px"]), torch.from_numpy(x["mask"]))


def _jargs(x, ids=None):
    return (jnp.asarray(ids if ids is not None else x["ids"]),
            jnp.asarray(x["px"]), jnp.asarray(x["mask"]))


def test_unitmodel_alias_and_layout(pd):
    assert tpd.UnitModel is tpd.ParallelDecodingVLA
    assert pd["tcfg"].layout() == pd["jcfg"].layout()
    full = tpd.ParallelDecodingConfig()
    jfull = jpd.ParallelDecodingConfig()
    assert full.layout() == jfull.layout()
    assert full.slots_per_arm == jfull.slots_per_arm == 56
    assert full.num_image_tokens == jfull.num_image_tokens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_builder_and_discretize_bit_equal(pd, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 12))  # past max_text_tokens too
    text = rng.integers(0, 100, (3, n))
    text[:, n // 2:] *= rng.integers(0, 2, (3, n - n // 2))  # pad ids inside
    qpos = rng.uniform(-1.5, 1.5, (3, pd["jcfg"].state_dim))
    ji, jm = pd["jb"].build(text, qpos)
    ti, tm = pd["tb"].build(text, qpos)
    assert ji.dtype == ti.dtype and jm.dtype == tm.dtype
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jm, tm)
    for vocab in (16, 512):
        np.testing.assert_array_equal(jpd.discretize_state(qpos, vocab),
                                      tpd.discretize_state(qpos, vocab))
    q = np.array([[-1.0, 0.0, 1.0]])
    bins = tpd.discretize_state(q, vocab=16)
    assert bins[0, 0] == 0 and bins[0, 2] == 15 and 7 <= bins[0, 1] <= 8


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_forward_matches_jax(pd, impl):
    """fp32 forward within FWD_ABS of JAX on both attention routes (the
    kernel route takes the flash twin on CPU tensors; text padding rows
    then give out = 0 where the reference averages, and no other row sees
    them)."""
    want = np.asarray(pd["jmodel"].apply(pd["variables"], *_jargs(pd["x"])))
    model = pd["tmodel"]
    model.set_impl(impl, impl)
    try:
        with torch.no_grad():
            got = model(*_targs(pd["x"])).numpy()
    finally:
        model.set_impl("auto")
    assert got.shape == (B, 4, 6) and got.dtype == np.float32
    assert np.abs(got - want).max() <= FWD_ABS, np.abs(got - want).max()


def test_loss_and_every_gradient_match_jax(pd):
    x, variables = pd["x"], pd["variables"]
    jmodel = pd["jmodel"]

    def jloss(v):
        return jmodel.apply(v, *_jargs(x), jnp.asarray(x["actions"]),
                            method=jmodel.loss)

    jl, jg = jax.value_and_grad(jloss)(variables)
    model = pd["tmodel"]
    model.zero_grad(set_to_none=True)
    tl = model.loss(*_targs(x), torch.from_numpy(x["actions"]))
    tl.backward()
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    grads = from_jax_variables(jax.tree_util.tree_map(np.asarray, jg))
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    for name, want in grads.items():
        got = named[name].grad
        assert got is not None, name
        tol = GRAD_REL * max(float(want.abs().max()), 1e-12)
        assert float((got - want).abs().max()) <= tol, name
    model.zero_grad(set_to_none=True)


def test_text_padding_inert(pd):
    """Junk in masked text positions does not change the predictions."""
    x, model = pd["x"], pd["tmodel"]
    s, e = pd["tcfg"].layout()["text"]
    ids2 = x["ids"].copy()
    ids2[:, s + N_TEXT:e] = 77
    with torch.no_grad():
        a = model(*_targs(x))
        b = model(*_targs(x, ids2))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_slot_content_inert(pd):
    """Slot token ids are irrelevant (their embeddings are zeroed)."""
    x, model = pd["x"], pd["tmodel"]
    s, e = pd["tcfg"].layout()["left_slots"]
    ids2 = x["ids"].copy()
    ids2[:, s:e] = 123
    with torch.no_grad():
        a = model(*_targs(x))
        b = model(*_targs(x, ids2))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_padding_rows_take_zero_input_gradients(pd):
    """The text padding rows' embeddings get exactly zero gradient on both
    routes (no row attends them and their own rows reach no slot)."""
    x, model = pd["x"], pd["tmodel"]
    s, e = pd["tcfg"].layout()["text"]
    for impl in ("reference", "kernel"):
        model.set_impl(impl, impl)
        grab = {}

        def keep(mod, args, out):
            out.retain_grad()
            grab["t"] = out

        hook = model.embed_tokens.register_forward_hook(keep)
        try:
            model.loss(*_targs(x), torch.from_numpy(x["actions"])).backward()
        finally:
            hook.remove()
            model.set_impl("auto")
            model.zero_grad(set_to_none=True)
        g = grab["t"].grad
        assert torch.isfinite(g).all()
        assert float(g[:, s + N_TEXT:e].abs().max()) == 0.0, impl
        assert float(g[:, s:s + N_TEXT].abs().max()) > 0.0, impl


def test_converter_round_trip_is_bit_exact(pd):
    """JAX tree -> port state -> JAX tree: every leaf bit for bit, the
    tree's five top-level entries included."""
    tree = jax.tree_util.tree_map(np.asarray, pd["variables"])["params"]
    assert set(tree) == {"embed_tokens", "language_model", "mlp1",
                         "vision_model", "action_head"}
    back = to_jax_params(pd["tmodel"].state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path], err_msg=str(path))
    again = from_jax_variables({"params": back})
    for k, v in pd["tmodel"].state_dict().items():
        assert torch.equal(again[k], v), k


def test_grafting_a_vit_of_another_grid():
    """A ViT tree converted at 56 px (a 4 x 4 grid, 17 position rows) put
    into the 28 px model (2 x 2, 5 rows), as train_robotwin grafts a
    448-px checkpoint into its 224-px model: the JAX apply refuses the
    shape (flax checks it before the ViT could interpolate); the port's
    graft raises a ValueError naming both grids, and grafts a tree of its
    own grid bit for bit."""
    from vlaser_tpu_torch.scripts.train_robotwin import graft_vlm

    jcfg, tcfg = _cfgs()
    jbig, _ = _cfgs(image_size=56)
    jb = jpd.SequenceBuilder(jcfg, TOKENS, state_token_start=420,
                             pad_token_id=0)
    x = _inputs(jcfg, jb)
    small = jpd.ParallelDecodingVLA(jcfg, compute_dtype=jnp.float32,
                                    attn_impl="reference")
    big = jpd.ParallelDecodingVLA(jbig, compute_dtype=jnp.float32,
                                  attn_impl="reference")
    xb = _inputs(jbig, jpd.SequenceBuilder(jbig, TOKENS, state_token_start=420,
                                           pad_token_id=0))
    v_small = _draw_variables(small, x)
    v_big = _draw_variables(big, xb)
    assert v_big["params"]["vision_model"]["embeddings"][
        "position_embedding"].shape == (1, 17, 32)
    grafted = {"params": dict(v_small["params"],
                              vision_model=v_big["params"]["vision_model"])}
    # flax's ScopeParamShapeError: the JAX CLI cannot take its first step
    with pytest.raises(Exception, match=r"position_embedding.*\(1, 17, 32\)"):
        small.apply(grafted, *_jargs(x))

    model = tpd.ParallelDecodingVLA(tcfg, compute_dtype=torch.float32,
                                    device="cpu")
    raw = jax.tree_util.tree_map(np.asarray, v_big)["params"]
    vlm = {"vision_model": raw["vision_model"], "mlp1": raw["mlp1"],
           "language_model": {"model": raw["language_model"],
                              "embed_tokens": raw["embed_tokens"]}}
    with pytest.raises(ValueError, match=r"4 x 4.*2 x 2"):
        graft_vlm(model, vlm)
    same = jax.tree_util.tree_map(np.asarray, v_small)["params"]
    vlm_same = {"vision_model": same["vision_model"], "mlp1": same["mlp1"],
                "language_model": {"model": same["language_model"],
                                   "embed_tokens": same["embed_tokens"]}}
    graft_vlm(model, vlm_same)
    pe = model.vision_model.embeddings.position_embedding
    np.testing.assert_array_equal(
        pe.detach().numpy(),
        same["vision_model"]["embeddings"]["position_embedding"])
