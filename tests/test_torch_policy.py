"""The port's control-step slice (vlaser_tpu_torch) against the JAX package
on the same tiny weights and inputs: conversion, the plain infer_action,
the fused serving path, and the PolicyServer step."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.config import tiny_vla
from vlaser_tpu.core.quant import POLICY_PATTERNS, quantize_variables
from vlaser_tpu.envs.adapters import BridgeSimplerAdapter
from vlaser_tpu.policy.fused_infer import make_fused_infer_action
from vlaser_tpu.policy.pizero import PiZeroVLA
from vlaser_tpu.policy.processing import InternVLAProcessor
from vlaser_tpu.serve.policy_server import PolicyServer
from vlaser_tpu_torch.core.quant import quantize_for_serving
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.policy.fused_infer import (
    make_fused_infer_action as torch_fused,
)
from vlaser_tpu_torch.policy.pizero import PiZeroVLA as TorchVLA
from vlaser_tpu_torch.serve.policy_server import PolicyServer as TorchServer
from vlaser_tpu_torch.utils.convert import from_jax_variables


def _inputs(cfg, seed=0):
    B, S = 1, cfg.max_image_text_tokens
    img = cfg.vlm.vision.image_size
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 400, (B, S)).astype(np.int32)
    ids[:, 2] = cfg.vlm.img_context_token_id
    text_mask = np.ones((B, S), np.int32)
    text_mask[:, -3:] = 0  # padded prefix tail
    return dict(
        ids=ids,
        px=rng.standard_normal((B, img, img, 3)).astype(np.float32),
        mask=text_mask,
        proprio=rng.standard_normal(
            (B, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32),
        noise=rng.standard_normal(
            (B, cfg.num_action_tokens, cfg.action_dim)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def setup():
    """One tiny VLA (32 prefix tokens, the processor's length below), its
    JAX variables (float and POLICY_PATTERNS-int8) and the port loaded with
    the int8 ones."""
    cfg = tiny_vla(max_image_text_tokens=32)
    jmodel = PiZeroVLA(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    x = _inputs(cfg)
    # shapes by tracing init (no compile); weights from a numpy seed: norm
    # scales 1 + N(0, 0.1^2), everything else N(0, 0.1^2)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *_jargs(x)[:4],
        jnp.zeros((1, cfg.num_action_tokens, cfg.action_dim)),
        jnp.zeros((1,)), jnp.asarray(x["noise"])))
    rng = np.random.default_rng(1)

    def draw(path, s):
        w = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return jnp.asarray(w + 1.0 if path[-1].key == "weight" else w)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    qvars = quantize_variables(variables, POLICY_PATTERNS)
    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, qvars))
    tmodel = TorchVLA(cfg, compute_dtype=torch.float32)
    load_state(tmodel, state)
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, qvars=qvars,
                tmodel=tmodel, state=state, x=x)


def _targs(x, **over):
    d = {**x, **over}
    return (torch.from_numpy(d["ids"]).long(), torch.from_numpy(d["px"]),
            torch.from_numpy(d["mask"]), torch.from_numpy(d["proprio"]),
            torch.from_numpy(d["noise"]))


def _jargs(x, **over):
    d = {**x, **over}
    return tuple(jnp.asarray(d[k]) for k in
                 ("ids", "px", "mask", "proprio", "noise"))


def test_from_jax_variables_covers_quantized_tree(setup):
    qvars, tmodel, state = setup["qvars"], setup["tmodel"], setup["state"]
    n_leaves = sum(len(jax.tree_util.tree_leaves(qvars[c]))
                   for c in ("params", "quant"))
    assert len(state) == n_leaves
    # int8 leaves arrive bit-exact, with the JAX layout
    q = tmodel.joint.layers.expert.q_proj
    np.testing.assert_array_equal(
        q.kernel_q.numpy(),
        np.asarray(qvars["quant"]["joint"]["layers"]["expert"]["q_proj"]
                   ["kernel_q"]))
    assert tmodel.embed_tokens.embedding_q.dtype == torch.int8
    # the patch conv is the one layout change (HWIO -> OIHW)
    w = np.asarray(qvars["params"]["vision_model"]["embeddings"]
                   ["patch_embedding"]["kernel"])
    np.testing.assert_array_equal(
        tmodel.vision_model.embeddings.patch_embedding.weight.detach().numpy(),
        w.transpose(3, 2, 0, 1))


def test_port_quantize_matches_jax_quantize(setup):
    """quantize_for_serving(policy, int8) on the port's float weights gives
    the same int8 tree as the JAX POLICY_PATTERNS quantization."""
    variables = setup["variables"]
    plain = TorchVLA(setup["cfg"], compute_dtype=torch.float32)
    load_state(plain, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    quantize_for_serving(plain, target="policy", mode="int8")
    want = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, quantize_variables(variables, POLICY_PATTERNS)))
    got = plain.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_infer_action_matches_jax(setup):
    """Plain oracle path, fp32 compute on both sides: atol 1e-4."""
    cfg, jmodel, qvars, tmodel, x = (setup[k] for k in (
        "cfg", "jmodel", "qvars", "tmodel", "x"))
    want = jmodel.apply(qvars, *_jargs(x), method=jmodel.infer_action)
    got = tmodel.infer_action(*_targs(x))
    assert got.shape == (1, cfg.horizon_steps, cfg.action_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_prefix_kv_matches_jax(setup):
    """Per-layer prefix K/V over [vlm | proprio], fp32: atol 1e-4."""
    jmodel, qvars, tmodel, x = (setup[k] for k in (
        "jmodel", "qvars", "tmodel", "x"))
    jk, jv, _, _ = jmodel.apply(qvars, *_jargs(x)[:4],
                                method=jmodel.prefix_forward)
    with torch.no_grad():
        tk, tv, _, _ = tmodel.prefix_forward(*_targs(x)[:4])
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)


def test_fused_infer_matches_jax_fused(setup):
    """Port's fused path (CPU twins) vs the JAX fused path (Pallas in
    interpret mode): both run the stacks in bf16 and round at their own
    points, so the 10-step integrated chunk is held to atol 0.05, as
    tests/test_fused_infer.py holds the JAX fused path."""
    jmodel, qvars, tmodel, x = (setup[k] for k in (
        "jmodel", "qvars", "tmodel", "x"))
    want = make_fused_infer_action(jmodel, interpret=True)(qvars, *_jargs(x))
    got = torch_fused(tmodel)(*_targs(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.05,
                               rtol=0.05)
    # and the port's fused path against its own plain oracle
    plain = tmodel.infer_action(*_targs(x))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=0.05,
                               rtol=0.05)


def test_fused_infer_respects_prefix_padding(setup):
    """Ids under text_mask=0 must not change the fused output."""
    tmodel, x = setup["tmodel"], setup["x"]
    fused = torch_fused(tmodel)
    a = fused(*_targs(x))
    ids2 = x["ids"].copy()
    ids2[:, -3:] = 123
    b = fused(*_targs(x, ids=ids2))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_fused_infer_raises_outside_the_slice(setup):
    """Multi-tile input and a cut encoder have no fused route: they raise
    rather than run the plain ViT."""
    cfg, tmodel, x = setup["cfg"], setup["tmodel"], setup["x"]
    two_tiles = np.concatenate([x["px"], x["px"]], axis=0)
    with pytest.raises(NotImplementedError):
        torch_fused(tmodel)(*_targs(x, px=two_tiles))
    cut = TorchVLA(replace(cfg, vlm=replace(cfg.vlm, select_layer=1)),
                   compute_dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        torch_fused(cut)


class _TinyTok:
    pad_token_id = 0

    def __call__(self, text, add_special_tokens=False, **kw):
        ids, i = [], 0
        while i < len(text):
            for tok, tid in (("<IMG_CONTEXT>", 500), ("<img>", 498),
                             ("</img>", 499)):
                if text.startswith(tok, i):
                    ids.append(tid)
                    i += len(tok)
                    break
            else:
                ids.append(ord(text[i]) % 490)
                i += 1
        return {"input_ids": ids}


STATS = {
    "action": {"p01": [-0.02] * 6 + [0.0], "p99": [0.02] * 6 + [1.0],
               "mean": [0.0] * 7, "std": [0.01] * 7},
    "proprio": {"p01": [-0.5] * 6 + [0.0], "p99": [0.5] * 6 + [1.0],
                "mean": [0.0] * 7, "std": [0.2] * 7},
}


@pytest.mark.parametrize("fused", [False, True])
def test_policy_server_step_matches_jax_server(setup, fused):
    """One PolicyServer step on the same frame. The torch server is fed the
    noise the JAX server draws (split(PRNGKey(seed)), then normal). Plain
    path: fp32 on both sides, env actions atol 1e-4. Fused path: bf16
    stacks on both sides, atol 0.05."""
    cfg, jmodel, qvars, state = (setup[k] for k in (
        "cfg", "jmodel", "qvars", "state"))
    img = cfg.vlm.vision.image_size
    proc = InternVLAProcessor(_TinyTok(),
                              num_image_tokens=cfg.vlm.num_image_token,
                              max_seq_len=cfg.max_image_text_tokens,
                              pad_token_id=0)
    obs = {"agent": {"eef_pos": np.array([0.1, 0.0, 0.2, 1, 0, 0, 0, 0.5],
                                         np.float32)}}
    frame = np.random.default_rng(1).integers(0, 255, (img, img, 3),
                                              dtype=np.uint8)
    mk = lambda: BridgeSimplerAdapter(dataset_statistics=STATS,
                                      image_size=(img, img))

    seed = 3
    jserver = PolicyServer(jmodel, qvars, mk(), proc, act_steps=4,
                           seed=seed, fused=fused)
    jserver.reset("pick the cube")
    want = jserver.step(obs, frame)

    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    noise = np.asarray(jax.random.normal(
        sub, (1, cfg.num_action_tokens, cfg.action_dim), jnp.float32))
    tserver = TorchServer(TorchVLA(cfg, compute_dtype=torch.float32), state,
                          mk(), proc, act_steps=4, seed=seed, fused=fused,
                          device="cpu")
    tserver.draw_noise = lambda: torch.from_numpy(noise.copy())
    tserver.reset("pick the cube")
    got = tserver.step(obs, frame)
    assert got.shape == want.shape == (4, 7)
    np.testing.assert_allclose(got, want, atol=0.05 if fused else 1e-4,
                               rtol=0)
