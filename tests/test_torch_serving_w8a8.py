"""The port's w8a8 serving slice (quantize_for_serving's default mode) against
the JAX package on the same tiny weights and inputs: the quantized tree,
the plain infer_action, the fused batch-1 path, the batched path and the
PolicyServer step.

The prompt is 128 tokens long at batch 1 and 48 at batch 3 (144 rows), so
the VLM mixture's prefix Dense calls reach the 128-row w8a8 threshold; the
ViT is quantized with min_size 1 (its tiny kernels would fall under the
4096-element floor), so the fused ViT runs its act_quant mode.
Tolerances: plain paths in fp32 on both sides, atol 2e-3 (an int8
activation that rounds the other way after a last-bit difference upstream
moves an output by ~1/127 of one term); the fused and batched paths run
their stacks in bf16 on both sides, atol 0.05 as tests/test_torch_policy.py
holds the weight-only fused path."""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.config import tiny_vla
from vlaser_tpu.core.quant import quantize_for_serving as jax_quantize
from vlaser_tpu.envs.adapters import BridgeSimplerAdapter
from vlaser_tpu.policy.fused_infer import (make_batched_infer_action,
                                           make_fused_infer_action)
from vlaser_tpu.policy.pizero import PiZeroVLA
from vlaser_tpu.policy.processing import InternVLAProcessor
from vlaser_tpu.serve.policy_server import PolicyServer
from vlaser_tpu_torch.core.quant import quantize_for_serving
from vlaser_tpu_torch.kernels.fused_vit import pack_vit_stack
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.policy import fused_infer as tfi
from vlaser_tpu_torch.policy.pizero import PiZeroVLA as TorchVLA
from vlaser_tpu_torch.serve.policy_server import PolicyServer as TorchServer
from vlaser_tpu_torch.utils.convert import from_jax_variables

PLAIN_ATOL, FUSED_ATOL = 2e-3, 0.05
STATS = {
    "action": {"p01": [-0.02] * 6 + [0.0], "p99": [0.02] * 6 + [1.0],
               "mean": [0.0] * 7, "std": [0.01] * 7},
    "proprio": {"p01": [-0.5] * 6 + [0.0], "p99": [0.5] * 6 + [1.0],
                "mean": [0.0] * 7, "std": [0.2] * 7},
}


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


def _inputs(cfg, B, seed):
    S, img = cfg.max_image_text_tokens, cfg.vlm.vision.image_size
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 400, (B, S)).astype(np.int32)
    ids[:, 2] = cfg.vlm.img_context_token_id
    mask = np.ones((B, S), np.int32)
    mask[:, -3:] = 0  # padded prefix tail
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (ids, f(B, img, img, 3), mask,
            f(B, cfg.cond_steps, cfg.proprio_dim),
            f(B, cfg.num_action_tokens, cfg.action_dim))


def _variables(jmodel, cfg, x):
    """Shapes by tracing init; weights from a numpy seed: norm scales
    1 + N(0, 0.1^2), everything else N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *[jnp.asarray(a[:1]) for a in x[:4]],
        jnp.zeros((1, cfg.num_action_tokens, cfg.action_dim)),
        jnp.zeros((1,)), jnp.asarray(x[4][:1])))
    rng = np.random.default_rng(1)

    def draw(path, s):
        w = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return jnp.asarray(w + 1.0 if path[-1].key == "weight" else w)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _setup(B, S):
    cfg = tiny_vla(max_image_text_tokens=S)
    jmodel = PiZeroVLA(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    x = _inputs(cfg, B, seed=B)
    variables = _variables(jmodel, cfg, x)
    qvars = jax_quantize(variables, target="policy", min_size=1)
    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, qvars))
    tmodel = TorchVLA(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tmodel, state)
    return dict(cfg=cfg, B=B, jmodel=jmodel, variables=variables,
                qvars=qvars, state=state, tmodel=tmodel, x=x)


@pytest.fixture(params=[(1, 128), (3, 48)], ids=["b1", "b3"])
def setup(request):
    return _setup(*request.param)


@pytest.fixture
def setup_b1():
    return _setup(1, 128)


def _t(x):
    ids, *rest = (torch.from_numpy(np.ascontiguousarray(a)) for a in x)
    return (ids.long(), *rest)


def _j(x):
    return tuple(jnp.asarray(a) for a in x)


@pytest.mark.parametrize("min_size", [4096, 1])
def test_quantize_for_serving_equals_jax(setup_b1, min_size):
    """The port's default serving quantization gives the JAX package's
    w8a8 tree bit for bit: int8 weights, scales and kernel_aq flags."""
    setup = setup_b1
    port = TorchVLA(setup["cfg"], compute_dtype=torch.float32, device="cpu")
    load_state(port, from_jax_variables(jax.tree_util.tree_map(
        np.asarray, setup["variables"])))
    quantize_for_serving(port, target="policy", min_size=min_size)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jax_quantize(
        setup["variables"], target="policy", min_size=min_size)))
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    flags = [k for k in want if k.endswith("kernel_aq")]
    assert "joint.layers.vlm.q_proj.kernel_aq" in flags
    assert tuple(want["joint.layers.vlm.q_proj.kernel_aq"].shape) == (2, 1)
    # the tiny encoder passes the 4096 floor only in part (then it packs to
    # the bf16 stack); with min_size 1 all four kernels are flagged
    n_vit = sum(k.startswith("vision_model.encoder") for k in flags)
    assert n_vit == 4 if min_size == 1 else n_vit < 4


def test_plain_infer_action_matches_jax(setup):
    jmodel, qvars, tmodel, x = (setup[k] for k in (
        "jmodel", "qvars", "tmodel", "x"))
    assert "kernel_aq" in tmodel.joint.layers.vlm.q_proj._buffers
    want = jmodel.apply(qvars, *_j(x), method=jmodel.infer_action)
    got = tmodel.infer_action(*_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PLAIN_ATOL, rtol=0)


def test_fused_path_matches_jax(setup):
    """B = 1: make_fused_infer_action (act_quant ViT, w8a8 prefix, int8
    denoise stacks) vs the JAX fused path in interpret mode. B = 3:
    make_batched_infer_action vs JAX's. Each also against the port's own
    plain infer_action."""
    B, jmodel, qvars, tmodel, x = (setup[k] for k in (
        "B", "jmodel", "qvars", "tmodel", "x"))
    assert pack_vit_stack(tmodel.vision_model)["act_quant"] is True
    if B == 1:
        jfn, tfn = make_fused_infer_action, tfi.make_fused_infer_action
    else:
        jfn, tfn = make_batched_infer_action, tfi.make_batched_infer_action
    want = jfn(jmodel, interpret=True)(qvars, *_j(x))
    got = tfn(tmodel)(*_t(x))
    assert got.shape == (B, setup["cfg"].horizon_steps,
                         setup["cfg"].action_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FUSED_ATOL, rtol=FUSED_ATOL)
    plain = tmodel.infer_action(*_t(x))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=FUSED_ATOL,
                               rtol=FUSED_ATOL)


def test_batched_path_falls_back_outside_the_fused_vit(setup_b1):
    """A cut encoder has no fused ViT: unlike the JAX package, whose
    fallback is its compiled plain path, the port's batched path does not
    fall back to the plain encoder but raises, as the batch-1 path does."""
    cfg = setup_b1["cfg"]
    cut = TorchVLA(replace(cfg, vlm=replace(cfg.vlm, select_layer=1)),
                   compute_dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError):
        tfi.make_batched_infer_action(cut)


@pytest.mark.parametrize("fused", [False, True])
def test_policy_server_matches_jax_server(setup_b1, fused):
    """One PolicyServer step on the w8a8 tree; the torch server is fed the
    noise the JAX server draws."""
    setup = setup_b1
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
    jserver = PolicyServer(jmodel, qvars, mk(), proc, act_steps=4, seed=3,
                           fused=fused)
    jserver.reset("pick the cube")
    want = jserver.step(obs, frame)
    _, sub = jax.random.split(jax.random.PRNGKey(3))
    noise = np.asarray(jax.random.normal(
        sub, (1, cfg.num_action_tokens, cfg.action_dim), jnp.float32))
    tserver = TorchServer(TorchVLA(cfg, compute_dtype=torch.float32,
                                   device="cpu"), state, mk(), proc,
                          act_steps=4, seed=3, fused=fused, device="cpu")
    tserver.draw_noise = lambda: torch.from_numpy(noise.copy())
    tserver.reset("pick the cube")
    got = tserver.step(obs, frame)
    assert got.shape == want.shape == (4, 7)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FUSED_ATOL if fused else PLAIN_ATOL)
