"""The dense families beyond Vlaser-2B in the port: the Vlaser-8B and
InternVL3.5-2B configs against the JAX package's factories, the full 8B VLA
laid out on the meta device against JAX's traced shapes, and the joint
model at the port's tiny cuts (core/config): `tiny_vla_8b` (a group of 7 q
heads a kv head, an expert whose q width 112 is wider than its hidden 32,
as the 8B expert's 3,584 against 768) and `tiny_qwen3_vla` (both mixtures
with Qwen3's per-head q/k RMSNorm). The flow loss and `infer_action` match
JAX on the same numpy-drawn weights (fp32: loss rtol 1e-5, actions atol
1e-4); the fused b1 / b8 paths run the 7-head group on the kernels' CPU
twins and refuse a qk-norm mixture, whose expert the JAX b1 path sends
through its fused stack without the norms (ROADMAP queue 3). No 8B or 1.7B
weights are built on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core import config as jconfig
from vlaser_tpu.core.quant import POLICY_PATTERNS, quantize_variables
from vlaser_tpu.policy.fused_infer import \
    make_fused_infer_action as jax_fused
from vlaser_tpu.policy.pizero import PiZeroVLA as JaxVLA
from vlaser_tpu_torch.core import config as tconfig
from vlaser_tpu_torch.core.quant import quantize_for_serving
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.policy import fused_infer
from vlaser_tpu_torch.policy.pizero import PiZeroVLA
from vlaser_tpu_torch.utils.convert import from_jax_variables

from test_torch_qwen3 import draw_variables, jax_cfg

KEYS = ("input_ids", "pixel_values", "text_mask", "proprios", "actions", "t",
        "x0")
FACTORIES = ("qwen2_5_7b", "vlaser_8b", "action_expert_8b", "qwen3_1_7b",
             "internvl3_5_2b")


@pytest.mark.parametrize("name", FACTORIES)
def test_config_equals_the_jax_factory(name):
    """Every field, at the default vocabulary and at another one."""
    vocabs = [()] if name == "action_expert_8b" else [(), (1000,)]
    for a in vocabs:
        assert dataclasses.asdict(getattr(tconfig, name)(*a)) == \
            dataclasses.asdict(getattr(jconfig, name)(*a))


def test_vlaser_8b_vla_is_the_jax_packages():
    """vlaser_tpu/utils/memory_budget.py:86-87 builds the 8B VLA as
    VLAConfig(vlm=vlaser_8b(151674 + 256), expert=action_expert_8b())."""
    want = jconfig.VLAConfig(vlm=jconfig.vlaser_8b(151674 + 256),
                             expert=jconfig.action_expert_8b())
    assert dataclasses.asdict(tconfig.vlaser_8b_vla()) == \
        dataclasses.asdict(want)


def test_named_configs_consistent():
    """tests/test_chat_and_configs.py::test_named_configs_consistent on the
    port's copies, with the 8B and Qwen3 families' own facts."""
    c2 = tconfig.vlaser_2b()
    assert c2.num_image_token == 256
    assert c2.vit_proj_in_dim == 4096
    assert c2.llm.q_dim == 1536 and c2.llm.kv_dim == 256
    c8 = tconfig.vlaser_8b()
    assert c8.llm.hidden_size == 3584 and c8.llm.num_heads == 28
    assert c8.llm.rope_theta == 1e6 and not c8.llm.tie_word_embeddings
    # joint attention requires identical head layouts between vlm + expert
    for llm, exp in ((tconfig.qwen2_5_1_5b(), tconfig.action_expert_2b()),
                     (tconfig.qwen2_5_7b(), tconfig.action_expert_8b()),
                     (tconfig.tiny_llm_8b(), tconfig.tiny_expert_8b())):
        assert llm.num_heads == exp.num_heads
        assert llm.num_kv_heads == exp.num_kv_heads
        assert llm.head_dim == exp.head_dim
    vla = tconfig.vlaser_2b_vla()
    assert vla.num_action_tokens == 4 and vla.num_proprio_tokens == 1
    assert vla.total_tokens == 384 + 1 + 4
    q3 = tconfig.internvl3_5_2b().llm
    assert q3.qk_norm and q3.tie_word_embeddings and q3.head_dim == 128
    # the tiny cuts keep what makes their family: a group of 7, an expert
    # q width beyond its hidden size, the q/k norms
    t8 = tconfig.tiny_vla_8b()
    assert t8.vlm.llm.num_heads // t8.vlm.llm.num_kv_heads == 7
    assert t8.expert.q_dim > t8.expert.hidden_size
    tq = tconfig.tiny_qwen3_vla()
    assert tq.vlm.llm.qk_norm and tq.expert.qk_norm


def test_the_8b_vla_on_the_meta_device_has_the_jax_shapes():
    """PiZeroVLA(vlaser_8b_vla()) built on the meta device (no weights):
    every leaf has the name and shape of JAX's traced init (7.94 G
    parameters), the expert's q projection 768 -> 3,584."""
    cfg = tconfig.vlaser_8b_vla()
    model = PiZeroVLA(cfg, device="meta")
    got = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    jm = JaxVLA(jax_cfg(cfg))
    S, img = cfg.max_image_text_tokens, cfg.vlm.vision.image_size
    A = (1, cfg.num_action_tokens, cfg.action_dim)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S), jnp.int32),
        jnp.zeros((1, img, img, 3)), jnp.ones((1, S), jnp.int32),
        jnp.zeros((1, cfg.cond_steps, cfg.proprio_dim)), jnp.zeros(A),
        jnp.zeros((1,)), jnp.zeros(A)))
    flat = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = ".".join(p.key for p in path[1:])
        flat[name] = s.shape
    conv = "vision_model.embeddings.patch_embedding.kernel"
    h, w, i, o = flat.pop(conv)  # HWIO -> OIHW, as utils/convert lays it
    flat[conv.replace("kernel", "weight")] = (o, i, h, w)
    assert got == flat
    assert got["joint.layers.expert.q_proj.kernel"] == (28, 768, 3584)
    assert got["joint.layers.vlm.mlp.down_proj.kernel"] == (28, 18944, 3584)
    assert round(sum(np.prod(s) for s in got.values()) / 1e9, 2) == 7.94


def _batch(cfg, B=2, seed=0):
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


VARIANTS = {"8b": tconfig.tiny_vla_8b, "qwen3": tconfig.tiny_qwen3_vla}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def vla(request):
    """A tiny VLA of the variant, JAX's model and its numpy-drawn variables,
    and the port loaded with them."""
    cfg = VARIANTS[request.param]()
    jm = JaxVLA(jax_cfg(cfg), compute_dtype=jnp.float32,
                attn_impl="reference")
    batch = _batch(cfg)
    jb = tuple(jnp.asarray(batch[k]) for k in KEYS)
    v = draw_variables(lambda: jm.init(jax.random.PRNGKey(0), *jb),
                       np.random.default_rng(1))
    tm = PiZeroVLA(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables(jax.tree_util.tree_map(np.asarray, v)))
    return dict(name=request.param, cfg=cfg, jm=jm, v=v, tm=tm, batch=batch,
                jb=jb)


def _infer_args(batch, b=1):
    return [batch[k][:b] for k in ("input_ids", "pixel_values", "text_mask",
                                   "proprios", "x0")]


def _jit_infer(jm):
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=jm.infer_action))


def test_flow_loss_matches_jax(vla):
    jm = vla["jm"]
    want = float(jax.jit(lambda v, *b: jm.apply(v, *b))(vla["v"], *vla["jb"]))
    with torch.no_grad():
        got = vla["tm"](*(torch.from_numpy(vla["batch"][k]) for k in KEYS))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_infer_action_matches_jax(vla):
    jm, v = vla["jm"], vla["v"]
    args = _infer_args(vla["batch"], 2)
    want = _jit_infer(jm)(v, *map(jnp.asarray, args))
    got = vla["tm"].infer_action(*map(torch.from_numpy, args))
    assert got.shape == (2, vla["cfg"].horizon_steps, vla["cfg"].action_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_fused_paths_take_the_group_of_7_and_refuse_qk_norm(vla):
    """On the 8B cut (int8 mixtures, the kernels' CPU twins) the fused b1
    path and the batched path hold the plain infer_action (the b1 stack and
    both paths' ViT twin in bf16: atol 0.05, as tests/test_torch_policy.py
    holds the fused path). A qk-norm mixture has no fused route: both
    raise NotImplementedError from the config, before any call."""
    cfg, tm = vla["cfg"], vla["tm"]
    model = PiZeroVLA(cfg, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(tm.state_dict())
    quantize_for_serving(model, target="policy", mode="int8", min_size=1)
    if vla["name"] == "qwen3":
        for make in (fused_infer.make_fused_infer_action,
                     fused_infer.make_batched_infer_action):
            with pytest.raises(NotImplementedError, match="qk-norm"):
                make(model)
        return
    x = [torch.from_numpy(a) for a in _infer_args(vla["batch"], 2)]
    plain = model.infer_action(*x)
    b1 = fused_infer.make_fused_infer_action(model)(*[a[:1] for a in x])
    np.testing.assert_allclose(b1.numpy(), plain[:1].numpy(), atol=0.05,
                               rtol=0.05)
    b8 = fused_infer.make_batched_infer_action(model)(*x)
    np.testing.assert_allclose(b8.numpy(), plain.numpy(), atol=0.05,
                               rtol=0.05)


def test_jax_fused_b1_path_drops_the_experts_qk_norms():
    """The reference's fault, on its VLA path (ROADMAP queue 3): the JAX
    make_fused_infer_action (Pallas in interpret mode) sends a qk-norm
    expert through fused_int8_stack, which has no q/k norm. On a qk-norm
    mixture its actions are those of the same weights with the expert's
    norms taken out (within the fused path's bf16 tolerance, 0.05), not
    those of the model (plain infer_action)."""
    cfg = tconfig.tiny_qwen3_vla()
    batch = _batch(cfg, B=1, seed=3)
    jb = tuple(jnp.asarray(batch[k]) for k in KEYS)
    args = tuple(map(jnp.asarray, _infer_args(batch)))
    jm = JaxVLA(jax_cfg(cfg), compute_dtype=jnp.float32,
                attn_impl="reference")
    qv = quantize_variables(draw_variables(
        lambda: jm.init(jax.random.PRNGKey(0), *jb),
        np.random.default_rng(4)), POLICY_PATTERNS)
    # the same weights without the expert's q/k norms
    bare = dataclasses.replace(cfg, expert=dataclasses.replace(
        cfg.expert, qk_norm=False))
    jb_ = JaxVLA(jax_cfg(bare), compute_dtype=jnp.float32,
                 attn_impl="reference")
    drop = lambda d: {k: (drop(x) if isinstance(x, dict) else x)
                      for k, x in d.items() if k not in ("q_norm", "k_norm")}
    qv_ = {c: dict(t) for c, t in qv.items()}
    joint = qv_["params"]["joint"] = dict(qv_["params"]["joint"])
    joint["layers"] = dict(joint["layers"], expert=drop(
        joint["layers"]["expert"]))
    fused = np.asarray(jax_fused(jm, interpret=True)(qv, *args))
    model = np.asarray(_jit_infer(jm)(qv, *args))
    no_norms = np.asarray(_jit_infer(jb_)(qv_, *args))
    d_model = float(np.abs(fused - model).max())
    d_bare = float(np.abs(fused - no_norms).max())
    print(f"JAX fused b1 actions, max abs: vs the qk-norm model's "
          f"infer_action {d_model:.3e}, vs the same weights without the "
          f"expert's q/k norms {d_bare:.3e}")
    assert d_bare <= 0.05 < d_model
