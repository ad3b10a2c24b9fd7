"""The port's PaliGemma VLA (open-pi-zero's pi0: SigLIP + Gemma mixture +
Gemma action expert) against the JAX package's PiZeroVLA(attn_impl=
"reference") on tiny_paligemma_vla, fp32 compute on both sides, the same
numpy-drawn weights (converted with utils.convert.from_jax_variables) and
inputs. The port runs both attention routes: "kernel" (the flash kernel's
plain versions with the softcap on the CPU) and "reference".

Tolerance 1e-4, as tests/test_pizero.py holds the JAX package's own cached
vs naive PaliGemma oracles: outputs within rtol 1e-4 / atol 1e-4;
gradients within 1e-4 x max|grad| of the leaf (fp32, summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.config import tiny_paligemma_vla
from vlaser_tpu.policy.pizero import PiZeroVLA
from vlaser_tpu.train.trainer import _vla_param_groups as j_groups
from vlaser_tpu_torch.kernels import flash_attention as tfa
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.policy.pizero import PiZeroVLA as TorchVLA
from vlaser_tpu_torch.train.trainer import _vla_param_groups
from vlaser_tpu_torch.utils.convert import _flatten, from_jax_variables

B = 2
TOL = 1e-4
KEYS = ("input_ids", "pixel_values", "text_mask", "proprios", "actions", "t",
        "x0")
ROUTES = [("kernel", True), ("reference", False)]  # (attn_impl, remat)


def _batch(cfg):
    rng = np.random.default_rng(3)
    S, img = cfg.max_image_text_tokens, cfg.siglip.image_size
    n_img = cfg.siglip.num_tokens  # image tokens first, as PaliGemma's
    ids = rng.integers(1, 400, (B, S)).astype(np.int32)
    ids[:, :n_img] = cfg.vlm.img_context_token_id
    mask = np.ones((B, S), np.int32)
    mask[1, -3:] = 0  # a padded prompt tail
    ids[mask == 0] = 0
    A = (B, cfg.num_action_tokens, cfg.action_dim)
    return dict(
        input_ids=ids, text_mask=mask,
        pixel_values=rng.standard_normal((B, img, img, 3)).astype(np.float32),
        proprios=rng.standard_normal(
            (B, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32),
        actions=rng.uniform(-1, 1, A).astype(np.float32),
        t=np.array([0.2, 0.7], np.float32),
        x0=rng.standard_normal(A).astype(np.float32))


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_paligemma_vla(max_image_text_tokens=12)
    jmodel = PiZeroVLA(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    batch = _batch(cfg)
    jb = tuple(jnp.asarray(batch[k]) for k in KEYS)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *jb))
    rng = np.random.default_rng(4)

    def draw(path, s):
        # N(0, 0.1^2); LayerNorm and plain RMSNorm scales 1 + N(0, 0.1^2);
        # the plus-one RMSNorms of the joint layers scale by 1 + w already
        keys = [p.key for p in path]
        w = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        plus_one = "layers" in keys and "joint" in keys
        return jnp.asarray(w + 1.0 if keys[-1] == "weight" and not plus_one
                           else w)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    jv = jax.tree_util.tree_map(np.asarray, variables)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, *jb)))(variables["params"])
    infer = jax.jit(lambda v: jmodel.apply(
        v, jb[0], jb[1], jb[2], jb[3], jb[6], method=jmodel.infer_action))
    tower = jax.jit(lambda v: jmodel.apply(
        v, jb[1], method=lambda m, px: m.vision_model(px)))
    return dict(cfg=cfg, variables=jv, batch=batch,
                state=from_jax_variables(jv), loss=float(loss),
                grads=from_jax_variables({"params": jax.tree_util.tree_map(
                    np.asarray, grads)}),
                actions=np.asarray(infer(variables)),
                tower=np.asarray(tower(variables)))


def _port(setup, impl, remat=False):
    model = TorchVLA(setup["cfg"], compute_dtype=torch.float32, device="cpu",
                     remat=remat, attn_impl=impl)
    return load_state(model, setup["state"])


def _tb(batch):
    return {k: torch.from_numpy(batch[k]) for k in KEYS}


def _counts():
    return tfa.fwd_launch_count, tfa.bwd_launch_count


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_siglip_tower_matches_jax(setup, impl):
    model = _port(setup, impl)
    before = _counts()
    with torch.no_grad():
        got = model.vision_model(_tb(setup["batch"])["pixel_values"])
    assert _counts() == before
    want = setup["tower"]
    assert got.shape == want.shape == (B, setup["cfg"].siglip.num_tokens,
                                       setup["cfg"].siglip.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_infer_action_matches_jax(setup, impl):
    model = _port(setup, impl)
    tb = _tb(setup["batch"])
    before = _counts()
    got = model.infer_action(tb["input_ids"], tb["pixel_values"],
                             tb["text_mask"], tb["proprios"], tb["x0"])
    assert _counts() == before
    want = setup["actions"]
    cfg = setup["cfg"]
    assert got.shape == want.shape == (B, cfg.horizon_steps, cfg.action_dim)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl,remat", ROUTES)
def test_flow_loss_and_gradients_match_jax(setup, impl, remat):
    model = _port(setup, impl, remat)
    tb = _tb(setup["batch"])
    before = _counts()
    loss = model(*(tb[k] for k in KEYS))
    loss.backward()
    assert _counts() == before
    np.testing.assert_allclose(loss.item(), setup["loss"], rtol=TOL)
    want = setup["grads"]
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g, w = got[name].grad, w.numpy()
        if g is None:  # a leaf the loss never reaches (the final vlm norm)
            assert not w.any(), name
            continue
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * np.abs(w).max() + 1e-7,
                                   err_msg=name)


def test_param_groups_match_jax_labels(setup):
    """SigLIP, the projector, embed_tokens and the Gemma mixture train in
    "vlm"; the expert, its norm and the encoders/decoder in "action"."""
    labels = dict(_flatten(j_groups(setup["variables"]["params"], True)))
    labels = {k.replace("patch_embedding.kernel", "patch_embedding.weight"): v
              for k, v in labels.items()}
    got = _vla_param_groups(_port(setup, "reference"), True)
    assert got == labels
    for name in ("vision_model.encoder.self_attn.q_proj.kernel",
                 "vision_model.patch_embedding.weight",
                 "multi_modal_projector.kernel", "embed_tokens.embedding",
                 "joint.layers.vlm.mlp.gate_proj.kernel"):
        assert got[name] == "vlm", name
    for name in ("joint.layers.expert.input_layernorm.weight",
                 "joint.expert_norm.weight", "action_encoder.linear_2.kernel",
                 "proprio_encoder.kernel", "action_decoder.bias"):
        assert got[name] == "action", name


def test_plus_one_norms_start_at_zero_and_fused_paths_refuse():
    """The Gemma layers' RMSNorm weights start at zero (scale 1 + w); the
    fused serving paths (InternViT stacks) refuse the paligemma backbone."""
    from vlaser_tpu_torch.core.config import tiny_paligemma_vla as t_cfg
    from vlaser_tpu_torch.policy.fused_infer import (
        make_batched_infer_action, make_fused_infer_action)

    model = TorchVLA(t_cfg(), device="cpu")
    joint = model.joint.layers
    for norm in (joint.vlm.input_layernorm, joint.expert.post_attention_layernorm):
        assert norm.plus_one and not norm.weight.any()
    assert not model.joint.vlm_norm.plus_one
    for make in (make_fused_infer_action, make_batched_infer_action):
        with pytest.raises(NotImplementedError):
            make(model)
