"""vlaser_tpu_torch/core/quant.py vs vlaser_tpu/core/quant.py: the int8
weights and scales are bit-exact for kernels and embeddings (as the JAX
package computes them, under jit), and quantize_for_serving quantizes the
same leaves of the chat model for both targets and both modes, with the
same default target ("vlm")."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.quant import quantize_for_serving as jax_serving
from vlaser_tpu.core.quant import quantize_int8 as jq
from vlaser_tpu_torch.core.quant import quantize_for_serving, quantize_int8


@pytest.mark.parametrize("kind,shape,axis", [
    ("kernel", (3, 48, 80), -2),          # stacked [L, in, out] -> [L, 1, out]
    ("embedding", (257, 64), -1),         # [V, H] -> [V, 1]
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bit_exact(kind, shape, axis, dtype):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.05).astype(
        np.float32)
    w[..., 0] = 0.0  # an all-zero column/row hits the 1e-12 floor
    jw = jnp.asarray(w).astype(dtype)
    want_q, want_s = jax.jit(lambda a: jq(a, reduce_axis=axis))(jw)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    q, s = quantize_int8(tw, reduce_axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


def test_quantize_for_serving_modes():
    """w8a8 is the default mode (as in the JAX package): the joint
    mixtures, the embedding and the ViT encoder go int8, the mixtures and
    the encoder with the kernel_aq flag; "int8" is weight-only with no
    flags; unknown modes and targets raise. On the VLA the "vlm" target
    (the default) takes every scanned layer kernel ("layers/"), as the JAX
    patterns do."""
    from vlaser_tpu.core.config import tiny_vla
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA

    def fresh():
        model = PiZeroVLA(tiny_vla(), compute_dtype=torch.float32,
                          device="cpu")
        g = torch.Generator().manual_seed(0)
        for t in model.state_dict().values():
            t.normal_(generator=g)
        return model

    model = fresh()
    with pytest.raises(ValueError):
        quantize_for_serving(model, target="policy", mode="int4")
    with pytest.raises(ValueError):
        quantize_for_serving(model, target="robot")
    vlm = set(quantize_for_serving(fresh(), target="vlm",
                                   mode="int8").state_dict())
    assert {"joint.layers.vlm.q_proj.kernel_q",
            "embed_tokens.embedding_q"} <= vlm
    assert not any(n.endswith("kernel_aq") for n in vlm)
    quantize_for_serving(model, target="policy", mode="int8")
    names = set(model.state_dict())
    # the vlm mixture's kernels and the embedding pass the 4096 floor;
    # the ViT encoder is never matched
    assert "joint.layers.vlm.mlp.gate_proj.kernel_q" in names
    assert "embed_tokens.embedding_q" in names
    assert "vision_model.encoder.attn.qkv.kernel" in names
    assert not any(n.endswith("kernel_aq") for n in names)
    # tiny expert kernels fall under the floor and stay float
    assert "joint.layers.expert.k_proj.kernel" in names
    # already quantized: passes through unchanged
    before = model.state_dict()
    quantize_for_serving(model, target="policy")
    assert model.state_dict().keys() == before.keys()

    model = quantize_for_serving(fresh(), target="policy", min_size=1)
    names = set(model.state_dict())
    for site in ("joint.layers.vlm.q_proj", "joint.layers.expert.k_proj",
                 "vision_model.encoder.attn.qkv",
                 "vision_model.encoder.mlp.fc2"):
        assert {f"{site}.kernel_q", f"{site}.kernel_aq"} <= names, site
    assert "embed_tokens.embedding_q" in names
    assert "mlp1.fc1.kernel" in names  # the ViT projector stays float
    assert model.joint.layers.vlm.q_proj.kernel_aq.shape == (2, 1)


@functools.lru_cache(maxsize=1)
def _tiny_chat_variables():
    """The JAX tiny chat model's float variables (built once)."""
    from vlaser_tpu.core.config import tiny_vlm
    from vlaser_tpu.models.vlm import InternVLChatModel as JaxModel

    cfg = tiny_vlm()
    img = cfg.vision.image_size
    return cfg, JaxModel(cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
        jnp.zeros((1, img, img, 3)), None)


@pytest.mark.parametrize("kw", [
    {},  # the defaults: target "vlm", mode "w8a8"
    dict(target="vlm", mode="w8a8"),
    dict(target="vlm", mode="int8"),
    dict(target="policy", mode="w8a8"),
    dict(target="policy", mode="int8"),
], ids=["default", "vlm-w8a8", "vlm-int8", "policy-w8a8", "policy-int8"])
def test_serving_tree_of_the_chat_model_is_bit_exact(kw):
    """The same tiny chat model quantized by both packages with the same
    arguments: the same leaves are quantized and flagged, bit for bit. With
    no target, the port quantizing for "policy" (its default before the
    chat slice) would leave every LLM layer float and fail here."""
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.utils.convert import from_jax_variables

    cfg, variables = _tiny_chat_variables()
    numpy = lambda v: jax.tree_util.tree_map(np.asarray, v)
    model = InternVLChatModel(cfg, device="cpu")
    load_state(model, from_jax_variables(numpy(variables)))
    want = from_jax_variables(numpy(jax_serving(variables, **kw)))
    got = quantize_for_serving(model, **kw).state_dict()
    assert sorted(got) == sorted(want)
    assert any(k.endswith(("kernel_q", "embedding_q")) for k in want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
