"""vlaser_tpu_torch/core/quant.py vs vlaser_tpu/core/quant.py: the int8
weights and scales are bit-exact for kernels and embeddings (as the JAX
package computes them, under jit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    flags; unknown modes and targets raise, "vlm" waits for the chat
    slice."""
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
    with pytest.raises(NotImplementedError):  # waits for the chat slice
        quantize_for_serving(model, target="vlm", mode="int8")
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
