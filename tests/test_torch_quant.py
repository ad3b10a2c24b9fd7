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
    from vlaser_tpu.core.config import tiny_vla
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA

    model = PiZeroVLA(tiny_vla(), compute_dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        quantize_for_serving(model, target="policy", mode="w8a8")
    with pytest.raises(ValueError):
        quantize_for_serving(model, target="policy", mode="int4")
    with pytest.raises(NotImplementedError):  # waits for the chat slice
        quantize_for_serving(model, target="vlm", mode="int8")
    for buf in model.buffers():
        buf.normal_(generator=torch.Generator().manual_seed(0))
    quantize_for_serving(model, target="policy", mode="int8")
    names = {n for n, _ in model.named_buffers()}
    # the vlm mixture's kernels and the embedding pass the 4096 floor;
    # the ViT encoder is never matched
    assert "joint.layers.vlm.mlp.gate_proj.kernel_q" in names
    assert "embed_tokens.embedding_q" in names
    assert "vision_model.encoder.attn.qkv.kernel" in names
    # tiny expert kernels fall under the floor and stay float
    assert "joint.layers.expert.k_proj.kernel" in names
    # already quantized: passes through unchanged
    before = dict(model.named_buffers())
    quantize_for_serving(model, target="policy", mode="int8")
    assert dict(model.named_buffers()).keys() == before.keys()
