"""vlaser_tpu_torch fused ViT stack (CPU twin) and InternVisionModel vs the
JAX package on the same weights.

Tolerances: the twin and the JAX Pallas kernel both run bf16 activations
with fp32 statistics, but round at slightly different points and the JAX
kernel uses a polynomial erf and a Cauchy-Schwarz softmax shift -> bf16
level, atol 3e-2. The port's plain encoder vs the JAX XLA encoder in fp32:
atol 1e-4."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.config import VisionConfig
from vlaser_tpu.kernels.fused_vit import fused_vit_stack as jax_stack
from vlaser_tpu.kernels.fused_vit import pack_vit_stack as jax_pack
from vlaser_tpu.models.internvit import InternVisionModel as JaxViT
from vlaser_tpu_torch.kernels import fused_vit
from vlaser_tpu_torch.models.internvit import InternVisionModel
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.utils.convert import from_jax_variables

BF16_ATOL = 3e-2


def _cfg(qk_norm):
    # head_dim 64 (the kernel's), 4x4 patches + CLS = 17 tokens, 3 layers
    return VisionConfig(hidden_size=128, intermediate_size=256, num_layers=3,
                        num_heads=2, image_size=32, patch_size=8,
                        qkv_bias=True, qk_normalization=qk_norm,
                        norm_type="layer_norm")


def _setup(qk_norm, dtype, seed):
    cfg = _cfg(qk_norm)
    jd = getattr(jnp, dtype)
    model = JaxViT(cfg, param_dtype=jd, compute_dtype=jd,
                   attn_impl="reference")
    px = np.random.default_rng(seed).standard_normal(
        (1, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    # every leaf its own numpy draw: norm scales 1 + N(0, 0.1^2), layer
    # scales 0.1 * (1 + N(0, 0.1^2)), the embeddings N(0, 0.03^2) (|x| stays
    # near 1, where bf16 rounding is below the tolerance), everything else
    # N(0, 0.1^2)
    rng = np.random.default_rng(seed + 1)

    def draw(path, s):
        w = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        key = path[-1].key
        if any(getattr(k, "key", None) == "embeddings" for k in path):
            w = w * 0.3
        elif key == "weight":
            w = w + 1.0
        elif key in ("ls1", "ls2"):
            w = 0.1 * (1.0 + w)
        return jnp.asarray(w, s.dtype)

    variables = jax.tree_util.tree_map_with_path(draw, jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(px))))
    td = getattr(torch, dtype)
    port = InternVisionModel(cfg, param_dtype=td, compute_dtype=td)
    load_state(port, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    return cfg, model, variables, port, px


@pytest.mark.parametrize("qk_norm", [False, True])
def test_twin_matches_jax_pallas_kernel(qk_norm):
    cfg, model, variables, port, px = _setup(qk_norm, "bfloat16", 0)
    emb = model.apply(variables, jnp.asarray(px), method=model.embed)
    want = jax_stack(emb[0].astype(jnp.bfloat16), **jax_pack(variables),
                     num_heads=cfg.num_heads, eps=cfg.layer_norm_eps,
                     qk_norm=qk_norm, interpret=True)
    temb = port.embed(torch.from_numpy(px))
    np.testing.assert_allclose(temb.detach().float().numpy(),
                               np.asarray(emb, np.float32), atol=BF16_ATOL)
    before = fused_vit.launch_count
    got = fused_vit.fused_vit_stack(
        temb[0].to(torch.bfloat16), **fused_vit.pack_vit_stack(port),
        num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, qk_norm=qk_norm)
    assert fused_vit.launch_count == before  # CPU tensors take the twin
    assert got.dtype == torch.bfloat16 and got.shape == temb[0].shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=BF16_ATOL)
    # the stack moves x far beyond the tolerance, so a dropped branch shows
    change = np.abs(np.asarray(want, np.float32) - np.asarray(emb[0],
                                                               np.float32))
    assert change.max() > 10 * BF16_ATOL


@pytest.mark.parametrize("qk_norm", [False, True])
def test_plain_encoder_matches_jax_fp32(qk_norm):
    """Port's plain layer loop vs the JAX XLA encoder, both fp32: 1e-4; and
    the bf16 twin stays within bf16 level of the same fp32 reference."""
    cfg, model, variables, port, px = _setup(qk_norm, "float32", 2)
    want = np.asarray(model.apply(variables, jnp.asarray(px)))
    got = port(torch.from_numpy(px)).detach()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    emb = port.embed(torch.from_numpy(px))
    twin = fused_vit.fused_vit_stack_plain(
        emb[0].to(torch.bfloat16), **fused_vit.pack_vit_stack(port),
        num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, qk_norm=qk_norm)
    np.testing.assert_allclose(twin.float().numpy(), want[0],
                               atol=BF16_ATOL)


def test_batched_twin_matches_per_sample():
    """B=2 through the twin equals each sample alone (no cross-talk): up
    to bf16 rounding flips from a different matmul blocking, atol 1e-2."""
    cfg, _, _, port, _ = _setup(True, "bfloat16", 4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 17, cfg.hidden_size)).astype(np.float32)).to(torch.bfloat16)
    stack = fused_vit.pack_vit_stack(port)
    kw = dict(num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, qk_norm=True)
    both = fused_vit.fused_vit_stack(x, **stack, **kw)
    for b in range(2):
        one = fused_vit.fused_vit_stack(x[b], **stack, **kw)
        np.testing.assert_allclose(both[b].float().numpy(),
                                   one.float().numpy(), atol=1e-2, rtol=0)


def test_w8a8_mode_waits():
    cfg, _, _, port, _ = _setup(False, "bfloat16", 6)
    with pytest.raises(NotImplementedError):
        fused_vit.fused_vit_stack(
            torch.zeros(17, cfg.hidden_size, dtype=torch.bfloat16),
            **fused_vit.pack_vit_stack(port), act_quant=True)
    assert fused_vit.supports_fused_vit(replace(cfg, qkv_bias=True))
    assert not fused_vit.supports_fused_vit(replace(cfg, norm_type="rms_norm"))
