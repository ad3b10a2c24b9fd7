"""The ViT's bicubic position-embedding interpolation in the port
(kernels/ops.bicubic_resize_matrix / bicubic_resize_2d, models/internvit's
embeddings) against the JAX package, at a grid smaller and one larger than
the config's: the interpolation matrices bit for bit, the resized grid and
the encoder's output within fp32 summation order (1e-5), the resize against
PyTorch's own bicubic (a = -0.75, align_corners=False) as the JAX package
claims it; and the fused serving ViT (its CPU twin), which takes the same
embeddings from `vit_embed`, against the layer loop at such a grid."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vlaser_tpu.kernels import ops as jops
from vlaser_tpu.models.internvit import InternVisionModel as JaxViT
from vlaser_tpu_torch.core.config import tiny_vision, tiny_vla
from vlaser_tpu_torch.kernels import ops
from vlaser_tpu_torch.models.internvit import InternVisionModel
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.utils.convert import from_jax_variables

from test_torch_qwen3 import draw_variables, jax_cfg

TOL = 1e-5


@pytest.mark.parametrize("n_in,n_out", [(4, 2), (4, 7), (32, 16), (16, 32)])
def test_resize_matrix_is_the_jax_packages(n_in, n_out):
    np.testing.assert_array_equal(ops.bicubic_resize_matrix(n_in, n_out),
                                  jops.bicubic_resize_matrix(n_in, n_out))


@pytest.mark.parametrize("out", [(2, 3), (7, 6)])
def test_resize_2d_matches_jax_and_torch_bicubic(out):
    grid = np.random.default_rng(0).standard_normal((2, 4, 5, 8)).astype(
        np.float32)
    got = ops.bicubic_resize_2d(torch.from_numpy(grid), *out)
    want = jops.bicubic_resize_2d(jnp.asarray(grid), *out)
    assert got.dtype == torch.float32 and got.shape == (2, *out, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    lib = F.interpolate(torch.from_numpy(grid).permute(0, 3, 1, 2), size=out,
                        mode="bicubic", align_corners=False)
    np.testing.assert_allclose(got.numpy(), lib.permute(0, 2, 3, 1).numpy(),
                               atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def vit():
    """tiny_vision at 56 px (a 4 x 4 patch grid), numpy-drawn weights."""
    cfg = tiny_vision(image_size=56)
    jm = JaxViT(jax_cfg(cfg), compute_dtype=jnp.float32,
                attn_impl="reference")
    v = draw_variables(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 56, 56, 3))),
                       np.random.default_rng(2))
    tm = InternVisionModel(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables(jax.tree_util.tree_map(np.asarray, v)))
    return cfg, jm, v, tm


@pytest.mark.parametrize("px", [28, 84])  # grids of 2 x 2 and 6 x 6
def test_interpolated_embeddings_and_encoder_match_jax(vit, px):
    cfg, jm, v, tm = vit
    x = np.random.default_rng(px).standard_normal((2, px, px, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(x))
    with torch.no_grad():
        emb = tm.embed(torch.from_numpy(x))
        got = tm(torch.from_numpy(x))
    n = (px // cfg.patch_size) ** 2
    assert emb.shape == got.shape == (2, 1 + n, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # the CLS row keeps its own embedding; the patches' are the resized grid
    e = tm.embeddings
    with torch.no_grad():
        pos, side = e.position_embedding, cfg.num_patches_per_side
        grid = ops.bicubic_resize_2d(pos[:, 1:].reshape(1, side, side, -1),
                                     px // cfg.patch_size,
                                     px // cfg.patch_size)
        patch = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                         e.patch_embedding.weight, stride=cfg.patch_size)
        patch = patch.permute(0, 2, 3, 1) + e.patch_embedding.bias
        want_patches = patch.reshape(2, n, -1) + grid.reshape(1, n, -1)
        want_cls = (e.class_embedding[0] + pos[:, 0]).expand(2, -1)
    np.testing.assert_allclose(emb[:, 1:].numpy(), want_patches.numpy(),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(emb[:, 0].numpy(), want_cls.numpy(), atol=TOL,
                               rtol=TOL)


def test_fused_vit_takes_the_interpolated_embeddings():
    """The fused serving ViT (kernels.fused_vit, its CPU twin) runs on
    `vit_embed`'s output: a 28 px tile into a 56 px config's VLA gives the
    layer loop's hidden states (bf16 twin: 2e-2 of max |hidden|)."""
    from vlaser_tpu_torch.inference.fused_runner import fused_visual_features
    from vlaser_tpu_torch.kernels.fused_vit import (fused_vit_stack,
                                                    pack_vit_stack)
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.models.vlm import InternVLChatModel

    vcfg = tiny_vision(image_size=56)
    cfg = dataclasses.replace(tiny_vla().vlm, vision=vcfg)
    model = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu")
    init_normal_(model, torch.Generator().manual_seed(3), std=0.1)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 28, 28, 3)).astype(np.float32))
    with torch.no_grad():
        emb = model.vit_embed(x)
        got = fused_vit_stack(emb.to(torch.bfloat16), **pack_vit_stack(
            model.vision_model), num_heads=vcfg.num_heads,
            eps=vcfg.layer_norm_eps, qk_norm=vcfg.qk_normalization).float()
        want = model.vision_model(x)
        feats = fused_visual_features(model, x)
    assert got.shape == want.shape == (1, 5, vcfg.hidden_size)
    bound = 2e-2 * want.abs().max().item()
    assert (got - want).abs().max().item() <= bound
    assert feats.shape == (1, 1, cfg.llm.hidden_size)
