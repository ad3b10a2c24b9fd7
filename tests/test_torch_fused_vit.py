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
from vlaser_tpu.core.quant import VIT_W8A8_PATTERNS, quantize_variables
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
    """The w8a8 mode no longer waits: an int8 encoder packs to act_quant
    and its CPU twin runs; a partly quantized one packs to bf16."""
    cfg, _, variables, port, _ = _setup(False, "bfloat16", 6)
    stack = fused_vit.pack_vit_stack(port)
    assert "act_quant" not in stack and stack["qkvw"].dtype == torch.bfloat16
    q_port = InternVisionModel(cfg, param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    load_state(q_port, _w8a8_state(variables))
    stack = fused_vit.pack_vit_stack(q_port)
    assert stack.pop("act_quant") is True
    assert stack["qkvw"].dtype == torch.int8
    assert stack["qkvs"].shape == (cfg.num_layers, 3 * cfg.hidden_size)
    before = (fused_vit.launch_count, fused_vit.act_quant_launch_count)
    out = fused_vit.fused_vit_stack(
        torch.ones(17, cfg.hidden_size, dtype=torch.bfloat16), **stack,
        act_quant=True)
    assert out.shape == (17, cfg.hidden_size) and torch.isfinite(
        out.float()).all()
    assert (fused_vit.launch_count, fused_vit.act_quant_launch_count) == before
    assert fused_vit.supports_fused_vit(replace(cfg, qkv_bias=True))
    assert not fused_vit.supports_fused_vit(replace(cfg, norm_type="rms_norm"))


def _w8a8_state(variables):
    """The JAX w8a8 serving quantization of the encoder (min_size 1: the
    tiny kernels would fall under the 4096 floor) as the port's state."""
    return from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                     _w8a8_vars(variables)))


def _w8a8_vars(variables):
    return quantize_variables(variables, VIT_W8A8_PATTERNS,
                              act_quant_patterns=VIT_W8A8_PATTERNS,
                              min_size=1)


@pytest.mark.parametrize("B,spread", [(1, 1.0), (2, 40.0)])
def test_act_quant_twin_matches_jax_pallas_kernel(B, spread):
    """The act_quant stack: the port's twin vs the JAX kernel (interpret
    mode) on the same int8 weights. bf16 level as above, atol 3e-2. At
    B = 2 fc2 quantizes its input in two halves of `inter`: the fc1
    columns of the second half are scaled up 40x (fc2's rows down 40x) so
    that one group for the whole row (the B = 1 rule) would crush the first
    half; that control must miss JAX by more than the tolerance. (At B = 1
    both sides use one group, and such a spread would let a last-bit
    difference upstream flip the crushed first half: B = 1 runs without
    it.)"""
    cfg, model, variables, _, _ = _setup(False, "bfloat16", 8)
    half = cfg.intermediate_size // 2
    mlp = variables["params"]["encoder"]["mlp"]
    for name in ("kernel", "bias"):
        mlp["fc1"][name] = mlp["fc1"][name].at[..., half:].multiply(spread)
    mlp["fc2"]["kernel"] = mlp["fc2"]["kernel"].at[:, half:].multiply(
        1 / spread)  # the MLP's output keeps its size
    qvars = _w8a8_vars(variables)
    px = np.random.default_rng(9).standard_normal(
        (B, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    emb = model.apply(variables, jnp.asarray(px), method=model.embed)
    jstack = jax_pack(qvars)
    assert jstack.get("act_quant") is True
    kw = dict(num_heads=cfg.num_heads, eps=cfg.layer_norm_eps, qk_norm=False)
    x = emb.astype(jnp.bfloat16)
    want = np.asarray(jax_stack(x if B > 1 else x[0], **jstack, **kw,
                                interpret=True), np.float32)
    port = InternVisionModel(cfg, param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16)
    load_state(port, _w8a8_state(variables))
    stack = fused_vit.pack_vit_stack(port)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    xt = xt if B > 1 else xt[0]
    got = fused_vit.fused_vit_stack(xt, **stack, **kw).float().numpy()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL)
    assert np.abs(want - np.asarray(x if B > 1 else x[0],
                                    np.float32)).max() > 10 * BF16_ATOL
    if B > 1:
        groups = fused_vit._fc2_groups
        fused_vit._fc2_groups = lambda b: 1
        try:
            one_group = fused_vit.fused_vit_stack(xt, **stack, **kw)
        finally:
            fused_vit._fc2_groups = groups
        assert np.abs(one_group.float().numpy() - want).max() > BF16_ATOL


def test_plain_encoder_w8a8_matches_jax():
    """The plain encoder (the oracle of the act_quant stack) on the w8a8
    tree at 8 x 17 = 136 rows, past the 128-row threshold, so each of its
    Dense calls runs w8a8_dot; fp32 on both sides. An int8 activation that
    rounds the other way after a last-bit difference upstream moves an
    output by ~1/127 of one term: atol 2e-3."""
    cfg, model, variables, _, _ = _setup(False, "float32", 10)
    qvars = _w8a8_vars(variables)
    px = np.random.default_rng(11).standard_normal(
        (8, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    want = np.asarray(model.apply(qvars, jnp.asarray(px)))
    port = InternVisionModel(cfg, compute_dtype=torch.float32)
    load_state(port, _w8a8_state(variables))
    assert "kernel_aq" in port.encoder.mlp.fc1._buffers
    with torch.no_grad():
        got = port(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    weight_only = np.asarray(model.apply(
        quantize_variables(variables, VIT_W8A8_PATTERNS, min_size=1),
        jnp.asarray(px)))
    assert np.abs(want - weight_only).max() > 5 * 2e-3  # w8a8 ran


def _bf16_np(x):
    """float32 -> the nearest bf16 value (round half to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + (((u >> 16) & 1) + 0x7FFF)) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _shifted_attention_np(q, k, v, S, Sp):
    """A numpy transcription of the TPU kernel's attention for one sample
    (fused_vit.py:270-281, 374-381): keys padded to Sp rows that are zeroed
    (vmask), the Cauchy-Schwarz shift per head, e = bf16(exp2(s - m)), d =
    sum e - npad * 2^-m in closed form, o = (e . v) * (1 / d). q/k/v [S,
    heads, D] float32 (bf16 values) -> o [heads, S, D] float32."""
    heads, D = q.shape[1], q.shape[2]
    npad = Sp - S
    pad = lambda t: np.concatenate([t, np.zeros((npad, heads, D),
                                                np.float32)])
    ks, vs = pad(k), pad(v)
    out = np.zeros((heads, S, D), np.float32)
    for h in range(heads):
        qh, kh, vh = q[:, h], ks[:, h], vs[:, h]
        s = (qh @ kh.T).astype(np.float32)
        qn = np.sum(qh * qh, axis=-1, keepdims=True, dtype=np.float32)
        kn = np.max(np.sum(kh * kh, axis=-1, keepdims=True, dtype=np.float32))
        m = np.sqrt(qn * kn + np.float32(1e-12)).astype(np.float32)
        e = _bf16_np(np.exp2(s - m).astype(np.float32))
        d = np.sum(e, axis=-1, keepdims=True, dtype=np.float32)
        if npad:
            d = d - np.float32(npad) * np.exp2(-m).astype(np.float32)
        out[h] = (e @ vh).astype(np.float32) * (np.float32(1.0) / d)
    return out


@pytest.mark.parametrize("B,S", [(1, 37), (2, 37)])
def test_shifted_attention_matches_numpy_transcription(B, S):
    """The twin's attention (fp32, before its bf16 rounding) against the
    numpy transcription of the TPU kernel on a ragged S: 37 keys, padded to
    48 on the TPU side, whose closed form removes the 11 zeroed tail keys
    that the twin never has. q and k at 4x a unit draw (multiples of 1/2 in
    [-1.5, 1.5], so every score is exact in fp32), each key near its own
    query as a token's q and k are (then the 11 pads' bf16 rounding in the
    closed form is ~2^-30 of d): atol 1e-6."""
    rng = np.random.default_rng(20 + B)
    heads, D = 2, 64
    draw = lambda lo, hi: (4 * rng.integers(lo, hi, (B, S, heads, D))
                           / 8).astype(np.float32)
    q = draw(-2, 3)
    k = q + draw(-1, 2)
    v = _bf16_np(rng.uniform(-1, 1, (B, S, heads, D)).astype(np.float32))
    want = np.stack([_shifted_attention_np(q[b], k[b], v[b], S, 48)
                     for b in range(B)])
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = fused_vit.shifted_attention(tq, tk, tv).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    bf = torch.bfloat16
    flat = lambda t: t.reshape(B * S, heads * D).to(bf)
    twin = fused_vit._attention(flat(tq), flat(tk), flat(tv), B, S, heads)
    want_rows = want.transpose(0, 2, 1, 3).reshape(B * S, heads * D)
    # the bf16 rounding of the output: within one bf16 step
    np.testing.assert_allclose(twin.float().numpy(), want_rows,
                               atol=2.0 ** -8 * np.abs(want).max(), rtol=0)


def test_shift_falls_back_to_the_row_max_where_the_bound_underflows():
    """A row whose largest score lies far below the norm bound (q long and
    orthogonal to the long keys): the TPU kernel's exponents all underflow
    there (d = 0, a NaN row in the numpy transcription), and the twin
    shifts that row by its largest score instead: finite, and the softmax
    of the scores (bf16 exponents: atol 1e-2). The other rows keep the
    bound (equal to the transcription at 1e-6)."""
    S, heads, D = 6, 1, 64
    q = np.zeros((1, S, heads, D), np.float32)
    k = np.zeros((1, S, heads, D), np.float32)
    q[0, 0, 0, 0] = 32.0        # row 0: long, along dim 0
    k[0, :, 0, 1] = 32.0        # every key long along dim 1 (bound 1024)
    k[0, 1, 0, 0] = 0.25        # one key with a small score for row 0
    q[0, 1:, 0, 1] = 0.125      # rows 1..5 see the long keys (in range)
    v = _bf16_np(np.random.default_rng(3).uniform(-1, 1, (1, S, heads, D))
                 .astype(np.float32))
    want = _shifted_attention_np(q[0], k[0], v[0], S, S)
    assert not np.isfinite(want[0, 0]).all()  # the reference design's row
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = fused_vit.shifted_attention(tq, tk, tv).numpy()[0]
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=1e-6, rtol=0)
    s = q[0, 0, 0] @ k[0, :, 0].T  # row 0's scores (log2 domain)
    p = np.exp2(s - s.max())
    np.testing.assert_allclose(got[0, 0], p @ v[0, :, 0] / p.sum(),
                               atol=1e-2, rtol=0)
