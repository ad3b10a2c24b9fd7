"""vlaser_tpu_torch w8a8 (kernels/w8a8.py, models/layers.py) vs the JAX
package's `w8a8_dot` and w8a8 Dense on the same numpy inputs.

Tolerances: the int8 activation rows must be identical (a flipped rounding
is a wrong kernel, not noise); the products are exact integers on both
sides and the rescale runs in the same order, so y is held to one fp32
rounding (rtol 2^-23). The weight-only Dense and the STE backward are fp32
matmuls summed in another order: atol 1e-5, rtol 1e-5. The port's GEMM
takes its weight K-major ([N, K], the JAX [K, N] kernel transposed); JAX is
handed the [K, N] kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.quant import quantize_variables
from vlaser_tpu.models.layers import ACT_QUANT_MIN_ROWS as JAX_MIN_ROWS
from vlaser_tpu.models.layers import Dense as JaxDense
from vlaser_tpu.models.layers import w8a8_dot as jax_w8a8_dot
from vlaser_tpu_torch.core.quant import quantize_int8
from vlaser_tpu_torch.kernels import w8a8
from vlaser_tpu_torch.models.layers import (ACT_QUANT_MIN_ROWS, Dense,
                                            load_state, w8a8_dot)
from vlaser_tpu_torch.utils.convert import from_jax_variables

ULP = 2.0 ** -23


def _tie_rows(K):
    """Row 0: max 127 (so 127 / amax = 1) and exact .5 ties elsewhere, where
    half-away-from-zero rounding differs from half-to-even."""
    row = (np.arange(K) % 120 - 60 + 0.5).astype(np.float32)
    row[0] = 127.0
    return row


def _inputs(M, K, N, dtype, seed=0):
    """-> (x, kq int8 [K, N] (the JAX layout), ks [1, N])."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0] = _tie_rows(K)
    x[1] = 0.0  # an all-zero row hits the 1e-9 floor
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    kq, ks = quantize_int8(torch.from_numpy(w), reduce_axis=-2)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    return xt, kq, ks


def _kmajor(kq):
    return kq.t().contiguous()


def _jax_rows(xt):
    """JAX's int8 rows, read back through w8a8_dot with an identity
    weight: y = q * (amax / 127) exactly, so round(y / (amax / 127)) = q."""
    K = xt.shape[-1]
    jx = jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if xt.dtype == torch.bfloat16 else jnp.float32)
    y = np.asarray(jax.jit(jax_w8a8_dot)(jx, jnp.eye(K, dtype=jnp.int8),
                                         jnp.ones((1, K), jnp.float32)))
    am = np.maximum(np.abs(np.asarray(jx, np.float32)).max(-1, keepdims=True),
                    1e-9)
    return np.round(y / (am * np.float32(1.0 / 127.0))).astype(np.int8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_equal_jax_rows(dtype):
    xt, _, _ = _inputs(40, 256, 16, dtype)
    q, am = w8a8.quantize_rows(xt)
    want = _jax_rows(xt)
    np.testing.assert_array_equal(q.numpy(), want)
    assert am[1].item() == pytest.approx(1e-9) and (q[1] == 0).all()
    # the control: half-away-from-zero rounding breaks row 0
    v = xt.float() * (torch.full_like(am, 127.0) / am)
    away = (torch.sign(v) * torch.floor(v.abs() + 0.5)).to(torch.int8)
    assert not np.array_equal(away[0].numpy(), want[0])
    np.testing.assert_array_equal(away[2:].numpy(), want[2:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_dot_matches_jax(dtype):
    xt, kq, ks = _inputs(130, 192, 48, dtype, seed=1)
    jx = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    want = np.asarray(jax.jit(jax_w8a8_dot)(jx, jnp.asarray(kq.numpy()),
                                            jnp.asarray(ks.numpy())))
    kt = _kmajor(kq)
    before = (w8a8.quant_launch_count, w8a8.gemm_launch_count)
    got = w8a8_dot(xt, kt, ks).numpy()
    assert (w8a8.quant_launch_count, w8a8.gemm_launch_count) == before
    np.testing.assert_allclose(got, want, rtol=ULP, atol=0)
    assert torch.equal(w8a8.w8a8_dot_plain(xt, kt, ks), torch.from_numpy(got))
    # the bf16 output is the fp32 one rounded once
    got_bf = w8a8_dot(xt, kt, ks, out_dtype=torch.bfloat16)
    assert torch.equal(got_bf, torch.from_numpy(got).to(torch.bfloat16))
    # controls: a dropped row or column scale is far outside the bound
    q, am = w8a8.quantize_rows_plain(xt)
    for wrong in (w8a8.int8_gemm_plain(q, torch.full_like(am, 127.0), kt, ks),
                  w8a8.int8_gemm_plain(q, am, kt, torch.ones_like(ks))):
        assert np.abs(wrong.numpy() - want).max() > 1e3 * ULP * np.abs(
            want).max()


def test_w8a8_dot_ste_backward_matches_jax():
    xt, kq, ks = _inputs(20, 64, 32, "float32", seed=2)
    g = np.random.default_rng(3).standard_normal((20, 32)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_w8a8_dot(a, jnp.asarray(kq.numpy()),
                                            jnp.asarray(ks.numpy())),
                     jnp.asarray(xt.numpy()))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    x = xt.clone().requires_grad_()
    w8a8_dot(x, _kmajor(kq), ks).backward(torch.from_numpy(g))
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.abs(want).max() > 0.1  # the gradient is not cut


def test_dense_row_threshold_matches_jax():
    """kernel_aq-flagged Dense: w8a8 at >= 128 rows (within one fp32
    rounding of JAX's, and away from weight-only), weight-only and equal to
    the unflagged Dense below 128 rows; as tests/test_quant.py holds the
    JAX Dense."""
    assert ACT_QUANT_MIN_ROWS == JAX_MIN_ROWS == 128
    rng = np.random.default_rng(11)
    x_big = rng.standard_normal((2, 64, 64)).astype(np.float32)  # 128 rows
    x_small = x_big[:1]  # 64 rows
    jd = JaxDense(features=96, compute_dtype=jnp.float32)
    variables = jd.init(jax.random.PRNGKey(0), jnp.asarray(x_big))
    jv = quantize_variables(variables, (r"kernel$",),
                            act_quant_patterns=(r"kernel$",))
    port = Dense(64, 96, compute_dtype=torch.float32)
    load_state(port, from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                               jv)))
    assert port.kernel_aq.dtype == torch.int8 and port.kernel_aq.shape == (1,)
    plain = Dense(64, 96, compute_dtype=torch.float32)
    wo = quantize_variables(variables, (r"kernel$",))
    load_state(plain, from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                                wo)))
    for x, w8 in ((x_big, True), (x_small, False)):
        want = np.asarray(jd.apply(jv, jnp.asarray(x)))
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
            weight_only = plain(torch.from_numpy(x)).numpy()
        if w8:
            np.testing.assert_allclose(got, want, rtol=ULP, atol=1e-7)
            assert not np.allclose(got, weight_only, atol=1e-7)
            np.testing.assert_allclose(got, weight_only, atol=0.05)
        else:  # fp32 matmuls summed in another order: atol 1e-5
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
            np.testing.assert_array_equal(got, weight_only)
