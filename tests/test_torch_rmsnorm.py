"""The port's RMSNorm (vlaser_tpu_torch.kernels.rmsnorm) against the JAX
Pallas kernel run in interpret mode, on numpy-seeded fp32 inputs: y, rrms,
dx and dw, with a row count that is not a multiple of the kernel's block.

Tolerance: fp32 on both sides, summation order only -> rtol 1e-5 /
atol 1e-6 (y, rrms), rtol 1e-4 / atol 1e-5 (dx, dw: dw sums 37 rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.kernels import rmsnorm as jrms
from vlaser_tpu_torch.kernels import ops
from vlaser_tpu_torch.kernels import rmsnorm as trms

N, H, BLOCK, EPS = 37, 64, 8, 1e-6


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, H)).astype(np.float32),
            (1 + 0.1 * rng.standard_normal(H)).astype(np.float32),
            rng.standard_normal((N, H)).astype(np.float32))


def test_rms_fwd_bwd_match_pallas_interpret():
    x, w, g = _inputs()
    j_y, j_rrms = jrms._rms_fwd(jnp.asarray(x), jnp.asarray(w), EPS, BLOCK,
                                True)
    j_dx, j_dw = jrms._rms_bwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g),
                               j_rrms, BLOCK, True)
    before = (trms.fwd_launch_count, trms.bwd_launch_count)
    t_y, t_rrms = trms.rms_fwd(torch.from_numpy(x), torch.from_numpy(w), EPS)
    t_dx, t_dw = trms.rms_bwd(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(g), t_rrms)
    assert (trms.fwd_launch_count, trms.bwd_launch_count) == before
    assert t_rrms.shape == (N, 1) and t_rrms.dtype == torch.float32
    np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t_rrms.numpy(), np.asarray(j_rrms), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t_dx.numpy(), np.asarray(j_dx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t_dw.numpy(), np.asarray(j_dw), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_rms_norm_vjp_matches_jax_fused_vjp(impl):
    """Both port routes (the autograd Function and autograd through the
    reference) against the VJP of JAX's fused_rms_norm(interpret=True)."""
    x, w, g = _inputs(1)
    x3 = x.reshape(1, N, H)
    j_y, vjp = jax.vjp(lambda a, b: jrms.fused_rms_norm(a, b, EPS, BLOCK, True),
                       jnp.asarray(x3), jnp.asarray(w))
    j_dx, j_dw = vjp(jnp.asarray(g.reshape(1, N, H)))
    tx = torch.from_numpy(x3).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = trms.rms_norm(tx, tw, EPS, impl=impl)
    y.backward(torch.from_numpy(g.reshape(1, N, H)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j_y),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_dx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(j_dw), rtol=1e-4,
                               atol=1e-5)


def test_auto_keeps_cpu_tensors_on_the_reference():
    """rows >= 2048 on the CPU: auto still takes ops.rms_norm (the JAX
    dispatch's CPU choice), bit for bit."""
    x = torch.randn(2048, 16, generator=torch.Generator().manual_seed(0))
    w = torch.ones(16)
    before = trms.fwd_launch_count
    assert torch.equal(trms.rms_norm(x, w), ops.rms_norm(x, w))
    assert trms.fwd_launch_count == before
