"""The port's flash attention (vlaser_tpu_torch.kernels.flash_attention)
against the JAX Pallas kernels run in interpret mode, on the same
numpy-seeded fp32 inputs: forward (out, lse) and backward (dq, dk, dv),
including the Gemma softcap (q and k drawn so that the logits' std is ~50,
where the cap bites), the causal sliding window and head dims 72 (SigLIP)
and 256 (Gemma; its logits' std is ~4 there: at 256-term dot products of
that size the Pallas kernel's own fp32 error passes the tolerance).

Tolerance: both sides compute in fp32 and differ only in summation order
(the Pallas kernel runs an online softmax over key blocks), so
rtol 1e-4 / atol 2e-5."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.kernels import flash_attention as jfa
from vlaser_tpu_torch.kernels import flash_attention as tfa

RTOL, ATOL = 1e-4, 2e-5


def _levels(B, S):
    """[img/text 0..29 (26..29 padding) | proprio 30 | action 31..34 | pad]
    -> (segments, levels)."""
    seg = np.ones((B, S), np.int32)
    seg[:, 26:30] = 0
    seg[:, 35:] = 0
    lev = np.zeros((B, S), np.int32)
    lev[:, 30] = 1
    lev[:, 31:35] = 2
    return seg, lev


def _case(name):
    """-> (q, k, v, dout, q_seg, kv_seg, q_lev, kv_lev, q_offset, causal,
    softcap, window)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    B, Sq, Skv, H, KVH, D = 2, 48, 48, 4, 2, 32
    q_offset, causal, softcap, window, gain = 0, False, None, None, 1.0
    q_seg = np.ones((B, Sq), np.int32)
    kv_seg = None
    q_lev = kv_lev = None
    if name in ("softcap", "head_dim_256"):
        # the joint's mask and cap; q, k x sqrt(50): the logits' std ~50
        q_seg, q_lev = _levels(B, Sq)
        kv_lev, softcap, gain = q_lev, 50.0, 50.0 ** 0.5
        if name == "head_dim_256":
            H, KVH, D, gain = 4, 1, 256, 2.0
    elif name == "head_dim_72":  # SigLIP: non-causal, no GQA
        KVH, D = 4, 72
    elif name == "window":  # causal over two segments, a padded tail
        causal, window = True, 10
        q_seg[:, 20:36] = 2
        q_seg[:, 44:] = 0
    elif name == "window_q_offset":
        Sq, q_offset, causal, window = 16, 32, True, 7
        q_seg = np.ones((B, Sq), np.int32)
    elif name == "gqa_causal":
        causal = True
    elif name == "segments_padding":
        causal = True
        q_seg[:, 20:36] = 2
        q_seg[:, 40:] = 0
    elif name == "levels":
        # [img/text 0..29 (26..29 padding) | proprio 30 | action 31..34 | pad]
        q_seg[:, 26:30] = 0
        q_seg[:, 35:] = 0
        q_lev = np.zeros((B, Sq), np.int32)
        q_lev[:, 30] = 1
        q_lev[:, 31:35] = 2
        kv_lev = q_lev
    elif name == "q_offset":
        Sq, q_offset, causal = 16, 32, True
        q_seg = np.ones((B, Sq), np.int32)
    elif name == "fully_masked_rows":
        # rows of segment 0 and of segment 3 (which no key has) see nothing
        kv_seg = q_seg.copy()
        q_seg[:, 5] = 0
        q_seg[:, 17] = 3
    if kv_seg is None:
        kv_seg = q_seg if Sq == Skv else np.ones((B, Skv), np.int32)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (gain * r(B, Sq, H, D), gain * r(B, Skv, KVH, D), r(B, Skv, KVH, D),
            r(B, Sq, H, D), q_seg, kv_seg, q_lev, kv_lev, q_offset, causal,
            softcap, window)


CASES = ["gqa", "gqa_causal", "segments_padding", "levels", "q_offset",
         "fully_masked_rows", "softcap", "window", "window_q_offset",
         "head_dim_72", "head_dim_256"]


@pytest.mark.parametrize("name", CASES)
def test_plain_flash_matches_pallas_interpret(name):
    q, k, v, do, qs, ks, ql, kl, off, causal, cap, win = _case(name)
    jm = lambda seg, lev: jfa.pack_meta(
        jnp.asarray(seg), None if lev is None else jnp.asarray(lev))
    tm = lambda seg, lev: tfa.pack_meta(
        torch.from_numpy(seg), None if lev is None else torch.from_numpy(lev))
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm(qs, ql),
             jm(ks, kl), jnp.int32(off))
    kw = dict(causal=causal, block_q=16, block_k=128, interpret=True,
              softcap=cap, window=win)
    j_out, j_lse = jfa.flash_attention_fwd(*jargs, **kw)
    j_dq, j_dk, j_dv = jfa.flash_attention_bwd(*jargs, j_out, j_lse,
                                               jnp.asarray(do), **kw)

    targs = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             tm(qs, ql), tm(ks, kl), off)
    before = (tfa.fwd_launch_count, tfa.bwd_launch_count)
    tkw = dict(causal=causal, softcap=cap, window=win)
    t_out, t_lse = tfa.flash_attention_fwd(*targs, **tkw)
    t_dq, t_dk, t_dv = tfa.flash_attention_bwd(
        *targs, t_out, t_lse, torch.from_numpy(do), **tkw)
    assert (tfa.fwd_launch_count, tfa.bwd_launch_count) == before

    for got, want in ((t_out, j_out), (t_lse, j_lse), (t_dq, j_dq),
                      (t_dk, j_dk), (t_dv, j_dv)):
        assert got.shape == want.shape
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    if name == "softcap":  # the cap bites: dropping it moves the output
        bare, _ = tfa.flash_attention_fwd(*targs, causal=causal)
        assert (bare - t_out).abs().max() > 100 * ATOL
    if win is not None:  # the window bites
        bare, _ = tfa.flash_attention_fwd(*targs, causal=causal)
        assert (bare - t_out).abs().max() > 100 * ATOL
    if name == "fully_masked_rows":
        for row in (5, 17):
            assert (t_out[:, row] == 0).all() and (t_dq[:, row] == 0).all()
            assert (t_lse[:, :, row] == tfa.NEG_INF).all()


def test_attention_entry_gradient_matches_reference_autograd():
    """The autograd Function (kernel route, plain on the CPU) against
    autograd through the eager reference, with the VLA level mask and the
    Gemma softcap."""
    q, k, v, do, qs, ks, ql, kl, _, _, cap, _ = _case("softcap")
    valid = torch.from_numpy(qs != 0)[:, :, None, None]
    grads = {}
    for impl in ("kernel", "reference"):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = tfa.attention(*ts, q_segment_ids=torch.from_numpy(qs),
                            kv_segment_ids=torch.from_numpy(ks),
                            q_levels=torch.from_numpy(ql),
                            kv_levels=torch.from_numpy(kl), impl=impl,
                            softcap=cap)
        # padded q rows are don't-care: the reference softmaxes them
        # uniformly, the kernel outputs zeros
        (out * torch.from_numpy(do) * valid).sum().backward()
        grads[impl] = [t.grad for t in ts]
    for a, b in zip(grads["kernel"], grads["reference"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_kernel_route_refuses_what_it_lacks():
    """A per-row q_offset has no kernel; softcap and window do, and on CPU
    tensors the kernel route runs their plain versions and launches
    nothing."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 2, 64, generator=g).requires_grad_()
    k = torch.randn(1, 4, 1, 64, generator=g).requires_grad_()
    with pytest.raises(NotImplementedError):
        tfa.attention(q, k, k, causal=True, impl="kernel",
                      q_offset=torch.zeros(1, dtype=torch.int32))
    before = (tfa.fwd_launch_count, tfa.bwd_launch_count)
    for kw in (dict(softcap=50.0), dict(causal=True, window=2)):
        out = tfa.attention(q, k, k, impl="kernel", **kw)
        ref = tfa.attention(q, k, k, impl="reference", **kw)
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        out.sum().backward()
    assert (tfa.fwd_launch_count, tfa.bwd_launch_count) == before
    assert q.grad is not None and k.grad is not None
