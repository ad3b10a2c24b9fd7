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


# (Sq, Skv, H, KVH, D): the PaliGemma serving suffix (packed), a short GQA
# pair (packed), the ViT, the joint, a windowed short block (packed), a
# group of 3 (not packed: 3 does not divide 32)
PLAN_SHAPES = [(4, 281, 8, 1, 256), (20, 20, 4, 2, 128),
               (1025, 1025, 16, 16, 64), (389, 389, 12, 2, 128),
               (60, 200, 4, 2, 128), (40, 100, 6, 2, 128)]


@pytest.mark.parametrize("sq,skv,h,kvh,d", PLAN_SHAPES)
def test_packed_tiles_cover_every_pair_once(sq, skv, h, kvh, d):
    """The CUDA kernels' launch plan: the forward / dq grids' tiles, and the
    q tiles each dk/dv block walks for its KV head, hold every (q head, q
    row) pair exactly once."""
    from collections import Counter

    plan = tfa.launch_plan(2, sq, skv, h, kvh, d)
    pack, g = plan["pack"], h // kvh
    assert pack == (g if sq < 64 and g > 1 and 32 % g == 0 else 1)
    every = Counter((hh, i) for hh in range(h) for i in range(sq))
    for kern in ("fwd", "dq"):
        gx, gy, gb = plan[kern]["grid"]
        assert gb == 2 and gy * pack == h
        got = Counter(p for x in range(gx) for y in range(gy)
                      for p in tfa.tile_pairs(pack, plan[kern]["rows"], x,
                                              y * pack, sq))
        assert got == every
    dkv = plan["dkv"]
    assert dkv["grid"] == (-(-skv // dkv["keys"]), kvh, 2)
    for kv in range(kvh):
        got = Counter(p for jg in range(dkv["head_groups"])
                      for qt in range(dkv["q_tiles"])
                      for p in tfa.tile_pairs(pack, dkv["q_rows"], qt,
                                              kv * g + jg * pack, sq))
        assert got == Counter((hh, i) for hh in range(kv * g, kv * g + g)
                              for i in range(sq))
    if sq < 64 and pack > 1:  # one block holds the whole group's rows
        assert plan["fwd"]["grid"][1] == kvh
        assert plan["fwd"]["grid"][0] == -(-sq * pack // plan["fwd"]["rows"])


@pytest.mark.parametrize("name", ["packed_suffix", "window_q_offset", "gqa"])
def test_tile_by_tile_forward_matches_jax_reference(name):
    """The forward computed one tile of the launch plan at a time (each
    tile's packed rows gathered, attended over all keys of their KV head
    with the kernels' mask, scattered back) equals JAX's _ref_attention."""
    if name == "packed_suffix":  # 4 action rows of 4 q heads over 35 keys
        q, k, v, _, qs, ks, ql, kl, off, causal, cap, win = _case("softcap")
        q, qs, ql = q[:, 31:35], qs[:, 31:35], ql[:, 31:35]
        q = np.repeat(q, 2, axis=2)[:, :, :4]  # 4 q heads, 2 kv heads
    else:
        q, k, v, _, qs, ks, ql, kl, off, causal, cap, win = _case(name)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(d)
    tm = lambda seg, lev: tfa.pack_meta(
        torch.from_numpy(seg), None if lev is None else torch.from_numpy(lev))
    qm, km = tm(qs, ql), tm(ks, kl)
    plan = tfa.launch_plan(b, sq, skv, h, kvh, d)
    if name == "packed_suffix":
        assert plan["pack"] == h // kvh
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ok = tfa._allowed(qm, km, off, causal, win)  # [B, Sq, Skv]
    out = torch.zeros_like(tq)
    gx, gy, _ = plan["fwd"]["grid"]
    for x in range(gx):
        for y in range(gy):
            pairs = tfa.tile_pairs(plan["pack"], plan["fwd"]["rows"], x,
                                   y * plan["pack"], sq)
            heads = torch.tensor([p[0] for p in pairs])
            rows = torch.tensor([p[1] for p in pairs])
            kv = heads // (h // kvh)
            qt = tq[:, rows, heads]  # [B, R, D]
            s, _ = tfa._capped(torch.einsum("brd,brsd->brs", qt * scale,
                                            tk[:, :, kv].transpose(1, 2)),
                               cap)
            m = ok[:, rows]
            p = torch.softmax(torch.where(m, s, -torch.inf), -1)
            p = torch.where(m.any(-1, keepdim=True), p, 0.0)
            out[:, rows, heads] = torch.einsum(
                "brs,brsd->brd", p, tv[:, :, kv].transpose(1, 2))
    jm = lambda seg, lev: jfa.pack_meta(
        jnp.asarray(seg), None if lev is None else jnp.asarray(lev))
    want = jfa._ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jm(qs, ql), jm(ks, kl), off, causal, scale,
                              cap, win)
    live = torch.from_numpy(qs != 0)  # the reference softmaxes dead rows
    np.testing.assert_allclose(out[live].numpy(), np.asarray(want)[live.numpy()],
                               rtol=RTOL, atol=ATOL)
    assert (out[~live] == 0).all()


def test_ptxas_report_reads_the_flash_kernels_of_a_build_log():
    """The registers, spills and serialization notes chip_smoke.py prints
    come from the -v lines of csrc/flash_attention.cu alone."""
    from vlaser_tpu_torch.kernels import _build

    log = "\n".join([
        "/usr/bin/nvcc -gencode arch=compute_90a,code=sm_90a -c -o f.o "
        "csrc/flash_attention.cu",
        "ptxas info    : Compiling entry function '_ZN2fa10fwd_kernelILi64E"
        "Lb0EEEv' for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized",
        "/usr/bin/nvcc -gencode arch=compute_90a,code=sm_90a -c -o r.o "
        "csrc/rmsnorm.cu",
        "ptxas info    : Compiling entry function 'rms' for 'sm_90a'",
        "ptxas info    : Used 40 registers"])
    got = _build.ptxas_report("flash_attention", log)
    assert got[0] == {"kernel": "_ZN2fa10fwd_kernelILi64ELb0EEEv", "stack": 0,
                      "spill_bytes": 12, "registers": 168}
    assert len(got) == 2 and "C7514" in got[1]["warning"]
    assert _build.ptxas_report("rmsnorm", log)[0]["registers"] == 40
