"""The port's CUDA kernels vs their plain twins on the card, at small
shapes with ragged edges. Marked `cuda`: without a CUDA device each test
skips (decided inside the fixture, never at import). Run on a GPU machine:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerance: both sides round to bf16 at the same points and differ only in
summation order -> max abs err <= 2e-2 * max(1, max|twin|)."""

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _check(got, ref):
    bound = TOL * max(1.0, ref.float().abs().max().item())
    err = (got.float() - ref.float()).abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("B,S,qk_norm", [(1, 100, False), (2, 77, True)])
def test_fused_vit_kernel_matches_twin(cuda, B, S, qk_norm):
    from vlaser_tpu_torch.kernels import fused_vit

    g = torch.Generator(device=cuda).manual_seed(0)
    L, C, inter, heads = 2, 128, 256, 2
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device=cuda) * sc
    vecs = dict(ln1w=1 + r(L, C, sc=0.1), ln1b=r(L, C, sc=0.1),
                ln2w=1 + r(L, C, sc=0.1), ln2b=r(L, C, sc=0.1),
                ls1=r(L, C, sc=0.1), ls2=r(L, C, sc=0.1),
                qnw=1 + r(L, C, sc=0.1), knw=1 + r(L, C, sc=0.1),
                qkvb=r(L, 3 * C, sc=0.02), projb=r(L, C, sc=0.02),
                fc1b=r(L, inter, sc=0.02), fc2b=r(L, C, sc=0.02))
    bf = torch.bfloat16
    mats = dict(qkvw=r(L, C, 3 * C, sc=0.05).to(bf),
                projw=r(L, C, C, sc=0.05).to(bf),
                fc1w=r(L, C, inter, sc=0.05).to(bf),
                fc2w=r(L, inter, C, sc=0.05).to(bf))
    x = r(B, S, C).to(bf)
    kw = dict(num_heads=heads, eps=1e-6, qk_norm=qk_norm)
    n = fused_vit.launch_count
    got = fused_vit.fused_vit_stack(x, **vecs, **mats, **kw)
    torch.cuda.synchronize()
    assert fused_vit.launch_count == n + 1
    _check(got, fused_vit.fused_vit_stack_plain(x, **vecs, **mats, **kw))


@pytest.mark.parametrize("R,E,step0,wdtype,rope", [
    (4, 37, False, "int8", "bf16"), (5, 33, True, "int8", "bf16"),
    # the VLM decode: one row over a cache with masked slots, fp32 rope;
    # 20,000 slots take the kernel past 48 KB of shared memory
    (1, 3000, False, "int8", "f32"), (1, 20000, False, "int8", "f32"),
    # the bf16-weight mode (unit scales)
    (4, 37, False, "bf16", "bf16"), (1, 300, False, "bf16", "f32")])
def test_fused_int8_kernel_matches_twin(cuda, R, E, step0, wdtype, rope):
    from vlaser_tpu_torch.core.quant import quantize_int8
    from vlaser_tpu_torch.kernels import fused_decode, ops

    g = torch.Generator(device=cuda).manual_seed(1)
    L, C, inter, H, KVH, D = 2, 256, 640, 4, 2, 128
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device=cuda) * sc
    bf = torch.bfloat16
    ws = {}
    for name, k, n in (("q", C, H * D), ("k", C, KVH * D), ("v", C, KVH * D),
                       ("o", H * D, C), ("g", C, inter), ("u", C, inter),
                       ("d", inter, C)):
        ws["w" + name], ws["s" + name] = quantize_int8(r(L, k, n, sc=0.05), -2)
        if wdtype == "bf16":
            ws["w" + name] = (ws["w" + name] * ws["s" + name]).to(bf)
            ws["s" + name] = torch.ones_like(ws["s" + name])
    cos, sin = ops.rope_cos_sin(torch.arange(R, device=cuda) + 3.0, D, 1e4)
    if rope == "bf16":
        cos, sin = cos.to(bf), sin.to(bf)
    selfm = torch.zeros(R, R, device=cuda)
    if step0:
        selfm[0, 1:] = fused_decode.NEG_INF
    extm = torch.zeros(1, E, device=cuda)
    extm[0, -5:] = fused_decode.NEG_INF
    extm[0, E // 2:E // 2 + 7] = fused_decode.NEG_INF
    args = (r(R, C, sc=0.3).to(bf), cos, sin, selfm, extm,
            1 + r(L, C, sc=0.1), 1 + r(L, C, sc=0.1), r(L, H * D, sc=0.02),
            r(L, KVH * D, sc=0.02), r(L, KVH * D, sc=0.02),
            ws["wq"], ws["sq"], ws["wk"], ws["sk"], ws["wv"], ws["sv"],
            ws["wo"], ws["so"], ws["wg"], ws["sg"], ws["wu"], ws["su"],
            ws["wd"], ws["sd"],
            r(L, E, KVH, D, sc=0.3).to(bf), r(L, E, KVH, D, sc=0.3).to(bf))
    n = fused_decode.launch_count
    got = fused_decode.fused_int8_stack(*args)
    torch.cuda.synchronize()
    assert fused_decode.launch_count == n + 1
    ref = fused_decode.fused_int8_stack_plain(*args)
    for a, b in zip(got, ref):
        _check(a, b)


def test_fused_int8_refuses_a_cache_beyond_shared_memory(cuda):
    """More external slots than the attention's shared memory holds: a
    clear ValueError before any launch, not a refused launch."""
    from vlaser_tpu_torch.kernels import fused_decode

    L, C, inter, H, KVH, D, E = 1, 256, 512, 2, 1, 128, 70000
    bf, i8 = torch.bfloat16, torch.int8
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=cuda)
    mats = []
    for k, n in ((C, H * D), (C, KVH * D), (C, KVH * D), (H * D, C),
                 (C, inter), (C, inter), (inter, C)):
        mats += [z(L, k, n, dt=i8), z(L, 1, n)]
    n = fused_decode.launch_count
    with pytest.raises(ValueError, match="shared"):
        fused_decode.fused_int8_stack(
            z(1, C, dt=bf), z(1, D), z(1, D), z(1, 1), z(1, E), z(L, C),
            z(L, C), z(L, H * D), z(L, KVH * D), z(L, KVH * D), *mats,
            z(L, E, KVH, D, dt=bf), z(L, E, KVH, D, dt=bf))
    assert fused_decode.launch_count == n


def test_cuda_wrappers_refuse_wrong_dtypes(cuda):
    from vlaser_tpu_torch.kernels import fused_vit

    x = torch.zeros(17, 128, device=cuda)  # fp32, not bf16
    z = torch.zeros(1, 128, device=cuda)
    with pytest.raises(TypeError):
        fused_vit.fused_vit_stack(x, *([z] * 16), num_heads=2)


def _meta_case(B, S, pad, levels, device):
    """Segments 1 with `pad` trailing padding tokens (segment 0); levels
    [0 ... | 1 | 2 x 4] over the valid tail when `levels`."""
    seg = torch.ones(B, S, dtype=torch.int32, device=device)
    lev = None
    if levels:
        lev = torch.zeros(B, S, dtype=torch.int32, device=device)
        lev[:, S - 5] = 1
        lev[:, S - 4:] = 2
        seg[:, S - 5 - pad:S - 5] = 0  # the padded prompt tail
    elif pad:
        seg[:, S - pad:] = 0
    return seg, lev


# gain multiplies q and k: 7 puts the logits' std near 50, where a cap of
# 50 bites
@pytest.mark.parametrize(
    "B,Sq,Skv,H,KVH,D,pad,levels,causal,off,cap,win,gain", [
        (2, 77, 77, 4, 4, 64, 9, False, False, 0, None, None, 1.0),
        (2, 100, 100, 6, 2, 128, 13, True, False, 0, None, None, 1.0),
        (2, 40, 100, 6, 2, 128, 0, False, True, 60, None, None, 1.0),
        (1, 130, 130, 2, 1, 64, 0, False, True, 0, None, None, 1.0),
        # SigLIP's head dim, Gemma's (softcap, GQA 8:1, the serving suffix)
        (2, 77, 77, 4, 4, 72, 9, False, False, 0, None, None, 1.0),
        (2, 90, 90, 8, 1, 256, 7, True, False, 0, 50.0, None, 7.0),
        (1, 4, 90, 8, 1, 256, 0, False, False, 0, 50.0, None, 7.0),
        (2, 70, 70, 4, 2, 64, 5, True, False, 0, 50.0, None, 7.0),
        # sliding windows, with q_offset and at D = 256
        (1, 200, 200, 4, 2, 128, 0, False, True, 0, None, 50, 1.0),
        (1, 60, 200, 4, 2, 128, 0, False, True, 140, None, 33, 1.0),
        (1, 100, 100, 2, 1, 256, 0, False, True, 0, 50.0, 40, 3.0),
        # more K/V tiles than the ring has stages; a shape shorter than one
        # tile (a GQA pair packed into it); the packed serving suffix at D
        # 256 with softcap over the joint's 281 keys; D = 72 at SigLIP's S
        (1, 1025, 1025, 16, 16, 64, 0, False, False, 0, None, None, 1.0),
        (1, 20, 20, 4, 2, 128, 3, False, False, 0, None, None, 1.0),
        (1, 4, 281, 8, 1, 256, 0, False, False, 0, 50.0, None, 7.0),
        (2, 256, 256, 16, 16, 72, 0, False, False, 0, None, None, 1.0),
    ])
def test_flash_attention_kernels_match_plain(cuda, B, Sq, Skv, H, KVH, D, pad,
                                             levels, causal, off, cap, win,
                                             gain):
    from vlaser_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(2)
    bf = torch.bfloat16
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device=cuda)
                            * sc).to(bf)
    q, k, v, do = r(B, Sq, H, D, sc=gain), r(B, Skv, KVH, D, sc=gain), \
        r(B, Skv, KVH, D), r(B, Sq, H, D)
    kv_seg, kv_lev = _meta_case(B, Skv, pad, levels, cuda)
    q_seg, q_lev = (kv_seg, kv_lev) if Sq == Skv else _meta_case(
        B, Sq, 0, False, cuda)
    qm, km = fa.pack_meta(q_seg, q_lev), fa.pack_meta(kv_seg, kv_lev)
    kw = dict(softcap=cap, window=win)
    nf, nb = fa.fwd_launch_count, fa.bwd_launch_count
    out, lse = fa.flash_attention_fwd(q, k, v, qm, km, off, causal, **kw)
    grads = fa.flash_attention_bwd(q, k, v, qm, km, off, out, lse, do, causal,
                                   **kw)
    torch.cuda.synchronize()
    assert (fa.fwd_launch_count, fa.bwd_launch_count) == (nf + 1, nb + 1)
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, qm, km, off, causal,
                                                **kw)
    p_grads = fa.flash_attention_bwd_plain(q, k, v, qm, km, off, out, lse, do,
                                           causal, **kw)
    _check(out, p_out)
    for a, b in zip(grads, p_grads):
        _check(a, b)
    live = p_lse > -1e29
    assert torch.equal(lse[~live], p_lse[~live])
    assert (lse[live] - p_lse[live]).abs().max().item() <= 1e-2
    dead = (q_seg == 0)
    assert (out[dead] == 0).all() and (grads[0][dead] == 0).all()


@pytest.mark.parametrize("D", [64, 72, 128, 256])
def test_wgmma_tma_probe_matches_matmul(cuda, D):
    """The kernels' first product of each kind on one 64-row tile loaded by
    TMA: S = Q K^T from shared memory against torch.matmul in fp32 (summation
    order only), then O = bf16(S) V with A from registers and V MN-major."""
    from vlaser_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(64, D, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    s, o = fa.wgmma_probe(q, k, v)
    torch.cuda.synchronize()
    ref_s = q.float() @ k.float().T
    assert (s - ref_s).abs().max().item() <= 1e-4 * ref_s.abs().max().item()
    ref_o = s.to(torch.bfloat16).float() @ v.float()
    assert (o - ref_o).abs().max().item() <= 1e-4 * ref_o.abs().max().item()


def test_flash_attention_refuses_other_head_dims(cuda):
    from vlaser_tpu_torch.kernels import flash_attention as fa

    q = torch.zeros(1, 8, 2, 96, dtype=torch.bfloat16, device=cuda)
    m = torch.ones(1, 8, dtype=torch.int32, device=cuda)
    n = fa.fwd_launch_count
    with pytest.raises(ValueError, match="96"):
        fa.flash_attention_fwd(q, q, q, m, m)
    assert fa.fwd_launch_count == n


@pytest.mark.parametrize("n,H,dtype", [(300, 1536, torch.bfloat16),
                                       (77, 136, torch.float32)])
def test_rmsnorm_kernels_match_plain(cuda, n, H, dtype):
    from vlaser_tpu_torch.kernels import rmsnorm

    g = torch.Generator(device=cuda).manual_seed(3)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    x, w, gy = r(n, H).to(dtype), (1 + 0.1 * r(H)).to(dtype), r(n, H).to(dtype)
    nf, nb = rmsnorm.fwd_launch_count, rmsnorm.bwd_launch_count
    y, rrms = rmsnorm.rms_fwd(x, w, 1e-6)
    dx, dw = rmsnorm.rms_bwd(x, w, gy, rrms)
    dx2, dw2 = rmsnorm.rms_bwd(x, w, gy, rrms)
    torch.cuda.synchronize()
    assert (rmsnorm.fwd_launch_count, rmsnorm.bwd_launch_count) == (nf + 1,
                                                                    nb + 2)
    assert torch.equal(dw, dw2)  # no atomics: bit-identical reruns
    p_y, p_rrms = rmsnorm.rms_fwd_plain(x, w, 1e-6)
    p_dx, p_dw = rmsnorm.rms_bwd_plain(x, w, gy, rrms)
    _check(y, p_y)
    assert (rrms - p_rrms).abs().max().item() <= 1e-4 * p_rrms.abs().max()
    _check(dx, p_dx)
    _check(dw, p_dw)


@pytest.mark.parametrize("n", [1, 300, 12289])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H", [1536, 200, 2560])
def test_rms_bwd_one_pass_matches_plain(cuda, n, dtype, H):
    """The one-pass backward at the training width (1536: 6 chunks of 256
    columns a lane), a width that is not a multiple of 256 (200) and one
    cut into two column slabs (2560): dx and dw against the plain version
    within chip_smoke's RMS_REL and DW_REL of their largest value, and dw
    bit-identical over two launches (fixed rows per block, no atomics)."""
    from vlaser_tpu_torch.kernels import rmsnorm

    g = torch.Generator(device=cuda).manual_seed(4)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    x, w, gy = r(n, H).to(dtype), (1 + 0.1 * r(H)).to(dtype), r(n, H).to(dtype)
    rrms = rmsnorm.rms_fwd_plain(x, w, 1e-6)[1]
    nb = rmsnorm.bwd_launch_count
    dx, dw = rmsnorm.rms_bwd(x, w, gy, rrms)
    dx2, dw2 = rmsnorm.rms_bwd(x, w, gy, rrms)
    torch.cuda.synchronize()
    assert rmsnorm.bwd_launch_count == nb + 2
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)
    p_dx, p_dw = rmsnorm.rms_bwd_plain(x, w, gy, rrms)
    for got, ref, rel in ((dx, p_dx, 1e-2), (dw, p_dw, 1e-3)):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= rel * ref.float().abs().max().item(), (err, rel)
    # the control: dx without its - x * sum(g w x) rrms^3 / H term (a term
    # ~H^-1/2 of dx: one row may hide it under the bound; 300 rows do not)
    no_sum = (gy.float() * w.float() * rrms).to(dtype)
    if n > 1:
        assert (dx.float() - no_sum.float()).abs().max().item() > \
            1e-2 * p_dx.float().abs().max().item()


@pytest.mark.parametrize("N", [128, 256])
def test_s8_wgmma_tma_probe_matches_exact_product(cuda, N):
    """The int8 GEMM's product alone on one 64-row tile: a [64, 128] and b
    [N, 128] int8 (K-major), each loaded by one TMA copy with the 128-byte
    swizzle, four s8 wgmma k-steps into int32 registers: exactly a @ b^T."""
    from vlaser_tpu_torch.kernels import w8a8

    g = torch.Generator(device=cuda).manual_seed(8)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, device=cuda,
                                  dtype=torch.int8)
    a, b = i8(64, 128), i8(N, 128)
    c = w8a8.s8_probe(a, b)
    torch.cuda.synchronize()
    # float64 sums of int8 products are exact (|sum| < 2^53)
    assert torch.equal(c.double(), a.double() @ b.double().T)


def test_tmap_cache_serves_repeats_and_off_changes_no_bit(cuda):
    """The tensor-map cache shared by the TMA kernels (csrc/sm90.cuh): a
    repeated int8_gemm is served from it (no encode), another shape at the
    same pointers encodes anew, and with the cache off every map is
    encoded and the product is bit-equal."""
    from vlaser_tpu_torch.kernels import _build, w8a8

    g = torch.Generator(device=cuda).manual_seed(10)
    q = torch.randint(-127, 128, (256, 512), generator=g, device=cuda,
                      dtype=torch.int8)
    kt = torch.randint(-127, 128, (384, 512), generator=g, device=cuda,
                       dtype=torch.int8)
    am = torch.rand(256, 1, generator=g, device=cuda) + 0.5
    ks = torch.rand(384, generator=g, device=cuda) * 1e-3
    assert _build.tmap_cache(True)["on"]
    try:
        y = w8a8.int8_gemm(q, am, kt, ks)
        before = _build.tmap_cache()
        y2 = w8a8.int8_gemm(q, am, kt, ks)
        after = _build.tmap_cache()
        assert after["misses"] == before["misses"]
        assert after["hits"] == before["hits"] + 2  # A and B
        w8a8.int8_gemm(q[:128], am[:128], kt, ks)  # A's map has other rows
        assert _build.tmap_cache()["misses"] == after["misses"] + 1
        off = _build.tmap_cache(False)
        assert off["maps"] == 0 and not off["on"]
        y3 = w8a8.int8_gemm(q, am, kt, ks)
        assert _build.tmap_cache()["misses"] == off["misses"] + 2
    finally:
        _build.tmap_cache(True)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(y, y3)


GEMM_MN = [(m, n) for m in (1, 130, 384, 1025) for n in (48, 256, 1536)] + [
    (4100, 1536), (4100, 2048)]  # grids of > 1 wave: no K split; BN 256


@pytest.mark.parametrize("M,N", GEMM_MN)
def test_int8_gemm_epilogues_match_plain(cuda, M, N):
    """w8a8::gemm with each of its five epilogues against the plain version
    on the same int8 rows, once over a contiguous K of 1536 and once over
    the second half of 4096-wide rows (lda = ldb = 4096, the row scales at
    stride 2: fc2's second half in the act_quant ViT), at ragged M and N
    (TMA's zero fill, the masked epilogue) and grids that split K or not.
    The integer products are exact on both sides and the rescale runs in
    the same order: fp32 outputs within one fp32 rounding, bf16 outputs
    within one bf16 rounding, the in-place residual update bit-equal."""
    from vlaser_tpu_torch.kernels import w8a8

    g = torch.Generator(device=cuda).manual_seed(9)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, device=cuda,
                                  dtype=torch.int8)
    wide_a, wide_b = i8(M, 4096), i8(N, 4096)
    am2 = r(M, 2).abs() + 0.5
    cases = (("K 1536", i8(M, 1536), am2[:, 0].contiguous(), i8(N, 1536)),
             ("K half of 4096", wide_a[:, 2048:], am2[:, 1], wide_b[:, 2048:]))
    s_col, bias = r(N).abs() * 1e-3, r(N)
    addm, ls = r(M, N), 0.1 * r(N)
    x = r(M, N).to(torch.bfloat16)
    for what, a, am, b in cases:
        for epi in range(5):
            for row_first in (False, True):
                kw = dict(bias=bias, ls=ls, row_first=row_first)
                if epi == w8a8.EPI_BIAS_LS_RESIDUAL:
                    kw.update(out=x.clone(), addm=addm if row_first else None)
                n = w8a8.gemm_launch_count
                got = w8a8.int8_gemm_ex(a, am, b, s_col, epi, **kw)
                ref = w8a8.int8_gemm_ex_plain(
                    a, am, b, s_col, epi,
                    **{**kw, "out": x if "out" in kw else None})
                torch.cuda.synchronize()
                assert w8a8.gemm_launch_count == n + 1
                tag = (what, epi, row_first)
                if epi == w8a8.EPI_BIAS_LS_RESIDUAL:
                    assert torch.equal(got, ref), tag
                    continue
                step = 2.0 ** (-8 if epi == w8a8.EPI_BF16 else -23)
                bad = (got.float() - ref.float()).abs() > \
                    step * ref.float().abs()
                assert not bad.any(), (tag, int(bad.sum()))
                # the control: a dropped row scale breaks the bound
                if epi == w8a8.EPI_F32 and not row_first:
                    wrong = w8a8.int8_gemm_ex_plain(
                        a, torch.full_like(am, 127.0), b, s_col, epi)
                    assert ((got - wrong).abs() > step * wrong.abs()).any()


def test_autograd_functions_launch_their_backward_kernels(cuda):
    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import rmsnorm

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2048, 64, generator=g, device=cuda).to(
        torch.bfloat16).requires_grad_()
    w = torch.ones(64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    q = torch.randn(1, 2048, 2, 64, generator=g, device=cuda).to(
        torch.bfloat16).requires_grad_()
    counts = lambda: (fa.fwd_launch_count, fa.bwd_launch_count,
                      rmsnorm.fwd_launch_count, rmsnorm.bwd_launch_count)
    before = counts()
    y = rmsnorm.rms_norm(x, w)  # auto: 2048 rows x 64 -> kernel
    o = fa.attention(q, q, q)   # auto: Sq = 2048 -> kernel
    (y.float().sum() + o.float().sum()).backward()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1, 1]
    assert torch.isfinite(x.grad.float()).all() and torch.isfinite(
        q.grad.float()).all()


@pytest.mark.parametrize("M,K,N,dtype", [(130, 192, 48, torch.bfloat16),
                                         (384, 1536, 256, torch.bfloat16),
                                         (77, 256, 96, torch.float32)])
def test_w8a8_kernels_match_plain(cuda, M, K, N, dtype):
    """quantize_rows: int8 rows bit-identical to the plain version (row 0
    holds exact .5 ties, row 1 is all zero); int8_gemm: the same integer
    products and rescale order, so y within one fp32 rounding."""
    from vlaser_tpu_torch.core.quant import quantize_int8
    from vlaser_tpu_torch.kernels import w8a8

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(M, K, generator=g, device=cuda)
    x[0] = (torch.arange(K, device=cuda) % 120 - 60 + 0.5).float()
    x[0, 0] = 127.0
    x[1] = 0.0
    x = x.to(dtype)
    kq, ks = quantize_int8(torch.randn(K, N, generator=g, device=cuda) * 0.05,
                           -2)
    kt = kq.t().contiguous()  # the GEMM's K-major weight
    nq, ng = w8a8.quant_launch_count, w8a8.gemm_launch_count
    q, am = w8a8.quantize_rows(x)
    y = w8a8.int8_gemm(q, am, kt, ks)
    yb = w8a8.int8_gemm(q, am, kt, ks, torch.bfloat16)
    torch.cuda.synchronize()
    assert (w8a8.quant_launch_count, w8a8.gemm_launch_count) == (nq + 1,
                                                                ng + 2)
    p_q, p_am = w8a8.quantize_rows_plain(x)
    assert torch.equal(q, p_q) and torch.equal(am, p_am)
    p_y = w8a8.int8_gemm_plain(p_q, p_am, kt, ks)
    assert ((y - p_y).abs() <= 2.0 ** -23 * p_y.abs()).all()
    assert torch.equal(yb, y.to(torch.bfloat16))


@pytest.mark.parametrize("B,S", [(1, 100), (2, 77)])
def test_fused_vit_act_quant_kernel_matches_twin(cuda, B, S):
    from vlaser_tpu_torch.core.quant import quantize_int8
    from vlaser_tpu_torch.kernels import fused_vit

    g = torch.Generator(device=cuda).manual_seed(6)
    L, C, inter, heads = 2, 128, 256, 2
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device=cuda) * sc
    vecs = dict(ln1w=1 + r(L, C, sc=0.1), ln1b=r(L, C, sc=0.1),
                ln2w=1 + r(L, C, sc=0.1), ln2b=r(L, C, sc=0.1),
                ls1=r(L, C, sc=0.1), ls2=r(L, C, sc=0.1),
                qnw=torch.ones(L, C, device=cuda),
                knw=torch.ones(L, C, device=cuda),
                qkvb=r(L, 3 * C, sc=0.02), projb=r(L, C, sc=0.02),
                fc1b=r(L, inter, sc=0.02), fc2b=r(L, C, sc=0.02))
    mats = {}
    for w, s, k, n in (("qkvw", "qkvs", C, 3 * C), ("projw", "projs", C, C),
                       ("fc1w", "fc1s", C, inter), ("fc2w", "fc2s", inter, C)):
        q8, sc = quantize_int8(r(L, k, n, sc=0.05), -2)
        mats[w] = q8.transpose(1, 2).contiguous()  # K-major [L, N, K]
        mats[s] = sc[:, 0].contiguous()
    x = r(B, S, C).to(torch.bfloat16)
    kw = dict(num_heads=heads, eps=1e-6, qk_norm=False, act_quant=True)
    n = fused_vit.act_quant_launch_count
    got = fused_vit.fused_vit_stack(x, **vecs, **mats, **kw)
    torch.cuda.synchronize()
    assert fused_vit.act_quant_launch_count == n + 1
    _check(got, fused_vit.fused_vit_stack_plain(x, **vecs, **mats, **kw))


def test_w8a8_dense_launches_both_kernels(cuda):
    """A kernel_aq Dense at >= 128 rows takes quantize_rows + int8_gemm on
    the card (below 128 rows neither), and its STE backward runs."""
    from vlaser_tpu_torch.core.quant import quantize_module
    from vlaser_tpu_torch.kernels import w8a8
    from vlaser_tpu_torch.models.layers import Dense

    g = torch.Generator(device=cuda).manual_seed(7)
    d = Dense(256, 512, device=cuda)
    with torch.no_grad():
        d.kernel.normal_(generator=g)
        d.bias.zero_()
    quantize_module(d, (r"kernel$",), (r"kernel$",))
    x = torch.randn(2, 64, 256, generator=g, device=cuda).requires_grad_()
    counts = lambda: (w8a8.quant_launch_count, w8a8.gemm_launch_count)
    before = counts()
    y = d(x)
    d(x[:1])
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1]
    assert y.dtype == torch.bfloat16 and torch.isfinite(x.grad).all()
