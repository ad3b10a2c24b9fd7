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


@pytest.mark.parametrize("B,S,qk_norm", [(1, 100, False), (2, 77, True),
                                         (1, 1025, False), (2, 1025, True),
                                         (13, 1025, False)])
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


def _stack_args(cuda, R, E, step0, wdtype, rope, seed=1, H=4, KVH=2, C=256,
                inter=640):
    from vlaser_tpu_torch.core.quant import quantize_int8
    from vlaser_tpu_torch.kernels import fused_decode, ops

    g = torch.Generator(device=cuda).manual_seed(seed)
    L, D = 2, 128
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
    return args


@pytest.mark.parametrize("R,E,step0,wdtype,rope", [
    (4, 37, False, "int8", "bf16"), (5, 33, True, "int8", "bf16"),
    # the VLM decode: one row over a cache with masked slots, fp32 rope
    (1, 3000, False, "int8", "f32"), (1, 20000, False, "int8", "f32"),
    # the bf16-weight mode (unit scales)
    (4, 37, False, "bf16", "bf16"), (1, 300, False, "bf16", "f32"),
    # the persistent stack at every row count and the caches of the
    # serving paths: E 1 (one chunk), 385, 3,592 and 32,768 (129 chunks)
    (1, 1, False, "int8", "f32"), (4, 385, False, "int8", "bf16"),
    (5, 385, True, "bf16", "bf16"), (8, 385, False, "int8", "bf16"),
    (8, 385, False, "bf16", "bf16"), (1, 3592, False, "bf16", "f32"),
    (1, 32768, False, "int8", "f32"), (1, 32768, False, "bf16", "f32")])
def test_fused_int8_kernel_matches_twin(cuda, R, E, step0, wdtype, rope):
    from vlaser_tpu_torch.kernels import fused_decode

    args = _stack_args(cuda, R, E, step0, wdtype, rope)
    n = fused_decode.launch_count
    got = fused_decode.fused_int8_stack(*args)
    torch.cuda.synchronize()
    assert fused_decode.launch_count == n + 1
    ref = fused_decode.fused_int8_stack_plain(*args)
    for a, b in zip(got, ref):
        _check(a, b)


@pytest.mark.parametrize("R,E,C,inter", [
    (1, 3592, 3584, 18944),  # Qwen2.5-7B's decode (2 of its 28 layers)
    (4, 385, 768, 5600), (5, 385, 768, 5600)])  # the 8B expert's denoise
def test_fused_int8_kernel_at_the_8b_shapes(cuda, R, E, C, inter):
    """28 q / 4 kv heads x 128 (a group of 7), q width 3,584: the decode's
    18,944-wide MLP and the expert's 768 -> 3,584 q projection."""
    from vlaser_tpu_torch.kernels import fused_decode

    args = _stack_args(cuda, R, E, R == 5, "int8", "f32" if R == 1 else
                       "bf16", H=28, KVH=4, C=C, inter=inter)
    got = fused_decode.fused_int8_stack(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, fused_decode.fused_int8_stack_plain(*args)):
        _check(a, b)


@pytest.mark.parametrize("R,E,wdtype", [(1, 3592, "int8"), (5, 385, "int8"),
                                        (4, 385, "bf16")])
def test_fused_int8_two_calls_are_bit_equal(cuda, R, E, wdtype):
    """Partials reduced in one fixed order, chunks combined in one fixed
    order, barriers that publish every partial: two calls give the same
    bits (a missing fence would read stale partials and differ)."""
    from vlaser_tpu_torch.kernels import fused_decode

    args = _stack_args(cuda, R, E, False, wdtype, "f32", seed=3)
    a = fused_decode.fused_int8_stack(*args)
    for _ in range(3):
        b = fused_decode.fused_int8_stack(*args)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_fused_int8_refuses_a_cache_beyond_shared_memory(cuda):
    """70,000 external slots, past what the old kernel's shared-memory
    scores held: the split-KV stack keeps no scores beyond one chunk, so it
    runs (one launch) and matches its twin."""
    from vlaser_tpu_torch.kernels import fused_decode

    args = _stack_args(cuda, 1, 70000, False, "int8", "f32", seed=4)
    n = fused_decode.launch_count
    got = fused_decode.fused_int8_stack(*args)
    torch.cuda.synchronize()
    assert fused_decode.launch_count == n + 1
    for a, b in zip(got, fused_decode.fused_int8_stack_plain(*args)):
        _check(a, b)


@pytest.mark.parametrize("R,E,H,KVH", [(1, 3592, 12, 2), (4, 385, 12, 2),
                                       (1, 1, 4, 2), (8, 700, 8, 1)])
def test_split_kv_attention_kernel_matches_plain(cuda, R, E, H, KVH):
    """The stack's attention phase alone (int8_stack_attention) against the
    plain split-KV attention at the planner's chunk, fp32 softmax: 2e-2 of
    the largest output (bf16 out)."""
    from vlaser_tpu_torch.kernels import fused_decode as fd

    g = torch.Generator(device=cuda).manual_seed(5)
    D, bf = 128, torch.bfloat16
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    q = (2 * r(R, H * D)).to(bf)
    ke, ve = (2 * r(E, KVH, D)).to(bf), r(E, KVH, D).to(bf)
    ks, vs = (2 * r(R, KVH, D)).to(bf), r(R, KVH, D).to(bf)
    selfm = torch.zeros(R, R, device=cuda)
    extm = torch.zeros(1, E, device=cuda)
    extm[0, E // 2:] = fd.NEG_INF
    got = fd.split_kv_attention(q, ke, ve, ks, vs, selfm, extm)
    torch.cuda.synchronize()
    chunk = fd.kv_chunk(E + R, KVH, R)
    G = H // KVH
    want = torch.empty(R, H * D, device=cuda)
    for h in range(H):
        keys = torch.cat([ke[:, h // G], ks[:, h // G]])
        vals = torch.cat([ve[:, h // G], vs[:, h // G]])
        mask = torch.cat([extm.expand(R, E), selfm], 1)
        want[:, h * D:(h + 1) * D] = fd.split_kv_attention_plain(
            q[:, h * D:(h + 1) * D].float() * D ** -0.5, keys, vals, mask,
            chunk)
    _check(got, want)


@pytest.mark.parametrize("N", [128, 256])
def test_transposed_b_wgmma_probe_matches_matmul(cuda, N):
    """One 128 x N tile of the bf16 GEMM's product with B read MN-major
    (wgmma's transposed B) from the JAX [K, N] layout: the descriptors and
    swizzles checked alone. Products of bf16 values summed in fp32 over 64
    terms: within 1e-3 of the fp32 product."""
    import ctypes

    from vlaser_tpu_torch.kernels import _build

    g = torch.Generator(device=cuda).manual_seed(8)
    a = torch.randn(128, 64, generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn(64, N, generator=g, device=cuda).to(torch.bfloat16)
    c = torch.empty(128, N, device=cuda)
    fn = _build.bind("vit_wgmma_tb_probe", 3, (ctypes.c_int, ctypes.c_void_p))
    _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), N,
                    torch.cuda.current_stream().cuda_stream), "probe")
    torch.cuda.synchronize()
    want = a.float() @ b.float()
    assert (c - want).abs().max().item() <= 1e-3


@pytest.mark.parametrize("B", [1, 2, 13])
def test_vit_attention_kernel_matches_twin(cuda, B):
    """The one-pass attention under the norm-bound shift alone, at the
    InternViT shape (S 1025, 16 heads x 64), q/k drawn as the stack's
    phase 1 draws them (x4): bf16 out within 2e-2 of the largest."""
    from vlaser_tpu_torch.kernels import fused_vit

    g = torch.Generator(device=cuda).manual_seed(9)
    S, heads, C = 1025, 16, 1024
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    qs = (r(B * S, C) * 0.5 * 64 ** -0.5 * fused_vit.LOG2E).to(torch.bfloat16)
    ks, vs = (r(B * S, C) * 0.5).to(torch.bfloat16), r(B * S, C).to(
        torch.bfloat16)
    got = fused_vit.attention(qs, ks, vs, B, S, heads)
    torch.cuda.synchronize()
    _check(got, fused_vit._attention(qs, ks, vs, B, S, heads))


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
        # Qwen2.5-7B's group of 7 (28 / 4 heads), causal with a padded
        # tail, and the same group packed into a short tile (Sq < 64)
        (1, 700, 700, 28, 4, 128, 30, False, True, 0, None, None, 1.0),
        (1, 5, 300, 28, 4, 128, 0, False, False, 0, None, None, 1.0),
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


QUANT_ROWS = (1, 127, 384, 3584)


def _quant_input(cuda, M, K, dtype, seed):
    """Normal rows, row 0 of exact .5 ties (chip_smoke._tie_row), row 1
    zero."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=cuda) * 3
    x[0] = (torch.arange(K, device=cuda) % 120 - 60 + 0.5).float()
    x[0, 0] = 127.0
    if M > 1:
        x[1] = 0.0
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("K", [1024, 1536, 4096, 8960])
def test_quantize_rows_bit_equal_to_plain(cuda, K, G, dtype):
    """The one-pass quantizer against its plain version, int8 rows and am
    bit for bit, at every row count (the launcher's layout follows M and
    K: 1 to 3,584 rows take several)."""
    from vlaser_tpu_torch.kernels import w8a8

    for M in QUANT_ROWS:
        x = _quant_input(cuda, M, K, dtype, 11)
        n = w8a8.quant_launch_count
        q, am = w8a8.quantize_rows(x, G)
        torch.cuda.synchronize()
        assert w8a8.quant_launch_count == n + 1
        p_q, p_am = w8a8.quantize_rows_plain(x, G)
        assert torch.equal(q, p_q) and torch.equal(am, p_am), M


@pytest.mark.parametrize("K", [1024, 1536, 4096, 8960])
def test_quantize_silu_mul_bit_equal_to_eager(cuda, K):
    """h = F.silu(g) * u in the eager ops' rounding, then its rows: the
    int8 rows and am bit for bit; row 0 is h = the tie row (silu(64) = 64
    and u = tie / 64, exact in bf16), row 1 zero."""
    from vlaser_tpu_torch.kernels import w8a8

    for M in QUANT_ROWS:
        g = _quant_input(cuda, M, K, torch.bfloat16, 12)
        u = _quant_input(cuda, M, K, torch.float32, 13)
        g[0] = 64.0
        u[0] = u[0] / 64.0
        u = u.to(torch.bfloat16)
        n = w8a8.silu_quant_launch_count
        q, am = w8a8.quantize_silu_mul(g, u)
        torch.cuda.synchronize()
        assert w8a8.silu_quant_launch_count == n + 1
        h = torch.nn.functional.silu(g) * u
        assert torch.equal(h[0].float(), u[0].float() * 64.0)
        p_q, p_am = w8a8.quantize_rows_plain(h)
        assert torch.equal(q, p_q) and torch.equal(am, p_am), M


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_ln_prologue_matches_fp32_layer_norm(cuda, dtype):
    """The LayerNorm prologue (the act_quant ViT's LN1 / LN2) against the
    fp32 twin: its sums run in another order, so an int8 value may round
    one step the other way (at most 1e-3 of them) and am agrees within
    1e-5; the first rows of a 3,584-row call equal a 384-row call bit for
    bit (the order of a row's sums does not depend on M)."""
    from vlaser_tpu_torch.kernels import w8a8

    g = torch.Generator(device=cuda).manual_seed(14)
    K = 1024
    w = 1 + 0.1 * torch.randn(K, generator=g, device=cuda)
    b = 0.1 * torch.randn(K, generator=g, device=cuda)
    x = (torch.randn(3584, K, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    first = None
    for M in QUANT_ROWS:
        q, am = w8a8.quantize_ln_probe(x[:M], w, b, 1e-6)
        torch.cuda.synchronize()
        p_q, p_am = w8a8.quantize_ln_rows_plain(x[:M], w, b, 1e-6)
        d = (q.int() - p_q.int()).abs()
        assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3, M
        assert ((am - p_am).abs() <= 1e-5 * p_am).all(), M
        if M == 384:
            first = q
    assert torch.equal(q[:384], first)


@pytest.mark.parametrize("K", [16400, 18944, 32768])
def test_wide_bf16_rows_bit_equal_to_plain(cuda, K):
    """bf16 rows past 16,384 values (Qwen2.5-7B's 18,944-wide down
    projection input; up to 512 threads x 8 chunks of 8) through both
    quantizers, int8 rows and am bit for bit at every row count."""
    from vlaser_tpu_torch.kernels import w8a8

    for M in QUANT_ROWS:
        x = _quant_input(cuda, M, K, torch.bfloat16, 15)
        q, am = w8a8.quantize_rows(x)
        torch.cuda.synchronize()
        p_q, p_am = w8a8.quantize_rows_plain(x)
        assert torch.equal(q, p_q) and torch.equal(am, p_am), M
        g = _quant_input(cuda, M, K, torch.bfloat16, 16)
        q, am = w8a8.quantize_silu_mul(g, x)
        torch.cuda.synchronize()
        p_q, p_am = w8a8.quantize_silu_mul_plain(g, x)
        assert torch.equal(q, p_q) and torch.equal(am, p_am), M


def test_quantizers_refuse_bad_rows(cuda):
    """K % 16, K / groups % 8, a misaligned row start, mismatched g / u
    and rows beyond a block's threads x chunks (32,768 bf16 or 16,384 fp32
    values) raise before any launch; nothing falls back to the CPU."""
    from vlaser_tpu_torch.kernels import w8a8

    bf = torch.bfloat16
    with pytest.raises(ValueError):
        w8a8.quantize_rows(torch.zeros(4, 40, dtype=bf, device=cuda))
    with pytest.raises(ValueError):
        w8a8.quantize_rows(torch.zeros(4, 16, dtype=bf, device=cuda), 4)
    buf = torch.zeros(4 * 64 + 1, dtype=bf, device=cuda)
    skew = buf[1:].view(4, 64)  # contiguous, 2 bytes off a 16-byte boundary
    with pytest.raises(ValueError):
        w8a8.quantize_rows(skew)
    with pytest.raises(ValueError):
        w8a8.quantize_silu_mul(skew, skew)
    a = torch.zeros(4, 64, dtype=bf, device=cuda)
    with pytest.raises(ValueError):
        w8a8.quantize_silu_mul(a, torch.zeros(4, 32, dtype=bf, device=cuda))
    with pytest.raises(TypeError):
        w8a8.quantize_silu_mul(a.float(), a.float())
    with pytest.raises(ValueError, match="32,768"):  # > 512 x 8 chunks
        w8a8.quantize_rows(torch.zeros(2, 32784, dtype=bf, device=cuda))
    with pytest.raises(ValueError, match="32,768"):
        w8a8.quantize_silu_mul(*[torch.zeros(2, 32784, dtype=bf,
                                             device=cuda)] * 2)
    with pytest.raises(ValueError, match="16,384"):  # > 256 x 8 chunks
        w8a8.quantize_rows(torch.zeros(2, 16400, device=cuda))


def test_qwen2_w8a8_layer_runs_four_quantizers(cuda):
    """A w8a8 Qwen2 stack on the card: 3 quantize_rows and 1
    quantize_silu_mul launches a layer (7 GEMMs), and its output equals
    the per-Dense route's (7 quantize_rows, eager silu * u) bit for bit."""
    from vlaser_tpu_torch.core.config import tiny_llm
    from vlaser_tpu_torch.core.quant import quantize_module
    from vlaser_tpu_torch.kernels import w8a8
    from vlaser_tpu_torch.models import layers
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.models.qwen2 import Qwen2Model

    cfg = tiny_llm()
    model = Qwen2Model(cfg, device=cuda)
    init_normal_(model, torch.Generator(device=cuda).manual_seed(15))
    quantize_module(model, (r"kernel$",), (r"kernel$",), min_size=1)
    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn(2, 80, cfg.hidden_size, generator=g, device=cuda).to(
        torch.bfloat16)
    pos = torch.arange(80, device=cuda)[None].expand(2, 80)
    counts = lambda: (w8a8.quant_launch_count, w8a8.silu_quant_launch_count,
                      w8a8.gemm_launch_count)
    L = cfg.num_layers
    with torch.no_grad():
        before = counts()
        got = model(x, pos, attn_impl="reference")[0]
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(counts(), before)] == [3 * L, L, 7 * L]
        shared = layers._int8_shared
        layers._int8_shared = lambda x, denses: False
        try:
            before = counts()
            ref = model(x, pos, attn_impl="reference")[0]
            torch.cuda.synchronize()
        finally:
            layers._int8_shared = shared
        assert [a - b for a, b in zip(counts(), before)] == [7 * L, 0, 7 * L]
    assert torch.equal(got, ref)


@pytest.mark.parametrize("B,S", [(1, 100), (2, 77), (1, 1025), (2, 1025),
                                 (13, 1025)])
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


def test_vit_attention_kernel_shifts_out_of_range_rows_by_their_max(cuda):
    """Rows whose largest score lies far below the norm bound (q long and
    orthogonal to the long keys): the kernel runs its second pass and, as
    the twin, shifts them by their largest score: finite, within 2e-2 of
    the twin; the in-range rows of the same block too."""
    from vlaser_tpu_torch.kernels import fused_vit

    g = torch.Generator(device=cuda).manual_seed(10)
    B, S, heads = 2, 300, 16
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    q, k, v = r(B, S, heads, 64) * 0.3, r(B, S, heads, 64) * 0.3, r(B, S,
                                                                    heads, 64)
    k[..., 1] = 32.0           # every key long along dim 1
    q[0, :20] = 0.0
    q[0, :20, :, 0] = 32.0     # 20 rows long along dim 0: out of range
    q[0, :20, :, 2] = 1.0
    k[0, :, :, 2] = r(S, heads)
    bf = torch.bfloat16
    qs, ks, vs = (t.reshape(B * S, heads * 64).to(bf) for t in (q, k, v))
    got = fused_vit.attention(qs, ks, vs, B, S, heads)
    torch.cuda.synchronize()
    _check(got, fused_vit._attention(qs, ks, vs, B, S, heads))


def test_engine_tokens_equal_solo_decode_fp32(cuda):
    """A short continuous-batching run on the card (tiny_vlm, fp32 compute
    and cache, 3 slots, staggered text and an image request, a speculative
    engine beside it): every request's tokens equal its solo plain decode."""
    import os
    import sys

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from vlaser_tpu_torch.serve.engine import (ContinuousBatchingEngine,
                                               Request)

    model = chip_smoke._tiny_fp32_vlm(torch, cuda, 3)
    cfg = model.cfg
    rng = np.random.default_rng(7)
    npt, img = cfg.num_image_token, cfg.vision.image_size
    reqs = []
    for i, n in enumerate((4, 9, 5, 13, 7, 3, 11)):
        row = rng.integers(1, 400, (n + (npt if i == 3 else 0),))
        px = None
        if i == 3:
            row[2:2 + npt] = cfg.img_context_token_id
            px = rng.standard_normal((1, img, img, 3)).astype(np.float32)
        reqs.append(Request(uid=i, input_ids=row, pixel_values=px,
                            max_new_tokens=(6, 9, 12)[i % 3]))
    oracle = chip_smoke._solo_oracle(torch, np, model, [3], torch.float32)
    want = {r.uid: oracle(r) for r in reqs}
    for kw in (dict(chunk_size=4), dict(chunk_size=3, pipeline_depth=2),
               dict(chunk_size=4, speculative_draft_len=4,
                    speculative_adaptive=False)):
        eng = ContinuousBatchingEngine(
            model, num_slots=3, max_len=96, eos_token_ids=[3],
            pad_token_id=0, prefill_buckets=(16, 32), cache_dtype=torch.float32,
            **kw)
        assert eng.cache.k.is_cuda and eng.cache.length.is_cuda
        got = {c.uid: c.token_ids for c in eng.run(reqs)}
        assert got == want, kw
        assert eng.stats["steps_run"] >= eng.stats["steps_live"]


def _adam8bit_leaf(dev, n, seed):
    """A leaf of n elements with a non-zero 8-bit state: two twin steps
    from zero, gradients across 6 decades."""
    from vlaser_tpu_torch.train import optim8bit as o

    g = torch.Generator(device=dev).manual_seed(seed)
    grad = lambda: torch.randn(n, generator=g, device=dev) * 10.0 ** (
        -6 * torch.rand(n, generator=g, device=dev))
    p = torch.randn(n, generator=g, device=dev)
    st = o.init_state(p)
    for count in (1, 2):
        o.adam8bit_update_plain(grad(), p, st["m_q"], st["m_scale"],
                                st["v_q"], st["v_scale"],
                                o.hyper(0.9, 0.999, 1e-8, 0.01, 1e-3, count))
    return p, st, grad()


@pytest.mark.parametrize("n", [4096, 37 * 256 + 13, (1 << 20) + 5,
                               3 * 32_768 * 256 + 256])
def test_adam8bit_kernel_equals_twin_bit_for_bit(cuda, n):
    """One step from the same non-zero state: codes, scales and parameters
    equal in every entry (tail blocks, several slabs of the twin); a b1 one
    fp32 ulp off must show (the gate can see a difference)."""
    import numpy as np

    from vlaser_tpu_torch.kernels import adam8bit
    from vlaser_tpu_torch.train import optim8bit as o

    p, st, g = _adam8bit_leaf(cuda, n, seed=n % 97)
    h = o.hyper(0.9, 0.999, 1e-8, 0.01, 1e-3, 3)
    clone = lambda: (p.clone(), {k: v.clone() for k, v in st.items()})
    (pk, sk), (pt, stw) = clone(), clone()
    before = adam8bit.launch_count
    adam8bit.adamw8bit(g, pk, sk["m_q"], sk["m_scale"], sk["v_q"],
                       sk["v_scale"], h)
    torch.cuda.synchronize()
    assert adam8bit.launch_count == before + 1
    o.adam8bit_update_plain(g, pt, stw["m_q"], stw["m_scale"], stw["v_q"],
                            stw["v_scale"], h)
    for k in ("m_q", "m_scale", "v_q", "v_scale"):
        assert torch.equal(sk[k], stw[k]), k
    assert torch.equal(pk, pt)
    b1 = float(np.nextafter(np.float32(0.9), np.float32(1)))
    ho = o.Hyper(**{**h.__dict__, "b1": b1})
    (pc, sc) = clone()
    adam8bit.adamw8bit(g, pc, sc["m_q"], sc["m_scale"], sc["v_q"],
                       sc["v_scale"], ho)
    assert not torch.equal(sc["m_scale"], stw["m_scale"])


def test_adamw8bit_optimizer_on_the_card_equals_the_cpu_twin(cuda):
    """AdamW8bit over a patch conv (HWIO blocking), a tail leaf and a
    small fp32 leaf: 3 steps on the card equal 3 on the CPU bit for bit."""
    from vlaser_tpu_torch.kernels import adam8bit
    from vlaser_tpu_torch.train.optim8bit import AdamW8bit

    gen = torch.Generator().manual_seed(0)
    shapes = [(64, 3, 14, 14), (70 * 256 + 3,), (100,)]
    init = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) * 1e-2 for s in shapes]
             for _ in range(3)]
    out = {}
    for dev in ("cpu", cuda):
        ps = [torch.nn.Parameter(t.clone().to(dev)) for t in init]
        opt = AdamW8bit(ps, lr=1e-3, weight_decay=0.01, hwio=ps[:1])
        before = adam8bit.launch_count
        for gs in grads:
            for p, gr in zip(ps, gs):
                p.grad = gr.to(dev)
            opt.step()
        torch.cuda.synchronize()
        out[str(dev)] = ([p.detach().cpu() for p in ps],
                         [{k: v.cpu() for k, v in opt.state[p].items()}
                          for p in ps], adam8bit.launch_count - before)
    (pc, sc, nc), (pg, sg, ng) = out["cpu"], out[str(cuda)]
    assert nc == 0 and ng == 3 * 2
    for a, b in zip(pc, pg):
        assert torch.equal(a, b)
    for a, b in zip(sc, sg):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
