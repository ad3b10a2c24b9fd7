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


@pytest.mark.parametrize("R,E,step0", [(4, 37, False), (5, 33, True)])
def test_fused_int8_kernel_matches_twin(cuda, R, E, step0):
    from vlaser_tpu_torch.core.quant import quantize_int8
    from vlaser_tpu_torch.kernels import fused_decode, ops

    g = torch.Generator(device=cuda).manual_seed(1)
    L, C, inter, H, KVH, D = 2, 256, 640, 4, 2, 128
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device=cuda) * sc
    ws = {}
    for name, k, n in (("q", C, H * D), ("k", C, KVH * D), ("v", C, KVH * D),
                       ("o", H * D, C), ("g", C, inter), ("u", C, inter),
                       ("d", inter, C)):
        ws["w" + name], ws["s" + name] = quantize_int8(r(L, k, n, sc=0.05), -2)
    bf = torch.bfloat16
    cos, sin = ops.rope_cos_sin(torch.arange(R, device=cuda) + 3.0, D, 1e4)
    selfm = torch.zeros(R, R, device=cuda)
    if step0:
        selfm[0, 1:] = fused_decode.NEG_INF
    extm = torch.zeros(1, E, device=cuda)
    extm[0, -5:] = fused_decode.NEG_INF
    args = (r(R, C, sc=0.3).to(bf), cos.to(bf), sin.to(bf), selfm, extm,
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


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,pad,levels,causal,off", [
    (2, 77, 77, 4, 4, 64, 9, False, False, 0),
    (2, 100, 100, 6, 2, 128, 13, True, False, 0),
    (2, 40, 100, 6, 2, 128, 0, False, True, 60),
    (1, 130, 130, 2, 1, 64, 0, False, True, 0),
])
def test_flash_attention_kernels_match_plain(cuda, B, Sq, Skv, H, KVH, D, pad,
                                             levels, causal, off):
    from vlaser_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(2)
    bf = torch.bfloat16
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(bf)
    q, k, v, do = r(B, Sq, H, D), r(B, Skv, KVH, D), r(B, Skv, KVH, D), \
        r(B, Sq, H, D)
    kv_seg, kv_lev = _meta_case(B, Skv, pad, levels, cuda)
    q_seg, q_lev = (kv_seg, kv_lev) if Sq == Skv else _meta_case(
        B, Sq, 0, False, cuda)
    qm, km = fa.pack_meta(q_seg, q_lev), fa.pack_meta(kv_seg, kv_lev)
    nf, nb = fa.fwd_launch_count, fa.bwd_launch_count
    out, lse = fa.flash_attention_fwd(q, k, v, qm, km, off, causal)
    grads = fa.flash_attention_bwd(q, k, v, qm, km, off, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (fa.fwd_launch_count, fa.bwd_launch_count) == (nf + 1, nb + 1)
    p_out, p_lse = fa.flash_attention_fwd_plain(q, k, v, qm, km, off, causal)
    p_grads = fa.flash_attention_bwd_plain(q, k, v, qm, km, off, out, lse, do,
                                           causal)
    _check(out, p_out)
    for a, b in zip(grads, p_grads):
        _check(a, b)
    live = p_lse > -1e29
    assert torch.equal(lse[~live], p_lse[~live])
    assert (lse[live] - p_lse[live]).abs().max().item() <= 1e-2
    dead = (q_seg == 0)
    assert (out[dead] == 0).all() and (grads[0][dead] == 0).all()


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
