"""One quantization per distinct input in the port's w8a8 layers
(models/layers.py `w8a8_group`, `gated_mlp`; kernels/w8a8.py
`quantize_silu_mul`) against the per-Dense route and the JAX package.

- quantize_silu_mul's plain route against JAX's `w8a8_dot` row
  quantization. The two frameworks round silu(g) * u in bf16 differently:
  JAX's `nn.silu` is x * sigmoid(x) with a bf16 rounding after each of exp,
  add, div and both products; the port keeps PyTorch's eager rounding
  (bf16(silu(g)) in fp32, then a bf16 product). So h is held to 4 bf16
  steps of JAX's (five roundings against two), and the int8 rows and row
  scales must then be equal bit for bit wherever h agrees: JAX's quantizer
  on the port's h gives the port's rows exactly, and JAX's own rows agree
  on every element whose h and whose row's amax agree.
- The shared route against the per-Dense route (`_int8_shared` forced
  off) in Qwen2Layers and in a MixtureBlock (SiLU and tanh-GELU):
  torch.equal, and 4 quantizations a layer (q/k/v, o, gate/up, down)
  against 7.
- With a gradient asked of the input, each Dense keeps W8A8Dot and its STE
  backward: within 1e-5 of JAX's custom VJP (fp32 matmuls summed in
  another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vlaser_tpu.models.layers import w8a8_dot as jax_w8a8_dot
from vlaser_tpu_torch.core.config import tiny_gemma_llm, tiny_llm
from vlaser_tpu_torch.core.quant import quantize_module
from vlaser_tpu_torch.kernels import ops, w8a8
from vlaser_tpu_torch.models import layers
from vlaser_tpu_torch.models.layers import (Dense, gated_mlp, init_normal_,
                                            layer_slices, w8a8_group)
from vlaser_tpu_torch.models.qwen2 import Qwen2Model
from vlaser_tpu_torch.policy.joint import MixtureBlock

BF = torch.bfloat16
H_STEPS = 4  # bf16 steps between JAX's h and the port's (see the docstring)


def _jax_quantize(h):
    """JAX's int8 rows and amax of h (bf16 [M, K] numpy as float32), read
    back through w8a8_dot with an identity weight: y = q * (amax / 127)
    exactly, so round(y / (amax / 127)) = q."""
    K = h.shape[-1]
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    y = np.asarray(jax.jit(jax_w8a8_dot)(jh, jnp.eye(K, dtype=jnp.int8),
                                         jnp.ones((1, K), jnp.float32)))
    am = np.maximum(np.abs(h).max(-1, keepdims=True), np.float32(1e-9))
    return np.round(y / (am * np.float32(1.0 / 127.0))).astype(np.int8), am


def _bf16_steps(a, b):
    """|a - b| in bf16 steps of b's binade."""
    mag = np.maximum(np.abs(b), np.float32(2.0 ** -126))
    return np.abs(a - b) / 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("scale", [0.5, 4.0])
def test_quantize_silu_mul_equals_jax_rows(scale):
    rng = np.random.default_rng(21)
    M, K = 96, 320
    g = (rng.standard_normal((M, K)) * scale).astype(np.float32)
    u = rng.standard_normal((M, K)).astype(np.float32)
    g[0], u[0] = 64.0, 0.0  # silu(64) = 64: an all-zero row of h
    gt, ut = torch.from_numpy(g).to(BF), torch.from_numpy(u).to(BF)
    q, am = w8a8.quantize_silu_mul(gt, ut)
    h = (F.silu(gt) * ut).float().numpy()
    # the port's rows are the rows of the eager product, and JAX's
    # quantizer makes the same int8 rows and scales from that product
    p_q, p_am = w8a8.quantize_rows_plain(F.silu(gt) * ut)
    assert torch.equal(q, p_q) and torch.equal(am, p_am)
    jq, jam = _jax_quantize(h)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(am.numpy(), jam)
    assert am[0].item() == pytest.approx(1e-9) and (q[0] == 0).all()
    # against JAX's own silu(g) * u in bf16
    jh = np.asarray(jax.jit(lambda a, b: jax.nn.silu(a) * b)(
        jnp.asarray(g).astype(jnp.bfloat16),
        jnp.asarray(u).astype(jnp.bfloat16)).astype(jnp.float32))
    steps = _bf16_steps(h, jh)
    assert steps.max() <= H_STEPS, steps.max()
    jq2, jam2 = _jax_quantize(jh)
    same = (h == jh) & (am.numpy() == jam2)
    assert same.mean() > 0.3  # the check below covers a share of elements
    np.testing.assert_array_equal(q.numpy()[same], jq2[same])
    print(f"h differing from JAX's: {(steps > 0).mean():.4f} of elements, "
          f"at most {steps.max():.0f} bf16 steps")


def _flag_all(model):
    """Every Dense kernel int8 and flagged for w8a8 (tiny kernels too)."""
    return quantize_module(model, (r"kernel$",), (r"kernel$",), min_size=1)


@pytest.fixture
def counted(monkeypatch):
    """Counts the quantizer calls of the CPU route: {"rows", "silu_mul"}."""
    n = {"rows": 0, "silu_mul": 0}
    rows, silu = w8a8.quantize_rows, w8a8.quantize_silu_mul

    def count_rows(*a, **k):
        n["rows"] += 1
        return rows(*a, **k)

    def count_silu(*a, **k):
        n["silu_mul"] += 1
        return silu(*a, **k)

    monkeypatch.setattr(w8a8, "quantize_rows", count_rows)
    monkeypatch.setattr(w8a8, "quantize_silu_mul", count_silu)
    return n


def _both_routes(monkeypatch, counted, fn):
    """fn() on the shared route, then with every Dense on its own; -> (the
    two results, their quantizer counts)."""
    got = fn()
    shared = dict(counted)
    counted.update(rows=0, silu_mul=0)
    with monkeypatch.context() as m:
        m.setattr(layers, "_int8_shared", lambda x, denses: False)
        ref = fn()
    return got, ref, shared, dict(counted)


def _tensors(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def test_qwen2_layers_quantize_once_per_distinct_input(monkeypatch,
                                                       counted):
    cfg = tiny_llm()
    model = Qwen2Model(cfg, device="cpu")
    init_normal_(model, torch.Generator().manual_seed(0))
    _flag_all(model)
    B, S = 2, 80  # 160 rows: over the 128-row w8a8 threshold
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, S, cfg.hidden_size)).astype(np.float32)).to(BF)
    pos = torch.arange(S)[None].expand(B, S)
    run = lambda: model(x, pos, attn_impl="reference")[0]
    with torch.no_grad():
        got, ref, shared, per_dense = _both_routes(monkeypatch, counted, run)
    assert torch.equal(got, ref) and got.isfinite().all()
    L = cfg.num_layers
    assert shared == {"rows": 3 * L, "silu_mul": L}
    assert per_dense == {"rows": 7 * L, "silu_mul": 0}


@pytest.mark.parametrize("llm", ["qwen2", "gemma"])
def test_mixture_block_quantizes_once_per_distinct_input(monkeypatch,
                                                         counted, llm):
    cfg = tiny_llm() if llm == "qwen2" else tiny_gemma_llm()
    blk = MixtureBlock(cfg, cfg.num_layers, device="cpu")
    init_normal_(blk, torch.Generator().manual_seed(2))
    _flag_all(blk)
    rng = np.random.default_rng(3)
    B, S = 1, 150
    x = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.hidden_size)).astype(np.float32)).to(BF)
    attn = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.q_dim)).astype(np.float32)).to(BF)
    cos, sin = ops.rope_cos_sin(torch.arange(S)[None], cfg.head_dim,
                                cfg.rope_theta)

    def run():
        with layer_slices(blk):
            return (*blk.qkv(x, cos, sin, 1), blk.post_attn(x, attn, 1))

    with torch.no_grad():
        got, ref, shared, per_dense = _both_routes(monkeypatch, counted, run)
    for a, b in zip(_tensors(got), _tensors(ref)):
        assert torch.equal(a, b) and a.isfinite().all()
    silu = cfg.mlp_act == "silu"
    assert shared == {"rows": 3 if silu else 4, "silu_mul": int(silu)}
    assert per_dense == {"rows": 7, "silu_mul": 0}


def test_gated_mlp_without_w8a8_down_stays_eager(monkeypatch, counted):
    """gate/up flagged, down not: the shared gate/up rows, then the eager
    product into down's weight-only matmul."""
    g = torch.Generator().manual_seed(4)
    gate, up, down = Dense(64, 96, False), Dense(64, 96, False), Dense(
        96, 64, False)
    for d in (gate, up, down):
        init_normal_(d, g)
    _flag_all(gate)
    _flag_all(up)
    quantize_module(down, (r"kernel$",), min_size=1)  # weight-only
    x = torch.randn(130, 64, generator=g).to(BF)
    with torch.no_grad():
        got, ref, shared, per_dense = _both_routes(
            monkeypatch, counted, lambda: gated_mlp(x, gate, up, down,
                                                    F.silu))
    assert torch.equal(got, ref)
    assert shared == {"rows": 1, "silu_mul": 0}
    assert per_dense == {"rows": 2, "silu_mul": 0}


def test_grad_route_keeps_the_ste_backward_of_jax(counted):
    """An input that asks for a gradient: each Dense runs W8A8Dot (one
    quantization each) and dx is JAX's STE VJP of the same sum."""
    rng = np.random.default_rng(5)
    M, K, N = 140, 64, 48
    x = rng.standard_normal((M, K)).astype(np.float32)
    gy = [rng.standard_normal((M, N)).astype(np.float32) for _ in range(2)]
    ds = [Dense(K, N, False, compute_dtype=torch.float32) for _ in range(2)]
    gen = torch.Generator().manual_seed(6)
    for d in ds:
        init_normal_(d, gen)
        _flag_all(d)
    xt = torch.from_numpy(x).requires_grad_()
    ys = w8a8_group(xt, ds)
    assert counted == {"rows": 2, "silu_mul": 0}
    sum((y * torch.from_numpy(g)).sum() for y, g in zip(ys, gy)).backward()
    kq = [jnp.asarray(d.kernel_q.numpy()) for d in ds]
    ks = [jnp.asarray(d.kernel_scale.numpy()) for d in ds]

    def f(a):
        return sum((jax_w8a8_dot(a, q, s) * g).sum()
                   for q, s, g in zip(kq, ks, gy))

    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.abs(want).max() > 0.1  # the gradient is not cut
    # without a gradient the same Dense share one quantization, same values
    counted.update(rows=0)
    with torch.no_grad():
        shared = w8a8_group(xt, ds)
    assert counted["rows"] == 1
    for a, b in zip(shared, ys):
        assert torch.equal(a, b.detach())


def test_gated_mlp_gradient_flows_through_the_eager_route(counted):
    """With a gradient asked of x, gated_mlp runs the per-Dense route
    (3 quantizations, no silu-mul kernel) and dx equals that route's."""
    gen = torch.Generator().manual_seed(7)
    mods = [Dense(32, 64, False), Dense(32, 64, False), Dense(64, 32, False)]
    for d in mods:
        init_normal_(d, gen)
        _flag_all(d)
    x = torch.randn(2, 70, 32, generator=gen).to(BF).requires_grad_()
    y = gated_mlp(x, *mods, F.silu)
    assert counted == {"rows": 3, "silu_mul": 0}
    (dx,) = torch.autograd.grad(y.float().sum(), x)
    x2 = x.detach().clone().requires_grad_()
    gate, up, down = mods
    y2 = down(F.silu(gate(x2)) * up(x2))
    (dx2,) = torch.autograd.grad(y2.float().sum(), x2)
    assert torch.equal(y, y2) and torch.equal(dx, dx2)
    assert dx.float().abs().max() > 0


def test_quantize_wrappers_raise_on_other_devices():
    meta = torch.empty(4, 32, dtype=BF, device="meta")
    for call in (lambda: w8a8.quantize_rows(meta),
                 lambda: w8a8.quantize_silu_mul(meta, meta)):
        with pytest.raises(RuntimeError):
            call()
    with pytest.raises(ValueError):  # the LN probe runs on the card alone
        w8a8.quantize_ln_probe(meta, meta[0].float(), meta[0].float(), 1e-6)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it reaches a wrapper's CUDA
    route on a box without a card."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("which", ["silu_mul", "ln_probe"])
def test_new_quantizers_raise_when_the_library_cannot_load(monkeypatch,
                                                           which):
    from vlaser_tpu_torch.kernels import _build

    def no_library():
        raise RuntimeError("cannot build the kernel library: nvcc not found")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(w8a8, "_fns", {})
    card = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt).as_subclass(
        _OnCard)
    count = w8a8.silu_quant_launch_count
    with pytest.raises(RuntimeError, match="cannot build"):
        if which == "silu_mul":
            w8a8.quantize_silu_mul(card(4, 32, dt=BF), card(4, 32, dt=BF))
        else:
            w8a8.quantize_ln_probe(card(4, 32, dt=BF), card(32), card(32),
                                   1e-6)
    assert w8a8.silu_quant_launch_count == count


def test_quantize_ln_rows_plain_is_the_vit_twin_layer_norm():
    """The LN prologue's plain version is fused_vit's twin LayerNorm
    quantized (the twin the act_quant stack is held to)."""
    from vlaser_tpu_torch.kernels.fused_vit import _ln

    g = torch.Generator().manual_seed(8)
    x = torch.randn(40, 96, generator=g).to(BF)
    w, b = 1 + 0.1 * torch.randn(96, generator=g), 0.1 * torch.randn(
        96, generator=g)
    q, am = w8a8.quantize_ln_rows_plain(x, w, b, 1e-6)
    p_q, p_am = w8a8.quantize_rows_plain(_ln(x, w, b, 1e-6))
    assert torch.equal(q, p_q) and torch.equal(am, p_am)

