"""The K-major int8 weights of the port's w8a8 GEMM (vlaser_tpu_torch):
where they come from, what they leave alone, and the GEMM's options on the
CPU route against the JAX package's `w8a8_dot`.

The int8 tensor-core product reads both operands K-major, so a w8a8 Dense
(the `kernel_aq` flag) derives `kernel_qt` = `kernel_q` transposed to [...,
out, in] on its first w8a8 call, outside the state dict, and drops it when
a state is loaded; the act_quant ViT is packed [L, N, K] from the same
copy; the weight-only leaves and the decode stack's packing keep the JAX
[K, N] layout. Layout checks are exact. Products are held as in
test_torch_w8a8.py: the same int8 rows and rescale order give y within one
fp32 rounding of JAX's (rtol 2^-23); the CPU route of int8_gemm_ex runs
the same float ops in the same order as the plain twins, so those are
compared bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.quant import quantize_variables
from vlaser_tpu.models.layers import Dense as JaxDense
from vlaser_tpu.models.layers import w8a8_dot as jax_w8a8_dot
from vlaser_tpu_torch.core import config
from vlaser_tpu_torch.core.quant import quantize_for_serving, quantize_int8
from vlaser_tpu_torch.kernels import fused_vit, w8a8
from vlaser_tpu_torch.models import layers
from vlaser_tpu_torch.models.layers import Dense, load_state
from vlaser_tpu_torch.utils.convert import from_jax_variables

ULP = 2.0 ** -23


def _model(target):
    torch.manual_seed(0)
    if target == "policy":
        from vlaser_tpu_torch.policy.pizero import PiZeroVLA

        model = PiZeroVLA(config.tiny_vla(), device="cpu")
    else:
        from vlaser_tpu_torch.models.vlm import InternVLChatModel

        model = InternVLChatModel(config.tiny_vlm(), device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g) * 0.05)
    return model


@pytest.mark.parametrize("target", ["policy", "vlm"])
def test_serving_w8a8_gives_each_w8a8_dense_a_kmajor_buffer(target):
    """quantize_for_serving(w8a8) derives no K-major copy up front; each
    kernel_aq Dense's kernel_kmajor() is kernel_q^T, contiguous int8, kept
    as kernel_qt and absent from state_dict(); weight-only int8 leaves
    hold none; the LLM stack's packing for the decode kernel (chat) keeps
    kernel_q's [L, K, N] storage."""
    model = quantize_for_serving(_model(target), target=target, min_size=1)
    assert not any(n.endswith("kernel_qt") for n, _ in model.named_buffers())
    flagged = weight_only = 0
    for name, mod in model.named_modules():
        if "kernel_q" not in mod._buffers:
            continue
        if "kernel_aq" in mod._buffers:
            flagged += 1
            kt = mod.kernel_kmajor()
            assert kt.is_contiguous() and kt.dtype == torch.int8
            assert torch.equal(kt, mod.kernel_q.transpose(-1, -2)), name
            assert mod.kernel_qt is kt
        else:
            weight_only += 1
            assert "kernel_qt" not in mod._buffers, name
    assert flagged >= 4 and weight_only >= (1 if target == "vlm" else 0)
    state = model.state_dict()
    assert not any(k.endswith("kernel_qt") for k in state)
    if target == "vlm":
        from vlaser_tpu_torch.inference.fused_runner import pack_qwen2_stack

        lm = model.language_model
        packed = pack_qwen2_stack(lm)
        q_proj = lm.model.layers.self_attn.q_proj
        assert packed["wq"].data_ptr() == q_proj.kernel_q.data_ptr()
        assert packed["wq"].shape == q_proj.kernel_q.shape  # [L, K, N]


def _jax_w8a8_state(seed):
    """A JAX w8a8 Dense tree (kernel_q, kernel_scale, kernel_aq) over 32 ->
    48, converted to the port's flat state."""
    jd = JaxDense(features=48, compute_dtype=jnp.float32)
    x = np.zeros((4, 32), np.float32)
    jv = quantize_variables(jd.init(jax.random.PRNGKey(seed),
                                    jnp.asarray(x)),
                            (r"kernel$",), act_quant_patterns=(r"kernel$",),
                            min_size=1)
    return from_jax_variables(jax.tree_util.tree_map(np.asarray, jv))


def test_load_state_attaches_kmajor_to_jax_w8a8_leaves():
    """The converter path: a JAX w8a8 Dense tree loads into the port, whose
    kernel_kmajor() is then kernel_q^T, while neither the converted state
    nor the port's state_dict() names kernel_qt."""
    state = _jax_w8a8_state(0)
    assert not any(k.endswith("kernel_qt") for k in state)
    port = load_state(Dense(32, 48, compute_dtype=torch.float32), state)
    assert torch.equal(port.kernel_kmajor(), port.kernel_q.t())
    assert "kernel_qt" not in port.state_dict()
    load_state(port, state)  # loading again: the buffer is no missing key


@pytest.mark.parametrize("how", ["load_state", "load_state_dict"])
def test_loading_new_w8a8_weights_replaces_the_kmajor_copy(how):
    """A Dense that ran w8a8 (so holds kernel_qt) and then loads different
    int8 weights, through load_state or torch's load_state_dict: its
    K-major copy is the new kernel_q^T, and a call at ACT_QUANT_MIN_ROWS
    rows gives the new weights' w8a8 product bit for bit (not the old)."""
    rows = layers.ACT_QUANT_MIN_ROWS
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (rows, 32)).astype(np.float32))
    port = load_state(Dense(32, 48, compute_dtype=torch.float32),
                      _jax_w8a8_state(0))
    with torch.no_grad():
        y_old = port(x)
    assert "kernel_qt" in port._buffers
    new_state = _jax_w8a8_state(1)
    if how == "load_state":
        load_state(port, new_state)
    else:
        other = load_state(Dense(32, 48, compute_dtype=torch.float32),
                           new_state)
        port.load_state_dict(other.state_dict())
    assert torch.equal(port.kernel_q, new_state["kernel_q"])
    with torch.no_grad():
        y = port(x)
    assert torch.equal(port.kernel_qt, port.kernel_q.t())
    kq, ks = new_state["kernel_q"], new_state["kernel_scale"]
    want = layers.w8a8_dot(x, kq.t().contiguous(), ks) + port.bias
    assert torch.equal(y, want)
    assert not torch.equal(y, y_old)


def test_kmajor_copy_only_where_a_call_reaches_act_quant_rows():
    """A w8a8 Dense called under ACT_QUANT_MIN_ROWS rows (weight-only
    matmul) holds no K-major copy; its first call at that row count derives
    one, a normal tensor even under inference_mode."""
    port = load_state(Dense(32, 48, compute_dtype=torch.float32),
                      _jax_w8a8_state(2))
    rows = layers.ACT_QUANT_MIN_ROWS
    with torch.inference_mode():
        port(torch.ones(rows - 1, 32))
        assert "kernel_qt" not in port._buffers
        port(torch.ones(2, rows // 2, 32))
    assert not port.kernel_qt.is_inference()
    assert torch.equal(port.kernel_qt, port.kernel_q.t())


def test_pack_vit_stack_act_quant_is_kmajor():
    """An int8 encoder packs K-major [L, N, K], the Dense's own copy;
    fc2's two K halves of the B > 1 stack are column slices of its [L, C,
    inter] rows."""
    from vlaser_tpu_torch.models.internvit import InternVisionModel

    cfg = config.tiny_vision()
    torch.manual_seed(3)
    vm = InternVisionModel(cfg, device="cpu")
    quantize_for_serving(vm, target="policy", min_size=1)
    stack = fused_vit.pack_vit_stack(vm)
    assert stack.pop("act_quant") is True
    enc = vm.encoder
    C, inter = cfg.hidden_size, cfg.intermediate_size
    L = enc.norm1.weight.shape[0]
    for key, dense, n, k in (("qkvw", enc.attn.qkv, 3 * C, C),
                             ("projw", enc.attn.proj, C, C),
                             ("fc1w", enc.mlp.fc1, inter, C),
                             ("fc2w", enc.mlp.fc2, C, inter)):
        assert stack[key].shape == (L, n, k) and stack[key].is_contiguous()
        assert torch.equal(stack[key], dense.kernel_q.transpose(-1, -2))
        assert stack[key] is dense.kernel_qt  # one copy per model
    half = inter // 2
    for ch in (slice(0, half), slice(half, inter)):
        assert torch.equal(stack["fc2w"][:, :, ch],
                           enc.mlp.fc2.kernel_q[:, ch].transpose(-1, -2))


def _ex_inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    kq, ks = quantize_int8(torch.from_numpy(w), reduce_axis=-2)
    return torch.from_numpy(x), kq, ks


@pytest.mark.parametrize("epi", ["f32", "bf16"])
def test_int8_gemm_ex_row_first_matches_jax_w8a8_dot(epi):
    """The general entry's w8a8_dot modes (row scale first) on the CPU
    route, K-major weight: JAX's w8a8_dot within one fp32 rounding, and
    int8_gemm's plain version bit for bit."""
    x, kq, ks = _ex_inputs(130, 192, 48, 4)
    want = np.asarray(jax.jit(jax_w8a8_dot)(
        jnp.asarray(x.numpy()), jnp.asarray(kq.numpy()),
        jnp.asarray(ks.numpy())))
    q, am = w8a8.quantize_rows(x)
    kt = kq.t().contiguous()
    mode = w8a8.EPI_F32 if epi == "f32" else w8a8.EPI_BF16
    got = w8a8.int8_gemm_ex(q, am[:, 0], kt, ks[0], mode, row_first=True)
    plain = w8a8.int8_gemm(q, am, kt, ks[0], got.dtype)
    assert torch.equal(got, plain)
    if epi == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=ULP, atol=0)
    else:
        assert torch.equal(got, torch.from_numpy(np.array(want)).to(
            torch.bfloat16))


def test_int8_gemm_ex_halves_of_k_are_the_vit_fc2():
    """fc2 of the act_quant ViT at B > 1 through the general entry: two K
    halves as column views (row strides 2 x half), the row scales of the
    two groups at stride 2, EPI_BIAS_F32 then EPI_BIAS_LS_RESIDUAL in place
    on the residual: equal bit for bit to the plain stack's two-group fc2,
    and a one-group quantization differs."""
    M, half, C = 40, 64, 32
    rng = np.random.default_rng(5)
    m = torch.from_numpy(rng.standard_normal((M, 2 * half)).astype(
        np.float32))
    m[:, half:] *= 40.0  # the groups matter
    w2, s2 = quantize_int8(torch.from_numpy(
        (rng.standard_normal((2 * half, C)) * 0.05).astype(np.float32)), -2)
    w2t, s2 = w2.t().contiguous(), s2[0]  # [C, inter]
    bias = torch.from_numpy(rng.standard_normal(C).astype(np.float32))
    ls = torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, C)).astype(
        np.float32)).to(torch.bfloat16)
    q, am = w8a8.quantize_rows(m, groups=2)
    part = w8a8.int8_gemm_ex(q[:, :half], am[:, 0], w2t[:, :half], s2,
                             w8a8.EPI_BIAS_F32, bias=bias)
    out = x.clone()
    w8a8.int8_gemm_ex(q[:, half:], am[:, 1], w2t[:, half:], s2,
                      w8a8.EPI_BIAS_LS_RESIDUAL, addm=part, ls=ls, out=out)
    m2 = bias.float()
    for ch in (slice(0, half), slice(half, 2 * half)):
        m2 = m2 + fused_vit._qdot(m[:, ch], w2t[:, ch], s2)
    want = (x.float() + m2.to(torch.bfloat16).float() * ls).to(torch.bfloat16)
    assert torch.equal(out, want)
    one = fused_vit._qdot(m, w2t, s2) + bias
    one = (x.float() + one.to(torch.bfloat16).float() * ls).to(torch.bfloat16)
    assert not torch.equal(one, want)


def test_int8_gemm_ex_gelu_is_the_plain_stacks_fc1():
    """fc1's epilogue (row scale times column scale first, then bias and
    the exact-erf GELU) against the plain stack's fc1 (F.gelu): the same
    v, then two implementations of erf, which differ by up to ~3e-7 near
    zero (atol 1e-6, rtol 1e-6)."""
    x, kq, ks = _ex_inputs(24, 64, 96, 6)
    kt, s = kq.t().contiguous(), ks[0]
    bias = torch.from_numpy(np.random.default_rng(7).standard_normal(
        96).astype(np.float32))
    q, am = w8a8.quantize_rows(x)
    got = w8a8.int8_gemm_ex(q, am[:, 0], kt, s, w8a8.EPI_BIAS_GELU_F32,
                            bias=bias)
    want = torch.nn.functional.gelu(fused_vit._qdot(x, kt, s) + bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
