"""vlaser_tpu_torch fused decoder stack (CPU twin) vs the JAX Pallas
kernel (interpret mode) on the same weights and inputs: int8 weights with
their scales, and the bf16-weight mode (unit scales); the VLA suffix's
configurations (R = 4 / 5) and the VLM decode's (R = 1 over a cache whose
padded and empty slots are masked, fp32 rope tables).

Both sides keep the same rounding points (bf16 norms, q/k/v rounded around
rope, fp32 softmax, bf16 residual stream); they differ in summation order
only, so outputs are held to bf16 level: atol 2e-2 on x_out and the self
K/V after 2 layers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.kernels.fused_decode import NEG_INF as JAX_NEG_INF
from vlaser_tpu.kernels.fused_decode import fused_int8_stack as jax_stack
from vlaser_tpu_torch.kernels import fused_decode

ATOL = 2e-2


def _quant(w):
    s = np.abs(w).max(axis=-2, keepdims=True) / 127.0 + 1e-12
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def _case(R, ext_len, step0, rope_dtype, seed=0, wdtype="int8",
          decode=False):
    rng = np.random.default_rng(seed)
    L, hidden, inter = 2, 256, 640
    heads, kv_heads, head_dim = 4, 2, 64
    q_dim, kv_dim = heads * head_dim, kv_heads * head_dim
    W = {}
    for name, k, n in (("q", hidden, q_dim), ("k", hidden, kv_dim),
                       ("v", hidden, kv_dim), ("o", q_dim, hidden),
                       ("g", hidden, inter), ("u", hidden, inter),
                       ("d", inter, hidden)):
        W["w" + name], W["s" + name] = _quant(
            rng.standard_normal((L, k, n)).astype(np.float32) * 0.05)
        if wdtype == "bf16":  # the same weights dequantized, unit scales
            W["w" + name] = W["w" + name] * W["s" + name]
            W["s" + name] = np.ones_like(W["s" + name])
    pos = np.arange(R) + 7.0
    freq = 1.0 / (10_000.0 ** (np.arange(0, head_dim, 2) / head_dim))
    ang = pos[:, None] * freq[None, :]
    cos = np.concatenate([np.cos(ang)] * 2, -1).astype(np.float32)
    sin = np.concatenate([np.sin(ang)] * 2, -1).astype(np.float32)
    ext_mask = np.zeros((1, ext_len), np.float32)
    ext_mask[0, -3:] = fused_decode.NEG_INF  # padded external keys
    if decode:  # the prompt's bucket padding, then the empty future slots
        ext_mask[0, ext_len // 2:ext_len // 2 + 5] = fused_decode.NEG_INF
    self_mask = np.zeros((R, R), np.float32)
    if step0:  # [proprio | action]: the proprio row is blind to the actions
        self_mask[0, 1:] = fused_decode.NEG_INF
    return dict(
        x=rng.standard_normal((R, hidden)).astype(np.float32) * 0.3,
        cos=cos, sin=sin, self_mask=self_mask, ext_mask=ext_mask,
        ln1=rng.uniform(0.7, 1.3, (L, hidden)).astype(np.float32),
        ln2=rng.uniform(0.7, 1.3, (L, hidden)).astype(np.float32),
        bq=rng.standard_normal((L, q_dim)).astype(np.float32) * 0.02,
        bk=rng.standard_normal((L, kv_dim)).astype(np.float32) * 0.02,
        bv=rng.standard_normal((L, kv_dim)).astype(np.float32) * 0.02,
        **W,
        k_ext=rng.standard_normal((L, ext_len, kv_heads, head_dim))
        .astype(np.float32) * 0.3,
        v_ext=rng.standard_normal((L, ext_len, kv_heads, head_dim))
        .astype(np.float32) * 0.3,
    ), rope_dtype, wdtype


ORDER = ("x", "cos", "sin", "self_mask", "ext_mask", "ln1", "ln2", "bq", "bk",
         "bv", "wq", "sq", "wk", "sk", "wv", "sv", "wo", "so", "wg", "sg",
         "wu", "su", "wd", "sd", "k_ext", "v_ext")
BF16_KEYS = ("x", "k_ext", "v_ext")


def _run_both(case):
    d, rope_dtype, wdtype = case
    jargs, targs = [], []
    for k in ORDER:
        a = d[k]
        if k in BF16_KEYS or (k in ("cos", "sin") and rope_dtype == "bf16") \
                or (k[0] == "w" and wdtype == "bf16"):
            jargs.append(jnp.asarray(a, jnp.bfloat16))
            targs.append(torch.from_numpy(a).to(torch.bfloat16))
        else:
            jargs.append(jnp.asarray(a))
            targs.append(torch.from_numpy(a))
    want = jax_stack(*jargs, mlp_tile=128, interpret=True)
    before = fused_decode.launch_count
    got = fused_decode.fused_int8_stack(*targs)
    assert fused_decode.launch_count == before  # CPU tensors take the twin
    return got, want


@pytest.mark.parametrize("R,ext_len,step0,rope_dtype,wdtype,decode", [
    (4, 24, False, "bf16", "int8", False),  # denoise steps 1..N-1: 4 actions
    (5, 21, True, "bf16", "int8", False),   # step 0: [proprio | 4 actions]
    (4, 24, False, "f32", "int8", False),   # fp32 rope tables
    (1, 40, False, "f32", "int8", True),    # VLM decode: 1 token, the cache
    (4, 24, False, "bf16", "bf16", False),  # bf16 weights, unit scales
    (1, 40, False, "f32", "bf16", True),    # bf16 weights at decode
])
def test_twin_matches_jax_kernel(R, ext_len, step0, rope_dtype, wdtype,
                                 decode):
    (gx, gk, gv), (wx, wk, wv) = _run_both(_case(
        R, ext_len, step0, rope_dtype, wdtype=wdtype, decode=decode))
    assert gx.dtype == torch.bfloat16 and gx.shape == (R, 256)
    assert gk.shape == gv.shape == (2, R, 2, 64)
    for g, w in ((gx, wx), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=ATOL, rtol=0)


def test_neg_inf_matches_and_masked_keys_are_ignored():
    assert fused_decode.NEG_INF == JAX_NEG_INF
    d, rd, wd = _case(4, 24, False, "bf16", seed=1)
    base, _ = _run_both((d, rd, wd))
    d2 = dict(d)
    d2["k_ext"] = d["k_ext"].copy()
    d2["v_ext"] = d["v_ext"].copy()
    d2["k_ext"][:, -3:] = 9.0  # the masked (padded) external keys
    d2["v_ext"][:, -3:] = -9.0
    moved, _ = _run_both((d2, rd, wd))
    for a, b in zip(base, moved):
        assert torch.equal(a, b)


def _attn_case(n, E, R, seed):
    """q [n, 64] (scaled), keys / values [E + R, 64], an additive mask [n, E
    + R] with the last 3 external keys masked, each row's self key open."""
    rng = np.random.default_rng(seed)
    T = E + R
    q = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((T, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((T, 64)).astype(np.float32))
    mask = torch.zeros(n, T)
    mask[:, max(0, E - 3):E] = fused_decode.NEG_INF
    return q * 0.125, k, v, mask


def _unsplit(q, k, v, mask):
    return torch.softmax(q @ k.T + mask, dim=-1) @ v


@pytest.mark.parametrize("n_chunks", [1, 2, 7])
@pytest.mark.parametrize("E", [1, 40])
def test_split_kv_attention_matches_unsplit(n_chunks, E):
    """The plain split-KV attention (the CUDA stack's chunking and combine)
    against one softmax over all keys: 41 or 44 keys in 1, 2 or 7 chunks (E
    + R not a multiple of the chunk), and E = 1; with 2+ chunks the first
    chunk's keys are all NEG_INF for every row and must weigh 0. atol
    1e-5."""
    R = 4
    q, k, v, mask = _attn_case(6, E, R, seed=E + n_chunks)
    T = E + R
    chunk = -(-T // n_chunks)
    if n_chunks > 1:
        mask[:, :chunk] = fused_decode.NEG_INF
    assert len(fused_decode.chunk_bounds(T, chunk)) == min(n_chunks, T)
    got = fused_decode.split_kv_attention_plain(q, k, v, mask, chunk)
    np.testing.assert_allclose(got.numpy(), _unsplit(q, k, v, mask).numpy(),
                               atol=1e-5, rtol=0)


def test_split_kv_attention_keeps_the_twins_all_masked_row():
    """A row whose every key is masked: the twin's softmax gives the mean of
    the values (every score is -1e30 in fp32); the split version gives it
    too, through chunks that all weigh exp(0)."""
    q, k, v, mask = _attn_case(3, 30, 2, seed=5)
    mask[1] = fused_decode.NEG_INF
    got = fused_decode.split_kv_attention_plain(q, k, v, mask, 8)
    want = _unsplit(q, k, v, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(want[1].numpy(), v.mean(0).numpy(), atol=1e-5)


@pytest.mark.parametrize("keys,kv_heads,rows", [
    (385, 2, 1), (3593, 2, 1), (32769, 2, 1),  # the VLM decode's caches
    (389, 2, 4), (394, 2, 5),                  # the denoise suffix
    (1, 1, 1), (41, 2, 3), (257, 8, 8)])
def test_kv_chunk_planner_covers_every_key_once(keys, kv_heads, rows):
    chunk = fused_decode.kv_chunk(keys, kv_heads, rows)
    assert chunk % 32 == 0
    assert fused_decode.KV_CHUNK_MIN <= chunk <= fused_decode.KV_CHUNK_MAX
    bounds = fused_decode.chunk_bounds(keys, chunk)
    seen = [j for j0, j1 in bounds for j in range(j0, j1)]
    assert seen == list(range(keys))  # every key once, in order
    assert all(j1 - j0 >= 1 for j0, j1 in bounds)
    assert kv_heads * rows * len(bounds) >= 1
    if keys > fused_decode.KV_CHUNK_MAX * 64:  # long caches fill the grid
        assert kv_heads * rows * len(bounds) >= fused_decode.ITEM_TARGET // 2
