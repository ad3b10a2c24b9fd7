"""vlaser_tpu_torch/models/qwen2.py vs vlaser_tpu/models/qwen2.py on the
same weights (tiny_llm, fp32 compute, `highest` matmul precision from
conftest), also with a sliding window: a cached prefill of right-padded prompts into a bucket larger
than the prompt, then three decode steps. Logits, the cache's K/V, segment
ids and fill length agree after every step within 1e-5 (fp32, summation
order only)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.config import tiny_llm
from vlaser_tpu.inference.kv_cache import KVCache as JKVCache
from vlaser_tpu.models.qwen2 import Qwen2ForCausalLM as JQwen2
from vlaser_tpu_torch.inference.kv_cache import KVCache
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.models.qwen2 import Qwen2ForCausalLM
from vlaser_tpu_torch.utils.convert import from_jax_variables

ATOL = 1e-5

VARIANTS = {
    "qwen2": {},
    "qwen3_tied": dict(qk_norm=True, tie_word_embeddings=True,
                       attention_bias=False),
    # a window shorter than the prompts: the prefill and the decode steps
    # both mask keys more than 4 slots back
    "qwen2_window": dict(sliding_window=4),
}


def _pair(variant):
    cfg = dataclasses.replace(tiny_llm(), **VARIANTS[variant])
    jm = JQwen2(cfg, compute_dtype=jnp.float32)
    ids = jnp.ones((1, 4), jnp.int32)
    variables = jm.init(jax.random.PRNGKey(3), input_ids=ids)
    # visible norms: 1 + N(0, 0.1^2) instead of ones
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
                      if "norm" in jax.tree_util.keystr(p) else a),
        variables)
    tm = Qwen2ForCausalLM(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    return cfg, jm, variables, tm


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=ATOL, err_msg=what)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_uncached_forward_matches_jax(variant):
    cfg, jm, variables, tm = _pair(variant)
    ids = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 9))
    seg = np.ones((2, 9), np.int32)
    seg[1, 6:] = 0
    want, _, _ = jm.apply(variables, input_ids=jnp.asarray(ids),
                          seg_ids=jnp.asarray(seg), attn_impl="reference")
    with torch.no_grad():
        got, _, _ = tm(input_ids=torch.from_numpy(ids),
                       seg_ids=torch.from_numpy(seg))
    assert got.dtype == torch.float32 and got.shape == (2, 9, cfg.vocab_size)
    valid = seg.astype(bool)  # padded rows attend nothing: left out
    _close(got.numpy()[valid], np.asarray(want)[valid], "logits")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cached_prefill_and_decode_match_jax(variant):
    cfg, jm, variables, tm = _pair(variant)
    rng = np.random.default_rng(2)
    n, new, lens = 12, 3, np.array([9, 5])  # bucket 12 > both prompts
    ids = np.zeros((2, n), np.int64)
    seg = np.zeros((2, n), np.int32)
    for r, ln in enumerate(lens):
        ids[r, :ln] = rng.integers(1, cfg.vocab_size, ln)
        seg[r, :ln] = 1
    jc = JKVCache.create(cfg.num_layers, 2, n + new, cfg.num_kv_heads,
                         cfg.head_dim, dtype=jnp.float32)
    tc = KVCache.create(cfg.num_layers, 2, n + new, cfg.num_kv_heads,
                        cfg.head_dim, dtype=torch.float32)
    jl, _, jc = jm.apply(variables, input_ids=jnp.asarray(ids),
                         seg_ids=jnp.asarray(seg), cache=jc,
                         attn_impl="reference")
    with torch.no_grad():
        tl, _, tc = tm(input_ids=torch.from_numpy(ids),
                       seg_ids=torch.from_numpy(seg), cache=tc)
    rows = np.arange(2)
    _close(tl.numpy()[rows, lens - 1], np.asarray(jl)[rows, lens - 1],
           "prefill logits")

    def same_cache(step):
        assert tc.length == int(jc.length) == n + step
        np.testing.assert_array_equal(tc.seg.numpy(), np.asarray(jc.seg))
        _close(tc.k.numpy(), jc.k, f"cache k, step {step}")
        _close(tc.v.numpy(), jc.v, f"cache v, step {step}")

    same_cache(0)
    token = np.asarray(jl)[rows, lens - 1].argmax(-1)
    for t in range(new):
        pos = (lens + t)[:, None]
        jl, _, jc = jm.apply(variables, input_ids=jnp.asarray(token[:, None]),
                             positions=jnp.asarray(pos), cache=jc,
                             attn_impl="reference")
        with torch.no_grad():
            tl, _, tc = tm(input_ids=torch.from_numpy(token[:, None]),
                           positions=torch.from_numpy(pos), cache=tc)
        _close(tl.numpy(), jl, f"decode logits, step {t}")
        same_cache(t + 1)
        token = np.asarray(jl)[:, 0].argmax(-1)


def test_unported_variants_raise():
    for over in (dict(num_experts=4), dict(rms_plus_one=True),
                 dict(rope_short_factor=(1.0,) * 8,
                      rope_long_factor=(1.0,) * 8),
                 dict(attn_softcap=50.0), dict(mlp_act="gelu_tanh")):
        cfg = dataclasses.replace(tiny_llm(), **over)
        with pytest.raises(NotImplementedError):
            Qwen2ForCausalLM(cfg, device="cpu")
