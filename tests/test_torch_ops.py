"""vlaser_tpu_torch/kernels/ops.py eager twins vs vlaser_tpu/kernels/ops.py
on the same numpy inputs, fp32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.kernels import ops as jops
from vlaser_tpu_torch.kernels import ops as tops

ATOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    _close(tops.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                         plus_one),
           jops.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, plus_one))


def test_layer_norm():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 64)) * 3 + 1).astype(np.float32)
    w, b = rng.standard_normal((2, 64)).astype(np.float32)
    _close(tops.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-5),
           jops.layer_norm(*map(jnp.asarray, (x, w, b)), 1e-5))


@pytest.mark.parametrize("batched", [False, True])
def test_rope(batched):
    rng = np.random.default_rng(2)
    pos = (np.arange(6)[None].repeat(2, 0) + 3 if batched
           else np.arange(1, 7)).astype(np.float32)
    tc, ts = tops.rope_cos_sin(torch.from_numpy(pos), 16, 10_000.0)
    jc, js = jops.rope_cos_sin(jnp.asarray(pos), 16, 10_000.0)
    _close(tc, jc)
    _close(ts, js)
    x = rng.standard_normal(((2,) if batched else ()) + (6, 4, 16)).astype(
        np.float32)
    _close(tops.apply_rope(torch.from_numpy(x), tc, ts),
           jops.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_pixel_shuffle(version):
    x = np.random.default_rng(3).standard_normal((2, 4, 4, 8)).astype(
        np.float32)
    _close(tops.pixel_shuffle(torch.from_numpy(x), 0.5, version),
           jops.pixel_shuffle(jnp.asarray(x), 0.5, version))


MASK_CASES = {
    "segments": dict(seg=True),
    "levels": dict(seg=True, lev=True),
    "causal_offset": dict(causal=True, q_offset=3),
    "window": dict(causal=True, window=2, seg=True),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_make_attention_mask(case):
    c = MASK_CASES[case]
    rng = np.random.default_rng(4)
    b, sq, skv = 2, 5, 8
    kw_np = {}
    if c.get("seg"):
        kw_np["q_segment_ids"] = rng.integers(0, 3, (b, sq)).astype(np.int32)
        kw_np["kv_segment_ids"] = rng.integers(0, 3, (b, skv)).astype(np.int32)
    if c.get("lev"):
        kw_np["q_levels"] = rng.integers(0, 3, (b, sq)).astype(np.int32)
        kw_np["kv_levels"] = rng.integers(0, 3, (b, skv)).astype(np.int32)
    common = dict(batch=b, q_len=sq, kv_len=skv,
                  causal=c.get("causal", False),
                  q_offset=c.get("q_offset", 0), window=c.get("window"))
    got = tops.make_attention_mask(
        **common, **{k: torch.from_numpy(v) for k, v in kw_np.items()})
    want = jops.make_attention_mask(
        **common, **{k: jnp.asarray(v) for k, v in kw_np.items()})
    np.testing.assert_array_equal(
        np.broadcast_to(got.numpy(), (b, sq, skv)),
        np.broadcast_to(np.asarray(want), (b, sq, skv)))


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_attention_reference(softcap):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    mask = rng.random((2, 5, 7)) > 0.3
    mask[1, 2] = False  # a fully masked row: uniform over all keys
    got = tops.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                   mask=torch.from_numpy(mask),
                                   softcap=softcap)
    want = jops.attention_reference(*map(jnp.asarray, (q, k, v)),
                                    mask=jnp.asarray(mask), softcap=softcap)
    _close(got, want)
