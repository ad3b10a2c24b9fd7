"""The port's prompt-lookup speculative decoding
(vlaser_tpu_torch/inference/speculative.py, VlaserChat's
speculative_draft_len, and the engine's speculative chunks) vs the JAX
package on tiny_vlm at fp32, the same weights through
utils/convert.from_jax_variables.

Tolerances: lookup_draft is exact; every decoder's tokens and counts are
identical to JAX's speculative decoder and to greedy decode (JAX's and the
port's); the speculative engine's completions equal the JAX engine's (0
mismatched rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.inference.chat import VlaserChat as JaxChat
from vlaser_tpu.inference.sampling import make_generate_fn as jax_generate
from vlaser_tpu.inference.speculative import lookup_draft as jax_lookup
from vlaser_tpu.inference.speculative import \
    make_speculative_generate_fn as jax_spec
from vlaser_tpu.serve.engine import Request as JRequest
from vlaser_tpu_torch.inference.chat import VlaserChat
from vlaser_tpu_torch.inference.sampling import make_generate_fn, trim_output
from vlaser_tpu_torch.inference.speculative import (
    lookup_draft, make_speculative_generate_fn)
from vlaser_tpu_torch.serve.engine import ContinuousBatchingEngine, Request

from test_chat_and_configs import ToyTok
from test_torch_engine import one_thread  # noqa: F401 (autouse)
from test_torch_engine import EOS, FP32_TOL, both, build_models, engines, \
    image_prompt


@pytest.fixture(scope="module")
def vlm():
    return build_models()


@pytest.mark.parametrize("total,ngram,k", [(40, 2, 4), (5, 1, 3), (63, 3, 8),
                                           (2, 2, 4)])
def test_lookup_draft_matches_jax(total, ngram, k):
    """The draft and the found flag of JAX's lookup_draft, at a small
    vocabulary (many matches), no match, and the window's edges; the [B, N]
    form equals the row-by-row calls."""
    rng = np.random.default_rng(total)
    buf = rng.integers(1, 6, 64).astype(np.int32)
    want = jax.jit(jax_lookup, static_argnums=(2, 3))(
        jnp.asarray(buf), jnp.asarray(total), ngram, k)
    got = lookup_draft(torch.as_tensor(buf), total, ngram, k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert bool(got[1]) == bool(want[1])
    rows = rng.integers(1, 4, (5, 64))
    totals = np.asarray([total, 10, 30, 64 - k, 3])
    draft, found = lookup_draft(torch.as_tensor(rows),
                                torch.as_tensor(totals), ngram, k)
    for i in range(5):
        d, f = jax_lookup(jnp.asarray(rows[i]), jnp.asarray(totals[i]),
                          ngram, k)
        np.testing.assert_array_equal(draft[i].numpy(), np.asarray(d))
        assert bool(found[i]) == bool(f)


def _run_both(vlm, ids, pixels, *, max_new, eos, k=4, ngram=2,
              force_no_match=False):
    """-> (JAX spec (tokens, num, emitted, passes), port spec the same,
    port greedy (tokens, num), JAX greedy (tokens, num))."""
    cfg, jm, v, tm = vlm
    seg = np.ones_like(ids, np.int32)
    kw = dict(max_new_tokens=max_new, eos_token_ids=eos, pad_token_id=0)
    jargs = (v, jnp.asarray(ids), jnp.asarray(seg),
             None if pixels is None else jnp.asarray(pixels),
             jax.random.PRNGKey(0))
    jspec = jax_spec(jm, draft_len=k, ngram=ngram, cache_dtype=jnp.float32,
                     force_no_match=force_no_match, **kw).with_stats(*jargs)
    jgreedy = jax_generate(jm, cache_dtype=jnp.float32, **kw)(*jargs)
    targs = (torch.as_tensor(ids, dtype=torch.int64), torch.as_tensor(seg),
             None if pixels is None else torch.as_tensor(pixels))
    tspec = make_speculative_generate_fn(
        tm, draft_len=k, ngram=ngram, cache_dtype=torch.float32,
        force_no_match=force_no_match, **kw).with_stats(*targs)
    tgreedy = make_generate_fn(tm, cache_dtype=torch.float32, **kw)(*targs)
    return jspec, tspec, tgreedy, jgreedy


def _image_ids(vlm, n=12, seed=0):
    cfg = vlm[0]
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 400, (1, n))
    ids[0, 2:2 + cfg.num_image_token] = cfg.img_context_token_id
    img = cfg.vision.image_size
    px = rng.standard_normal((1, img, img, 3)).astype(np.float32)
    return ids, px


@pytest.mark.parametrize("k,ngram", [(4, 2), (1, 1), (8, 3)])
def test_spec_generate_matches_jax_and_greedy(vlm, k, ngram):
    """Tokens and counts equal JAX's speculative decoder, the port's greedy
    decoder and JAX's; the pass count is JAX's, and drafts are accepted
    (more tokens than passes) on the cycling greedy chain."""
    ids, px = _image_ids(vlm)
    jspec, tspec, tgreedy, jgreedy = _run_both(vlm, ids, px, max_new=24,
                                               eos=EOS, k=k, ngram=ngram)
    np.testing.assert_array_equal(tspec[0].numpy(), np.asarray(jspec[0]))
    np.testing.assert_array_equal(tspec[1].numpy(), np.asarray(jspec[1]))
    assert (tspec[2], tspec[3]) == (int(jspec[2]), int(jspec[3]))
    trimmed = trim_output(tspec[0], tspec[1], EOS)
    assert trimmed == trim_output(*tgreedy, EOS) == trim_output(
        np.asarray(jgreedy[0]), np.asarray(jgreedy[1]), EOS)
    if k > 1:
        assert tspec[2] > tspec[3]


def test_spec_eos_cut_and_force_no_match(vlm):
    """An EOS reached inside a block stops both decoders at the same token;
    force_no_match keeps the tokens and takes one pass a token."""
    ids, px = _image_ids(vlm)
    _, tspec, _, _ = _run_both(vlm, ids, px, max_new=8, eos=EOS)
    row = tspec[0][0, :int(tspec[1][0])].tolist()
    eos = [int(row[2])]
    jspec, tspec, tgreedy, _ = _run_both(vlm, ids, px, max_new=8, eos=eos)
    np.testing.assert_array_equal(tspec[0].numpy(), np.asarray(jspec[0]))
    np.testing.assert_array_equal(tspec[1].numpy(), np.asarray(jspec[1]))
    # the EOS is emitted into the stream (counted), then trimmed
    assert int(tspec[1][0]) == row.index(eos[0]) + 1
    assert trim_output(tspec[0], tspec[1], eos) == trim_output(*tgreedy,
                                                               eos)
    jspec, tspec, tgreedy, _ = _run_both(vlm, ids, px, max_new=10, eos=EOS,
                                         force_no_match=True)
    assert trim_output(tspec[0], tspec[1], EOS) == trim_output(*tgreedy, EOS)
    assert tspec[3] == int(jspec[3]) == tspec[2] - 1


def test_spec_right_padded_prompt(vlm):
    """A right-padded prompt (seg 0 tail) decodes what the unpadded one
    does, as in JAX."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(5)
    row = rng.integers(1, 400, (1, 10))
    spec = make_speculative_generate_fn(
        tm, max_new_tokens=6, eos_token_ids=EOS, pad_token_id=0,
        draft_len=3, cache_dtype=torch.float32)
    seg = torch.ones((1, 10), dtype=torch.int32)
    t1, n1 = spec(torch.as_tensor(row), seg, None)
    padded = torch.cat([torch.as_tensor(row), torch.zeros((1, 5),
                                                          dtype=torch.int64)],
                       1)
    segp = torch.cat([seg, torch.zeros((1, 5), dtype=torch.int32)], 1)
    t2, n2 = spec(padded, segp, None)
    assert torch.equal(t1, t2) and torch.equal(n1, n2)
    jspec = jax_spec(jm, max_new_tokens=6, eos_token_ids=EOS, pad_token_id=0,
                     draft_len=3, cache_dtype=jnp.float32)
    jt, _ = jspec(v, jnp.asarray(padded.numpy()), jnp.asarray(segp.numpy()),
                  None, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(jt))


def test_chat_speculative_matches_plain_and_jax(vlm):
    """VlaserChat(speculative_draft_len=4) answers what the plain chat and
    JAX's speculative chat answer; speculative decoding with beams raises
    (JAX asserts num_beams == 1 there)."""
    cfg, jm, v, tm = vlm
    ids, px = _image_ids(vlm)
    kw = dict(max_new_tokens=12, bucket=64)
    spec = VlaserChat(tm, ToyTok(), speculative_draft_len=4,
                      cache_dtype=torch.float32, **kw)
    assert spec._fused_gen is None
    plain = VlaserChat(tm, ToyTok(), cache_dtype=torch.float32,
                       use_fused=False, **kw)
    jchat = JaxChat(jm, v, ToyTok(), speculative_draft_len=4,
                    cache_dtype=jnp.float32, **kw)
    for q, pix in (("describe the scene", px), ("hello there", None)):
        got = spec.chat(q, pix)
        assert got == plain.chat(q, pix) == jchat.chat(q, pix)
    with pytest.raises(ValueError):
        VlaserChat(tm, ToyTok(), num_beams=2, speculative_draft_len=4)


# -- the speculative engine vs the JAX engine ---------------------------------

def _spec_engines(jm, v, tm, *, draft_len=4, chunk_size=4, num_slots=3,
                  max_len=96, buckets=(16, 32), eos=EOS, **kw):
    """A speculative JAX engine and the port's (adaptive off unless asked:
    every chunk takes the verify path)."""
    kw.setdefault("speculative_adaptive", False)
    return engines(jm, v, tm, num_slots=num_slots, max_len=max_len,
                   eos_token_ids=eos, pad_token_id=0,
                   prefill_buckets=buckets, chunk_size=chunk_size,
                   speculative_draft_len=draft_len, **kw)


@pytest.mark.parametrize("chunk_size,draft_len", [(1, 4), (4, 2), (4, 6)])
def test_spec_engine_matches_jax(vlm, chunk_size, draft_len):
    """Speculative engine: the JAX engine's completions (accepting drafts:
    max_new 24 lets the greedy chains cycle). After the run the slot
    cache's segment ids, fill depths and every valid K/V slot equal JAX's:
    the in-place rollback of rejected block slots is JAX's."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(13)
    specs = [dict(uid=i, input_ids=rng.integers(1, 400, (n,)).astype(
        np.int32), max_new_tokens=24) for i, n in enumerate((4, 9, 5, 13, 7))]
    je, pe = _spec_engines(jm, v, tm, draft_len=draft_len,
                           chunk_size=chunk_size)
    want, got = both(je, pe, specs)
    assert got == want
    plain = ContinuousBatchingEngine(
        tm, cache_dtype=torch.float32, num_slots=3, max_len=96,
        eos_token_ids=EOS, pad_token_id=0, prefill_buckets=(16, 32))
    assert {c.uid: c.token_ids
            for c in plain.run([Request(**s) for s in specs])} == got
    assert pe.stats["spec_chunks"] == pe.stats["chunks"]
    seg = np.asarray(je.cache.seg)
    np.testing.assert_array_equal(pe.cache.seg.numpy(), seg)
    np.testing.assert_array_equal(pe.cache.length.numpy(),
                                  np.asarray(je.cache.length))
    valid = seg != 0
    np.testing.assert_allclose(pe.cache.k.numpy()[:, valid],
                               np.asarray(je.cache.k)[:, valid],
                               atol=FP32_TOL, rtol=FP32_TOL)


def test_spec_engine_eos_mid_block_matches_jax(vlm):
    """An EOS taken from the middle of a stream cuts it inside a verify
    block exactly where JAX's engine does."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(17)
    specs = [dict(uid=i, input_ids=rng.integers(1, 400, (n,)).astype(
        np.int32), max_new_tokens=24) for i, n in enumerate((6, 11))]
    _, pe = _spec_engines(jm, v, tm)
    emitted = [c.token_ids for c in pe.run([Request(**s) for s in specs])]
    mid = [t for toks in emitted for t in toks[1:-1]]
    eos = [int(mid[len(mid) // 2])]
    je, pe = _spec_engines(jm, v, tm, eos=eos)
    want, got = both(je, pe, specs)
    assert got == want
    assert any(len(t) < 23 for t in got.values())


def test_spec_engine_budget_cut_and_image_matches_jax(vlm):
    """Budgets that cut mid block, an image request and slot reuse."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(19)
    ids, px = image_prompt(cfg, rng, 6)
    texts = [rng.integers(1, 400, (n,)).astype(np.int32)
             for n in (5, 8, 3, 10)]
    specs = [dict(uid=0, input_ids=ids, pixel_values=px, max_new_tokens=7)]
    specs += [dict(uid=i + 1, input_ids=t, max_new_tokens=(2, 3, 7, 5)[i])
              for i, t in enumerate(texts)]
    je, pe = _spec_engines(jm, v, tm, num_slots=2, max_len=128,
                           buckets=(16, 64), draft_len=5)
    want, got = both(je, pe, specs)
    assert got == want
    assert all(len(got[i + 1]) <= (2, 3, 7, 5)[i] for i in range(4))


def test_spec_engine_prefix_cached_matches_jax(vlm):
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(23)
    prefix, px = image_prompt(cfg, rng, 4)
    tails = [rng.integers(1, 400, (n,)).astype(np.int32) for n in (5, 9, 3)]
    je, pe = _spec_engines(jm, v, tm, num_slots=2, max_len=128)
    jpid, pid = je.register_prefix(prefix, px), pe.register_prefix(prefix,
                                                                   px)
    want = {c.uid: c.token_ids for c in je.run(
        [JRequest(uid=i, input_ids=t, max_new_tokens=16, prefix_id=jpid)
         for i, t in enumerate(tails)])}
    got = {c.uid: c.token_ids for c in pe.run(
        [Request(uid=i, input_ids=t, max_new_tokens=16, prefix_id=pid)
         for i, t in enumerate(tails)])}
    assert got == want


def test_spec_adaptive_policy_matches_jax(vlm):
    """The adaptive policy (pessimistic probes, back-off, EMA) is JAX's:
    on the same requests it runs the same speculative and plain chunks,
    ends at the same EMA and probe interval, and the tokens are the JAX
    engine's."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(31)
    specs = [dict(uid=i, input_ids=rng.integers(1, 400, (n,)).astype(
        np.int32), max_new_tokens=30) for i, n in enumerate((6, 11, 8))]
    je, pe = _spec_engines(jm, v, tm, chunk_size=2, buckets=(16,),
                           speculative_adaptive=True, spec_reprobe_every=2)
    want, got = both(je, pe, specs)
    assert got == want
    for name in ("spec_chunks_run", "plain_chunks_run", "spec_last_ema",
                 "_spec_probe_interval"):
        assert getattr(pe, name) == getattr(je, name), name
    assert pe.plain_chunks_run >= 1 and pe.spec_chunks_run >= 1


def test_spec_sampled_run_falls_back(vlm):
    """A run with a sampled request takes the sampled loop: the speculative
    engine's completions equal the plain engine's, and its greedy row equals
    the JAX engine's."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, 400, (n,)).astype(np.int32) for n in (6, 9)]
    specs = [dict(uid=0, input_ids=prompts[0], max_new_tokens=10,
                  temperature=0.8, top_k=7, seed=5),
             dict(uid=1, input_ids=prompts[1], max_new_tokens=10)]
    je, pe = _spec_engines(jm, v, tm)
    plain = ContinuousBatchingEngine(
        tm, cache_dtype=torch.float32, num_slots=3, max_len=96,
        eos_token_ids=EOS, pad_token_id=0, prefill_buckets=(16, 32),
        chunk_size=4)
    want, got = both(je, pe, specs)
    assert got[1] == want[1]
    assert {c.uid: c.token_ids
            for c in plain.run([Request(**s) for s in specs])} == got
    assert pe.spec_chunks_run == 0
