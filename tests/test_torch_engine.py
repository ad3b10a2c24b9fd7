"""The port's continuous-batching engine (vlaser_tpu_torch/serve/engine.py
and what it needs: per-row offsets in inference/kv_cache, the per-row
decode of models/qwen2, image_flags in models/vlm, sampling.sample_per_row,
serve/engine_chat) vs the JAX package on tiny_vlm at fp32, the same weights
loaded through utils/convert.from_jax_variables.

Tolerances: cache writes, the image_flags scatter, the sampling filters'
kept sets and greedy rows are exact; per-row decode logits within 1e-5
(fp32, `highest` matmul precision from conftest). Engine completions are
token-identical to the JAX engine's on the same requests: 0 mismatched
rows. Sampled rows (the JAX Gumbel stream has no torch twin) are held to
the port's own solo decode under a generator of the same seed."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.config import tiny_vlm
from vlaser_tpu.inference import sampling as jsampling
from vlaser_tpu.inference.kv_cache import KVCache as JKVCache
from vlaser_tpu.inference.kv_cache import write_kv as jwrite_kv
from vlaser_tpu.models.vlm import InternVLChatModel as JaxModel
from vlaser_tpu.models.vlm import scatter_image_embeds as jscatter
from vlaser_tpu.serve.engine import ContinuousBatchingEngine as JaxEngine
from vlaser_tpu.serve.engine import Request as JRequest
from vlaser_tpu_torch.inference.kv_cache import KVCache, write_kv
from vlaser_tpu_torch.inference.sampling import (_filter_logits, _sample,
                                                 make_generate_fn,
                                                 sample_per_row, trim_output)
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.models.vlm import InternVLChatModel, scatter_image_embeds
from vlaser_tpu_torch.serve.engine import ContinuousBatchingEngine, Request
from vlaser_tpu_torch.utils.convert import from_jax_variables

from test_chat_and_configs import ToyTok

EOS = [3]
MAX_NEW = 6
FP32_TOL = 1e-5


def build_models(seed=0):
    """-> (cfg, jax model, jax variables, port model) at tiny_vlm fp32, the
    JAX engine tests' init (tests/test_engine.py)."""
    cfg = tiny_vlm()
    jm = JaxModel(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    rng = np.random.default_rng(seed)
    npt = cfg.num_image_token
    ids = rng.integers(1, 400, (1, 8 + npt))
    ids[0, 2:2 + npt] = cfg.img_context_token_id
    img = cfg.vision.image_size
    px = rng.standard_normal((1, img, img, 3)).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(px),
                jnp.asarray([1], np.int32))
    tm = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables(jax.tree_util.tree_map(np.asarray, v)))
    return cfg, jm, v, tm


def engines(jm, v, tm, **kw):
    """The JAX engine and the port's with the same keywords, fp32 caches."""
    return (JaxEngine(jm, v, cache_dtype=jnp.float32, **kw),
            ContinuousBatchingEngine(tm, cache_dtype=torch.float32, **kw))


def both(je, pe, specs, **run_kw):
    """Run one request list (dicts of Request fields) through both engines:
    -> ({uid: tokens} of JAX, of the port)."""
    want = {c.uid: c.token_ids
            for c in je.run([JRequest(**s) for s in specs], **run_kw)}
    got = {c.uid: c.token_ids
           for c in pe.run([Request(**s) for s in specs], **run_kw)}
    return want, got


def image_prompt(cfg, rng, n_text, at=2):
    npt = cfg.num_image_token
    ids = rng.integers(1, 400, (n_text + npt,)).astype(np.int32)
    ids[at:at + npt] = cfg.img_context_token_id
    img = cfg.vision.image_size
    return ids, rng.standard_normal((1, img, img, 3)).astype(np.float32)


def port_solo(tm, ids, pixels=None, max_new=MAX_NEW, temperature=0.0,
              top_k=0, top_p=1.0, seed=0):
    """The port's solo make_generate_fn decode (a seeded generator)."""
    gen = make_generate_fn(tm, max_new_tokens=max_new, eos_token_ids=EOS,
                           pad_token_id=0, temperature=temperature,
                           top_k=top_k, top_p=top_p,
                           cache_dtype=torch.float32)
    t = torch.as_tensor(np.asarray(ids, np.int64))[None]
    px = None if pixels is None else torch.as_tensor(pixels)
    g = torch.Generator().manual_seed(seed)
    toks, num = gen(t, torch.ones_like(t, dtype=torch.int32), px, g)
    return trim_output(toks, num, EOS)[0]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vlm():
    return build_models()


# -- modules ----------------------------------------------------------------

@pytest.mark.parametrize("lengths", [(2, 5, 0), (13, 3, 15)])
def test_per_row_write_meta_and_kv_match_jax(lengths):
    """Per-row write_meta writes S contiguous slots at each row's offset
    (clamped as dynamic_update_slice clamps) and advances a row by its
    nonzero seg ids; write_kv with a [B] offset writes each row at its
    own position. Exact against JAX."""
    rng = np.random.default_rng(1)
    B, M, S = 3, 16, 3
    seg = np.asarray([[1, 1, 1], [0, 0, 0], [1, 1, 0]], np.int32)
    lev = rng.integers(0, 3, (B, S)).astype(np.int32)
    length = np.asarray(lengths, np.int32)
    jc = JKVCache.create(1, B, M, 1, 4, dtype=jnp.float32).replace(
        length=jnp.asarray(length))
    jc = jc.write_meta(jnp.asarray(seg), jnp.asarray(lev))
    tc = KVCache.create(1, B, M, 1, 4, torch.float32)
    tc.length = torch.as_tensor(length)
    tc = tc.write_meta(torch.as_tensor(seg), torch.as_tensor(lev))
    np.testing.assert_array_equal(tc.seg.numpy(), np.asarray(jc.seg))
    np.testing.assert_array_equal(tc.lev.numpy(), np.asarray(jc.lev))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    buf = rng.standard_normal((B, M, 2, 4)).astype(np.float32)
    new = rng.standard_normal((B, S, 2, 4)).astype(np.float32)
    want = jwrite_kv(jnp.asarray(buf), jnp.asarray(new), jnp.asarray(length))
    got = torch.as_tensor(buf.copy())
    write_kv(got, torch.as_tensor(new), torch.as_tensor(length))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("src", [None, (1, 3)])
def test_insert_rows_rewrites_whole_rows(src):
    """KVCache.insert_rows (the engine's and the offline runner's admission
    insert) copies the prefilled rows' K/V and metadata into their slots,
    clears each slot's stale segment ids past the new prompt, sets only
    those slots' lengths and leaves the other slots as they were."""
    rng = np.random.default_rng(11)
    L, B, M, KVH, D, W = 2, 4, 12, 2, 3, 5
    cache = KVCache.create(L, B, M, KVH, D, torch.float32)
    cache.k.copy_(torch.as_tensor(rng.standard_normal(cache.k.shape)))
    cache.v.copy_(torch.as_tensor(rng.standard_normal(cache.v.shape)))
    cache.seg.fill_(7)
    cache.lev.fill_(2)
    cache.length = torch.full((B,), 9, dtype=torch.int32)
    small = KVCache.create(L, 4, W, KVH, D, torch.float32)
    small.k.copy_(torch.as_tensor(rng.standard_normal(small.k.shape)))
    small.v.copy_(torch.as_tensor(rng.standard_normal(small.v.shape)))
    small.seg[:, :3] = 1
    small.lev[:, :3] = 1
    before = cache.clone()
    rows = torch.tensor([2, 0])
    take = [0, 1] if src is None else list(src)
    out = cache.insert_rows(small, rows, torch.tensor([3, 2]),
                            src=None if src is None else torch.tensor(src))
    for slot, i in zip(rows.tolist(), take):
        assert torch.equal(out.k[:, slot, :W], small.k[:, i])
        assert torch.equal(out.v[:, slot, :W], small.v[:, i])
        assert torch.equal(out.k[:, slot, W:], before.k[:, slot, W:])
        assert torch.equal(out.seg[slot], torch.tensor([1] * 3 + [0] * 9,
                                                       dtype=torch.int32))
        assert torch.equal(out.lev[slot], out.seg[slot])
    for slot in (1, 3):
        for name in ("k", "v", "seg", "lev"):
            assert torch.equal(getattr(out, name)[:, slot] if name in "kv"
                               else getattr(out, name)[slot],
                               getattr(before, name)[:, slot] if name in "kv"
                               else getattr(before, name)[slot])
    assert out.length.tolist() == [2, 9, 3, 9]
    assert before.length.tolist() == [9] * B  # the old offsets stay valid


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (4, 1.0), (0, 0.6)])
def test_sample_skips_unused_filters_bit_identically(top_k, top_p):
    """`_sample` skips the full-vocabulary sort of a filter its numbers
    turn off (top_k 0, top_p 1): its filtered logits are the same bits
    as the full filter's, and its draw equals sample_per_row's row under a
    generator of the same seed, with and without the skip."""
    rng = np.random.default_rng(12)
    B, V = 3, 50
    logits = torch.as_tensor((rng.standard_normal((B, V)) * 2)
                             .astype(np.float32))
    full = lambda x, dt: torch.full((B,), x, dtype=dt)
    args = (logits, full(0.9, torch.float32), full(top_k, torch.int64),
            full(top_p, torch.float32))
    skipped = _filter_logits(*args, use_k=top_k > 0, use_p=top_p < 1.0)
    assert torch.equal(skipped, _filter_logits(*args))
    for seed in range(3):
        want = _sample(logits[:1], torch.Generator().manual_seed(seed),
                       0.9, top_k, top_p)
        for use in (dict(), dict(use_k=top_k > 0, use_p=top_p < 1.0)):
            got = sample_per_row(logits[:1], [torch.Generator().manual_seed(
                seed)], *(a[:1] for a in args[1:]), **use)
            assert int(got[0]) == int(want[0])


@pytest.mark.parametrize("s", [1, 3])
def test_per_row_decode_logits_match_jax(vlm, s):
    """A decode step against a per-row cache (rows at fill depths 7, 4, 9;
    one row dead at seg 0): a one-token step (segment mask alone) and a
    3-token block (causal at the [B] offsets) give JAX's logits within
    1e-5 and the same cache."""
    cfg, jm, v, tm = vlm
    llm = cfg.llm
    rng = np.random.default_rng(5)
    B, n, M = 3, 9, 24
    ids = rng.integers(1, 400, (B, n)).astype(np.int32)
    seg = np.ones((B, n), np.int32)
    fill = np.asarray([7, 4, 9], np.int32)
    seg[np.arange(n)[None] >= fill[:, None]] = 0
    tok = rng.integers(1, 400, (B, s)).astype(np.int32)
    alive = np.asarray([1, 0, 1], np.int32)
    step_seg = np.repeat(alive[:, None], s, 1)
    pos = fill[:, None] + np.arange(s)[None]

    jc = JKVCache.create(llm.num_layers, B, M, llm.num_kv_heads,
                         llm.head_dim, dtype=jnp.float32)
    _, _, jc = jm.apply(v, jnp.asarray(ids), None, jnp.asarray(seg), jc,
                        method=jm.prefill)
    jc = jc.replace(length=jnp.asarray(fill))
    want, _, jc = jm.apply(v, jnp.asarray(tok), jc, jnp.asarray(pos),
                           jnp.asarray(step_seg), method=jm.decode_step)
    tc = KVCache.create(llm.num_layers, B, M, llm.num_kv_heads,
                        llm.head_dim, torch.float32)
    with torch.no_grad():
        _, _, tc = tm.prefill(torch.as_tensor(ids, dtype=torch.int64), None,
                              torch.as_tensor(seg), tc)
        tc.length = torch.as_tensor(fill)
        got, _, tc = tm.decode_step(torch.as_tensor(tok, dtype=torch.int64),
                                    tc, torch.as_tensor(pos),
                                    torch.as_tensor(step_seg))
    live = alive.astype(bool)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_array_equal(tc.seg.numpy(), np.asarray(jc.seg))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=FP32_TOL,
                               rtol=FP32_TOL)


def test_per_row_decode_matches_scalar_decode(vlm):
    """With aligned rows, a one-token step against a per-row cache equals
    the step against the scalar-length cache (the port's own two paths)."""
    cfg, _, _, tm = vlm
    llm = cfg.llm
    rng = np.random.default_rng(6)
    B, n = 2, 7
    ids = torch.as_tensor(rng.integers(1, 400, (B, n)))
    seg = torch.ones((B, n), dtype=torch.int32)

    def run(per_row):
        c = KVCache.create(llm.num_layers, B, 32, llm.num_kv_heads,
                           llm.head_dim, torch.float32)
        with torch.no_grad():
            lg, _, c = tm.prefill(ids, None, seg, c)
            if per_row:
                c.length = torch.full((B,), n, dtype=torch.int32)
            tok = lg[:, n - 1].argmax(-1)
            out, _, _ = tm.decode_step(tok[:, None], c,
                                       torch.full((B, 1), n))
        return out.numpy()

    np.testing.assert_allclose(run(True), run(False), atol=2e-5, rtol=2e-5)


def test_image_flags_scatter_matches_jax():
    """Padding tiles (flag 0) are compacted out of the <IMG_CONTEXT>
    gather; the port's scatter equals JAX's exactly."""
    rng = np.random.default_rng(2)
    T, ppt, C, B, N, ctx = 4, 3, 5, 2, 10, 99
    ids = rng.integers(1, 50, (B, N))
    ids[0, 1:4] = ctx
    ids[1, 2:8] = ctx  # 9 context slots: the 3 flagged tiles' tokens
    tok = rng.standard_normal((B, N, C)).astype(np.float32)
    vit = rng.standard_normal((T, ppt, C)).astype(np.float32)
    flags = np.asarray([1, 0, 1, 1], np.int32)
    want = jscatter(jnp.asarray(ids), jnp.asarray(tok), jnp.asarray(vit),
                    jnp.asarray(flags), ctx)
    got = scatter_image_embeds(torch.as_tensor(ids), torch.as_tensor(tok),
                               torch.as_tensor(vit), torch.as_tensor(flags),
                               ctx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    none = scatter_image_embeds(torch.as_tensor(ids), torch.as_tensor(tok),
                                torch.as_tensor(vit), None, ctx)
    assert not torch.equal(none, got)  # the flags do change the gather


def _jax_kept(monkeypatch, logits, temps, top_ks, top_ps):
    """JAX sample_per_row's kept-token mask [B, V]: its categorical draw is
    replaced by a probe that reports whether the token the key names
    survived the filters (one row a (row, token) pair)."""
    B, V = logits.shape
    monkeypatch.setattr(
        jsampling.jax.random, "categorical",
        lambda key, lt: (lt[key[0]] > -1e29).astype(jnp.int32))
    rep = lambda a: jnp.asarray(np.repeat(a, V, axis=0))
    keys = np.zeros((B * V, 2), np.uint32)
    keys[:, 0] = np.tile(np.arange(V), B)
    kept = jsampling.sample_per_row(rep(logits), jnp.asarray(keys),
                                    rep(temps), rep(top_ks), rep(top_ps))
    return np.asarray(kept).reshape(B, V).astype(bool)


def test_sample_per_row_filters_and_greedy_rows_match_jax(monkeypatch):
    """The per-row filters (temperature, top-k, nucleus, each row its own
    numbers, 0 = off) keep the same tokens as JAX's sample_per_row, and
    temperature-0 rows take JAX's argmax; the filter stays in the logits'
    dtype."""
    rng = np.random.default_rng(3)
    B, V = 6, 40
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    temps = np.asarray([0.7, 1.3, 1.0, 0.0, 0.5, 2.0], np.float32)
    top_ks = np.asarray([5, 0, 1, 0, 12, 3], np.int32)
    top_ps = np.asarray([1.0, 0.8, 1.0, 1.0, 0.3, 0.95], np.float32)
    got = _filter_logits(torch.as_tensor(logits), torch.as_tensor(temps),
                         torch.as_tensor(top_ks), torch.as_tensor(top_ps))
    want = _jax_kept(monkeypatch, logits, temps, top_ks, top_ps)
    np.testing.assert_array_equal(got.numpy() > -1e29, want)
    assert want.sum(1).min() >= 1 and (want.sum(1) < V).any()
    monkeypatch.undo()
    jtok = jsampling.sample_per_row(
        jnp.asarray(logits), jax.random.split(jax.random.PRNGKey(0), B),
        jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps))
    gens = [torch.Generator().manual_seed(i) for i in range(B)]
    ttok = sample_per_row(torch.as_tensor(logits), gens,
                          torch.as_tensor(temps), torch.as_tensor(top_ks),
                          torch.as_tensor(top_ps))
    greedy = temps == 0
    np.testing.assert_array_equal(ttok.numpy()[greedy],
                                  np.asarray(jtok)[greedy])
    assert want[np.arange(B), ttok.numpy()].all()  # draws are kept tokens
    bf = _filter_logits(torch.as_tensor(logits).bfloat16(),
                        torch.as_tensor(temps), torch.as_tensor(top_ks),
                        torch.as_tensor(top_ps))
    assert bf.dtype == torch.bfloat16


def test_sample_per_row_rows_match_solo_sample():
    """Each sampled row draws from its own generator and emits what the
    port's `_sample` at B = 1 emits with that row's numbers under a
    generator of the same seed; rows without a generator take the
    argmax."""
    rng = np.random.default_rng(4)
    B, V = 5, 64
    logits = torch.as_tensor((rng.standard_normal((B, V)) * 2)
                             .astype(np.float32))
    temps = [0.8, 0.0, 1.2, 0.6, 1.0]
    top_ks = [6, 0, 0, 3, 0]
    top_ps = [1.0, 1.0, 0.9, 0.7, 1.0]
    for draw in range(3):
        gens = [None if t == 0 else torch.Generator().manual_seed(10 * i
                                                                  + draw)
                for i, t in enumerate(temps)]
        got = sample_per_row(logits, gens, torch.tensor(temps),
                             torch.tensor(top_ks), torch.tensor(top_ps))
        for i, t in enumerate(temps):
            if t == 0:
                assert int(got[i]) == int(logits[i].argmax())
                continue
            g = torch.Generator().manual_seed(10 * i + draw)
            want = _sample(logits[i:i + 1], g, t, top_ks[i], top_ps[i])
            assert int(got[i]) == int(want[0]), (draw, i)


# -- the engine vs the JAX engine ---------------------------------------------

@pytest.mark.parametrize("chunk_size", [1, 3, 16])
def test_staggered_text_matches_jax(vlm, chunk_size):
    """7 text prompts through 3 slots (slot reuse, mid-flight admission at
    mismatched fill depths, rows dying mid-chunk): the port's completions
    equal the JAX engine's, which equal solo decode."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(7)
    specs = [dict(uid=i, input_ids=rng.integers(1, 400, (n,)).astype(
        np.int32), max_new_tokens=MAX_NEW)
        for i, n in enumerate((4, 9, 5, 13, 7, 3, 11))]
    je, pe = engines(jm, v, tm, num_slots=3, max_len=64, eos_token_ids=EOS,
                     pad_token_id=0, prefill_buckets=(16,),
                     chunk_size=chunk_size)
    want, got = both(je, pe, specs)
    assert got == want
    assert got[0] == port_solo(tm, specs[0]["input_ids"])
    assert pe.stats["steps_run"] == pe.stats["steps_live"]  # exact on CPU


def test_image_request_matches_jax(vlm):
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(11)
    ids, px = image_prompt(cfg, rng, 6)
    txt = rng.integers(1, 400, (5,)).astype(np.int32)
    je, pe = engines(jm, v, tm, num_slots=2, max_len=64, eos_token_ids=EOS,
                     pad_token_id=0, prefill_buckets=(32,))
    want, got = both(je, pe, [
        dict(uid=0, input_ids=ids, pixel_values=px, max_new_tokens=MAX_NEW),
        dict(uid=1, input_ids=txt, max_new_tokens=MAX_NEW)])
    assert got == want
    assert got[0] == port_solo(tm, ids, px)


def test_vacant_slots_are_inert(vlm):
    """A request decodes the same alone (3 vacant slots) and beside
    others, and both equal the JAX engine's."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(3)
    p = rng.integers(1, 400, (6,)).astype(np.int32)
    others = [rng.integers(1, 400, (n,)).astype(np.int32) for n in (4, 9, 7)]
    kw = dict(num_slots=4, max_len=64, eos_token_ids=EOS, pad_token_id=0,
              prefill_buckets=(16,))
    je, pe = engines(jm, v, tm, **kw)
    solo = [dict(uid=0, input_ids=p, max_new_tokens=MAX_NEW)]
    want, got = both(je, pe, solo)
    assert got == want
    shared = solo + [dict(uid=i + 1, input_ids=o, max_new_tokens=MAX_NEW)
                     for i, o in enumerate(others)]
    want2, got2 = both(je, pe, shared)
    assert got2 == want2 and got2[0] == got[0]


def _snapshot(pref):
    return {k: (t.clone() if torch.is_tensor(t) else np.array(t))
            for k, t in pref.items()}


def _same(a, b):
    return all((torch.equal(a[k], b[k]) if torch.is_tensor(a[k])
                else np.array_equal(a[k], b[k])) for k in a)


def _disjoint(t, cache):
    """t shares no storage with the slot cache's buffers."""
    base = t.untyped_storage().data_ptr()
    return all(base != b.untyped_storage().data_ptr()
               for b in (cache.k, cache.v, cache.seg, cache.lev))


def test_prefix_cached_requests_match_jax(vlm):
    """Tails over a registered image prefix equal the JAX engine's (and the
    full-prompt solo decode). The stored prefix is no view of the slot
    cache and is bit-unchanged after slot rows over it were overwritten;
    a prefix request beside a plain one stays invisible."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(29)
    prefix, px = image_prompt(cfg, rng, 4)
    tails = [rng.integers(1, 400, (n,)).astype(np.int32)
             for n in (5, 9, 3, 12)]
    je, pe = engines(jm, v, tm, num_slots=2, max_len=96, eos_token_ids=EOS,
                     pad_token_id=0, prefill_buckets=(16, 32))
    jpid, pid = je.register_prefix(prefix, px), pe.register_prefix(prefix,
                                                                   px)
    before = _snapshot(pe._prefixes[pid])
    specs = [dict(uid=i, input_ids=t, max_new_tokens=MAX_NEW)
             for i, t in enumerate(tails)]
    want = {c.uid: c.token_ids for c in je.run(
        [JRequest(prefix_id=jpid, **s) for s in specs])}
    done = pe.run([Request(prefix_id=pid, **s) for s in specs])
    got = {c.uid: c.token_ids for c in done}
    assert got == want
    assert got[1] == port_solo(tm, np.concatenate([prefix, tails[1]]), px)
    assert all(c.prompt_len == len(prefix) + len(tails[c.uid])
               for c in done)
    assert _same(before, pe._prefixes[pid])
    assert all(_disjoint(pe._prefixes[pid][k], pe.cache)
               for k in ("k", "v", "seg", "lev"))
    plain = rng.integers(1, 400, (7,)).astype(np.int32)
    want = {c.uid: c.token_ids for c in je.run([
        JRequest(uid=0, input_ids=tails[0], max_new_tokens=MAX_NEW,
                 prefix_id=jpid),
        JRequest(uid=1, input_ids=plain, max_new_tokens=MAX_NEW)])}
    got = {c.uid: c.token_ids for c in pe.run([
        Request(uid=0, input_ids=tails[0], max_new_tokens=MAX_NEW,
                prefix_id=pid),
        Request(uid=1, input_ids=plain, max_new_tokens=MAX_NEW)])}
    assert got == want
    pe.release_prefix(pid)
    assert pid not in pe._prefixes


def test_suffix_prefill_masks_a_copy_of_the_store(vlm):
    """A tail prefilled against a stored prefix matched at plen shorter
    than the entry (the automatic store's case): the stored metadata is
    masked at plen in the suffix cache's copy, the store stays
    bit-unchanged, and the suffix cache and first tokens equal JAX's."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(37)
    prefix, px = image_prompt(cfg, rng, 9)
    je, pe = engines(jm, v, tm, num_slots=2, max_len=96, eos_token_ids=EOS,
                     pad_token_id=0, prefill_buckets=(16, 32))
    jpid, pid = je.register_prefix(prefix, px), pe.register_prefix(prefix,
                                                                   px)
    pref, jpref = pe._prefixes[pid], je._prefixes[jpid]
    before = _snapshot(pref)
    plen = len(prefix) - 5
    ids = rng.integers(1, 400, (2, 16)).astype(np.int32)
    seg = np.zeros((2, 16), np.int32)
    seg[0, :7], seg[1, :12] = 1, 1
    tms = seg.sum(1)
    with torch.no_grad():
        small, tok, _ = pe._prefill_suffix(
            pref, plen, torch.as_tensor(ids, dtype=torch.int64),
            torch.as_tensor(seg), torch.as_tensor(tms, dtype=torch.int64))
    jk, _, jseg, _, jtok, _ = je._prefill_suffix(
        v, jpref["k"], jpref["v"], jpref["seg"], jpref["lev"],
        jnp.asarray(plen, jnp.int32), jnp.asarray(ids), jnp.asarray(seg),
        jnp.asarray(tms))
    assert _same(before, pref)
    np.testing.assert_array_equal(small.seg.numpy(), np.asarray(jseg))
    np.testing.assert_allclose(small.k.numpy(), np.asarray(jk),
                               atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_auto_prefix_caching_matches_jax(vlm):
    """Automatic prefix caching: requests sharing an image prefix hit the
    block-hash store (as often as JAX's) and equal the JAX engine's
    completions; the suffix prefill masks a copy of the stored metadata at
    the matched length, so the store stays bit-unchanged; different pixels
    never match; text prompts cache too, under the LRU cap."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(41)
    prefix, px = image_prompt(cfg, rng, 4)
    tails = [rng.integers(1, 400, (n,)).astype(np.int32)
             for n in (5, 9, 3, 12)]
    je, pe = engines(jm, v, tm, num_slots=2, max_len=96, eos_token_ids=EOS,
                     pad_token_id=0, prefill_buckets=(16, 24, 32),
                     auto_prefix_block=4)
    specs = [dict(uid=i, input_ids=np.concatenate([prefix, t]),
                  pixel_values=px, max_new_tokens=MAX_NEW)
             for i, t in enumerate(tails)]
    want, got = both(je, pe, specs)
    assert got == want
    assert pe.auto_prefix_hits == je.auto_prefix_hits >= 1
    assert sorted(pe._prefixes) == sorted(je._prefixes)
    stored = {p: _snapshot(e) for p, e in pe._prefixes.items()}
    # a shorter match of the same entries (a fresh 2-block tail)
    more = [dict(uid=9, input_ids=np.concatenate([prefix, tails[0][:2]]),
                 pixel_values=px, max_new_tokens=MAX_NEW)]
    want, got = both(je, pe, more)
    assert got == want
    assert all(_same(stored[p], pe._prefixes[p]) for p in stored
               if p in pe._prefixes)
    px2 = rng.standard_normal(px.shape).astype(np.float32)
    hits = pe.auto_prefix_hits
    want, got = both(je, pe, [dict(specs[0], pixel_values=px2)])
    assert got == want and pe.auto_prefix_hits == hits
    je_t, pe_t = engines(jm, v, tm, num_slots=2, max_len=96,
                         eos_token_ids=EOS, pad_token_id=0,
                         prefill_buckets=(16, 32), auto_prefix_block=4,
                         auto_prefix_max=2)
    base = rng.integers(1, 400, (13,)).astype(np.int32)
    tspecs = [dict(uid=i, input_ids=np.concatenate(
        [base, rng.integers(1, 400, (4,)).astype(np.int32)]),
        max_new_tokens=MAX_NEW) for i in range(4)]
    want, got = both(je_t, pe_t, tspecs)
    assert got == want
    assert pe_t.auto_prefix_hits == je_t.auto_prefix_hits >= 1
    assert len(pe_t._auto_pids) <= 2


def test_tile_buckets_match_jax(vlm):
    """A 1-tile request through a 2-tile bucket (a zero tile, flag 0):
    the JAX engine's tokens, and the unbucketed engine's."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(17)
    ids, px = image_prompt(cfg, rng, 5, at=1)
    kw = dict(num_slots=2, max_len=64, eos_token_ids=EOS, pad_token_id=0,
              prefill_buckets=(32,))
    spec = [dict(uid=0, input_ids=ids, pixel_values=px,
                 max_new_tokens=MAX_NEW)]
    je, pe = engines(jm, v, tm, tile_buckets=(2,), **kw)
    want, got = both(je, pe, spec)
    assert got == want
    plain = ContinuousBatchingEngine(tm, cache_dtype=torch.float32, **kw)
    assert plain.run([Request(**spec[0])])[0].token_ids == got[0]


def test_sampled_requests_match_port_solo_decode(vlm):
    """Sampled requests (each its own temperature / top-k / top-p / seed)
    beside a greedy one emit what the port's solo make_generate_fn emits
    under a generator of the request's seed; the greedy row equals the JAX
    engine's."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(13)
    p = [rng.integers(1, 400, (n,)).astype(np.int32) for n in (6, 9, 4)]
    specs = [dict(uid=0, input_ids=p[0], max_new_tokens=MAX_NEW),
             dict(uid=1, input_ids=p[1], max_new_tokens=MAX_NEW,
                  temperature=0.75, top_k=5, seed=11),
             dict(uid=2, input_ids=p[2], max_new_tokens=MAX_NEW,
                  temperature=1.25, top_p=0.9, seed=23)]
    je, pe = engines(jm, v, tm, num_slots=3, max_len=64, eos_token_ids=EOS,
                     pad_token_id=0, prefill_buckets=(16,))
    want, got = both(je, pe, specs)
    assert got[0] == want[0]
    for s in specs[1:]:
        assert got[s["uid"]] == port_solo(
            tm, s["input_ids"], temperature=s["temperature"],
            top_k=s.get("top_k", 0), top_p=s.get("top_p", 1.0),
            seed=s["seed"]), s["uid"]


@pytest.mark.parametrize("mode", ["greedy", "spec", "sampled"])
def test_on_token_stream_equals_completions(vlm, mode):
    """The on_token stream of a uid is exactly its Completion.token_ids in
    every run path; greedy and speculative completions equal JAX's."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(41)
    kw = dict(num_slots=3, max_len=96, eos_token_ids=EOS, pad_token_id=0,
              prefill_buckets=(16, 32), chunk_size=4)
    if mode == "spec":
        kw.update(speculative_draft_len=4, speculative_adaptive=False)
    specs = [dict(uid=i, input_ids=rng.integers(1, 400, (n,)).astype(
        np.int32), max_new_tokens=(1, 7, 20)[i % 3],
        temperature=0.8 if mode == "sampled" else 0.0,
        top_k=5 if mode == "sampled" else 0, seed=i)
        for i, n in enumerate((4, 9, 5, 13, 7, 6))]
    pe = ContinuousBatchingEngine(tm, cache_dtype=torch.float32, **kw)
    streamed: dict = {}
    done = pe.run([Request(**s) for s in specs],
                  on_token=lambda uid, tok: streamed.setdefault(
                      uid, []).append(tok))
    for c in done:
        assert streamed.get(c.uid, []) == c.token_ids, (mode, c.uid)
    if mode != "sampled":
        je = JaxEngine(jm, v, cache_dtype=jnp.float32, **kw)
        want = {c.uid: c.token_ids
                for c in je.run([JRequest(**s) for s in specs])}
        assert {c.uid: c.token_ids for c in done} == want


@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_depth_matches_jax(vlm, depth):
    """Chunks chained off the device state with one or two in flight: the
    same tokens as the JAX engine at that depth."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(43)
    specs = [dict(uid=i, input_ids=rng.integers(1, 400, (n,)).astype(
        np.int32), max_new_tokens=(3, 9, 14)[i % 3])
        for i, n in enumerate((4, 9, 5, 13, 7, 3, 11, 6))]
    je, pe = engines(jm, v, tm, num_slots=3, max_len=64, eos_token_ids=EOS,
                     pad_token_id=0, prefill_buckets=(16,), chunk_size=3,
                     pipeline_depth=depth)
    want, got = both(je, pe, specs)
    assert got == want


def test_engine_defaults_match_jax():
    """The constructor's keywords and defaults are the JAX engine's (the
    cache dtype as a torch dtype; no `params`: the port's model holds its
    weights); EngineChat's too."""
    from vlaser_tpu.serve.engine_chat import EngineChat as JaxChat
    from vlaser_tpu_torch.serve.engine_chat import EngineChat

    for jcls, pcls in ((JaxEngine, ContinuousBatchingEngine),
                       (JaxChat, EngineChat)):
        jsig = inspect.signature(jcls.__init__).parameters
        psig = inspect.signature(pcls.__init__).parameters
        assert [n for n in jsig if n != "params"] == list(psig)
        for name, p in psig.items():
            want = jsig[name].default
            if name == "cache_dtype":
                assert want is jnp.bfloat16 and p.default is torch.bfloat16
            else:
                assert p.default == want, name


def test_admission_validation(vlm):
    cfg, _, _, tm = vlm
    with pytest.raises(ValueError, match="exceed max_len"):
        ContinuousBatchingEngine(tm, num_slots=2, max_len=32,
                                 eos_token_ids=EOS, pad_token_id=0,
                                 prefill_buckets=(16, 64))
    # a mesh needs the process group whose ranks it spans
    with pytest.raises(ValueError, match="process group"):
        ContinuousBatchingEngine(tm, num_slots=2, max_len=32,
                                 eos_token_ids=EOS, pad_token_id=0,
                                 mesh=object())
    pe = ContinuousBatchingEngine(tm, num_slots=2, max_len=32,
                                  eos_token_ids=EOS, pad_token_id=0,
                                  prefill_buckets=(16,),
                                  speculative_draft_len=4,
                                  speculative_adaptive=False)
    with pytest.raises(ValueError, match="max_new_tokens"):
        pe.run([Request(uid=0, input_ids=np.asarray([5, 6]),
                        max_new_tokens=0)])
    with pytest.raises(ValueError, match="speculative margin"):
        pe.run([Request(uid=0, input_ids=np.arange(2, 14),
                        max_new_tokens=17)])


def test_engine_chat_matches_jax(vlm):
    """EngineChat's batch_chat (text and image rows, tiles split per
    request), chat_many and batch_chat_shared_image answer as JAX's
    EngineChat with the same toy tokenizer; the quantize flag quantizes
    the model in place."""
    from vlaser_tpu.serve.engine_chat import EngineChat as JaxChat
    from vlaser_tpu_torch.core.quant import is_quantized
    from vlaser_tpu_torch.serve.engine_chat import EngineChat

    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(53)
    img = cfg.vision.image_size
    px = rng.standard_normal((3, img, img, 3)).astype(np.float32)
    kw = dict(max_new_tokens=5, num_slots=3, max_len=256,
              prefill_buckets=(128, 192), tile_buckets=(1, 2))
    jc = JaxChat(jm, v, ToyTok(), cache_dtype=jnp.float32, **kw)
    pc = EngineChat(tm, ToyTok(), cache_dtype=torch.float32, **kw)
    qs = ["what is here?", "describe it", "hello"]
    npl = [2, 1, 0]
    assert pc.batch_chat(qs, px, npl) == jc.batch_chat(qs, px, npl)
    items = [("left or right?", px[:1], None), ("count", None, None, None, 3)]
    assert pc.chat_many(items) == jc.chat_many(items)
    assert pc.chat("one tile", px[2:]) == jc.chat("one tile", px[2:])
    shared = ["what color?", "how many objects?"]
    assert pc.batch_chat_shared_image(shared, px[:1]) == \
        jc.batch_chat_shared_image(shared, px[:1]) == \
        pc.batch_chat(shared, px[:1].repeat(2, 0), [1, 1])
    _, _, _, tq = build_models()
    EngineChat(tq, ToyTok(), max_new_tokens=4, num_slots=2, max_len=64,
               quantize="w8a8")
    assert is_quantized(tq)
    assert not is_quantized(tm)
