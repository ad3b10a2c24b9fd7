"""The port's chat path (vlaser_tpu_torch: models/vlm.InternVLChatModel,
inference/{sampling,fused_runner,chat}, tokenizer/conversation) vs the JAX
package on tiny_vlm, the same weights loaded through
utils/convert.from_jax_variables.

Tolerances: fp32 compute (`highest` matmul precision, conftest) holds the
prefill logits to 1e-5 and the greedy tokens exactly. The fused decoder
rounds to bf16 inside its stack on both sides in other summation orders:
teacher-forced logits within 2e-2 of max |JAX logits| per step, and the
tokens equal wherever JAX's top-2 margin exceeds twice that bound. The JAX
Pallas kernels run in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.config import tiny_vlm
from vlaser_tpu.core.quant import quantize_for_serving as jax_quantize
from vlaser_tpu.inference import fused_runner as jfr
from vlaser_tpu.inference.chat import VlaserChat as JaxChat
from vlaser_tpu.inference.kv_cache import KVCache as JKVCache
from vlaser_tpu.inference.sampling import make_generate_fn as jax_generate
from vlaser_tpu.models.vlm import InternVLChatModel as JaxModel
from vlaser_tpu.tokenizer.conversation import \
    build_chat_query as jax_build_query
from vlaser_tpu_torch.core.quant import quantize_for_serving
from vlaser_tpu_torch.inference import fused_runner
from vlaser_tpu_torch.inference.chat import VlaserChat
from vlaser_tpu_torch.inference.kv_cache import KVCache
from vlaser_tpu_torch.inference.sampling import make_generate_fn
from vlaser_tpu_torch.kernels import fused_decode, fused_vit
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.models.vlm import InternVLChatModel
from vlaser_tpu_torch.tokenizer.conversation import build_chat_query
from vlaser_tpu_torch.utils.convert import from_jax_variables

from test_chat_and_configs import ToyTok

FP32_TOL = 1e-5
FUSED_REL = 2e-2


def _models(compute="float32", quantize=False, seed=0):
    """-> (cfg, jax model, jax variables, port model, ids, pixels): two
    tiles, a prompt whose 8 image-context slots take their features, norms
    1 + N(0, 0.1^2) so that every branch shows."""
    cfg = tiny_vlm()
    jm = JaxModel(cfg, compute_dtype=getattr(jnp, compute),
                  attn_impl="reference")
    rng = np.random.default_rng(seed)
    t = cfg.num_image_token
    ids = rng.integers(1, 400, (1, 3 + 2 * t))
    ids[0, 1:1 + 2 * t] = cfg.img_context_token_id
    img = cfg.vision.image_size
    px = rng.standard_normal((2, img, img, 3)).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(px),
                None)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
                      if "norm" in jax.tree_util.keystr(p) else a), v)
    tm = InternVLChatModel(cfg, compute_dtype=getattr(torch, compute),
                           device="cpu")
    load_state(tm, from_jax_variables(jax.tree_util.tree_map(np.asarray, v)))
    if quantize:
        v = jax_quantize(v, target="vlm", mode="w8a8", min_size=1)
        quantize_for_serving(tm, target="vlm", mode="w8a8", min_size=1)
    return cfg, jm, v, tm, ids, px


def test_prefill_logits_match_jax():
    cfg, jm, v, tm, ids, px = _models()
    n, new = ids.shape[1], 3
    llm = cfg.llm
    seg = np.ones_like(ids, dtype=np.int32)
    jc = JKVCache.create(llm.num_layers, 1, n + new, llm.num_kv_heads,
                         llm.head_dim, dtype=jnp.float32)
    want, _, jc = jm.apply(v, jnp.asarray(ids), jnp.asarray(px),
                           jnp.asarray(seg), jc, method=jm.prefill)
    tc = KVCache.create(llm.num_layers, 1, n + new, llm.num_kv_heads,
                        llm.head_dim, dtype=torch.float32)
    with torch.no_grad():
        got, _, tc = tm.prefill(torch.from_numpy(ids), torch.from_numpy(px),
                                torch.from_numpy(seg), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_TOL,
                               rtol=FP32_TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=FP32_TOL,
                               rtol=FP32_TOL)
    assert tc.length == int(jc.length) == n


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_generate_greedy_tokens_match_jax(penalty):
    """The plain generator on right-padded prompts of two rows (batch
    requests take it), fp32, fp32 cache; with and without HF's repetition
    penalty."""
    cfg, jm, v, tm, ids, px = _models()
    n = ids.shape[1] + 5
    ids2 = np.zeros((2, n), np.int64)
    seg = np.zeros((2, n), np.int32)
    ids2[0, :ids.shape[1]], seg[0, :ids.shape[1]] = ids[0], 1
    ids2[1, :4], seg[1, :4] = [5, 6, 7, 8], 1  # text-only row, no tiles
    kw = dict(max_new_tokens=5, eos_token_ids=[3], pad_token_id=0,
              repetition_penalty=penalty)
    want = jax_generate(jm, cache_dtype=jnp.float32, **kw)(
        v, jnp.asarray(ids2), jnp.asarray(seg), jnp.asarray(px),
        jax.random.PRNGKey(0))
    got = make_generate_fn(tm, cache_dtype=torch.float32, **kw)(
        torch.from_numpy(ids2), torch.from_numpy(seg), torch.from_numpy(px))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_fused_decode_teacher_forced_matches_jax():
    """bf16 compute on a quantize_for_serving("vlm", "w8a8") tree: the
    prefill (w8a8 fused ViT on both sides), then the fused decode steps of
    both packages fed JAX's greedy stream from their own prefilled caches."""
    cfg, jm, v, tm, ids, px = _models(compute="bfloat16", quantize=True)
    llm = cfg.llm
    n, new = ids.shape[1], 4
    seg = np.ones_like(ids, dtype=np.int32)
    jfeat = jfr.fused_visual_features(jm, v, jnp.asarray(px))
    jc = JKVCache.create(llm.num_layers, 1, n + new, llm.num_kv_heads,
                         llm.head_dim, dtype=jnp.bfloat16)
    jl, _, jc = jm.apply(v, jnp.asarray(ids), None, jnp.asarray(seg), jc,
                         visual_features=jfeat, method=jm.prefill)
    counts = (fused_vit.act_quant_launch_count, fused_decode.launch_count)
    with torch.no_grad():
        tfeat = fused_runner.fused_visual_features(tm, torch.from_numpy(px))
        tc = KVCache.create(llm.num_layers, 1, n + new, llm.num_kv_heads,
                            llm.head_dim, dtype=torch.bfloat16)
        tl, _, tc = tm.prefill(torch.from_numpy(ids), None,
                               torch.from_numpy(seg), tc,
                               visual_features=tfeat)
    np.testing.assert_allclose(tfeat.float().numpy(),
                               np.asarray(jfeat, np.float32), atol=5e-2)
    stack = jfr.pack_qwen2_stack(v)
    q = v["quant"]["language_model"]
    jhead = ("lm_head", q["lm_head"]["kernel_q"],
             q["lm_head"]["kernel_scale"])
    tstack = fused_runner.pack_qwen2_stack(tm.language_model)
    thead = fused_runner.head_of(tm.language_model)
    token = np.asarray(jl[0, -1], np.float32).argmax()[None]
    checked = 0
    for t in range(new):
        pos = np.asarray([n + t], np.int32)
        want, jc = jfr.fused_decode_step(stack, q["embed_tokens"], jhead, llm,
                                         jnp.asarray(token, jnp.int32), jc,
                                         jnp.asarray(pos))
        with torch.no_grad():
            got, tc = fused_runner.fused_decode_step(
                tstack, tm.language_model.embed_tokens, thead, llm,
                torch.from_numpy(token), tc, torch.from_numpy(pos))
        want = np.asarray(want, np.float32)[0]
        got = got.numpy()[0]
        bound = FUSED_REL * np.abs(want).max()
        assert np.abs(got - want).max() <= bound, (t, np.abs(got - want).max())
        top2 = np.sort(want)[-2:]
        if top2[1] - top2[0] > 2 * bound:
            assert got.argmax() == want.argmax(), t
            checked += 1
        token = want.argmax()[None]
    assert tc.length == int(jc.length) == n + new
    assert checked > 0
    assert (fused_vit.act_quant_launch_count,
            fused_decode.launch_count) == counts  # CPU: the plain versions


def test_chat_text_matches_jax_fused_chat():
    """VlaserChat.chat (use_fused=True: the fused runner on the kernels'
    plain versions) answers as the JAX package's fused chat does."""
    cfg, jm, v, tm, ids, px = _models(quantize=True, seed=1)
    jchat = JaxChat(jm, v, ToyTok(), max_new_tokens=4, bucket=32,
                    use_fused=True)
    chat = VlaserChat(tm, ToyTok(), max_new_tokens=4, bucket=32,
                      use_fused=True)
    assert chat._fused_gen is not None and jchat._fused_gen is not None
    calls = []
    orig = chat._fused_gen
    chat._fused_gen = lambda *a: (calls.append(1), orig(*a))[1]
    resp = chat.chat("what do you see?", px)
    assert calls
    assert resp == jchat.chat("what do you see?", px)
    resp2, hist = chat.chat("and then?", None, history=[("hi", "ho")],
                            return_history=True)
    assert hist[-1] == ("and then?", resp2)


TEMPLATES = ("internvl2_5", "Hermes-2", "internlm2-chat", "phi3-chat",
             "internvl_zh")


@pytest.mark.parametrize("template", TEMPLATES)
def test_build_chat_query_matches_jax(template):
    cases = [
        ("<image>\nWhat is this?", [2], None, None),
        ("Describe it.", [1, 3], None, "be brief"),
        ("and now?", [], [("first q", "first a"), ("q2", "a2")], None),
    ]
    for question, patches, history, system in cases:
        got = build_chat_query(template, question, patches, 4,
                               history=history, system_message=system)
        want = jax_build_query(template, question, patches, 4,
                               history=history, system_message=system)
        assert got == want


def test_chat_routing():
    """As tests/test_chat_and_configs.py's routing cases: only a quantized
    LLM, greedy, single-stream request takes the fused runner; "auto" does
    not route on the CPU nor at a non-bf16 cache; batch_chat keeps the plain
    generator; beams are not ported; speculative decoding takes its own
    generator, never the fused runner."""
    cfg, jm, v, tm, ids, px = _models()
    assert VlaserChat(tm, ToyTok(), max_new_tokens=4,
                      use_fused=True)._fused_gen is None  # unquantized
    quantize_for_serving(tm, min_size=1)
    assert VlaserChat(tm, ToyTok(), max_new_tokens=4, temperature=0.7,
                      use_fused=True)._fused_gen is None
    assert VlaserChat(tm, ToyTok(), max_new_tokens=4, repetition_penalty=1.2,
                      use_fused=True)._fused_gen is None
    with pytest.raises(NotImplementedError):
        VlaserChat(tm, ToyTok(), max_new_tokens=4, num_beams=2)
    spec = VlaserChat(tm, ToyTok(), max_new_tokens=4,
                      speculative_draft_len=4, use_fused=True)
    assert spec._fused_gen is None and hasattr(spec._gen, "with_stats")
    assert VlaserChat(tm, ToyTok(), max_new_tokens=4)._fused_gen is None
    assert VlaserChat(tm, ToyTok(), max_new_tokens=4,
                      cache_dtype=torch.float32,
                      use_fused="auto")._fused_gen is None
    chat = VlaserChat(tm, ToyTok(), max_new_tokens=4, bucket=32,
                      use_fused=True)
    assert chat._fused_gen is not None
    calls = []
    orig = chat._fused_gen
    chat._fused_gen = lambda *a: (calls.append(1), orig(*a))[1]
    chat.chat("what do you see?", px)
    assert len(calls) == 1
    out = chat.batch_chat(["hello", "hi"], None, num_patches_list=[0, 0])
    assert len(out) == 2 and len(calls) == 1
    # sampling draws from the chat's own seeded generator: reproducible
    a = VlaserChat(tm, ToyTok(), max_new_tokens=6, temperature=1.0,
                   top_k=5).chat("hello", None)
    b = VlaserChat(tm, ToyTok(), max_new_tokens=6, temperature=1.0,
                   top_k=5).chat("hello", None)
    assert a == b


def test_sampling_filters_keep_the_top_token():
    """top-k of 1, or a nucleus smaller than the top token's mass, leaves
    only the argmax to draw (the JAX filters' rule: a token is kept while
    the mass before it is under top_p)."""
    from vlaser_tpu_torch.inference.sampling import _sample

    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 50, generator=g) * 3
    for kw in (dict(top_k=1), dict(top_k=0, top_p=1e-3),
               dict(top_k=5, top_p=1e-3)):
        got = _sample(logits, g, temperature=0.7, **kw)
        assert torch.equal(got, logits.argmax(-1)), kw
    drawn = _sample(logits, g, temperature=1.0, top_k=3)
    assert all(int(t) in logits[i].topk(3).indices.tolist()
               for i, t in enumerate(drawn))
