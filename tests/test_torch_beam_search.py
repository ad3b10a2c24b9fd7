"""The port's beam search (vlaser_tpu_torch/inference/beam_search.py) and
VlaserChat's beam route vs the JAX package on tiny_vlm at fp32 (the same
weights loaded through utils/convert.from_jax_variables), and vs HF
`generate(num_beams=2)` on a tiny Qwen2 holding the same weights.

The JAX searcher feeds each token one position late (ROADMAP queue 3): it
is held here with its model's decode_step moved one position back
(`OnTime`), which makes its K = 1 search greedy decoding again; the
unmoved searcher is shown to differ. Tolerance: tokens and lengths equal
(fp32 compute, `highest` matmul precision from conftest)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.config import tiny_vlm
from vlaser_tpu.core.quant import quantize_for_serving as jax_quantize
from vlaser_tpu.inference.beam_search import \
    make_beam_generate_fn as jax_beams
from vlaser_tpu.inference.chat import VlaserChat as JaxChat
from vlaser_tpu.inference.sampling import make_generate_fn as jax_greedy
from vlaser_tpu.models.vlm import InternVLChatModel as JaxModel
from vlaser_tpu.utils.hf_convert import convert_qwen2
from vlaser_tpu_torch.core.quant import quantize_for_serving
from vlaser_tpu_torch.inference import beam_search
from vlaser_tpu_torch.inference.beam_search import make_beam_generate_fn
from vlaser_tpu_torch.inference.chat import VlaserChat
from vlaser_tpu_torch.inference.sampling import make_generate_fn
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.models.vlm import InternVLChatModel
from vlaser_tpu_torch.utils.convert import from_jax_variables

from test_chat_and_configs import ToyTok

NEW = 10
NEVER = 511  # an EOS id the tiny model does not reach in NEW tokens


class OnTime(JaxModel):
    """The JAX model whose decode_step takes positions one back: under the
    JAX beam searcher, each token then stands at its place in the
    sequence."""

    def decode_step(self, token, cache, positions=None, seg_ids=None):
        return super().decode_step(token, cache, positions - 1, seg_ids)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _variables(cfg, seed):
    """The JAX tiny_vlm's variables from PRNGKey(seed), made once a seed."""
    jm = JaxModel(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 400, (1, 8 + cfg.num_image_token))
    ids[0, 2:2 + cfg.num_image_token] = cfg.img_context_token_id
    img = cfg.vision.image_size
    px = rng.standard_normal((1, img, img, 3)).astype(np.float32)
    return jm.init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                   jnp.asarray(px), None)


def _port(cfg, v):
    tm = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu")
    return load_state(tm, from_jax_variables(jax.tree_util.tree_map(
        np.asarray, v)))


@pytest.fixture(scope="module")
def pair():
    """-> (cfg, on-time JAX model, plain JAX model, variables, port model,
    ids [2, 9], seg): two text rows, the second right-padded (6 tokens)."""
    cfg = tiny_vlm()
    v = _variables(cfg, 0)
    rng = np.random.default_rng(21)
    ids = rng.integers(5, 200, (2, 9))
    seg = np.ones((2, 9), np.int32)
    ids[1, 6:], seg[1, 6:] = 0, 0
    return (cfg, OnTime(cfg, compute_dtype=jnp.float32, attn_impl="reference"),
            JaxModel(cfg, compute_dtype=jnp.float32, attn_impl="reference"),
            v, _port(cfg, v), ids, seg)


def _jax_run(model, v, ids, seg, K, eos):
    gen = jax_beams(model, max_new_tokens=NEW, num_beams=K,
                    eos_token_ids=[eos], pad_token_id=0,
                    cache_dtype=jnp.float32)
    toks, lens = gen(v, jnp.asarray(ids), jnp.asarray(seg), None)
    return np.asarray(toks), np.asarray(lens)


def _port_run(tm, ids, seg, K, eos):
    gen = make_beam_generate_fn(tm, max_new_tokens=NEW, num_beams=K,
                                eos_token_ids=[eos], pad_token_id=0,
                                cache_dtype=torch.float32)
    toks, lens = gen(torch.from_numpy(ids), torch.from_numpy(seg), None)
    return toks.numpy(), lens.numpy()


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("case", ["eos_never", "eos_mid_beam"])
def test_beams_match_jax(pair, K, case):
    """B 2, K 2 and 3: the port's tokens and lengths equal the on-time JAX
    searcher's, with an EOS the model never reaches and with one it emits
    mid-beam (picked as test_golden_vs_reference.py picks it: the token at
    NEW // 2 of the first row's unreachable-EOS beam)."""
    cfg, jm, _, v, tm, ids, seg = pair
    eos = NEVER
    if case == "eos_mid_beam":
        eos = int(_jax_run(jm, v, ids, seg, K, NEVER)[0][0, NEW // 2])
    want = _jax_run(jm, v, ids, seg, K, eos)
    got = _port_run(tm, ids, seg, K, eos)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if case == "eos_mid_beam":
        assert (got[1] < NEW).any()  # a hypothesis finished on EOS
    else:
        assert (got[1] == NEW).all()


def test_k1_is_greedy_and_the_jax_searcher_is_one_position_late(pair):
    """K = 1 is greedy decoding: the port's search equals the port's and
    JAX's greedy decoders, and so does the on-time JAX searcher; the JAX
    searcher as written does not (it feeds each token one position late:
    the control that OnTime is needed)."""
    cfg, jm, jplain, v, tm, ids, seg = pair
    got = _port_run(tm, ids, seg, 1, NEVER)
    greedy = make_generate_fn(tm, max_new_tokens=NEW, eos_token_ids=[NEVER],
                              pad_token_id=0, cache_dtype=torch.float32)(
        torch.from_numpy(ids), torch.from_numpy(seg), None)
    jgreedy = jax_greedy(jplain, max_new_tokens=NEW, eos_token_ids=[NEVER],
                         pad_token_id=0, cache_dtype=jnp.float32)(
        v, jnp.asarray(ids), jnp.asarray(seg), None, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got[0], greedy[0].numpy())
    np.testing.assert_array_equal(got[1], greedy[1].numpy())
    np.testing.assert_array_equal(got[0], np.asarray(jgreedy[0]))
    np.testing.assert_array_equal(_jax_run(jm, v, ids, seg, 1, NEVER)[0],
                                  got[0])
    late = _jax_run(jplain, v, ids, seg, 1, NEVER)[0]
    assert not np.array_equal(late, got[0])


def test_top_breaks_ties_toward_the_lower_index():
    """lax.top_k's order: equal values keep their index order, NEG ties
    included."""
    x = torch.tensor([[1.0, 3.0, 3.0, -1e9, 3.0, -1e9],
                      [-1e9, -1e9, -1e9, -1e9, 0.5, -1e9]])
    i = beam_search._top(x, 4)[1]
    assert i.tolist() == [[1, 2, 4, 0], [4, 0, 1, 2]]
    want = jax.lax.top_k(jnp.asarray(x.numpy()), 4)[1]
    assert i.tolist() == np.asarray(want).tolist()


def test_cache_reorder_writes_into_the_spare_buffers():
    from vlaser_tpu_torch.inference.kv_cache import KVCache

    c = KVCache.create(2, 4, 5, 1, 3, torch.float32)
    c.k.copy_(torch.arange(c.k.numel(), dtype=torch.float32).view_as(c.k))
    c.seg.copy_(torch.arange(20, dtype=torch.int32).view(4, 5))
    spare = KVCache.create(2, 4, 5, 1, 3, torch.float32)
    ptr = spare.k.data_ptr()
    rows = torch.tensor([2, 2, 0, 3])
    out = beam_search._reorder_cache(c, rows, spare)
    assert out.k.data_ptr() == ptr
    assert torch.equal(out.k, c.k[:, rows]) and torch.equal(out.seg,
                                                             c.seg[rows])


def _chat_pair(quantize):
    cfg = tiny_vlm()
    v = _variables(cfg, 0)
    tm = _port(cfg, v)
    if quantize:
        v = jax_quantize(v, target="vlm", mode="w8a8", min_size=1)
        quantize_for_serving(tm, target="vlm", mode="w8a8", min_size=1)
    jm = OnTime(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    return cfg, jm, v, tm


@pytest.mark.parametrize("quantize", [False, True],
                         ids=["float", "w8a8"])
def test_chat_beams_match_jax(quantize):
    """VlaserChat(num_beams=2) with pixels answers as the JAX chat's beam
    route does (test_chat_and_configs.py's beam cases), on the float tree
    and on quantize_for_serving's w8a8 tree; batch_chat too."""
    cfg, jm, v, tm = _chat_pair(quantize)
    rng = np.random.default_rng(3)
    img = cfg.vision.image_size
    px = rng.standard_normal((1, img, img, 3)).astype(np.float32)
    kw = dict(max_new_tokens=6, bucket=32, num_beams=2)
    jchat = JaxChat(jm, v, ToyTok(), cache_dtype=jnp.float32, **kw)
    chat = VlaserChat(tm, ToyTok(), cache_dtype=torch.float32, **kw)
    resp = chat.chat("describe", px)
    assert isinstance(resp, str) and resp == jchat.chat("describe", px)
    qs = ["what do you see?", "hi"]
    assert chat.batch_chat(qs, None, [0, 0]) == jchat.batch_chat(qs, None,
                                                                 [0, 0])


def test_beams_never_take_the_fused_runner():
    """num_beams > 1 keeps `_fused_gen` None on a quantized model even when
    the fused runner is forced (JAX test_chat_and_configs.py:297-303);
    beams are greedy; speculative decoding takes no beams. The beam route
    ignores repetition_penalty, as the JAX route does."""
    tm = _chat_pair(True)[3]
    beams = VlaserChat(tm, ToyTok(), max_new_tokens=4, num_beams=2,
                       use_fused=True, cache_dtype=torch.float32)
    assert beams._fused_gen is None
    assert VlaserChat(tm, ToyTok(), max_new_tokens=4,
                      use_fused=True)._fused_gen is not None
    with pytest.raises(ValueError):
        VlaserChat(tm, ToyTok(), max_new_tokens=4, num_beams=2,
                   temperature=0.7)
    with pytest.raises(ValueError):
        VlaserChat(tm, ToyTok(), max_new_tokens=4, num_beams=2,
                   speculative_draft_len=4)
    pen = VlaserChat(tm, ToyTok(), max_new_tokens=4, num_beams=2,
                     repetition_penalty=1.3, bucket=32,
                     cache_dtype=torch.float32)
    assert pen.chat("hello") == VlaserChat(
        tm, ToyTok(), max_new_tokens=4, num_beams=2, bucket=32,
        cache_dtype=torch.float32).chat("hello")


@pytest.fixture(scope="module")
def hf_pair():
    """A tiny HF Qwen2 and the port's tiny_vlm holding its LLM weights
    (tests/test_qwen2.py's bridge: convert_qwen2 of the HF state dict)."""
    from transformers import Qwen2Config
    from transformers.models.qwen2.modeling_qwen2 import \
        Qwen2ForCausalLM as HFQwen2

    cfg = tiny_vlm()
    llm = cfg.llm
    torch.manual_seed(0)
    hf = HFQwen2(Qwen2Config(
        vocab_size=llm.vocab_size, hidden_size=llm.hidden_size,
        intermediate_size=llm.intermediate_size,
        num_hidden_layers=llm.num_layers, num_attention_heads=llm.num_heads,
        num_key_value_heads=llm.num_kv_heads, head_dim=llm.head_dim,
        rope_theta=llm.rope_theta, rms_norm_eps=llm.rms_norm_eps,
        max_position_embeddings=llm.max_position_embeddings,
        tie_word_embeddings=False, attention_dropout=0.0)).eval()
    v = _variables(cfg, 0)
    v = {"params": {**v["params"], "language_model": convert_qwen2(
        {k: t.numpy() for k, t in hf.state_dict().items()},
        llm.num_layers)}}
    return hf, _port(cfg, v)


@pytest.mark.parametrize("case", ["eos_never", "eos_mid_beam"])
def test_beams_match_hf_generate(hf_pair, case):
    """HF generate(num_beams=2, early_stopping=False) on unpadded prompts
    as a second oracle. transformers 4.57 normalizes a finished hypothesis
    by its generated length, the JAX searcher (and the port) by prompt +
    generated length, as transformers did before 4.38; the EOS case is
    therefore compared at length_penalty 0, where both take the summed
    log-probabilities, through each row's first EOS (HF pads a finished row
    with EOS, the port with the pad id)."""
    hf, tm = hf_pair
    B, N = 2, 9
    g = torch.Generator().manual_seed(21)
    ids = torch.randint(5, 200, (B, N), generator=g)
    lp = 1.0 if case == "eos_never" else 0.0

    def hf_beams(eos):
        with torch.no_grad():
            out = hf.generate(input_ids=ids,
                              attention_mask=torch.ones_like(ids),
                              max_new_tokens=NEW, do_sample=False,
                              num_beams=2, pad_token_id=0, eos_token_id=eos,
                              use_cache=True, early_stopping=False,
                              length_penalty=lp)
        return out[:, N:].numpy()

    eos = NEVER
    if case == "eos_mid_beam":
        eos = int(hf_beams(NEVER)[0, NEW // 2])
    want = hf_beams(eos)
    got, lens = make_beam_generate_fn(
        tm, max_new_tokens=NEW, num_beams=2, eos_token_ids=[eos],
        pad_token_id=0, length_penalty=lp, cache_dtype=torch.float32)(
        ids, torch.ones((B, N), dtype=torch.int32), None)
    got, lens = got.numpy(), lens.numpy()
    if case == "eos_never":
        np.testing.assert_array_equal(got, want)
        return
    for r in range(B):
        w = list(want[r])
        end = w.index(eos) + 1 if eos in w else NEW
        assert int(lens[r]) == end
        np.testing.assert_array_equal(got[r, :end], want[r, :end])
    assert (lens < NEW).any()
