"""Qwen3 (the Qwen3-1.7B LLM of InternVL3.5-2B: a per-head q/k RMSNorm
before rope, no q/k/v bias, tied embeddings) in the port against the JAX
package, at the port's tiny qk-norm configs (core/config.tiny_qwen3_*), the
same numpy-drawn weights loaded through utils/convert.from_jax_variables,
norms 1 + N(0, 0.1^2) so that the q/k norms are not the identity:
- the LLM's logits against HF transformers' Qwen3 through the port's HF
  converter, a cached prefill and the per-row-offset decode against JAX;
- quantize_for_serving leaves q_norm / k_norm float, the tree bit-equal to
  JAX's in both modes;
- the chat routes: "auto" keeps the plain generator, use_fused=True and
  the fused runner raise; EngineChat's greedy streams equal JAX's and the
  plain generator's;
- the reference's fault: the JAX fused decode stack has no q/k norm, so its
  teacher-forced logits leave the plain decoder's by far more than on a
  Qwen2 model of the same weights (ROADMAP queue 3).

Tolerances: fp32 (`highest` matmul precision, conftest): logits 1e-5
against JAX, 2e-4 against HF (the JAX test's); the fused decoder's bf16
against the plain fp32 decoder: FUSED_REL x max |logits| a step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core import config as jconfig
from vlaser_tpu.core.quant import quantize_for_serving as jax_quantize
from vlaser_tpu.inference import fused_runner as jfr
from vlaser_tpu.inference.kv_cache import KVCache as JKVCache
from vlaser_tpu.models.vlm import InternVLChatModel as JaxModel
from vlaser_tpu_torch.core import config as tconfig
from vlaser_tpu_torch.core.quant import quantize_for_serving
from vlaser_tpu_torch.inference import fused_runner
from vlaser_tpu_torch.inference.chat import VlaserChat
from vlaser_tpu_torch.inference.kv_cache import KVCache
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.models.qwen2 import Qwen2ForCausalLM
from vlaser_tpu_torch.models.vlm import InternVLChatModel
from vlaser_tpu_torch.utils.convert import from_jax_variables

from test_chat_and_configs import ToyTok

FP32_TOL = 1e-5
FUSED_REL = 2e-2


def jax_cfg(cfg):
    """The JAX package's config object with every field of a port config
    (the classes share their names and fields)."""
    if not dataclasses.is_dataclass(cfg):
        return cfg
    return getattr(jconfig, type(cfg).__name__)(**{
        f.name: jax_cfg(getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)})


def draw_variables(init, rng):
    """Variables shaped as `init()` traces them (no compile), drawn from
    numpy: norm weights 1 + N(0, 0.1^2), so that no norm is the identity,
    everything else N(0, 0.1^2)."""
    def draw(path, s):
        w = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        norm = ("norm" in jax.tree_util.keystr(path)
                and path[-1].key in ("weight", "scale"))
        return jnp.asarray(w + 1.0 if norm else w)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


def vlm_pair(cfg, compute="float32", seed=0):
    """-> (jax model, its variables, the port model, ids, pixels): one tile
    and a prompt whose image-context slots take its features."""
    jm = JaxModel(jax_cfg(cfg), compute_dtype=getattr(jnp, compute),
                  attn_impl="reference")
    rng = np.random.default_rng(seed)
    t = cfg.num_image_token
    ids = rng.integers(1, 400, (1, 3 + t))
    ids[0, 1:1 + t] = cfg.img_context_token_id
    img = cfg.vision.image_size
    px = rng.standard_normal((1, img, img, 3)).astype(np.float32)
    v = draw_variables(lambda: jm.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(ids), jnp.asarray(px),
                                       None), rng)
    tm = InternVLChatModel(cfg, compute_dtype=getattr(torch, compute),
                           device="cpu")
    load_state(tm, from_jax_variables(jax.tree_util.tree_map(np.asarray, v)))
    return jm, v, tm, ids, px


@pytest.fixture(scope="module")
def qwen3():
    cfg = tconfig.tiny_qwen3_vlm()
    return (cfg,) + vlm_pair(cfg)


def test_tiny_config_is_qwen3():
    llm = tconfig.tiny_qwen3_llm()
    assert llm.qk_norm and llm.tie_word_embeddings
    assert not llm.attention_bias


def test_logits_match_hf_qwen3_through_the_port_converter():
    """HF Qwen3ForCausalLM (tied embeddings) -> the port's
    hf_convert.convert_qwen2 -> from_jax_variables -> the port's LLM: its
    logits are HF's within the JAX test's 2e-4."""
    from transformers import Qwen3Config
    from transformers.models.qwen3.modeling_qwen3 import (
        Qwen3ForCausalLM as HFQwen3)

    from vlaser_tpu_torch.utils.hf_convert import convert_qwen2

    cfg = tconfig.tiny_qwen3_llm()
    hf_cfg = Qwen3Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
        tie_word_embeddings=True, attention_bias=False,
        attention_dropout=0.0)
    torch.manual_seed(5)
    hf = HFQwen3(hf_cfg).eval().to(torch.float32)
    with torch.no_grad():  # visible q/k norms
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    params = convert_qwen2(hf.state_dict(), cfg.num_layers)
    # a tied head is the embedding: the state dict lists it twice
    np.testing.assert_array_equal(params.pop("lm_head")["kernel"].T,
                                  params["embed_tokens"]["embedding"])
    assert "q_norm" in params["model"]["layers"]["self_attn"]
    tm = Qwen2ForCausalLM(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables({"params": params}))
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 9)))
    with torch.no_grad():
        want = hf(ids).logits
        got, _, _ = tm(input_ids=ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("s", [1, 3])
def test_per_row_decode_matches_jax(qwen3, s):
    """A cached prefill of three rows, then a decode step against the
    per-row cache (fill depths 7, 4, 9; row 1 dead): a one-token step and a
    3-token block give JAX's logits within 1e-5 and the same cache."""
    cfg, jm, v, tm, _, _ = qwen3
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
    jl0, _, jc = jax.jit(lambda *a: jm.apply(*a, method=jm.prefill))(
        v, jnp.asarray(ids), None, jnp.asarray(seg), jc)
    jc = jc.replace(length=jnp.asarray(fill))
    want, _, jc = jax.jit(lambda *a: jm.apply(*a, method=jm.decode_step))(
        v, jnp.asarray(tok), jc, jnp.asarray(pos), jnp.asarray(step_seg))
    tc = KVCache.create(llm.num_layers, B, M, llm.num_kv_heads,
                        llm.head_dim, torch.float32)
    with torch.no_grad():
        tl0, _, tc = tm.prefill(torch.as_tensor(ids, dtype=torch.int64),
                                None, torch.as_tensor(seg), tc)
        tc.length = torch.as_tensor(fill)
        got, _, tc = tm.decode_step(torch.as_tensor(tok, dtype=torch.int64),
                                    tc, torch.as_tensor(pos),
                                    torch.as_tensor(step_seg))
    valid = seg.astype(bool)
    np.testing.assert_allclose(tl0.numpy()[valid], np.asarray(jl0)[valid],
                               atol=FP32_TOL, rtol=FP32_TOL)
    live = alive.astype(bool)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_array_equal(tc.seg.numpy(), np.asarray(jc.seg))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=FP32_TOL,
                               rtol=FP32_TOL)


def test_cached_decode_equals_the_full_forward(qwen3):
    """prefill + per-token decode == one uncached forward (the JAX test
    tests/test_qwen2.py::test_qwen3_cached_decode_matches_full, on the
    port)."""
    cfg, _, _, tm, _, _ = qwen3
    llm, lm = cfg.llm, tm.language_model
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        1, llm.vocab_size, (2, 10)))
    with torch.no_grad():
        full, _, _ = lm(input_ids=ids)
        cache = KVCache.create(llm.num_layers, 2, 16, llm.num_kv_heads,
                               llm.head_dim, torch.float32)
        pre, _, cache = lm(input_ids=ids[:, :6], cache=cache)
        steps = [pre]
        for t in range(6, 10):
            lg, _, cache = lm(input_ids=ids[:, t:t + 1], cache=cache)
            steps.append(lg)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mode", ["w8a8", "int8"])
def test_serving_tree_keeps_the_qk_norms_float(qwen3, mode):
    """quantize_for_serving quantizes the q/k/v kernels and leaves the
    per-head norms float: the whole tree bit-equal to the JAX package's."""
    cfg, _, v, _, _, _ = qwen3
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jax_quantize(
        v, target="vlm", mode=mode, min_size=1)))
    tm = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables(jax.tree_util.tree_map(np.asarray, v)))
    quantize_for_serving(tm, target="vlm", mode=mode, min_size=1)
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    key = "language_model.model.layers.self_attn.q_norm.weight"
    assert got[key].dtype == torch.float32
    assert "language_model.model.layers.self_attn.q_proj.kernel_q" in got
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_chat_never_takes_the_fused_runner(qwen3, monkeypatch):
    """A quantized qk-norm LLM: "auto" routes to the plain generator (also
    on a CUDA-looking device), use_fused=True raises ValueError naming the
    norm, the fused runner raises; all from the config, before any call."""
    cfg = qwen3[0]
    tm = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu")
    quantize_for_serving(tm, min_size=1)
    chat = VlaserChat(tm, ToyTok(), max_new_tokens=4)
    assert chat.route == "plain" and chat._fused_gen is None
    with monkeypatch.context() as m:  # "auto" routes a Qwen2 model there
        m.setattr(InternVLChatModel, "device",
                  property(lambda self: torch.device("cuda")))
        gen = torch.Generator
        m.setattr(torch, "Generator", lambda device=None: gen())
        chat = VlaserChat(tm, ToyTok(), max_new_tokens=4, use_fused="auto")
    assert chat.route == "plain" and chat._fused_gen is None
    with pytest.raises(ValueError, match="q/k RMSNorm"):
        VlaserChat(tm, ToyTok(), max_new_tokens=4, use_fused=True)
    with pytest.raises(NotImplementedError, match="qk_norm"):
        fused_runner.make_fused_generate_fn(tm, max_new_tokens=4,
                                            eos_token_ids=[3],
                                            pad_token_id=0)
    # a Qwen2 model of the same shapes does take it
    q2 = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, qk_norm=False))
    tm2 = InternVLChatModel(q2, compute_dtype=torch.float32, device="cpu")
    quantize_for_serving(tm2, min_size=1)
    assert VlaserChat(tm2, ToyTok(), max_new_tokens=4,
                      use_fused=True).route == "fused"


def test_engine_chat_streams_equal_jax_and_the_plain_generator(qwen3):
    """EngineChat over the qk-norm model (per-row offsets, the per-row
    decode): its greedy answers equal JAX's EngineChat and the port's plain
    VlaserChat on each item."""
    from vlaser_tpu.serve.engine_chat import EngineChat as JaxChat
    from vlaser_tpu_torch.serve.engine_chat import EngineChat

    cfg, jm, v, tm, _, _ = qwen3
    rng = np.random.default_rng(53)
    img = cfg.vision.image_size
    px = rng.standard_normal((2, img, img, 3)).astype(np.float32)
    kw = dict(max_new_tokens=5, num_slots=3, max_len=256,
              prefill_buckets=(128, 192), tile_buckets=(1, 2))
    jc = JaxChat(jm, v, ToyTok(), cache_dtype=jnp.float32, **kw)
    pc = EngineChat(tm, ToyTok(), cache_dtype=torch.float32, **kw)
    items = [("left or right?", px[:1], None), ("count", None, None),
             ("what is here?", px[1:], None)]
    got = pc.chat_many(items)
    assert got == jc.chat_many(items)
    plain = VlaserChat(tm, ToyTok(), max_new_tokens=5,
                       cache_dtype=torch.float32)
    assert plain.route == "plain"
    assert got == [plain.chat(q, p) for q, p, _ in items]


def test_jax_fused_decode_drops_the_qk_norms():
    """The reference's fault (ROADMAP queue 3): vlaser_tpu's
    pack_qwen2_stack never reads q_norm / k_norm, yet its VlaserChat sends
    any quantized LLM to the fused runner. Its fused decode step (Pallas in
    interpret mode) on a weight-only int8 Qwen3 tree, teacher-forced on the
    plain greedy stream from the model's prefilled cache: within FUSED_REL
    of the plain decode step of the same weights with the q/k norms taken
    out (over the same cache), and far from the model's own plain decode
    step (bf16 compute)."""
    cfg = tconfig.tiny_qwen3_vlm()
    jm, v, _, _, _ = vlm_pair(cfg, compute="bfloat16", seed=7)
    v = jax_quantize(v, target="vlm", mode="int8", min_size=1)
    bare_cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, qk_norm=False))
    bare = JaxModel(jax_cfg(bare_cfg), compute_dtype=jnp.bfloat16,
                    attn_impl="reference")
    attn = v["params"]["language_model"]["model"]["layers"]["self_attn"]
    vb = jax.tree_util.tree_map(lambda a: a, v)  # a copy to cut the norms
    vb["params"]["language_model"]["model"]["layers"]["self_attn"] = {
        k: a for k, a in attn.items() if k not in ("q_norm", "k_norm")}
    llm = cfg.llm
    ids = np.random.default_rng(7).integers(1, 400, (1, 12))  # text only
    n, new = ids.shape[1], 3
    cache = JKVCache.create(llm.num_layers, 1, n + new, llm.num_kv_heads,
                            llm.head_dim, dtype=jnp.bfloat16)
    step = lambda m: jax.jit(lambda w, t, c, p: m.apply(
        w, t[:, None], c, p[:, None], method=m.decode_step))
    lp, _, cp = jax.jit(lambda w, c: jm.apply(
        w, jnp.asarray(ids), None, jnp.ones(ids.shape, jnp.int32), c,
        method=jm.prefill))(v, cache)
    cf = cb = cp  # the fused runner decodes over the model's own prefill
    stack = jfr.pack_qwen2_stack(v)
    q = v["quant"]["language_model"]
    head = ("tied", q["embed_tokens"]["embedding_q"],
            q["embed_tokens"]["embedding_scale"])
    plain_step, bare_step = step(jm), step(bare)
    token = jnp.argmax(lp[0, -1])[None].astype(jnp.int32)
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    d_model = d_bare = 0.0
    for t in range(new):
        pos = jnp.asarray([n + t], jnp.int32)
        want, _, cp = plain_step(v, token, cp, pos)
        nob, _, cb = bare_step(vb, token, cb, pos)
        got, cf = jfr.fused_decode_step(stack, q["embed_tokens"], head, llm,
                                        token, cf, pos)
        want, nob, got = (np.asarray(a, np.float32).reshape(-1)
                          for a in (want, nob, got))
        d_model, d_bare = max(d_model, rel(got, want)), max(d_bare,
                                                             rel(got, nob))
        token = jnp.asarray([want.argmax()], jnp.int32)
    print(f"JAX fused decode, teacher-forced, max |diff| / max |logits|: vs "
          f"the qk-norm model's plain decode {d_model:.3e}, vs the same "
          f"weights without the q/k norms {d_bare:.3e}")
    assert d_bare <= FUSED_REL < 5 * FUSED_REL < d_model
