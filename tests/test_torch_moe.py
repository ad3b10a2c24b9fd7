"""Qwen3-MoE (models/moe.py: the sparse MLP of InternVL3.5-30B-A3B) and
Phi3 longrope in the port, against the JAX package and HF transformers,
at the port's tiny MoE configs (core/config.tiny_qwen3_moe_*: 8 experts,
top-2, 16 wide), the same numpy-drawn weights loaded through
utils/convert.from_jax_variables:
- the LLM's logits against JAX at capacity None, 1.25 and 0.5, and against
  HF Qwen3MoeForCausalLM through the port's HF converter (lossless);
- one MoE layer at a binding capacity against JAX and an independent
  per-slot oracle; a generous capacity equals the lossless one;
- router_aux_loss against HF load_balancing_loss_func and JAX's sown
  vectors; make_sft_loss with and without the aux term against JAX, with
  and without remat; SFTTrainer(moe_aux_coef) takes a step;
- cached decode against the full forward; EngineChat's greedy streams
  against JAX's and the plain generator's (lossless); the chat routes;
- quantize_for_serving leaves the experts and the router float, the tree
  bit-equal to JAX's in both modes;
- the whole InternVL3.5-30B-A3B parameter tree on the `meta` device
  against jax.eval_shape of the JAX model, name by name;
- Phi3 longrope against JAX and HF Phi3 (short and long contexts);
- the reference's capacity fault: at a factor of 1.25 the JAX model's
  logits depend on how a prompt is chunked, and leave HF's (ROADMAP
  queue 3).

Tolerances: fp32 (`highest` matmul precision, conftest): 1e-5 against JAX,
2e-4 against HF (the JAX tests' own), 3e-4 for Phi3 (tests/test_qwen2.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.quant import quantize_for_serving as jax_quantize
from vlaser_tpu.inference.kv_cache import KVCache as JKVCache
from vlaser_tpu.models.moe import MoEMLP as JMoE
from vlaser_tpu.models.qwen2 import Qwen2ForCausalLM as JQwen2
from vlaser_tpu_torch.core import config as tconfig
from vlaser_tpu_torch.core.quant import quantize_for_serving
from vlaser_tpu_torch.inference.chat import VlaserChat
from vlaser_tpu_torch.inference.kv_cache import KVCache
from vlaser_tpu_torch.models import moe
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.models.qwen2 import Qwen2ForCausalLM
from vlaser_tpu_torch.models.vlm import InternVLChatModel
from vlaser_tpu_torch.utils.convert import from_jax_variables

from test_chat_and_configs import ToyTok
from test_torch_qwen3 import draw_variables, jax_cfg, vlm_pair

FP32_TOL = 1e-5
HF_TOL = 2e-4


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


def llm_pair(capacity, seed=0, ids_shape=(2, 16)):
    """-> (cfg, jax model, its variables, the port LLM, ids)."""
    cfg = tconfig.tiny_qwen3_moe_llm(capacity)
    jm = JQwen2(jax_cfg(cfg), compute_dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, ids_shape)
    v = draw_variables(lambda: jm.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(ids)), rng)
    tm = Qwen2ForCausalLM(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables(_np_tree(v)))
    return cfg, jm, v, tm, ids


def _jax_logits(jm, v, ids):
    return np.asarray(jax.jit(lambda w, i: jm.apply(
        w, i, attn_impl="reference")[0])(v, jnp.asarray(ids)))


def _hf_moe(seed=0):
    """HF Qwen3MoeForCausalLM at tiny_qwen3_moe_llm's shapes (the JAX
    test's _hf_model), norms 1 + N(0, 0.1^2)."""
    from transformers import Qwen3MoeConfig, Qwen3MoeForCausalLM

    cfg = tconfig.tiny_qwen3_moe_llm(None)
    torch.manual_seed(seed)
    hf_cfg = Qwen3MoeConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        moe_intermediate_size=cfg.moe_intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        num_experts=cfg.num_experts,
        num_experts_per_tok=cfg.num_experts_per_tok, decoder_sparse_step=1,
        mlp_only_layers=[], norm_topk_prob=True, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_norm_eps, attention_bias=False,
        tie_word_embeddings=False, attn_implementation="eager")
    hf = Qwen3MoeForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    return hf, hf_cfg


@pytest.fixture(scope="module")
def hf_moe():
    from vlaser_tpu_torch.utils.hf_convert import convert_qwen2

    hf, hf_cfg = _hf_moe()
    params = convert_qwen2(hf.state_dict(), hf_cfg.num_hidden_layers)
    ids = np.random.default_rng(3).integers(1, hf_cfg.vocab_size, (2, 16))
    with torch.no_grad():
        out = hf(torch.from_numpy(ids), output_router_logits=True)
    return hf_cfg, params, ids, out


def test_tiny_configs_and_the_30b_config():
    a, b = tconfig.tiny_qwen3_moe_llm(), tconfig.tiny_qwen3_moe_llm(None)
    assert (a.num_experts, a.num_experts_per_tok, a.hidden_size,
            a.moe_intermediate_size, a.num_layers) == (8, 2, 32, 16, 2)
    assert a.qk_norm and a.moe_capacity_factor == 1.25
    assert b.moe_capacity_factor is None
    from vlaser_tpu.core import config as jconfig

    for name in ("qwen3_moe_30b_a3b", "internvl3_5_30b_a3b"):
        assert dataclasses.asdict(getattr(tconfig, name)()) == (
            dataclasses.asdict(getattr(jconfig, name)())), name


@pytest.mark.parametrize("capacity", [None, 1.25, 0.5])
def test_logits_match_jax(capacity):
    """The MoE LLM's logits equal JAX's at capacity None (lossless), 1.25
    (the named config's) and 0.5 (most slots past C dropped)."""
    _, jm, v, tm, ids = llm_pair(capacity)
    with torch.no_grad():
        got = tm(input_ids=torch.from_numpy(ids))[0].numpy()
    np.testing.assert_allclose(got, _jax_logits(jm, v, ids), atol=FP32_TOL,
                               rtol=FP32_TOL)


def test_logits_match_hf_through_the_port_converter(hf_moe):
    """HF Qwen3MoeForCausalLM -> the port's hf_convert.convert_qwen2 (its
    Qwen3-MoE branch) -> from_jax_variables -> the port's LLM at capacity
    None: HF's logits within the JAX test's 2e-4; the MoE leaves cross bit
    for bit."""
    hf_cfg, params, ids, out = hf_moe
    tm = Qwen2ForCausalLM(tconfig.tiny_qwen3_moe_llm(None),
                          compute_dtype=torch.float32, device="cpu")
    state = from_jax_variables({"params": params})
    load_state(tm, state)
    mlp = params["model"]["layers"]["mlp"]
    assert sorted(mlp) == ["experts_down_proj", "experts_gate_proj",
                           "experts_up_proj", "gate"]
    for k, a in mlp.items():
        assert np.array_equal(
            getattr(tm.model.layers.mlp, k).detach().numpy(), a), k
    with torch.no_grad():
        got = tm(input_ids=torch.from_numpy(ids))[0]
    np.testing.assert_allclose(got.numpy(), out.logits.numpy(), atol=HF_TOL,
                               rtol=HF_TOL)


def test_router_aux_loss_matches_hf_and_jax(hf_moe):
    """collect_router_stats + router_aux_loss on the port == HF
    load_balancing_loss_func over the same weights, and == JAX's aux from
    its sown intermediates."""
    from transformers.models.qwen3_moe.modeling_qwen3_moe import (
        load_balancing_loss_func)

    from vlaser_tpu.models.moe import router_aux_loss as j_aux

    hf_cfg, params, ids, out = hf_moe
    cfg = tconfig.tiny_qwen3_moe_llm(None)
    tm = Qwen2ForCausalLM(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables({"params": params}))
    with torch.no_grad(), moe.collect_router_stats(tm) as stacks:
        tm(input_ids=torch.from_numpy(ids))
    (f, p), = stacks
    assert f.shape == p.shape == (cfg.num_layers, cfg.num_experts)
    got = float(moe.router_aux_loss(f, p))
    want = float(load_balancing_loss_func(
        out.router_logits, hf_cfg.num_experts, hf_cfg.num_experts_per_tok))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jm = JQwen2(jax_cfg(cfg), compute_dtype=jnp.float32)
    _, state = jm.apply({"params": params}, jnp.asarray(ids),
                        attn_impl="reference", mutable=["intermediates"])
    inter = state["intermediates"]["model"]["layers"]["mlp"]
    np.testing.assert_allclose(f.numpy(), np.asarray(inter["router_f"][0]),
                               atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(inter["router_p"][0]),
                               atol=1e-6)
    np.testing.assert_allclose(
        got, float(j_aux(inter["router_f"][0], inter["router_p"][0])),
        rtol=1e-6)
    # outside the block nothing records
    assert all(m.router_stats is None for m in tm.modules()
               if isinstance(m, moe.MoEMLP))


def _oracle(cfg, x, gate, wg, wu, wd):
    """One MoE layer, slot by slot in float64 (independent of moe.py's
    scatter): route each token, walk the slots in token-major order with a
    count per expert, keep a slot while its expert has fewer than C, and
    add weight x expert(x) for each kept slot. -> (y [T, H], dropped)."""
    x = x.reshape(-1, x.shape[-1]).astype(np.float64)
    T, E, k = x.shape[0], cfg.num_experts, cfg.num_experts_per_tok
    logits = x @ gate.astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = np.argsort(-probs, -1, kind="stable")[:, :k]
    C = moe.capacity(cfg, T)
    count, dropped = np.zeros(E, int), 0
    y = np.zeros_like(x)
    for t in range(T):
        w = probs[t, top[t]]
        if cfg.norm_topk_prob:
            w = w / w.sum()
        for j, e in enumerate(top[t]):
            if count[e] >= C:
                dropped += 1
                continue
            count[e] += 1
            g, u = x[t] @ wg[e], x[t] @ wu[e]
            y[t] += w[j] * ((g / (1 + np.exp(-g)) * u) @ wd[e])
    return y, dropped


@pytest.mark.parametrize("capacity", [0.5, None])
def test_one_layer_matches_jax_and_a_slot_by_slot_oracle(capacity):
    """MoEMLP's layer (moe_forward) on x [2, 16, 32]: at a binding capacity
    (0.5: C = 4 of an expected 4 slots an expert) some slots drop; the
    output and the router vectors equal the JAX MoEMLP's within fp32, and
    the float64 oracle's; a generous factor (8.0) equals the lossless one
    bit for bit."""
    cfg = tconfig.tiny_qwen3_moe_llm(capacity)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, cfg.hidden_size)).astype(np.float32)
    jmod = JMoE(jax_cfg(cfg), compute_dtype=jnp.float32)
    v = draw_variables(lambda: jmod.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)), rng)
    want, state = jmod.apply(v, jnp.asarray(x), mutable=["intermediates"])
    w = {k: np.array(a) for k, a in v["params"].items()}
    args = [torch.from_numpy(w[k]) for k in
            ("gate", "experts_gate_proj", "experts_up_proj",
             "experts_down_proj")]
    got, f, p = moe.moe_forward(cfg, torch.from_numpy(x), *args,
                                torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_TOL,
                               rtol=FP32_TOL)
    inter = state["intermediates"]
    np.testing.assert_allclose(f.numpy(), np.asarray(inter["router_f"][0]),
                               atol=1e-7)
    np.testing.assert_allclose(p.numpy(), np.asarray(inter["router_p"][0]),
                               atol=1e-7)
    ref, dropped = _oracle(cfg, x, *(w[k] for k in (
        "gate", "experts_gate_proj", "experts_up_proj", "experts_down_proj")))
    np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref,
                               atol=FP32_TOL, rtol=FP32_TOL)
    assert (dropped > 0) == (capacity is not None), dropped
    if capacity is None:
        roomy = dataclasses.replace(cfg, moe_capacity_factor=8.0)
        assert torch.equal(moe.moe_forward(roomy, torch.from_numpy(x), *args,
                                           torch.float32)[0], got)


def test_capacity_is_the_jax_rule():
    cfg = tconfig.tiny_qwen3_moe_llm(1.25)
    assert [moe.capacity(cfg, t) for t in (1, 3, 8, 16, 100)] == [
        1, 2, 2, 5, 31]
    big = tconfig.qwen3_moe_30b_a3b()
    assert moe.capacity(big, 1) == 1 and moe.capacity(big, 3506) == 273


@pytest.fixture(scope="module")
def vlm_none():
    cfg = tconfig.tiny_qwen3_moe_vlm(None)
    return (cfg,) + vlm_pair(cfg)


def _sft_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    B, S = 2, 12
    ids = rng.integers(1, 400, (B, S))
    ids[:, 1] = cfg.img_context_token_id
    labels = ids.copy()
    labels[:, :3] = -100
    img = cfg.vision.image_size
    return {
        "input_ids": ids, "labels": labels,
        "loss_weight": (labels != -100).astype(np.float32),
        "seg_ids": np.ones((B, S), np.int32),
        "pixel_values": rng.standard_normal((B, img, img, 3)).astype(
            np.float32),
        "image_flags": np.ones((B,), np.int32),
    }


def test_sft_loss_with_and_without_the_aux_term_matches_jax():
    """make_sft_loss(model) and make_sft_loss(model, moe_aux_coef=0.1) on
    the tiny MoE VLM (capacity 1.25, one image token a row) equal the JAX
    losses; the aux term is coef x router_aux_loss of the one stack. With
    remat (each decoder layer under torch.utils.checkpoint) the loss and
    every gradient are the same."""
    from vlaser_tpu.train.losses import make_sft_loss as j_loss
    from vlaser_tpu_torch.train.losses import make_sft_loss

    cfg = tconfig.tiny_qwen3_moe_vlm(1.25)
    cfg = dataclasses.replace(cfg, max_dynamic_patch=1)
    jm, v, tm, _, _ = vlm_pair(cfg, seed=3)
    batch = _sft_batch(cfg)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    for coef in (0.0, 0.1):
        want = float(jax.jit(lambda w, b: j_loss(jm, moe_aux_coef=coef)(
            w, b, None))(v, jb))
        with torch.no_grad():
            got = float(make_sft_loss(tm, moe_aux_coef=coef)(tb))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    grads = []
    for remat in (False, True):
        m = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu",
                              remat=remat)
        load_state(m, dict(tm.state_dict()))
        loss = make_sft_loss(m, moe_aux_coef=0.1)(tb)
        loss.backward()
        grads.append((loss.item(), {n: q.grad.clone()
                                    for n, q in m.named_parameters()}))
    (l0, g0), (l1, g1) = grads
    assert l0 == pytest.approx(l1, rel=1e-6)
    gate = "language_model.model.layers.mlp.gate"
    assert g0[gate].abs().max() > 0
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-6, rtol=1e-5)


def test_sft_trainer_takes_a_step_with_the_router_loss():
    from vlaser_tpu_torch.train.losses import make_sft_loss
    from vlaser_tpu_torch.train.trainer import SFTTrainer, TrainConfig

    cfg = dataclasses.replace(tconfig.tiny_qwen3_moe_vlm(1.25),
                              max_dynamic_patch=1)
    _, _, tm, _, _ = vlm_pair(cfg, seed=3)
    batch = _sft_batch(cfg, seed=1)
    with torch.no_grad():
        want = float(make_sft_loss(tm, moe_aux_coef=1e-3)(
            {k: torch.from_numpy(a) for k, a in batch.items()}))
    before = tm.language_model.model.layers.mlp.gate.detach().clone()
    tr = SFTTrainer(tm, TrainConfig(moe_aux_coef=1e-3, learning_rate=1e-3,
                                    total_steps=4, warmup_ratio=0.0))
    # the schedule's first step takes lr 0, so the second step's loss is
    # still the initial model's
    metrics = tr.train(iter([batch, batch]))
    assert tr.step == 2
    assert float(metrics["loss"]) == pytest.approx(want, rel=1e-5)
    assert not torch.equal(tm.language_model.model.layers.mlp.gate, before)


def test_cached_decode_equals_the_full_forward_when_lossless(vlm_none):
    """prefill + per-token decode == one uncached forward at capacity None
    (each call's T differs; lossless routing does not see it)."""
    cfg, _, _, tm, _, _ = vlm_none
    llm, lm = cfg.llm, tm.language_model
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        1, llm.vocab_size, (2, 10)))
    with torch.no_grad():
        full = lm(input_ids=ids)[0]
        cache = KVCache.create(llm.num_layers, 2, 16, llm.num_kv_heads,
                               llm.head_dim, torch.float32)
        pre, _, cache = lm(input_ids=ids[:, :6], cache=cache)
        steps = [pre]
        for t in range(6, 10):
            lg, _, cache = lm(input_ids=ids[:, t:t + 1], cache=cache)
            steps.append(lg)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=2e-5, rtol=2e-5)


def test_engine_chat_streams_equal_jax_and_the_plain_generator(vlm_none):
    """EngineChat over the MoE model at capacity None (the per-row decode
    routes T = the active rows): its greedy answers equal JAX's EngineChat
    and the port's plain VlaserChat on each item."""
    from vlaser_tpu.serve.engine_chat import EngineChat as JaxChat
    from vlaser_tpu_torch.serve.engine_chat import EngineChat

    cfg, jm, v, tm, _, _ = vlm_none
    rng = np.random.default_rng(53)
    img = cfg.vision.image_size
    px = rng.standard_normal((2, img, img, 3)).astype(np.float32)
    kw = dict(max_new_tokens=5, num_slots=3, max_len=256,
              prefill_buckets=(128, 192), tile_buckets=(1, 2))
    items = [("left or right?", px[:1], None), ("count", None, None),
             ("what is here?", px[1:], None)]
    got = EngineChat(tm, ToyTok(), cache_dtype=torch.float32,
                     **kw).chat_many(items)
    assert got == JaxChat(jm, v, ToyTok(), cache_dtype=jnp.float32,
                          **kw).chat_many(items)
    plain = VlaserChat(tm, ToyTok(), max_new_tokens=5,
                       cache_dtype=torch.float32)
    assert plain.route == "plain"
    assert got == [plain.chat(q, p) for q, p, _ in items]


@pytest.mark.parametrize("mode", ["w8a8", "int8"])
def test_serving_tree_keeps_the_experts_float(vlm_none, mode):
    """quantize_for_serving quantizes the attention kernels, the embedding
    and the head, and leaves the router and the experts float: the tree
    bit-equal to JAX's quantize_for_serving in both modes."""
    cfg, _, v, _, _, _ = vlm_none
    want = from_jax_variables(_np_tree(jax_quantize(
        v, target="vlm", mode=mode, min_size=1)))
    tm = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables(_np_tree(v)))
    quantize_for_serving(tm, target="vlm", mode=mode, min_size=1)
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for leaf in ("gate", "experts_gate_proj", "experts_down_proj"):
        assert got[f"language_model.model.layers.mlp.{leaf}"].dtype == (
            torch.float32)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_chat_never_takes_the_fused_runner(vlm_none):
    from vlaser_tpu_torch.inference import fused_runner

    cfg = vlm_none[0]
    tm = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu")
    quantize_for_serving(tm, min_size=1)
    assert VlaserChat(tm, ToyTok(), max_new_tokens=4).route == "plain"
    bare = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, qk_norm=False))  # MoE alone refuses too
    tb = InternVLChatModel(bare, compute_dtype=torch.float32, device="cpu")
    quantize_for_serving(tb, min_size=1)
    with pytest.raises(ValueError, match="num_experts"):
        VlaserChat(tb, ToyTok(), max_new_tokens=4, use_fused=True)
    with pytest.raises(NotImplementedError, match="num_experts"):
        fused_runner.make_fused_generate_fn(tb, max_new_tokens=4,
                                            eos_token_ids=[3],
                                            pad_token_id=0)


def test_30b_parameter_tree_on_meta_matches_jax_eval_shape():
    """InternVL3.5-30B-A3B built on the `meta` device (no memory): every
    parameter name, shape and the count equal jax.eval_shape of the JAX
    model's init (the patch conv HWIO there, OIHW here)."""
    from vlaser_tpu.models.vlm import InternVLChatModel as JaxModel

    cfg = tconfig.internvl3_5_30b_a3b()
    tm = InternVLChatModel(cfg, param_dtype=torch.bfloat16, device="meta")
    got = {n: tuple(p.shape) for n, p in tm.state_dict().items()}
    jm = JaxModel(jax_cfg(cfg), param_dtype=jnp.bfloat16)
    img = cfg.vision.image_size
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 300), jnp.int32),
        jnp.zeros((1, img, img, 3), jnp.float32), jnp.ones((1,), jnp.int32)))
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        name = ".".join(str(k.key) for k in path)
        shape = tuple(s.shape)
        if name.endswith("embeddings.patch_embedding.kernel"):
            name, shape = name[:-len("kernel")] + "weight", (
                shape[3], shape[2], shape[0], shape[1])
        want[name] = shape
    assert got == want
    n = sum(int(np.prod(s)) for s in got.values())
    assert 30.8e9 < n < 30.9e9, n
    mlp = "language_model.model.layers.mlp."
    assert got[mlp + "experts_gate_proj"] == (48, 128, 2048, 768)
    assert got[mlp + "gate"] == (48, 2048, 128)


def _phi3_pair():
    from transformers import Phi3Config, Phi3ForCausalLM

    from vlaser_tpu.core.config import LLMConfig
    from vlaser_tpu_torch.utils.hf_convert import convert_phi3

    H, HEADS, KV, L, D = 64, 4, 2, 2, 16
    short = [1.0 + 0.05 * i for i in range(D // 2)]
    long = [2.0 + 0.1 * i for i in range(D // 2)]
    torch.manual_seed(0)
    hf = Phi3ForCausalLM(Phi3Config(
        vocab_size=256, hidden_size=H, intermediate_size=128,
        num_hidden_layers=L, num_attention_heads=HEADS,
        num_key_value_heads=KV, rope_theta=10_000.0,
        max_position_embeddings=128, original_max_position_embeddings=32,
        rope_scaling={"type": "longrope", "short_factor": short,
                      "long_factor": long},
        tie_word_embeddings=False, attention_dropout=0.0, pad_token_id=0,
        attn_implementation="eager")).eval()
    cfg = LLMConfig(
        vocab_size=256, hidden_size=H, intermediate_size=128, num_layers=L,
        num_heads=HEADS, num_kv_heads=KV, head_dim=D, rope_theta=10_000.0,
        attention_bias=False, max_position_embeddings=128, rms_norm_eps=1e-5,
        rope_short_factor=tuple(short), rope_long_factor=tuple(long),
        original_max_position=32)
    return hf, cfg, convert_phi3(hf.state_dict(), L, HEADS, KV, D)


@pytest.mark.parametrize("n", [12, 48])
def test_phi3_longrope_matches_jax_and_hf(n):
    """Phi3 (fused qkv / gate_up split by the port's convert_phi3) with
    su/longrope scaling: within the original 32 positions (short factors)
    and past them (long factors and the amplitude), the port's logits equal
    JAX's within 1e-5 and HF transformers' Phi3 within 3e-4
    (tests/test_qwen2.py::test_phi3_backend_matches_hf's bound), and the
    rope tables equal JAX's ops.rope_cos_sin_su."""
    from vlaser_tpu.kernels import ops as jops
    from vlaser_tpu_torch.kernels import ops

    hf, cfg, params = _phi3_pair()
    ids = np.random.default_rng(1).integers(0, 256, (1, n))
    tm = Qwen2ForCausalLM(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables({"params": params}))
    with torch.no_grad():
        got = tm(input_ids=torch.from_numpy(ids))[0].numpy()
        want = hf(torch.from_numpy(ids), use_cache=False).logits.numpy()
    jm = JQwen2(cfg, compute_dtype=jnp.float32)
    np.testing.assert_allclose(got, _jax_logits(jm, {"params": params}, ids),
                               atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)
    pos = np.arange(n)[None]
    tabs = ops.rope_cos_sin_su(torch.from_numpy(pos), 16, 10_000.0,
                               cfg.rope_short_factor, cfg.rope_long_factor,
                               32, 128)
    jtabs = jops.rope_cos_sin_su(jnp.asarray(pos), 16, 10_000.0,
                                 cfg.rope_short_factor, cfg.rope_long_factor,
                                 32, 128)
    for a, b in zip(tabs, jtabs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def _chunked(jm, v, ids, cut, llm):
    """The JAX model's logits for ids when a prompt is prefilled in two
    calls (ids[:, :cut], then the rest over the cache)."""
    cache = JKVCache.create(llm.num_layers, ids.shape[0], ids.shape[1],
                            llm.num_kv_heads, llm.head_dim, jnp.float32)
    run = jax.jit(lambda w, i, c: jm.apply(w, input_ids=i, cache=c,
                                           attn_impl="reference"))
    a, _, cache = run(v, jnp.asarray(ids[:, :cut]), cache)
    b, _, _ = run(v, jnp.asarray(ids[:, cut:]), cache)
    return np.concatenate([np.asarray(a), np.asarray(b)], 1)


def test_the_reference_capacity_depends_on_the_chunking(hf_moe):
    """The reference's fault (ROADMAP queue 3): with the named config's
    capacity factor 1.25, C depends on the tokens of one call, so the JAX
    model's logits for a prompt prefilled in two chunks of 8 differ from
    its full forward over the 16, and both from HF Qwen3-MoE, which drops
    nothing. At capacity None all three agree. The port copies the JAX
    rule: its chunked logits equal the JAX chunked ones."""
    hf_cfg, params, ids, out = hf_moe
    ids = ids[:1]
    v = {"params": params}
    hf_logits = out.logits.numpy()[:1]
    res = {}
    for cap in (None, 1.25):
        cfg = tconfig.tiny_qwen3_moe_llm(cap)
        jm = JQwen2(jax_cfg(cfg), compute_dtype=jnp.float32)
        full, chunk = _jax_logits(jm, v, ids), _chunked(jm, v, ids, 8, cfg)
        res[cap] = (np.abs(full - chunk).max(), np.abs(full - hf_logits).max())
        tm = Qwen2ForCausalLM(cfg, compute_dtype=torch.float32, device="cpu")
        load_state(tm, from_jax_variables(v))
        cache = KVCache.create(cfg.num_layers, 1, 16, cfg.num_kv_heads,
                               cfg.head_dim, torch.float32)
        with torch.no_grad():
            a, _, cache = tm(input_ids=torch.from_numpy(ids[:, :8]),
                             cache=cache)
            b = tm(input_ids=torch.from_numpy(ids[:, 8:]), cache=cache)[0]
        np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), chunk,
                                   atol=FP32_TOL, rtol=FP32_TOL)
    assert res[None][0] < FP32_TOL and res[None][1] < HF_TOL, res
    # at 1.25 the chunking moves the logits by far more than fp32 noise
    assert res[1.25][0] > 1e-3 and res[1.25][1] > 1e-3, res
    print(f"capacity 1.25: JAX full vs 2 chunks {res[1.25][0]:.4e}, "
          f"vs HF {res[1.25][1]:.4e}; capacity None: {res[None][0]:.2e}, "
          f"{res[None][1]:.2e}")
