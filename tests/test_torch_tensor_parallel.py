"""Tensor and expert parallelism for serving in the port
(core/tensor_parallel.py, the tensor-parallel Dense / Embed / MoE of
models/, PolicyServer(mesh=), ContinuousBatchingEngine(mesh=)) against
the JAX package's oracles on the CPU, every multi-rank case on the 8 gloo
ranks of ONE spawn (tests/torch_ranks.py), from the same numpy-drawn
inputs and converted JAX variables:

- the quantized tiny VLA's infer_action at (data 1, fsdp 2, tensor 4)
  against JAX's one-device infer_action within 2e-5
  (tests/test_tp_serving.py), its leaves really cut;
- PolicyServer(fused=True, mesh) takes the plain path ("plain", a logged
  warning) and its step equals the JAX server's plain step (atol 1e-4,
  the one-device step test's bound);
- the engine at (1, 2, 4) token-identical to the JAX engine on the mixed
  requests and on prefix-cached tails (tests/test_engine_tp.py); at
  tensor 8 its parameters are cut and its KV cache keeps whole heads;
- every rank's completions equal, sampled requests included;
- MoE expert parallelism at (2, 2, 2) against JAX's logits within 2e-5 /
  2e-4, lossless and at a binding capacity
  (test_moe.py::test_moe_expert_parallel_matches_single_device);
- a row-parallel w8a8 input's int8 codes bit-equal to one device's (plain
  rows and the silu-mul rows), and the row-parallel Dense's product;
- the attention rules: the tiny 8B's 7 / 1 heads at tensor 2 stay whole,
  4 / 2 heads at tensor 4 take one KV head a rank; both LLMs' logits
  against JAX within 1e-5.

Cases that need no process group (per-rank shapes, the strided qkv, the
rules' dims, utils/convert.tensor_shards, the bytes a rank against
utils/memory_budget) run in the pytest process.
"""

import dataclasses
import logging
import os
import pickle

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

N_RANKS = 8
EOS = [3]
TP_TOL = 2e-5


# -- the ranks ------------------------------------------------------------------

def _count_cut(model, whole):
    """Leaves whose shape differs from the whole model's."""
    shapes = {n: tuple(t.shape) for n, t in whole}
    return sum(1 for n, t in list(model.named_parameters())
               + list(model.named_buffers())
               if n in shapes and tuple(t.shape) != shapes[n])


def _vla_cases(d, mesh):
    from vlaser_tpu_torch.core.tensor_parallel import shard_for_serving
    from vlaser_tpu_torch.envs.adapters import BridgeSimplerAdapter
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.policy.processing import InternVLAProcessor
    from vlaser_tpu_torch.serve.policy_server import PolicyServer

    cfg = d["vla_cfg"]
    mk = lambda: PiZeroVLA(cfg, compute_dtype=torch.float32,
                           attn_impl="reference", device="cpu")
    whole = load_state(mk(), d["vla_state"])
    model = shard_for_serving(load_state(mk(), d["vla_state"]), mesh)
    out = {"vla_cut": _count_cut(model, list(whole.named_parameters())
                                 + list(whole.named_buffers()))}
    args = [torch.as_tensor(d["vla_args"][k]) for k in (
        "input_ids", "pixel_values", "text_mask", "proprios", "noise")]
    out["infer_action"] = model.infer_action(*args).numpy()

    img = cfg.vlm.vision.image_size
    proc = InternVLAProcessor(_TinyTok(),
                              num_image_tokens=cfg.vlm.num_image_token,
                              max_seq_len=cfg.max_image_text_tokens,
                              pad_token_id=0)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("vlaser_tpu_torch.serve.policy_server")
    log.addHandler(handler)
    try:
        server = PolicyServer(
            mk(), d["vla_state"], BridgeSimplerAdapter(
                dataset_statistics=STATS, image_size=(img, img)), proc,
            act_steps=4, seed=3, fused=True, device="cpu", mesh=mesh)
    finally:
        log.removeHandler(handler)
    noise = d["server_noise"]
    server.draw_noise = lambda: torch.from_numpy(noise.copy())
    server.reset("pick the cube")
    out["server"] = server.step(d["obs"], d["frame"])
    out["server_path"] = server.serving_path
    out["server_warned"] = any("single-device" in r.getMessage()
                               for r in records)
    return out


def _engine(model, mesh, **kw):
    from vlaser_tpu_torch.serve.engine import ContinuousBatchingEngine

    base = dict(num_slots=3, max_len=64, eos_token_ids=EOS, pad_token_id=0,
                prefill_buckets=(16, 32), cache_dtype=torch.float32,
                chunk_size=4, mesh=mesh)
    base.update(kw)
    return ContinuousBatchingEngine(model, **base)


def _engine_cases(d, mesh, mesh8):
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.serve.engine import Request

    mk = lambda: load_state(InternVLChatModel(
        d["vlm_cfg"], compute_dtype=torch.float32, attn_impl="reference",
        device="cpu"), d["vlm_state"])
    model = mk()
    eng = _engine(model, mesh)
    out = {"mixed": {c.uid: c.token_ids for c in eng.run(d["mixed"])}}
    sampled = [Request(uid=10 + i, input_ids=r.input_ids, max_new_tokens=6,
                       temperature=0.8, top_k=20, seed=7 + i)
               for i, r in enumerate(d["mixed"][:3])]
    out["sampled"] = {c.uid: c.token_ids for c in eng.run(sampled)}
    peng = _engine(model, mesh, num_slots=2, prefill_buckets=(8, 32),
                   chunk_size=64)
    pid = peng.register_prefix(d["prefix_ids"], d["prefix_px"])
    out["prefix"] = {c.uid: c.token_ids for c in peng.run([
        Request(uid=i, input_ids=t, prefix_id=pid, max_new_tokens=4)
        for i, t in enumerate(d["tails"])])}
    whole = mk()
    m8 = mk()
    e8 = _engine(m8, mesh8, num_slots=2, prefill_buckets=(16,))
    out["tp8_cut"] = _count_cut(m8, list(whole.named_parameters()))
    out["tp8_cache_heads"] = e8.cache.k.shape[3]
    return out


def _moe_cases(d, mesh):
    from vlaser_tpu_torch.core.tensor_parallel import shard_for_serving
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.models.qwen2 import Qwen2ForCausalLM

    out = {}
    for key, (cfg, state, ids) in d["moe"].items():
        m = shard_for_serving(load_state(Qwen2ForCausalLM(
            cfg, compute_dtype=torch.float32, device="cpu"), state), mesh)
        with torch.no_grad():
            out[key] = m(torch.as_tensor(ids), attn_impl="reference")[0]
        out[f"{key}_experts"] = m.model.layers.mlp.experts_gate_proj.shape[1]
    return out


def _row_quant_cases(d, mesh):
    from vlaser_tpu_torch.core import tensor_parallel as tpl
    from vlaser_tpu_torch.kernels import w8a8
    from vlaser_tpu_torch.models.layers import Dense, row_quantize

    group, size, rank = tpl.tensor_group(mesh)
    x, g, u = (torch.as_tensor(d["rowq"][k]).to(torch.bfloat16)
               for k in ("x", "g", "u"))
    c = x.shape[1] // size
    cols = slice(rank * c, (rank + 1) * c)
    split = tpl.TensorSplit("row", size, rank, group)
    out = {}
    q, am = row_quantize(x[:, cols].contiguous(), split)
    wq, wam = w8a8.quantize_rows(x)
    out["rows_equal"] = bool(torch.equal(q, wq[:, cols])
                             and torch.equal(am, wam))
    local = w8a8.quantize_rows(x[:, cols].contiguous())[0]
    out["local_differs"] = not torch.equal(local, wq[:, cols])
    q, am = row_quantize(g[:, cols].contiguous(), split,
                         u[:, cols].contiguous())
    wq, wam = w8a8.quantize_silu_mul(g, u)
    out["silu_equal"] = bool(torch.equal(q, wq[:, cols])
                             and torch.equal(am, wam))
    # a w8a8 Dense cut row-parallel: its product against the whole one
    state = d["rowq"]["dense"]

    def dense(rows):
        m = Dense(x.shape[1], 64, True, (), torch.float32, torch.bfloat16,
                  "cpu")
        del m._parameters["kernel"]
        m.register_buffer("kernel_q", state["kernel_q"][rows].clone())
        for k in ("kernel_scale", "kernel_aq"):
            m.register_buffer(k, state[k].clone())
        m.bias.data.copy_(state["bias"])
        return m

    local = dense(cols)
    local.tp = split
    with torch.no_grad():
        want = dense(slice(None))(x).float()
        got = local(x[:, cols].contiguous()).float()
    out["dense_err"] = float((got - want).abs().max() / want.abs().max())
    return out


def _degrade_cases(d):
    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core.tensor_parallel import shard_for_serving
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.models.qwen2 import Qwen2ForCausalLM

    out = {}
    for key, (cfg, state, ids, tp) in d["degrade"].items():
        mesh = mesh_lib.make_mesh(dp=-1, fsdp=1, tp=tp)
        m = shard_for_serving(load_state(Qwen2ForCausalLM(
            cfg, compute_dtype=torch.float32, device="cpu"), state), mesh)
        att = m.model.layers.self_attn
        with torch.no_grad():
            out[key] = m(torch.as_tensor(ids), attn_impl="reference")[0]
        out[f"{key}_heads"] = (att.heads, att.kv_heads)
    return out


def _rank_main(rank, work):
    from vlaser_tpu_torch.core import mesh as mesh_lib

    with open(os.path.join(work, "in.pkl"), "rb") as f:
        d = pickle.load(f)
    mesh = mesh_lib.make_mesh(dp=1, fsdp=2, tp=4)
    res = _vla_cases(d, mesh)
    res.update(_engine_cases(d, mesh, mesh_lib.make_mesh(dp=1, fsdp=1,
                                                         tp=8)))
    res.update(_moe_cases(d, mesh_lib.make_mesh(dp=2, fsdp=2, tp=2)))
    res.update(_row_quant_cases(d, mesh_lib.make_mesh(dp=2, fsdp=1, tp=4)))
    res.update(_degrade_cases(d))
    with open(os.path.join(work, f"out.{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


class _TinyTok:
    pad_token_id = 0

    def __call__(self, text, add_special_tokens=False, **kw):
        ids, i = [], 0
        while i < len(text):
            for tok, tid in (("<IMG_CONTEXT>", 500), ("<img>", 498),
                             ("</img>", 499)):
                if text.startswith(tok, i):
                    ids.append(tid)
                    i += len(tok)
                    break
            else:
                ids.append(ord(text[i]) % 490)
                i += 1
        return {"input_ids": ids}


STATS = {
    "action": {"p01": [-0.02] * 6 + [0.0], "p99": [0.02] * 6 + [1.0],
               "mean": [0.0] * 7, "std": [0.01] * 7},
    "proprio": {"p01": [-0.5] * 6 + [0.0], "p99": [0.5] * 6 + [1.0],
                "mean": [0.0] * 7, "std": [0.2] * 7},
}


# -- the oracles and the spawn --------------------------------------------------

def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _vla_oracles(d, want):
    """The quantized tiny VLA (the JAX server test's): JAX's infer_action
    on random inputs and its plain PolicyServer step."""
    import jax
    import jax.numpy as jnp

    from vlaser_tpu.core.config import tiny_vla as jtiny_vla
    from vlaser_tpu.core.quant import POLICY_PATTERNS, quantize_variables
    from vlaser_tpu.envs.adapters import BridgeSimplerAdapter
    from vlaser_tpu.policy.pizero import PiZeroVLA
    from vlaser_tpu.policy.processing import InternVLAProcessor
    from vlaser_tpu.serve.policy_server import PolicyServer
    from vlaser_tpu_torch.core.config import tiny_vla
    from vlaser_tpu_torch.utils.convert import from_jax_variables

    jcfg = jtiny_vla(max_image_text_tokens=32)
    jm = PiZeroVLA(jcfg, compute_dtype=jnp.float32, attn_impl="reference")
    B, S = 1, jcfg.max_image_text_tokens
    img = jcfg.vlm.vision.image_size
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 400, (B, S)).astype(np.int32)
    ids[:, 2] = jcfg.vlm.img_context_token_id
    args = dict(
        input_ids=ids,
        pixel_values=rng.standard_normal((B, img, img, 3)).astype(np.float32),
        text_mask=np.ones((B, S), np.int32),
        proprios=rng.standard_normal(
            (B, jcfg.cond_steps, jcfg.proprio_dim)).astype(np.float32),
        noise=rng.standard_normal((B, jcfg.num_action_tokens,
                                   jcfg.action_dim)).astype(np.float32))
    A = jnp.zeros((B, jcfg.num_action_tokens, jcfg.action_dim))
    variables = jm.init(jax.random.PRNGKey(0), *(jnp.asarray(args[k]) for k in
                        ("input_ids", "pixel_values", "text_mask",
                         "proprios")), A, jnp.zeros((B,)), A)
    qvars = quantize_variables(variables, POLICY_PATTERNS)
    want["infer_action"] = np.asarray(jm.apply(
        qvars, *(jnp.asarray(args[k]) for k in (
            "input_ids", "pixel_values", "text_mask", "proprios", "noise")),
        method=jm.infer_action))
    d["vla_cfg"] = tiny_vla(max_image_text_tokens=32)
    d["vla_state"] = from_jax_variables(_np(qvars))
    d["vla_args"] = args

    proc = InternVLAProcessor(_TinyTok(),
                              num_image_tokens=jcfg.vlm.num_image_token,
                              max_seq_len=S, pad_token_id=0)
    d["obs"] = {"agent": {"eef_pos": np.array(
        [0.1, 0.0, 0.2, 1, 0, 0, 0, 0.5], np.float32)}}
    d["frame"] = np.random.default_rng(1).integers(0, 255, (img, img, 3),
                                                   dtype=np.uint8)
    jserver = PolicyServer(jm, qvars, BridgeSimplerAdapter(
        dataset_statistics=STATS, image_size=(img, img)), proc, act_steps=4,
        seed=3)
    jserver.reset("pick the cube")
    want["server"] = jserver.step(d["obs"], d["frame"])
    _, sub = jax.random.split(jax.random.PRNGKey(3))
    d["server_noise"] = np.asarray(jax.random.normal(
        sub, (1, jcfg.num_action_tokens, jcfg.action_dim), jnp.float32))


def _engine_oracles(d, want):
    """The JAX engine on test_engine_tp.py's model, requests and prefix."""
    import jax
    import jax.numpy as jnp

    from test_engine_tp import _mixed_requests
    from vlaser_tpu.core.config import tiny_vlm as jtiny_vlm
    from vlaser_tpu.models.vlm import InternVLChatModel
    from vlaser_tpu.serve.engine import ContinuousBatchingEngine
    from vlaser_tpu.serve.engine import Request as JRequest
    from vlaser_tpu_torch.core.config import tiny_vlm
    from vlaser_tpu_torch.serve.engine import Request
    from vlaser_tpu_torch.utils.convert import from_jax_variables

    cfg = jtiny_vlm()
    jm = InternVLChatModel(cfg, compute_dtype=jnp.float32,
                           attn_impl="reference")
    rng = np.random.default_rng(0)
    npt = cfg.num_image_token
    ids = rng.integers(1, 400, (1, 8 + npt))
    ids[0, 2:2 + npt] = cfg.img_context_token_id
    px = rng.standard_normal((1, cfg.vision.image_size,
                              cfg.vision.image_size, 3)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                     jnp.asarray(px), jnp.asarray([1], np.int32))
    kw = dict(num_slots=3, max_len=64, eos_token_ids=EOS, pad_token_id=0,
              prefill_buckets=(16, 32), cache_dtype=jnp.float32,
              chunk_size=4)
    mixed = _mixed_requests(cfg, np.random.default_rng(5))
    want["mixed"] = {c.uid: c.token_ids for c in ContinuousBatchingEngine(
        jm, params, **kw).run(mixed)}
    d["mixed"] = [Request(uid=r.uid, input_ids=r.input_ids,
                          pixel_values=r.pixel_values,
                          max_new_tokens=r.max_new_tokens) for r in mixed]

    prng = np.random.default_rng(11)
    pfx = prng.integers(1, 400, (4 + npt,)).astype(np.int32)
    pfx[2:2 + npt] = cfg.img_context_token_id
    ppx = prng.standard_normal((1, cfg.vision.image_size,
                                cfg.vision.image_size, 3)).astype(np.float32)
    tails = [prng.integers(1, 400, (m,)).astype(np.int32) for m in (3, 6, 4)]
    kw.update(num_slots=2, prefill_buckets=(8, 32), chunk_size=64)
    eng = ContinuousBatchingEngine(jm, params, **kw)
    pid = eng.register_prefix(pfx, ppx)
    want["prefix"] = {c.uid: c.token_ids for c in eng.run([
        JRequest(uid=i, input_ids=t, prefix_id=pid, max_new_tokens=4)
        for i, t in enumerate(tails)])}
    d.update(vlm_cfg=tiny_vlm(), vlm_state=from_jax_variables(_np(params)),
             prefix_ids=pfx, prefix_px=ppx, tails=tails)


def _llm_oracle(cfg, seed, ids_shape):
    """-> (state, ids, JAX logits) of a port LLM config's JAX twin, its
    variables drawn from numpy."""
    import jax
    import jax.numpy as jnp

    from test_torch_qwen3 import draw_variables, jax_cfg
    from vlaser_tpu.models.qwen2 import Qwen2ForCausalLM
    from vlaser_tpu_torch.utils.convert import from_jax_variables

    jm = Qwen2ForCausalLM(jax_cfg(cfg), compute_dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, ids_shape)
    v = draw_variables(lambda: jm.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(ids)), rng)
    logits = np.asarray(jm.apply(v, jnp.asarray(ids),
                                 attn_impl="reference")[0])
    return from_jax_variables(_np(v)), ids, logits


def _row_inputs(d):
    from vlaser_tpu_torch.core.quant import quantize_int8

    rng = np.random.default_rng(4)
    M, K = 160, 256
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[:, 7] *= 9.0  # the rows' absmax in one rank's columns
    kq, ks = quantize_int8(torch.as_tensor(
        rng.standard_normal((K, 64)).astype(np.float32) * 0.05), -2)
    d["rowq"] = dict(
        x=x, g=rng.standard_normal((M, K)).astype(np.float32) * 2,
        u=rng.standard_normal((M, K)).astype(np.float32),
        dense=dict(kernel_q=kq, kernel_scale=ks,
                   kernel_aq=torch.zeros((1,), dtype=torch.int8),
                   bias=torch.as_tensor(rng.standard_normal(64).astype(
                       np.float32))))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The JAX oracles here, every multi-rank case in one 8-rank spawn: ->
    (oracles, inputs, [each rank's results])."""
    from vlaser_tpu_torch.core import config as tconfig

    d, want = {}, {}
    _vla_oracles(d, want)
    _engine_oracles(d, want)
    d["moe"] = {}
    for key, cap in (("moe_lossless", None), ("moe_capacity", 1.25)):
        cfg = tconfig.tiny_qwen3_moe_llm(cap)
        state, ids, want[key] = _llm_oracle(cfg, 0, (2, 16))
        d["moe"][key] = (cfg, state, ids)
    d["degrade"] = {}
    for key, cfg, tp in (("llm_8b_tp2", tconfig.tiny_llm_8b(), 2),
                         ("llm_tp4", tconfig.tiny_llm(), 4)):
        state, ids, want[key] = _llm_oracle(cfg, 1, (2, 12))
        d["degrade"][key] = (cfg, state, ids, tp)
    _row_inputs(d)
    work = str(tmp_path_factory.mktemp("tp_ranks"))
    with open(os.path.join(work, "in.pkl"), "wb") as f:
        pickle.dump(d, f)
    run_ranks(_rank_main, N_RANKS, work, work)
    outs = []
    for r in range(N_RANKS):
        with open(os.path.join(work, f"out.{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return want, d, outs


def test_tp_sharded_infer_action_matches_jax(spawned):
    want, _, outs = spawned
    assert outs[0]["vla_cut"] > 0, "the tensor layout cut no leaf"
    for out in outs:
        np.testing.assert_allclose(out["infer_action"], want["infer_action"],
                                   rtol=TP_TOL, atol=TP_TOL)


def test_policy_server_fused_on_mesh_takes_plain_and_matches(spawned):
    want, _, outs = spawned
    for out in outs:
        assert out["server_path"] == "plain" and out["server_warned"]
        assert out["server"].shape == want["server"].shape == (4, 7)
        np.testing.assert_allclose(out["server"], want["server"], atol=1e-4,
                                   rtol=0)


def test_tp_engine_token_identity(spawned):
    want, _, outs = spawned
    assert sorted(outs[0]["mixed"]) == sorted(want["mixed"])
    for uid, toks in want["mixed"].items():
        assert outs[0]["mixed"][uid] == toks, f"request {uid} diverged"


def test_tp_engine_prefix_cached_identity(spawned):
    want, _, outs = spawned
    assert outs[0]["prefix"] == want["prefix"]


def test_tp_engine_params_actually_cut(spawned):
    _, _, outs = spawned
    # tensor 8: the MLPs and the vocabulary split, the 4 / 2 heads do not
    assert outs[0]["tp8_cut"] > 0
    assert outs[0]["tp8_cache_heads"] == 2


def test_every_rank_completes_alike(spawned):
    _, _, outs = spawned
    for key in ("mixed", "sampled", "prefix"):
        assert all(o[key] == outs[0][key] for o in outs), key
    assert any(len(t) > 1 for t in outs[0]["sampled"].values())


@pytest.mark.parametrize("key", ["moe_lossless", "moe_capacity"])
def test_moe_expert_parallel_matches_jax(spawned, key):
    want, _, outs = spawned
    for out in outs:
        assert out[f"{key}_experts"] == 4  # 8 experts over tensor 2
        np.testing.assert_allclose(out[key].numpy(), want[key], atol=2e-5,
                                   rtol=2e-4)


def test_row_parallel_int8_codes_equal_one_device(spawned):
    _, _, outs = spawned
    for out in outs:
        assert out["rows_equal"] and out["silu_equal"]
        assert out["dense_err"] < 1e-2
    # the control: a rank's own absmax gives other codes
    assert any(o["local_differs"] for o in outs)


@pytest.mark.parametrize("key,heads", [("llm_8b_tp2", (7, 1)),
                                       ("llm_tp4", (1, 1))])
def test_attention_rules_match_jax(spawned, key, heads):
    want, _, outs = spawned
    for out in outs:
        assert out[f"{key}_heads"] == heads
        np.testing.assert_allclose(out[key].numpy(), want[key], atol=1e-5,
                                   rtol=1e-5)


# -- without a process group ----------------------------------------------------

def _meta_vla(tp, rank, quantized=False):
    from vlaser_tpu_torch.core.config import vlaser_2b_vla
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.core.tensor_parallel import shard_model
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA

    m = PiZeroVLA(vlaser_2b_vla(), device="meta")
    if quantized:
        quantize_for_serving(m, target="policy")
    return shard_model(m, tp, rank)


@pytest.mark.parametrize("tp", [2, 4])
def test_per_rank_shapes_at_vlaser_2b(tp):
    """Vlaser-2B-VLA's 12 / 2 heads: split at 2, one KV head a rank at 4;
    the vocabulary (151,930) splits at 2 only; the 16-head ViT splits."""
    m = _meta_vla(tp, 1, quantized=True)
    for mix in (m.joint.layers.vlm, m.joint.layers.expert):
        assert (mix.heads, mix.kv_heads) == (12 // tp, 1)
        assert mix.q_proj.kernel_q.shape[-1] == 12 // tp * 128
        assert mix.k_proj.kernel_q.shape[-1] == 128
        assert mix.o_proj.kernel_q.shape[-2] == 12 // tp * 128
        assert mix.mlp.down_proj.kernel_q.shape[-2] == 8960 // tp
        assert mix.q_proj.kernel_scale.shape[-1] == 12 // tp * 128
        # a row-parallel layer's per-column scales stay whole
        assert mix.o_proj.kernel_scale.shape == (
            28, 1, mix.o_proj.kernel_q.shape[-1])
    assert m.vision_model.encoder.attn.heads == 16 // tp
    assert m.vision_model.encoder.attn.qkv.kernel_q.shape[-1] == 3072 // tp
    assert m.vision_model.encoder.mlp.fc2.kernel_q.shape[-2] == 4096 // tp
    assert m.embed_tokens.embedding_q.shape[0] == (
        151930 // 2 if tp == 2 else 151930)
    assert (m.embed_tokens.tp is not None) == (tp == 2)
    assert m.mlp1.fc1.kernel.shape == (4096, 1536)  # the projector: whole


def test_kv_pick_and_strided_qkv_cover_the_heads():
    """Rank r's q heads read the KV head it holds; the ViT's strided qkv
    shard is each rank's heads' columns of q, k and v."""
    from vlaser_tpu_torch.core import tensor_parallel as tpl
    from vlaser_tpu_torch.core.config import tiny_vlm
    from vlaser_tpu_torch.models.vlm import InternVLChatModel

    for tp in (4, 8):
        qs = []
        for r in range(tp):
            q, kv = tpl.head_columns(r, tp, 8 if tp == 8 else 12, 2, 16,
                                     "pick")
            heads = 8 if tp == 8 else 12
            group = heads // 2
            assert {int(i) // 16 // group for i in q} == {int(kv[0]) // 16}
            qs.append(q)
        assert torch.equal(torch.cat(qs), torch.arange(qs[0].numel() * tp))
    vcfg = dataclasses.replace(tiny_vlm().vision, qk_normalization=False)
    cfg = dataclasses.replace(tiny_vlm(), vision=vcfg)
    whole = InternVLChatModel(cfg, device="cpu")
    torch.nn.init.normal_(whole.vision_model.encoder.attn.qkv.kernel)
    C, hd = vcfg.hidden_size, vcfg.head_dim
    for r in range(2):
        m = InternVLChatModel(cfg, device="cpu")
        m.load_state_dict(whole.state_dict())
        tpl.shard_model(m, 2, r)
        got = m.vision_model.encoder.attn.qkv.kernel
        full = whole.vision_model.encoder.attn.qkv.kernel
        h = C // 2
        for j in range(3):
            assert torch.equal(got[..., j * h:(j + 1) * h],
                               full[..., j * C + r * h:j * C + (r + 1) * h])
        assert m.vision_model.encoder.attn.heads == vcfg.num_heads // 2
        assert m.vision_model.encoder.attn.qkv.kernel.shape[-1] == 3 * h
    assert hd * vcfg.num_heads == C


def test_cut_dims_are_the_rules_tensor_dims():
    """Every kernel the layout cuts is cut along the dim that
    core/mesh.default_param_rules gives the tensor axis."""
    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core.tensor_parallel import plan

    m = _meta_vla(1, 0)
    rules = mesh_lib.default_param_rules()
    p = plan(m, 2, 0)
    names = dict(m.named_parameters())
    checked = 0
    for key, (dim, _) in p.leaves.items():
        if key not in names or not key.endswith(("kernel", "embedding")):
            continue
        spec = mesh_lib.spec_for(mesh_lib.path_str(key), rules)
        assert spec[dim] == mesh_lib.TENSOR_AXIS, (key, spec, dim)
        checked += 1
    assert checked >= 19  # q k v o gate up down of 2 mixtures, ViT, embed


def test_tensor_shards_equal_a_cut_model():
    """utils/convert.tensor_shards of the JAX tree equals the state of the
    whole model cut by shard_model, leaf for leaf, on each rank."""
    from vlaser_tpu_torch.core.config import tiny_vla
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.core.tensor_parallel import shard_model
    from vlaser_tpu_torch.graft_entry import seeded_
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.utils.convert import tensor_shards

    cfg = tiny_vla()
    whole = quantize_for_serving(seeded_(PiZeroVLA(cfg, device="cpu"), 0),
                                 target="policy", min_size=1)
    tree = {"params": {}, "quant": {}}
    for name, t in whole.state_dict().items():
        col = ("quant" if name.rsplit(".", 1)[-1] in (
            "kernel_q", "kernel_scale", "kernel_aq", "embedding_q",
            "embedding_scale") else "params")
        if name.endswith("patch_embedding.weight"):
            name, t = name[:-len("weight")] + "kernel", t.permute(2, 3, 1, 0)
        node = tree[col]
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.numpy()
    for r in range(4):
        m = PiZeroVLA(cfg, device="cpu")
        quantize_for_serving(m, target="policy", min_size=1)
        m.load_state_dict(whole.state_dict())
        shard_model(m, 4, r)
        got = tensor_shards(tree, whole, 4, r)
        want = m.state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_bytes_against_memory_budget(tp):
    """A rank's parameter bytes at Vlaser-2B-VLA against
    utils/memory_budget's GSPMD layout at (1, 1, tp): equal on every leaf
    the port cuts as JAX does; more only where the port keeps whole heads
    (a KV head on several ranks) or a leaf GSPMD splits and the port keeps
    (the projector)."""
    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.utils import memory_budget as mb

    whole = _meta_vla(1, 0)
    m = _meta_vla(tp, 0)
    mesh = mb._abstract_mesh(1, 1, tp)
    rules = mesh_lib.default_param_rules(fsdp_only=False)
    local = dict(m.named_parameters())
    port = 0
    for path, shape, dtype in mb.param_leaves(whole):
        name = path[len("params/"):].replace("/", ".")
        name = name if name in local else name[:-len("kernel")] + "weight"
        n = local[name].numel() * dtype.itemsize
        rule = (int(np.prod(shape)) * dtype.itemsize
                // mb._shard_denominator(mesh_lib.spec_for(path, rules),
                                         shape, mesh))
        port += n
        if n < rule:  # JAX keeps every bias whole; a column's is cut here
            assert name.endswith("bias"), name
        elif n > rule:
            assert ("mlp1" in name or (tp == 4 and (
                "k_proj" in name or "v_proj" in name))), name
    gspmd = mb.sharded_bytes_per_device(mb.param_leaves(whole), mesh, rules)
    total = sum(t.numel() * t.element_size() for t in whole.parameters())
    assert port < total and abs(port - gspmd) < 0.02 * gspmd, (port, gspmd)


def test_fused_packers_refuse_a_cut_model():
    """The fused stacks read whole weights: each packer refuses a model cut
    over the tensor axis (PolicyServer takes the plain route on a mesh)."""
    from vlaser_tpu_torch.core.config import tiny_vla
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.core.tensor_parallel import shard_model
    from vlaser_tpu_torch.inference.fused_runner import pack_qwen2_stack
    from vlaser_tpu_torch.kernels.fused_vit import pack_vit_stack
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.policy.fused_infer import pack_expert_stack
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA

    cfg = tiny_vla()
    vcfg = dataclasses.replace(cfg.vlm, vision=dataclasses.replace(
        cfg.vlm.vision, qk_normalization=False))
    vla = shard_model(quantize_for_serving(PiZeroVLA(
        dataclasses.replace(cfg, vlm=vcfg), device="cpu"), target="policy",
        min_size=1), 2, 0)
    vlm = shard_model(quantize_for_serving(InternVLChatModel(
        vcfg, device="cpu"), min_size=1), 2, 1)
    for pack, arg in ((pack_expert_stack, vla),
                      (pack_qwen2_stack, vlm.language_model),
                      (pack_vit_stack, vlm.vision_model)):
        with pytest.raises(ValueError, match="single-device"):
            pack(arg)
