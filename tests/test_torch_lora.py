"""LoRA of the port (vlaser_tpu_torch/train/lora.py, the activation-path
term of models/layers.Dense) against the JAX package on the CPU, fp32.

- A LoRA Dense over a float, an int8 weight-only and a w8a8 base equals
  the JAX Dense with the same `params` / `quant` / `lora` collections
  (rtol 1e-5: fp32 products summed in another order; the w8a8 int8 rows
  are equal, the integer products exact); with b = 0 it equals the port's
  base Dense bit for bit.
- The LoRA factors' gradients through make_sft_loss_chunked at tiny_vlm,
  every LLM layer kernel int8 and flagged w8a8 (VLM_W8A8_ACT_PATTERNS, B x
  N >= 128 rows so w8a8 fires), against jax.grad (after
  tests/test_quant.py::test_w8a8_forward_qlora_training_trajectory): loss
  within 2e-3 relative, each factor's gradient norm within 5e-3 (an int8
  activation row may round one step apart across the frameworks).
- merge_qlora_into_quant against the JAX merge (after
  tests/test_lora_mpo.py::test_qlora_over_int8_base), leaf by leaf within
  1e-6 relative, and the merged float model's logits against the int8 +
  LoRA model's.
- A LoRA Dense keeps its term on the shared int8 route under no_grad."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core.config import tiny_vlm
from vlaser_tpu.core.quant import (DEFAULT_PATTERNS, VLM_W8A8_ACT_PATTERNS,
                                   quantize_variables)
from vlaser_tpu.models.layers import Dense as JDense
from vlaser_tpu.models.vlm import InternVLChatModel as JVLM
from vlaser_tpu.train.lora import init_qlora_collection as j_init_qlora
from vlaser_tpu.train.lora import merge_qlora_into_quant as j_merge
from vlaser_tpu.train.losses import make_sft_loss_chunked as j_chunked
from vlaser_tpu_torch.core import config as tcfg
from vlaser_tpu_torch.core.quant import quantize_module
from vlaser_tpu_torch.models.layers import Dense, init_normal_, load_state
from vlaser_tpu_torch.models.qwen2 import Qwen2Model
from vlaser_tpu_torch.models.vlm import InternVLChatModel
from vlaser_tpu_torch.train import lora as tl
from vlaser_tpu_torch.train.losses import make_sft_loss_chunked
from vlaser_tpu_torch.utils.convert import from_jax_variables

IN, OUT, R = 48, 40, 4



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny shapes: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dense_variables(base, rng):
    """JAX variables of one Dense (bias) over a `base` kernel ("float",
    "int8", "w8a8"), with a LoRA collection whose b is nonzero."""
    kernel = rng.standard_normal((IN, OUT)).astype(np.float32) * 0.2
    v = {"params": {"kernel": jnp.asarray(kernel),
                    "bias": jnp.asarray(rng.standard_normal(OUT).astype(
                        np.float32) * 0.1)}}
    if base != "float":
        v = quantize_variables(v, (r"kernel$",), min_size=0,
                               act_quant_patterns=(r"kernel$",)
                               if base == "w8a8" else ())
    v["lora"] = {"a": jnp.asarray(rng.standard_normal((IN, R)).astype(
        np.float32) * 0.3), "b": jnp.asarray(rng.standard_normal(
            (R, OUT)).astype(np.float32) * 0.3)}
    return v


@pytest.mark.parametrize("base", ["float", "int8", "w8a8"])
def test_lora_dense_matches_jax(base):
    rng = np.random.default_rng(3)
    v = _dense_variables(base, rng)
    rows = 160 if base == "w8a8" else 6  # w8a8 fires at >= 128 rows
    x = rng.standard_normal((2, rows // 2, IN)).astype(np.float32)
    want = np.asarray(JDense(OUT, compute_dtype=jnp.float32).apply(
        v, jnp.asarray(x)))
    d = Dense(IN, OUT, True, (), torch.float32, torch.float32, "cpu")
    load_state(d, {k: t for k, t in from_jax_variables(_np_tree(v)).items()})
    assert d.has_lora and ("kernel_aq" in d._buffers) == (base == "w8a8")
    got = d(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # b = 0: the base Dense's output bit for bit
    base_d = Dense(IN, OUT, True, (), torch.float32, torch.float32, "cpu")
    state = {k: t for k, t in from_jax_variables(_np_tree(v)).items()
             if not k.startswith("lora")}
    load_state(base_d, state)
    with torch.no_grad():
        d.lora_b.zero_()
    assert torch.equal(d(torch.from_numpy(x)), base_d(torch.from_numpy(x)))


def _vlm_batch(cfg, B, N, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 400, (B, N)).astype(np.int32)
    ids[:, 2] = cfg.img_context_token_id
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    img = cfg.vision.image_size
    return {"input_ids": ids, "labels": labels,
            "loss_weight": rng.uniform(0.5, 1.5, (B, N)).astype(np.float32),
            "seg_ids": np.ones((B, N), np.int32),
            "pixel_values": rng.standard_normal(
                (B, img, img, 3)).astype(np.float32),
            "image_flags": np.ones((B,), np.int32)}


@pytest.fixture(scope="module")
def qlora():
    """tiny_vlm, every LLM layer kernel int8 + w8a8, the embedding and the
    lm_head int8, LoRA r 4 on the LLM targets with b ~ N(0, 0.05^2) (so
    that a's gradient is nonzero too)."""
    cfg = tiny_vlm()
    jmodel = JVLM(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    batch = _vlm_batch(cfg, 4, 40, 17)
    assert 4 * 40 >= 128  # the w8a8 branch fires
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.asarray(batch["input_ids"]),
                            jnp.asarray(batch["pixel_values"]),
                            jnp.asarray(batch["image_flags"]))
    qv = quantize_variables(variables, DEFAULT_PATTERNS,
                            act_quant_patterns=VLM_W8A8_ACT_PATTERNS,
                            min_size=0)
    lora = j_init_qlora(jax.random.PRNGKey(1), qv, r=4, alpha=8.0)
    rng = np.random.default_rng(5)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: x if p[-1].key == "a" else jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32) * 0.05), lora)
    return dict(cfg=cfg, jmodel=jmodel, batch=batch, qv=qv, lora=lora)


def _port_qlora(q):
    model = InternVLChatModel(q["cfg"], compute_dtype=torch.float32,
                              device="cpu", attn_impl="reference")
    load_state(model, from_jax_variables(_np_tree(dict(q["qv"],
                                                        lora=q["lora"]))))
    return model


def test_lora_gradients_through_the_w8a8_chunked_loss_match_jax(qlora):
    q = qlora
    jb = {k: jnp.asarray(v) for k, v in q["batch"].items()}
    jloss = j_chunked(q["jmodel"], chunk=64)
    loss, grads = jax.value_and_grad(
        lambda lt: jloss(dict(q["qv"], lora=lt), jb, None))(q["lora"])
    want = from_jax_variables(_np_tree({"lora": grads}))

    model = _port_qlora(q)
    for name, p in model.named_parameters():
        p.requires_grad_(name.endswith(("lora_a", "lora_b")))
    tb = {k: torch.from_numpy(v) for k, v in q["batch"].items()}
    got = make_sft_loss_chunked(model, chunk=64)(tb)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=2e-3)
    named = dict(model.named_parameters())
    assert sorted(n for n, p in named.items() if p.grad is not None) == \
        sorted(want)
    for name, w in want.items():
        g = named[name].grad
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        np.testing.assert_allclose(torch.linalg.vector_norm(g).item(),
                                   np.linalg.norm(w.numpy()), rtol=5e-3,
                                   err_msg=name)


def test_merge_qlora_into_quant_matches_jax(qlora):
    q = qlora
    want = from_jax_variables(_np_tree(j_merge(dict(q["qv"],
                                                    lora=q["lora"]))))
    model = _port_qlora(q)
    state = dict(model.state_dict())
    merged = tl.merge_qlora_into_quant(state)
    assert sorted(merged) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(merged[name].numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    # the float model of the merged state against the int8 + LoRA model:
    # weight-only (N < 128 rows), so the two differ by the fp32 order of
    # (x W) + (x a) b against x (W + a b) alone
    flt = load_state(InternVLChatModel(q["cfg"], compute_dtype=torch.float32,
                                       device="cpu", attn_impl="reference"),
                     merged)
    b = {k: torch.from_numpy(v) for k, v in _vlm_batch(
        q["cfg"], 1, 24, 8).items()}
    with torch.no_grad():
        args = (b["input_ids"], b["pixel_values"], b["image_flags"])
        lq, lf = model(*args)[0], flt(*args)[0]
    np.testing.assert_allclose(lf.numpy(), lq.numpy(), rtol=0,
                               atol=1e-4 * lq.abs().max().item())


def test_init_qlora_collection_targets_and_start():
    """Each LLM target Dense, int8 or float, gets a [L, in, r] / [L, r,
    out] pair, a ~ N(0, 1/r^2) * alpha / r and b = 0, as the JAX
    collection's shapes; the ViT and the head get none."""
    cfg = tcfg.tiny_vlm()
    model = InternVLChatModel(cfg, compute_dtype=torch.float32,
                              device="cpu")
    gen = torch.Generator().manual_seed(0)
    init_normal_(model, gen)
    quantize_module(model, (r"(^|/)layers/.*mlp/.*kernel$",), min_size=0)
    factors = tl.init_qlora_collection(model, r=8, alpha=16.0,
                                       generator=gen)
    L, C, I = cfg.llm.num_layers, cfg.llm.hidden_size, \
        cfg.llm.intermediate_size
    sites = {"self_attn.q_proj": (C, cfg.llm.q_dim),
             "self_attn.k_proj": (C, cfg.llm.kv_dim),
             "self_attn.v_proj": (C, cfg.llm.kv_dim),
             "self_attn.o_proj": (cfg.llm.q_dim, C),
             "mlp.gate_proj": (C, I), "mlp.up_proj": (C, I),
             "mlp.down_proj": (I, C)}
    want = {}
    for site, (din, dout) in sites.items():
        pre = f"language_model.model.layers.{site}"
        want[pre + ".lora_a"] = (L, din, 8)
        want[pre + ".lora_b"] = (L, 8, dout)
    assert {n: tuple(p.shape) for n, p in factors.items()} == want
    assert tl.count_lora_params(factors) == sum(
        int(np.prod(s)) for s in want.values())
    a = torch.cat([p.flatten() for n, p in factors.items()
                   if n.endswith("a")])
    assert all(not p.any() for n, p in factors.items() if n.endswith("b"))
    np.testing.assert_allclose(a.std().item(), (1 / 8) * 2.0, rtol=0.1)
    named = dict(model.named_parameters())
    assert all(named[n] is p for n, p in factors.items())


def test_weight_path_lora_equals_jax_apply():
    """apply_lora / merge_lora over a flat state: base + (alpha / r) a @ b,
    the JAX formula, stacked and plain kernels."""
    from vlaser_tpu.train.lora import apply_lora as j_apply

    rng = np.random.default_rng(2)
    params = {"layers": {"q_proj": {"kernel": rng.standard_normal(
        (2, 8, 6)).astype(np.float32)}},
        "lm_head": {"kernel": rng.standard_normal((8, 5)).astype(
            np.float32)}}
    state = from_jax_variables({"params": params})
    lora = tl.init_lora_params(torch.Generator().manual_seed(1), state,
                               target_patterns=(r"(q_proj|lm_head)/kernel$",),
                               r=3)
    assert tl.count_lora_params(lora) == 2 * 8 * 3 + 2 * 3 * 6 + 8 * 3 + 15
    for ab in lora.values():
        ab["b"].normal_(generator=torch.Generator().manual_seed(4))
    jlora = {k.replace(".", "/"): {n: jnp.asarray(t.numpy())
                                   for n, t in ab.items()}
             for k, ab in lora.items()}
    want = from_jax_variables({"params": _np_tree(j_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jlora, 6.0, 3))})
    got = tl.merge_lora(state, lora, 6.0, 3)
    for name, w in want.items():
        # one fp32 rounding of the rank-3 sum, in another order
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_lora_term_survives_the_shared_int8_route():
    """Under no_grad, w8a8 Dense that read one input share its int8 rows
    (models/layers.w8a8_group / gated_mlp); a Dense with LoRA factors must
    not lose its term there. The stack under no_grad equals the same stack
    with a gradient asked of its input (every Dense on its own W8A8Dot) bit
    for bit, and differs from the stack without the factors."""
    cfg = dataclasses.replace(tcfg.tiny_llm(), num_layers=2)
    gen = torch.Generator().manual_seed(7)
    model = Qwen2Model(cfg, compute_dtype=torch.float32, device="cpu")
    init_normal_(model, gen, std=0.1)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("layernorm.weight") or n == "norm.weight":
                p.add_(1.0)
    quantize_module(model, DEFAULT_PATTERNS, VLM_W8A8_ACT_PATTERNS,
                    min_size=0)
    x = torch.randn(2, 80, cfg.hidden_size, generator=gen)
    pos = torch.arange(80)[None].expand(2, 80)
    with torch.no_grad():
        base = model(x, pos)[0]
    factors = tl.init_qlora_collection(model, r=4, alpha=8.0, generator=gen)
    with torch.no_grad():
        for n, p in factors.items():
            if n.endswith("lora_b"):
                p.normal_(generator=gen).mul_(0.1)
        shared = model(x, pos)[0]
    per_dense = model(x.clone().requires_grad_(), pos)[0]
    assert torch.equal(shared, per_dense.detach())
    assert (shared - base).abs().max() > 1e-3
