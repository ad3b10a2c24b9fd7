"""The VLA's text head and its ablation mixtures in the port
(vlaser_tpu_torch) against the JAX package on the same tiny weights and
inputs: forward_vlm and the cached infer_text, adaLN / adaLN-Zero,
vision-in-expert, the quantized adaLN-Zero policy (which the JAX package
cannot serve), the trainer's parameter labels, conversion and serving
quantization of every new leaf, the fused routes' refusals, Beta flow
times, the InternViT-6B tier's configs and the graft entry's twin.

Every comparison is fp32 on both sides (the conftest sets JAX's matmul
precision to highest); the tolerance is stated where it is used.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from vlaser_tpu.core import config as jcfg
from vlaser_tpu.core.quant import quantize_for_serving as jax_quantize
from vlaser_tpu.policy.pizero import PiZeroVLA as JaxVLA
from vlaser_tpu.train.trainer import _vla_param_groups as jax_groups
from vlaser_tpu_torch.core import config as tcfg
from vlaser_tpu_torch.core.quant import quantize_for_serving
from vlaser_tpu_torch.graft_entry import entry
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.policy.flow import sample_fm_time
from vlaser_tpu_torch.policy.fused_infer import (make_batched_infer_action,
                                                 make_fused_infer_action)
from vlaser_tpu_torch.policy.pizero import PiZeroVLA
from vlaser_tpu_torch.serve.policy_server import PolicyServer
from vlaser_tpu_torch.train.trainer import _vla_param_groups
from vlaser_tpu_torch.utils.convert import from_jax_variables, to_jax_params

TOL = 1e-4  # fp32 on both sides: atol and rtol of every value comparison
B = 2


def _cfg(**over):
    """tiny_vla with 16 prompt slots; an expert 128 wide, so that the
    stacked adaLN-Zero gate kernels [2, 16, 128] reach the serving
    quantizer's 4,096-element floor."""
    cfg = jcfg.tiny_vla(max_image_text_tokens=16)
    cfg = dataclasses.replace(
        cfg, expert=dataclasses.replace(cfg.expert, hidden_size=128),
        time_hidden_size=16)
    return dataclasses.replace(cfg, **over)


def _inputs(cfg, seed=0):
    """B rows, one tile each; row 0's prompt padded after 12 tokens, row 1's
    after 9."""
    rng = np.random.default_rng(seed)
    S, img = cfg.max_image_text_tokens, cfg.vlm.vision.image_size
    ids = rng.integers(1, 400, (B, S)).astype(np.int32)
    ids[:, 2] = cfg.vlm.img_context_token_id
    mask = np.ones((B, S), np.int32)
    mask[0, 12:] = 0
    mask[1, 9:] = 0
    n_a = cfg.num_action_tokens
    return dict(
        ids=ids, px=rng.standard_normal((B, img, img, 3)).astype(np.float32),
        mask=mask,
        proprio=rng.standard_normal((B, cfg.cond_steps, cfg.proprio_dim))
        .astype(np.float32),
        actions=rng.standard_normal((B, n_a, cfg.action_dim))
        .astype(np.float32),
        t=np.array([0.3, 0.8], np.float32),
        x0=rng.standard_normal((B, n_a, cfg.action_dim)).astype(np.float32))


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if k in out and isinstance(v, dict) else v
    return out


def _variables(cfg, x, seed=1):
    """JAX variables of the config from numpy draws: norm and LayerNorm
    weights 1 + N(0, 0.1^2), everything else N(0, 0.1^2) (the adaLN-Zero
    gates too, so that they are live). The lm head's leaves come from an
    init through forward_vlm."""
    jm = JaxVLA(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    a = [jnp.asarray(x[k]) for k in ("ids", "px", "mask", "proprio",
                                     "actions", "t", "x0")]
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(key, *a))
    if cfg.use_lm_head:
        shapes = _merge(shapes, jax.eval_shape(lambda: jm.init(
            key, *a[:3], method=jm.forward_vlm)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        w = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return jnp.asarray(w + 1.0 if path[-1].key == "weight" else w)

    return jm, jax.tree_util.tree_map_with_path(draw, shapes)


def _port(cfg, variables):
    m = PiZeroVLA(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(m, from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                            variables)))
    return m


def _t(x, *keys):
    return [torch.from_numpy(x[k]).long() if k == "ids" else
            torch.from_numpy(x[k]) for k in keys]


def _j(x, *keys):
    return [jnp.asarray(x[k]) for k in keys]


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL, err_msg=what)


ACT = ("ids", "px", "mask", "proprio", "x0")
LOSS = ("ids", "px", "mask", "proprio", "actions", "t", "x0")
TEXT = ("ids", "px", "mask")


# -- the text head ------------------------------------------------------------
@pytest.fixture(scope="module")
def text_model():
    cfg = _cfg(use_lm_head=True)
    x = _inputs(cfg, seed=4)
    jm, v = _variables(cfg, x)
    return cfg, jm, v, _port(cfg, v), x


def test_forward_vlm_logits_match_jax(text_model):
    """Causal logits through the VLM mixture on two padded prompts: every
    valid position within TOL."""
    cfg, jm, v, tm, x = text_model
    want = np.asarray(jm.apply(v, *_j(x, *TEXT), method=jm.forward_vlm))
    with torch.no_grad():
        got = tm.forward_vlm(*_t(x, *TEXT)).numpy()
    assert got.shape == (B, cfg.max_image_text_tokens, cfg.vlm.llm.vocab_size)
    valid = x["mask"].astype(bool)
    _close(got[valid], want[valid])


def test_infer_text_matches_jax_with_eos_mid_stream(text_model):
    """Greedy cached decode on the padded prompts: first with an EOS no row
    emits, then with EOS set to row 0's third token, so that row 0 stops
    mid-stream (zeros after it) while row 1 runs on. Tokens equal JAX's, and
    each stream equals the argmax of teacher-forced forward_vlm logits."""
    cfg, jm, v, tm, x = text_model
    new = 6

    def both(eos):
        want = np.asarray(jm.apply(v, *_j(x, *TEXT), method=jm.infer_text,
                                   max_new_tokens=new, eos_token_id=eos))
        got = tm.infer_text(*_t(x, *TEXT), max_new_tokens=new,
                            eos_token_id=eos).numpy()
        np.testing.assert_array_equal(got, want)
        return got

    free = both(-1)
    # the forced kernel route (flash's plain version on the CPU: a causal
    # prefill and one-row decode steps at a scalar q_offset) decodes alike
    tm.set_attn_impl("kernel")
    try:
        np.testing.assert_array_equal(
            tm.infer_text(*_t(x, *TEXT), max_new_tokens=new,
                          eos_token_id=-1).numpy(), free)
    finally:
        tm.set_attn_impl("auto")
    eos = int(free[0, 2])
    first = list(free[0]).index(eos)
    stopped = both(eos)
    assert (stopped[0, first + 1:] == 0).all() and 0 < first < new - 1
    # the cached stream against teacher-forced logits: the prompt (valid
    # tokens only) + the stream, rows one at a time
    for r in range(B):
        n = int(x["mask"][r].sum())
        ids = np.concatenate([x["ids"][r, :n], free[r]])[None]
        mask = np.ones_like(ids)
        with torch.no_grad():
            logits = tm.forward_vlm(torch.from_numpy(ids).long(),
                                    torch.from_numpy(x["px"][r:r + 1]),
                                    torch.from_numpy(mask))
        np.testing.assert_array_equal(
            logits[0, n - 1:n - 1 + new].argmax(-1).numpy(), free[r])


# -- adaLN / adaLN-Zero ---------------------------------------------------------
@pytest.fixture(scope="module", params=["adaln", "adaln_zero"])
def ada(request):
    cfg = _cfg(adaptive_mode=request.param)
    x = _inputs(cfg)
    jm, v = _variables(cfg, x)
    return cfg, jm, v, _port(cfg, v), x


def test_adaptive_loss_and_actions_match_jax(ada):
    """The flow loss, the cached infer_action and the no-cache oracle, each
    within TOL of JAX's; the port's cached and naive actions within TOL."""
    cfg, jm, v, tm, x = ada
    with torch.no_grad():
        loss = tm(*_t(x, *LOSS))
    _close(loss.item(), jm.apply(v, *_j(x, *LOSS)), "loss")
    got = tm.infer_action(*_t(x, *ACT))
    naive = tm.infer_action_naive(*_t(x, *ACT))
    _close(got, jm.apply(v, *_j(x, *ACT), method=jm.infer_action), "cached")
    _close(naive, jm.apply(v, *_j(x, *ACT), method=jm.infer_action_naive),
           "naive")
    _close(got, naive, "cached vs naive")
    assert got.shape == (B, cfg.horizon_steps, cfg.action_dim)


def test_adaptive_weights_reach_action_rows_only(ada):
    """Perturbing only the expert's adaLN weights moves the action rows of
    the joint train pass and leaves the tied proprio row (plain norms) and
    the prefix K/V exactly as they were."""
    cfg, jm, v, tm, x = ada
    ids, px, mask, proprio, actions, t, _ = _t(x, *LOSS)
    cond = tm._time_embed(t)[1]
    n_p = cfg.num_proprio_tokens

    def run():
        with torch.no_grad():
            emb = tm._image_text_embeds(ids, px)
            pa = torch.cat([tm._proprio(proprio), tm.action_encoder(actions)],
                           1)
            vp, pp, ap = tm._positions(B, "cpu")
            cv, sv = tm._rope(vp, cfg.vlm.llm.rope_theta)
            cp, sp = tm._rope(torch.cat([pp, ap], 1), cfg.expert.rope_theta)
            seg, lev = tm._meta(mask, include_action=True)
            out = tm.joint("train", emb, pa, cv, sv, cp, sp, seg, lev, cond)[1]
            return out, tm.prefix_forward(ids, px, mask, proprio)[:2]

    out0, kv0 = run()
    saved = {n: p.detach().clone() for n, p in tm.named_parameters()
             if "ada" in n}
    try:
        with torch.no_grad():
            for n, p in tm.named_parameters():
                if "ada" in n:
                    p.add_(0.5)
        out1, kv1 = run()
    finally:
        with torch.no_grad():
            for n, p in tm.named_parameters():
                if n in saved:
                    p.copy_(saved[n])
    assert torch.equal(out1[:, :n_p], out0[:, :n_p])
    assert (out1[:, n_p:] - out0[:, n_p:]).abs().max() > 1e-3
    assert all(torch.equal(a, b) for a, b in zip(kv0, kv1))


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_quantized_adaln_zero_serves_where_jax_raises(mode):
    """quantize_for_serving(target="policy") makes the adaLN-Zero gates'
    raw `kernel` int8, and the JAX layer then cannot find its parameter (a
    fault of the reference). The port's gate dequantizes it as a Dense
    does: its actions equal JAX's on the same tree with those gate kernels
    dequantized by hand (kernel_q x kernel_scale back under params), within
    TOL."""
    cfg = _cfg(adaptive_mode="adaln_zero")
    x = _inputs(cfg)
    jm, v = _variables(cfg, x)
    qv = jax_quantize(v, target="policy", mode=mode)
    qv = jax.tree_util.tree_map(np.asarray, qv)
    gates = ("post_adaptive_scale", "final_adaptive_scale")
    qexp = qv["quant"]["joint"]["layers"]["expert"]
    assert all("kernel_q" in qexp[g] for g in gates)
    with pytest.raises(Exception, match="kernel"):
        jm.apply(qv, *_j(x, *ACT), method=jm.infer_action)
    hand = jax.tree_util.tree_map(lambda a: a, qv)
    pexp = hand["params"]["joint"]["layers"]["expert"]
    for g in gates:
        q = hand["quant"]["joint"]["layers"]["expert"].pop(g)
        pexp[g]["kernel"] = q["kernel_q"].astype(np.float32) * q[
            "kernel_scale"]
    want = jm.apply(hand, *_j(x, *ACT), method=jm.infer_action)
    tm = _port(cfg, v)
    quantize_for_serving(tm, target="policy", mode=mode)
    gate = tm.joint.layers.expert.post_adaptive_scale
    assert "kernel" not in gate._parameters and "kernel_q" in gate._buffers
    _close(tm.infer_action(*_t(x, *ACT)), want)


# -- vision-in-expert -------------------------------------------------------------
def test_vision_in_expert_matches_jax_and_stops_vlm_tower_gradients():
    """The second tower's tokens ahead of proprio: loss, cached and naive
    actions within TOL of JAX's; the flow loss's gradients on the VLM-side
    tower and its projector are exactly 0 in both packages, while the
    expert tower's are not."""
    cfg = _cfg(vision_in_expert=True)
    x = _inputs(cfg)
    jm, v = _variables(cfg, x)
    tm = _port(cfg, v)
    loss = tm(*_t(x, *LOSS))
    _close(loss.item(), jm.apply(v, *_j(x, *LOSS)), "loss")
    for meth in ("infer_action", "infer_action_naive"):
        _close(getattr(tm, meth)(*_t(x, *ACT)),
               jm.apply(v, *_j(x, *ACT), method=getattr(jm, meth)), meth)
    loss.backward()
    jg = jax.grad(lambda p: jm.apply({"params": p}, *_j(x, *LOSS)))(
        v["params"])
    for side in ("vision_model", "mlp1"):
        assert all(float(jnp.abs(g).max()) == 0.0
                   for g in jax.tree_util.tree_leaves(jg[side]))
        for p in getattr(tm, side).parameters():
            assert p.grad is None or not p.grad.any()
    grads = [p.grad for p in tm.vision_model_expert.parameters()]
    assert all(g is not None for g in grads)
    assert max(float(g.abs().max()) for g in grads) > 0
    np.testing.assert_allclose(
        tm.expert_img_proj.kernel.grad.numpy(),
        np.asarray(jg["expert_img_proj"]["kernel"]), atol=TOL, rtol=1e-3)


# -- the all-options tree: labels, conversion, quantization --------------------
@pytest.fixture(scope="module")
def every():
    cfg = _cfg(adaptive_mode="adaln_zero", vision_in_expert=True,
               use_lm_head=True)
    x = _inputs(cfg)
    jm, v = _variables(cfg, x)
    return cfg, jm, v, _port(cfg, v), x


def _jax_names(tree):
    """A JAX params-shaped tree -> {port parameter name: leaf} (the patch
    convs' "kernel" is the port's "weight")."""
    names = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = ".".join(k.key for k in path)
        if name.endswith("patch_embedding.kernel"):
            name = name[:-len("kernel")] + "weight"
        names[name] = leaf
    return names


@pytest.mark.parametrize("train_vlm", [False, True])
def test_param_labels_match_jax(every, train_vlm):
    """The port's optimizer labels equal JAX's for every parameter: the
    second tower, its projectors and the expert's adaLN norms and gates are
    "action"; the lm head follows the VLM ("vlm" / "frozen")."""
    cfg, jm, v, tm, x = every
    want = _jax_names(jax_groups(v["params"], train_vlm))
    got = _vla_param_groups(tm, train_vlm)
    assert got == want
    vlm = "vlm" if train_vlm else "frozen"
    for name, label in (
            ("vision_model_expert.encoder.attn.qkv.kernel", "action"),
            ("vision_model_expert.embeddings.patch_embedding.weight",
             "action"),
            ("expert_img_mlp.fc1.kernel", "action"),
            ("expert_img_proj.kernel", "action"),
            ("joint.layers.expert.ada_input_norm.to_gamma.kernel", "action"),
            ("joint.layers.expert.ada_post_norm.to_beta.kernel", "action"),
            ("joint.layers.expert.post_adaptive_scale.kernel", "action"),
            ("joint.layers.expert.final_adaptive_scale.bias", "action"),
            ("lm_head.kernel", vlm), ("vision_model.encoder.ls1", vlm)):
        assert got[name] == label, name


def test_convert_round_trip_of_every_new_leaf(every):
    """from_jax_variables -> the port -> to_jax_params gives the JAX params
    tree back bit for bit, the second tower's patch conv through OIHW."""
    cfg, jm, v, tm, x = every
    conv = tm.vision_model_expert.embeddings.patch_embedding.weight
    hwio = np.asarray(v["params"]["vision_model_expert"]["embeddings"]
                      ["patch_embedding"]["kernel"])
    np.testing.assert_array_equal(conv.detach().numpy(),
                                  hwio.transpose(3, 2, 0, 1))
    back = to_jax_params(tm.state_dict())
    want = jax.tree_util.tree_map(np.asarray, v["params"])
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    for name in ("joint.layers.expert.ada_input_norm.to_gamma.kernel",
                 "joint.layers.expert.post_adaptive_scale.kernel",
                 "expert_img_proj.bias", "lm_head.kernel"):
        assert name in tm.state_dict()


@pytest.mark.parametrize("target", ["policy", "vlm"])
@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_quantize_for_serving_bit_for_bit(every, target, mode):
    """The port's serving quantization of the all-options model equals the
    JAX tree leaf for leaf (int8 leaves, scales, w8a8 flags and the float
    leaves left), the raw gate kernels included; the quantized state
    carries over from JAX and loads."""
    cfg, jm, v, tm, x = every
    m = _port(cfg, v)
    quantize_for_serving(m, target=target, mode=mode)
    jq = jax.tree_util.tree_map(np.asarray,
                                jax_quantize(v, target=target, mode=mode))
    want = from_jax_variables(jq)
    got = m.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert "joint.layers.expert.post_adaptive_scale.kernel_q" in got
    fresh = PiZeroVLA(cfg, compute_dtype=torch.float32, device="cpu")
    quantize_for_serving(fresh, target=target, mode=mode)
    load_state(fresh, want)


# -- the fused routes refuse the ablations ----------------------------------------
@pytest.mark.parametrize("over", [dict(adaptive_mode="adaln"),
                                  dict(adaptive_mode="adaln_zero"),
                                  dict(vision_in_expert=True)])
def test_fused_routes_refuse_ablations(over):
    cfg = dataclasses.replace(tcfg.tiny_vla(max_image_text_tokens=16),
                              time_hidden_size=16, **over)
    m = PiZeroVLA(cfg, compute_dtype=torch.float32, device="cpu")
    for make in (make_fused_infer_action, make_batched_infer_action):
        with pytest.raises(NotImplementedError, match="ablation"):
            make(m)
    with pytest.raises(NotImplementedError, match="ablation"):
        PolicyServer(m, fused=True, device="cpu")
    assert PolicyServer(m, device="cpu").serving_path == "plain"


# -- Beta flow times ------------------------------------------------------------
@pytest.mark.parametrize("alpha,beta", [(2.0, 3.0), (0.5, 0.5)])
def test_beta_flow_times_ks(alpha, beta):
    """20,000 draws of t = t_max (1 - z), z ~ Beta(alpha, beta): a
    Kolmogorov-Smirnov test of z against scipy.stats.beta (distance below
    0.015, p above 1e-3), t inside [0, t_max]."""
    g = torch.Generator().manual_seed(0)
    t_max = 1.0 - 1e-3
    t = sample_fm_time(g, 20000, "beta", alpha, beta, t_max=t_max)
    assert t.dtype == torch.float32 and t.shape == (20000,)
    assert float(t.min()) >= 0.0 and float(t.max()) <= np.float32(t_max)
    z = 1.0 - t.double().numpy() / t_max
    res = stats.kstest(z, stats.beta(alpha, beta).cdf)
    assert res.statistic < 0.015 and res.pvalue > 1e-3, res


def test_beta_one_draw_unchanged():
    """Beta(alpha, 1) keeps its exact u^(1/alpha) draw, bit for bit."""
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    got = sample_fm_time(g1, 64, "beta", 1.5, 1.0)
    u = torch.rand(64, generator=g2)
    assert torch.equal(got, (1.0 - 1e-3) * (1.0 - u ** (1.0 / 1.5)))


# -- configs and the graft entry ------------------------------------------------
@pytest.mark.parametrize("name", [
    "internvit_6b", "qwen2_5_32b", "internvl3_38b", "qwen2_5_72b",
    "internvl3_78b", "llm_100b_class", "internvl_100b_class"])
def test_config_field_for_field(name):
    assert (dataclasses.asdict(getattr(tcfg, name)())
            == dataclasses.asdict(getattr(jcfg, name)()))


def test_graft_entry_matches_jax_zero_parameters():
    """entry(tiny_vla(), "cpu") against JAX's infer_action on the same
    zero-parameter bf16 model and example batch (the JAX entry's layout cut
    to the tiny prompt): equal actions [1, horizon, action_dim]."""
    cfg = jcfg.tiny_vla()
    fn, args = entry(cfg, "cpu")
    got = fn(*args)
    jm = JaxVLA(cfg, param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16,
                attn_impl="reference")
    ja = [jnp.asarray(a.numpy()) for a in args]
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *ja[:4], ja[4], jnp.zeros((1,)), ja[4]))
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   shapes)
    want = jm.apply(zeros, *ja, method=jm.infer_action)
    assert got.shape == (1, cfg.horizon_steps, cfg.action_dim)
    assert args[2].sum() == cfg.max_image_text_tokens
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
