"""The port's block-wise 8-bit AdamW (vlaser_tpu_torch/train/optim8bit.py)
against the JAX package's (vlaser_tpu/train/optim8bit.py) on the CPU, where
AdamW8bit runs the kernel's eager twin.

Codes are held equal. Where they are not, the one allowed difference is
one step, and only where the value lies within 2 fp32 ulp of the midpoint
between the two codes: XLA's CPU code may contract a product and a sum
into one rounding where the twin rounds twice (the kernel rounds as the
twin does). Scales are the blocks' maxima of the same fp32 values, so
they are equal after a quantization; after an update, where XLA
contracts b * m + (1 - b) * g, within 2 ulp; parameters after a step within 2 fp32 ulp of their
magnitude plus 1e-9 (the update's last rounding and lr from the
schedule's float64 in the port, fp32 in JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vlaser_tpu.core.config import tiny_paligemma_vla as j_tiny_pali
from vlaser_tpu.core.config import tiny_vla as j_tiny_vla
from vlaser_tpu.train import optim8bit as jo
from vlaser_tpu_torch.train import optim8bit as po
from vlaser_tpu_torch.utils.convert import (adam8bit_state_from_jax,
                                            load_optimizer_state)

ULP2 = 2 * 2.0 ** -23


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _near_mid(ratio, code, mids):
    """Whether each ratio lies within 2 ulp of the midpoint below or above
    its code."""
    lo = np.where(code > 0, mids[np.clip(code - 1, 0, len(mids) - 1)], -1)
    hi = np.where(code < len(mids), mids[np.clip(code, 0, len(mids) - 1)], 9)
    tol = ULP2 * np.maximum(np.abs(ratio), 2.0 ** -126)
    return (np.abs(ratio - lo) <= tol) | (np.abs(ratio - hi) <= tol)


def test_tables_are_the_jax_tables():
    assert np.array_equal(po.SMAP, np.asarray(jo._SMAP))
    assert np.array_equal(po.UMAP, np.asarray(jo._UMAP))
    for table, mids in ((jo._SMAP, po.SMID), (jo._UMAP, po.UMID)):
        t = jnp.asarray(table)
        assert np.array_equal(mids, np.asarray((t[1:] + t[:-1]) / 2.0))
    assert len(po.SMID) == 127 and len(po.UMID) == 255  # 2^k - 1 (kernel)


def _wide_inputs(signed):
    """4 full blocks and a tail of 77: one block across 10 decades, one of
    exact midpoints (max 1, so value / scale is the midpoint itself), one
    of zeros and a random one."""
    rng = np.random.default_rng(3)
    mids = po.SMID if signed else po.UMID
    decades = 10.0 ** rng.uniform(-10, 0, 256)
    on_mid = np.resize(np.concatenate([[1.0], mids]), 256)
    blocks = [decades, on_mid, np.zeros(256), rng.standard_normal(256),
              10.0 ** rng.uniform(-6, 1, 77)]
    x = np.concatenate(blocks).astype(np.float32)
    if signed:
        x *= np.where(rng.random(x.size) < 0.5, -1, 1).astype(np.float32)
    return x


@pytest.mark.parametrize("signed", [True, False])
def test_quant_matches_jax(signed):
    x = _wide_inputs(signed)
    jq, jdq = ((jo._quant_signed, jo._dequant_signed) if signed else
               (jo._quant_unsigned, jo._dequant_unsigned))
    pq, pdq = ((po.quant_signed, po.dequant_signed) if signed else
               (po.quant_unsigned, po.dequant_unsigned))
    q_j, s_j = (np.asarray(a) for a in jq(jnp.asarray(x)))
    q_p, s_p = pq(torch.from_numpy(x))
    assert q_p.dtype == torch.uint8 and q_p.shape == (5, 256)
    assert s_p.dtype == torch.float32 and s_p.shape == (5, 1)
    assert np.array_equal(s_p.numpy(), s_j)
    assert np.array_equal(s_p.numpy()[2], [np.float32(1e-32)])  # zeros
    mag = lambda q: q.astype(int) % 128 if signed else q.astype(int)
    mag_p, mag_j = mag(q_p.numpy()), mag(q_j)
    diff = q_p.numpy() != q_j
    if diff.any():
        mids = po.SMID if signed else po.UMID
        ratio = np.abs(np.pad(x, (0, 179)).reshape(5, 256)) / s_j
        assert np.abs(mag_p - mag_j)[diff].max() == 1
        assert _near_mid(ratio[diff], np.minimum(mag_p, mag_j)[diff] + 1,
                         mids).all()
    assert (q_p.numpy() == q_j).mean() > 0.99
    # the exact midpoints take the lower code (searchsorted's left rule)
    mags = mag_p[1]
    n_mid = len(po.SMID if signed else po.UMID)
    assert np.array_equal(mags[1:1 + n_mid], np.arange(n_mid))
    back_j = np.asarray(jdq(jnp.asarray(q_j), jnp.asarray(s_j), x.shape))
    back_p = pdq(_t(q_j), _t(s_j), x.shape)
    assert np.array_equal(back_p.numpy(), back_j)


def _jax_state(tree, grads, lr, wd):
    """JAX adamw8bit over len(grads) updates -> (params, chain state)."""
    tx = jo.adamw8bit(lr, weight_decay=wd)
    st = tx.init(tree)
    step = jax.jit(lambda p, s, g: tx.update(g, s, p))
    for g in grads:
        u, st = step(tree, st, g)
        tree = optax.apply_updates(tree, u)
    return tree, st


def _moments(st):
    return jax.tree_util.tree_map(np.asarray, st[0].moments), int(st[0].count)


def test_one_update_from_a_carried_jax_state():
    """Three JAX updates build a non-zero state (block maxima that differ,
    codes across the tables), which is carried across; one more update on
    both sides from the same gradient: codes, scales and parameters. A
    tail block (n = 40 x 256 + 13) and a small fp32 leaf ride along."""
    rng = np.random.default_rng(0)
    shapes = {"w": (40 * 256 + 13,), "b": (100,)}
    tree = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32) * 0.1)
            for k, s in shapes.items()}
    decades = lambda s: (rng.standard_normal(s) * 10.0 ** rng.uniform(
        -6, 0, s)).astype(np.float32)
    grads = [{k: jnp.asarray(decades(s)) for k, s in shapes.items()}
             for _ in range(4)]
    lr, wd = 1e-2, 1e-2
    p3, st3 = _jax_state(tree, grads[:3], lr, wd)
    tx = jo.adamw8bit(lr, weight_decay=wd)  # the fourth, from st3
    u, st4 = tx.update(grads[3], st3, p3)
    p4 = optax.apply_updates(p3, u)

    params = {k: torch.nn.Parameter(_t(v)) for k, v in p3.items()}
    model = torch.nn.Module()
    for k, v in params.items():
        model.register_parameter(k, v)
    opt = po.AdamW8bit(list(params.values()), lr=lr, weight_decay=wd)
    mom, count = _moments(st3)
    assert count == 3
    load_optimizer_state(opt, model, adam8bit_state_from_jax(mom, count))
    for k, p in params.items():
        p.grad = _t(grads[3][k])
    opt.step()

    want, _ = _moments(st4)
    st_w = opt.state[params["w"]]
    assert float(st_w["step"]) == 4
    j_w = want["w"]
    for key in ("m_scale", "v_scale"):
        np.testing.assert_allclose(st_w[key].numpy(), getattr(j_w, key),
                                   rtol=ULP2, atol=0, err_msg=key)
    for key, jq in (("m_q", j_w.m_q), ("v_q", j_w.v_q)):
        got = st_w[key].numpy().astype(int)
        diff = got != jq
        assert (np.abs(got - jq)[diff] % 128 <= 1).all(), key
        assert diff.mean() <= 1e-3, (key, diff.sum())
    assert not st_w["m_q"][-1, 13:].any() and not st_w["v_q"][-1, 13:].any()
    m_b, v_b = want["b"]
    st_b = opt.state[params["b"]]
    np.testing.assert_allclose(st_b["m"].numpy(), m_b, rtol=ULP2, atol=0)
    np.testing.assert_allclose(st_b["v"].numpy(), v_b, rtol=ULP2, atol=0)
    for k, p in params.items():
        w = np.asarray(p4[k])
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=ULP2 * np.abs(w).max() + 1e-9)


def test_fresh_state_is_the_jax_init():
    p = torch.nn.Parameter(torch.zeros(5000))
    st = po.init_state(p)
    j = jo.scale_by_adam8bit().init({"p": jnp.zeros(5000)}).moments["p"]
    for k in ("m_q", "m_scale", "v_q", "v_scale"):
        assert np.array_equal(st[k].numpy(), np.asarray(getattr(j, k))), k
    small = po.init_state(torch.nn.Parameter(torch.zeros(4095)))
    assert sorted(small) == ["m", "step", "v"]


def _regression(opt_fn, steps=60):
    rng = np.random.default_rng(0)
    W = torch.tensor(rng.standard_normal((64, 128)) * 0.1,
                     dtype=torch.float32)
    X = torch.tensor(rng.standard_normal((256, 64)), dtype=torch.float32)
    Y = X @ torch.tensor(rng.standard_normal((64, 128)), dtype=torch.float32)
    w = torch.nn.Parameter(W.clone())
    b = torch.nn.Parameter(torch.zeros(8))
    loss = lambda: ((X @ w - Y) ** 2).mean() + (b ** 2).mean()
    opt = opt_fn([w, b])
    start = float(loss())
    for _ in range(steps):
        opt.zero_grad()
        l = loss()
        l.backward()
        opt.step()
    return start, float(l), opt, w, b


def test_adamw8bit_tracks_fp32():
    """tests/test_optim8bit.py's stress problem on the port: >= 85% of fp32
    AdamW's loss reduction, state < 0.35 x fp32's, the small leaf fp32."""
    start, l32, _, _, _ = _regression(
        lambda ps: torch.optim.AdamW(ps, lr=1e-2, weight_decay=1e-3))
    start8, l8, opt, w, b = _regression(
        lambda ps: po.AdamW8bit(ps, lr=1e-2, weight_decay=1e-3))
    assert start == start8
    assert (start - l8) / (start - l32) > 0.85, (l8, l32)
    st = opt.state[w]
    assert st["m_q"].dtype == torch.uint8 and st["v_q"].dtype == torch.uint8
    nbytes = sum(st[k].numel() * st[k].element_size()
                 for k in ("m_q", "v_q", "m_scale", "v_scale"))
    assert nbytes < 0.35 * 2 * 4 * w.numel()
    assert opt.state[b]["m"].dtype == torch.float32


def _patch_leaf(which):
    """(JAX HWIO kernel shape) of the InternViT (tiny_vla) or SigLIP
    (tiny_paligemma_vla) patch conv."""
    if which == "internvit":
        v = j_tiny_vla().vlm.vision
        return (v.patch_size, v.patch_size, 3, v.hidden_size)
    s = j_tiny_pali().siglip
    return (s.patch_size, s.patch_size, 3, s.hidden_size)


@pytest.mark.parametrize("which", ["internvit", "siglip"])
def test_patch_conv_is_blocked_in_hwio_order(which):
    """The conv's JAX leaf is HWIO, the port's parameter OIHW: AdamW8bit(
    hwio=...) blocks the gradient and the parameter in HWIO order, so the
    block maxima, codes and parameters are the JAX leaf's; the same step
    blocked in OIHW order differs."""
    shape = _patch_leaf(which)
    n = int(np.prod(shape))
    assert n >= po.MIN_8BIT_SIZE
    rng = np.random.default_rng(5)
    tree = {"k": jnp.asarray(rng.standard_normal(shape).astype(np.float32))}
    # per-output-channel gradient scales: OIHW blocks mix what HWIO's keep
    scales = 10.0 ** rng.uniform(-4, 0, shape[-1])
    grads = [{"k": jnp.asarray((rng.standard_normal(shape) * scales)
                               .astype(np.float32))} for _ in range(3)]
    p2, st2 = _jax_state(tree, grads[:2], 1e-3, 1e-2)
    tx = jo.adamw8bit(1e-3, weight_decay=1e-2)
    u, st3 = tx.update(grads[2], st2, p2)
    p3 = np.asarray(optax.apply_updates(p2, u)["k"])
    mom, count = _moments(st2)
    want, _ = _moments(st3)
    oihw = lambda a: _t(np.asarray(a)).permute(3, 2, 0, 1).contiguous()

    def port(hwio):
        p = torch.nn.Parameter(oihw(p2["k"]))
        model = torch.nn.Module()
        model.register_parameter("weight", p)
        opt = po.AdamW8bit([p], lr=1e-3, weight_decay=1e-2,
                           hwio=[p] if hwio else ())
        st = adam8bit_state_from_jax({"k": mom["k"]}, count)
        load_optimizer_state(opt, model, {"weight": st["k"]})
        p.grad = oihw(grads[2]["k"])
        opt.step()
        return p.detach(), opt.state[p]

    p, st = port(hwio=True)
    np.testing.assert_allclose(p.permute(2, 3, 1, 0).numpy(), p3, rtol=0,
                               atol=ULP2 * np.abs(p3).max())
    for key in ("m_scale", "v_scale"):
        np.testing.assert_allclose(st[key].numpy(), getattr(want["k"], key),
                                   rtol=ULP2, atol=0, err_msg=key)
    for key in ("m_q", "v_q"):
        diff = st[key].numpy() != getattr(want["k"], key)
        assert diff.mean() <= 1e-3, (key, diff.sum())
    _, wrong = port(hwio=False)  # the control: OIHW blocks
    assert not np.array_equal(wrong["m_scale"].numpy(), want["k"].m_scale)


def test_cpu_step_runs_the_twin_and_launches_nothing():
    from vlaser_tpu_torch.kernels import adam8bit

    before = adam8bit.launch_count
    _regression(lambda ps: po.AdamW8bit(ps, lr=1e-2), steps=2)
    assert adam8bit.launch_count == before
