"""The port's ring attention (vlaser_tpu_torch/kernels/ring_attention.py)
and context-parallel LLM route against the JAX package's full attention,
LLM stack and SFT step on the CPU, the cases of tests/test_ring_attention.py
at its sizes and tolerances (forward 2e-5, gradients 3e-5; the LLM stack's
loss 1e-6 and gradients 1e-5, the SFT step's loss 1e-5).

The ring runs on 8 gloo ranks of one spawn (tests/torch_ranks.py): the
logical-sequence wrapper over all 8 in both layouts, the softcap case on a
(data 2, context 4) mesh with each data rank taking its batch row, the
per-rank entry on the 4-rank context groups, the tiny Qwen2 stack ring-
sharded over context 8, and the packed SFT step on (data 2, context 4).
`virtual_ring` (the card's check of the chunk route) runs in this process
on both chunk routes: the kernel route's blocks and lse merge run on the
flash kernels' plain versions here.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks
from vlaser_tpu_torch.kernels import ring_attention as ra

N = 8


def _inputs(b=2, s=256, h=4, kvh=2, d=16, seed=0, levels=False):
    """tests/test_ring_attention.py's inputs, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    bounds = sorted(rng.choice(np.arange(8, s - 8), size=3, replace=False))
    seg = np.zeros((b, s), np.int32)
    for bi in range(b):
        prev, sid = 0, 1
        for e in list(bounds) + [s - 4]:
            seg[bi, prev:e] = sid
            prev, sid = e, sid + 1
    lev = None
    if levels:
        lev = np.zeros((b, s), np.int32)
        lev[:, s // 2: 3 * s // 4] = 1
        lev[:, 3 * s // 4:] = 2
    return q, k, v, seg, lev


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def _valid(seg):
    # fully masked (padding) query rows: the reference's softmax degrades
    # to uniform, flash and ring give zeros; compare valid rows only
    return (seg != 0).astype(np.float32)[:, :, None, None]


# -- the ranks ----------------------------------------------------------------

def _all_gather(x, group=None, dim=0):
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _worker(rank, work):
    import torch.distributed as dist

    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core.config import tiny_llm, tiny_vlm
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.models.qwen2 import Qwen2ForCausalLM
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.train import losses
    from vlaser_tpu_torch.train.optim import make_optimizer
    from vlaser_tpu_torch.train.train_step import (make_train_step,
                                                   shard_train_state)

    cases = torch.load(os.path.join(work, "cases.pt"))
    res = {}
    cpa = ra.context_parallel_attention
    for lv in (False, True):
        q, k, v, seg, lev = cases[f"in_{lv}"]
        for causal in (False, True):
            res[f"fwd_{causal}_{lv}"] = cpa(
                q, k, v, q_segment_ids=seg, kv_segment_ids=seg, q_levels=lev,
                kv_levels=lev, causal=causal)
    q, k, v, seg, lev = cases["in_True"]
    for layout in ("contiguous", "zigzag"):
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = cpa(*qkv, q_segment_ids=seg, kv_segment_ids=seg, q_levels=lev,
                  kv_levels=lev, causal=True, layout=layout)
        grads = torch.autograd.grad((out * cases["gw"]).sum(), qkv)
        res[f"grad_{layout}"] = [out.detach(), *grads]

    mesh = mesh_lib.make_mesh(dp=2, cp=4)
    ctx = mesh.get_group(mesh_lib.CONTEXT_AXIS)
    data = mesh.get_group(mesh_lib.DATA_AXIS)
    d = mesh_lib.axis_index(mesh, mesh_lib.DATA_AXIS)
    q, k, v, seg = cases["softcap"]
    out = cpa(q[d:d + 1], k[d:d + 1], v[d:d + 1], group=ctx,
              q_segment_ids=seg[d:d + 1], kv_segment_ids=seg[d:d + 1],
              causal=True, softcap=30.0)
    res["softcap_2d"] = _all_gather(out, data)
    q, k, v, seg = cases["direct"]
    c = q.shape[1] // 4
    part = slice(mesh_lib.axis_index(mesh, mesh_lib.CONTEXT_AXIS) * c,
                 (mesh_lib.axis_index(mesh, mesh_lib.CONTEXT_AXIS) + 1) * c)
    out = ra.ring_attention(q[:, part], k[:, part], v[:, part], group=ctx,
                            q_segment_ids=seg[:, part],
                            kv_segment_ids=seg[:, part], causal=True)
    res["direct"] = _all_gather(out, ctx, dim=1)

    # the tiny Qwen2 stack ring-sharded over context 8: the loss's share
    # of this rank's slice, gradients summed over the ranks
    mesh8 = mesh_lib.make_mesh(dp=1, cp=8)
    lm = Qwen2ForCausalLM(dataclasses.replace(
        tiny_llm(), context_parallel_axis="context"),
        compute_dtype=torch.float32, device="cpu")
    load_state(lm, cases["llm_state"])
    ids, seg, labels, lmask = cases["llm_batch"]
    with mesh_lib.set_mesh(mesh8):
        logits, _, _ = lm(ids, seg_ids=seg, attn_impl="reference")
    lab = mesh_lib.context_slice(labels, mesh8)
    msk = mesh_lib.context_slice(lmask, mesh8)
    nll = -torch.log_softmax(logits.float(), -1).gather(
        -1, lab[..., None].long())[..., 0]
    loss = (nll * msk).sum() / losses._global_sum(msk.sum(), mesh8)
    loss.backward()
    grads = {n: p.grad for n, p in lm.named_parameters()}
    flat = torch.cat([g.reshape(-1) for g in grads.values()] +
                     [loss.detach().reshape(1)])
    dist.all_reduce(flat)
    res["llm_loss"] = flat[-1]
    off = 0
    for n, g in grads.items():
        grads[n] = flat[off:off + g.numel()].view_as(g)
        off += g.numel()
    res["llm_grads"] = grads

    # the packed SFT step on (data 2, context 4)
    vcfg = tiny_vlm()
    model = InternVLChatModel(dataclasses.replace(
        vcfg, llm=dataclasses.replace(vcfg.llm,
                                      context_parallel_axis="context")),
        compute_dtype=torch.float32, attn_impl="reference", device="cpu")
    load_state(model, cases["vlm_state"])
    groups, frozen = make_optimizer(model, 1e-4,
                                    frozen_patterns=(r"vision_model/",))
    sharded = shard_train_state(model, mesh)
    step = make_train_step(losses.make_sft_loss(model, mesh=mesh), groups,
                           frozen=frozen, sharded=sharded)
    batch = {k: v[d:d + 1] for k, v in cases["sft_batch"].items()}
    with mesh_lib.set_mesh(mesh):
        m = step(batch)
    res["sft"] = [m["loss"], m["grad_norm"]]
    if rank == 0:
        torch.save(res, os.path.join(work, "res.pt"))


# -- the JAX oracle and the spawn --------------------------------------------

@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from vlaser_tpu.core.config import tiny_llm as j_tiny_llm
    from vlaser_tpu.core.config import tiny_vlm as j_tiny_vlm
    from vlaser_tpu.kernels.flash_attention import attention
    from vlaser_tpu.models.qwen2 import Qwen2ForCausalLM as JLM
    from vlaser_tpu.models.vlm import InternVLChatModel as JVLM
    from vlaser_tpu.train.losses import make_sft_loss
    from vlaser_tpu.train.optim import make_optimizer
    from vlaser_tpu.train.train_step import TrainState, make_train_step
    from vlaser_tpu_torch.utils.convert import from_jax_variables

    work = tmp_path_factory.mktemp("ring")
    cases, refs = {}, {}
    for lv in (False, True):
        q, k, v, seg, lev = _inputs(levels=lv)
        cases[f"in_{lv}"] = [_t(x) for x in (q, k, v, seg, lev)]
        for causal in (False, True):
            refs[f"fwd_{causal}_{lv}"] = np.asarray(attention(
                *map(jnp.asarray, (q, k, v)), q_segment_ids=jnp.asarray(seg),
                kv_segment_ids=jnp.asarray(seg),
                q_levels=None if lev is None else jnp.asarray(lev),
                kv_levels=None if lev is None else jnp.asarray(lev),
                causal=causal, impl="reference"))
    q, k, v, seg, lev = _inputs(levels=True)
    gw = (np.random.default_rng(7).standard_normal(q.shape).astype(
        np.float32) * _valid(seg))
    cases["gw"] = _t(gw)

    def loss_ref(q, k, v):
        out = attention(q, k, v, q_segment_ids=jnp.asarray(seg),
                        kv_segment_ids=jnp.asarray(seg),
                        q_levels=jnp.asarray(lev), kv_levels=jnp.asarray(lev),
                        causal=True, impl="reference")
        return jnp.sum(out * gw)

    refs["grad"] = [np.asarray(g) for g in jax.grad(loss_ref, (0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]
    refs["grad_out"] = refs["fwd_True_True"]
    q, k, v, seg, _ = _inputs(s=128, seed=3)
    cases["softcap"] = [_t(x) for x in (q, k, v, seg)]
    refs["softcap_2d"] = np.asarray(attention(
        *map(jnp.asarray, (q, k, v)), q_segment_ids=jnp.asarray(seg),
        kv_segment_ids=jnp.asarray(seg), causal=True, softcap=30.0,
        impl="reference"))
    refs["softcap_seg"] = seg
    q, k, v, seg, _ = _inputs(b=1, s=128, seed=5)
    cases["direct"] = [_t(x) for x in (q, k, v, seg)]
    refs["direct"] = np.asarray(attention(
        *map(jnp.asarray, (q, k, v)), q_segment_ids=jnp.asarray(seg),
        kv_segment_ids=jnp.asarray(seg), causal=True, impl="reference"))
    refs["direct_seg"] = seg

    # the LLM stack (tests/test_ring_attention.py's loss, no shift)
    cfg = j_tiny_llm()
    model = JLM(cfg, compute_dtype=jnp.float32)
    rng = np.random.default_rng(0)
    b, s = 2, 64
    ids = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    lseg = np.ones((b, s), np.int32)
    lseg[:, s // 2:] = 2
    lseg[:, -4:] = 0
    labels = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    lmask = (lseg != 0).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                        seg_ids=jnp.asarray(lseg))

    def loss(p):
        logits, _, _ = model.apply(p, jnp.asarray(ids),
                                   seg_ids=jnp.asarray(lseg),
                                   attn_impl="reference")
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(lp, jnp.asarray(labels)[..., None],
                                   axis=-1)[..., 0]
        return jnp.sum(nll * lmask) / jnp.sum(lmask)

    l_ref, g_ref = jax.value_and_grad(loss)(params)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    cases["llm_state"] = from_jax_variables(np_tree(params))
    cases["llm_batch"] = [_t(x) for x in (ids, lseg, labels, lmask)]
    refs["llm_loss"] = float(l_ref)
    refs["llm_grads"] = from_jax_variables(np_tree(g_ref))

    # the SFT step (tests/test_ring_attention.py's batch)
    vcfg = j_tiny_vlm()
    vmodel = JVLM(vcfg, compute_dtype=jnp.float32, attn_impl="reference")
    rng = np.random.default_rng(0)
    B, S = 2, 32
    vids = rng.integers(1, 400, (B, S))
    vids[:, 1] = vcfg.img_context_token_id
    vlabels = vids.copy()
    vlabels[:, :4] = -100
    img = vcfg.vision.image_size
    batch = {
        "input_ids": vids.astype(np.int32),
        "labels": vlabels.astype(np.int32),
        "loss_weight": (vlabels != -100).astype(np.float32),
        "seg_ids": np.ones((B, S), np.int32),
        "pixel_values": rng.standard_normal((B, img, img, 3)).astype(
            np.float32),
        "image_flags": np.ones((B,), np.int32),
    }
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vparams = vmodel.init(jax.random.PRNGKey(0), jb["input_ids"][:1],
                          jb["pixel_values"][:1], jb["image_flags"][:1])
    tx = make_optimizer(1e-4, frozen_patterns=(r"vision_model/",),
                        params=vparams)
    state = TrainState(vparams, tx.init(vparams), jnp.zeros((), jnp.int32))
    _, m_ref = make_train_step(make_sft_loss(vmodel), tx, donate=False)(
        state, jb, jax.random.PRNGKey(1))
    cases["vlm_state"] = from_jax_variables(np_tree(vparams))
    cases["sft_batch"] = {k: _t(v) for k, v in batch.items()}
    refs["sft"] = [float(m_ref["loss"]), float(m_ref["grad_norm"])]

    torch.save(cases, os.path.join(work, "cases.pt"))
    run_ranks(_worker, N, work, str(work))
    return {"res": torch.load(os.path.join(work, "res.pt")), "refs": refs}


def _close(got, want, seg, atol):
    m = _valid(seg)
    np.testing.assert_allclose(np.asarray(got) * m, want * m, atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("levels", [False, True])
def test_ring_matches_full(ring, causal, levels):
    seg = _inputs(levels=levels)[3]
    _close(ring["res"][f"fwd_{causal}_{levels}"],
           ring["refs"][f"fwd_{causal}_{levels}"], seg, 2e-5)


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_grad_matches_full(ring, layout):
    seg = _inputs(levels=True)[3]
    out, *grads = ring["res"][f"grad_{layout}"]
    _close(out, ring["refs"]["grad_out"], seg, 2e-5)
    for got, want, name in zip(grads, ring["refs"]["grad"], "qkv"):
        np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5,
                                   err_msg=f"d{name}")


def test_ring_softcap_and_2d_mesh(ring):
    _close(ring["res"]["softcap_2d"], ring["refs"]["softcap_2d"],
           ring["refs"]["softcap_seg"], 2e-5)


def test_ring_attention_per_rank_entry(ring):
    _close(ring["res"]["direct"], ring["refs"]["direct"],
           ring["refs"]["direct_seg"], 2e-5)


def test_context_parallel_llm_stack_parity(ring):
    res, refs = ring["res"], ring["refs"]
    np.testing.assert_allclose(float(res["llm_loss"]), refs["llm_loss"],
                               rtol=1e-6)
    assert set(res["llm_grads"]) == set(refs["llm_grads"])
    for name, want in refs["llm_grads"].items():
        np.testing.assert_allclose(res["llm_grads"][name].numpy(),
                                   want.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_context_parallel_sft_train_step_parity(ring):
    (loss, gnorm), (l_ref, g_ref) = ring["res"]["sft"], ring["refs"]["sft"]
    np.testing.assert_allclose(float(loss), l_ref, rtol=1e-5)
    np.testing.assert_allclose(float(gnorm), g_ref, rtol=1e-5)


@pytest.mark.parametrize("kernel_route", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_virtual_ring_matches_full(monkeypatch, kernel_route, layout):
    """Every virtual rank's chunk steps, forward and backward, in this
    process: the rank outputs put together equal JAX's full attention
    and its gradients. The kernel route (flash fwd per block pair, lse
    merge, flash bwd on the merged out and lse) runs on the plain
    versions."""
    import jax
    import jax.numpy as jnp

    from vlaser_tpu.kernels.flash_attention import attention

    monkeypatch.setattr(ra, "_kernel_route", lambda q: kernel_route)
    n = 4
    q, k, v, seg, lev = _inputs(s=128, levels=True, seed=2)
    dout = (np.random.default_rng(3).standard_normal(q.shape).astype(
        np.float32) * _valid(seg))

    def ref(q, k, v):
        return attention(q, k, v, q_segment_ids=jnp.asarray(seg),
                         kv_segment_ids=jnp.asarray(seg),
                         q_levels=jnp.asarray(lev),
                         kv_levels=jnp.asarray(lev), causal=True,
                         impl="reference")

    jq = tuple(map(jnp.asarray, (q, k, v)))
    out_ref = np.asarray(ref(*jq))
    g_ref = jax.grad(lambda *a: jnp.sum(ref(*a) * dout), (0, 1, 2))(*jq)
    fwd, inv = (ra.zigzag_indices(n, q.shape[1]) if layout == "zigzag"
                else (np.arange(q.shape[1]),) * 2)
    perm = lambda a: _t(a[:, fwd])
    res = ra.virtual_ring(perm(q), perm(k), perm(v), n, dout=perm(dout),
                          q_segment_ids=perm(seg), q_levels=perm(lev),
                          kv_levels=perm(lev), causal=True, layout=layout)
    whole = lambda key: torch.cat([res[key][r] for r in range(n)],
                                  1).numpy()[:, inv]
    _close(whole("out"), out_ref, seg, 2e-5)
    for key, want in zip(("dq", "dk", "dv"), g_ref):
        np.testing.assert_allclose(whole(key), np.asarray(want), atol=3e-5,
                                   rtol=3e-5, err_msg=key)


def test_zigzag_layout_is_the_jax_layout():
    """zigzag_indices and the ranks' global positions equal JAX's; the
    kernel route's block pairs cover exactly the chunk pairs the causal
    mask leaves non-empty."""
    from vlaser_tpu.kernels import ring_attention as jra

    for n, s in ((2, 16), (4, 64), (8, 256)):
        for a, b in zip(ra.zigzag_indices(n, s), jra.zigzag_indices(n, s)):
            np.testing.assert_array_equal(a, b)
        c = s // n
        for r in range(n):
            np.testing.assert_array_equal(
                ra._zig_positions(r, n, c).numpy(),
                np.asarray(jra._zig_positions(r, n, c)))
            for layout in ("contiguous", "zigzag"):
                qp = ra._positions(r, n, c, layout)
                for src in range(n):
                    kp = ra._positions(src, n, c, layout)
                    mask = (qp[:, None] >= kp[None, :])
                    got = torch.zeros_like(mask)
                    for qs, ks, off in ra._pairs(r, src, n, c, layout, True):
                        i = torch.arange(qs.stop - qs.start)[:, None]
                        j = torch.arange(ks.stop - ks.start)[None]
                        got[qs, ks] |= (i + off >= j)
                    assert torch.equal(got, mask), (n, r, src, layout)


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_virtual_ring_lone_rank_runs_its_own_steps(layout):
    """virtual_ring(ranks=[r]): a lone virtual rank runs the same loops,
    the other ranks' k / v chunks standing in, so its out, lse and dq
    equal the whole ring's for that rank (its dk / dv lack the others'
    shares, which travel with the chunks)."""
    n = 4
    q, k, v, seg, _ = _inputs(s=64, levels=False, seed=4)
    dout = np.random.default_rng(5).standard_normal(q.shape).astype(
        np.float32)
    fwd = (ra.zigzag_indices(n, q.shape[1])[0] if layout == "zigzag"
           else np.arange(q.shape[1]))
    args = [_t(a[:, fwd]) for a in (q, k, v)]
    kw = dict(dout=_t(dout[:, fwd]), q_segment_ids=_t(seg[:, fwd]),
              causal=True, layout=layout)
    whole = ra.virtual_ring(*args, n, **kw)
    for r in range(n):
        lone = ra.virtual_ring(*args, n, ranks=[r], **kw)
        assert set(lone["out"]) == {r}
        for key in ("out", "lse", "dq"):
            assert torch.equal(lone[key][r], whole[key][r]), (key, r)
