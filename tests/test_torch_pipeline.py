"""The stage axis (vlaser_tpu_torch/train/pipeline.py, ShardedState over
stage) against the JAX package on the CPU: one 8-rank gloo spawn
(tests/torch_ranks.py) reads the JAX oracles, which run in the pytest
process on the 8 virtual CPU devices (tests/conftest.py) exactly as
tests/test_pipeline.py calls them, with attn_impl="reference", fp32 at
`highest` precision and that test's tolerances:

1. spmd_pipeline over the generic tanh stack at stage 4 (data 2 x stage
   4), M 4, against JAX spmd_pipeline and the sequential scan: outputs
   atol / rtol 1e-6, gradients 1e-5;
2. pipeline_llm_forward on tiny_llm at 4 layers (stage 4, M 4), 8 x 16
   tokens in packed segments that differ per row, against JAX
   pipeline_llm_forward and the JAX Qwen2ForCausalLM: logits 2e-5, layer
   gradients atol 2e-5 / rtol 2e-4; the backward's transfers zeroed and
   every microbatch given microbatch 0's segment ids (chip_smoke.py's
   controls) each break it;
3. remat=True equals remat=False;
4. the PP x FSDP step (make_pipeline_lm_loss under make_train_step) on
   data 2 x fsdp 2 x stage 2: the loss against JAX make_pipeline_lm_loss
   under JAX make_train_step (1e-4), every leaf after one AdamW step
   against the port's one-device step (within 1e-6 on all but 0.1% of the
   elements and 2 lr on those, as tests/test_torch_sharded_train.py), the
   layer leaves held as [L / 2, ...] stage slices, fsdp-split within, and
   each rank's parameter bytes equal utils/memory_budget's for the mesh;
5. the same step at fsdp 2 x stage 2 x tensor 2 against one device;
6. a tied head at data 2 x fsdp 2 x stage 2 against one device (the
   embedding's input share from stage 0, its head share from stage 1);
7. a checkpoint of the stage-sharded state holds the one-device tree bit
   for bit, and restores into another stage-sharded state and at data 8;
8. a stage axis with a context axis raises NotImplementedError naming
   both;
and, on the same spawn, models/moe.prior_slots on (data 2, fsdp 2,
context 2): a MoE slot's position within its expert is its global
token-major position.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

N_RANKS = 8
LR = 1e-3
WD = 1e-4  # optax.adamw's default decay
L4 = 4  # tiny_llm's layers here
B, S = 8, 16


def _seg(b, s):
    """Packed segment ids that differ per row: lengths rotated a row, a
    zero tail."""
    lens = (5, 6, 3)
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        order = lens[r % 3:] + lens[:r % 3]
        ofs = 0
        for k, n in enumerate(order):
            n = min(n, s - 2 - ofs)
            seg[r, ofs:ofs + n] = k + 1
            ofs += n
    return seg


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = ids.copy()
    labels[:, :3] = -100
    return {"input_ids": ids, "labels": labels, "seg_ids": _seg(B, S)}


def _rows(batch, mesh):
    from vlaser_tpu_torch.core.mesh import batch_shard

    i, n = batch_shard(mesh)
    b = next(iter(batch.values())).shape[0] // n
    return {k: torch.as_tensor(v[i * b:(i + 1) * b]) for k, v in
            batch.items()}


def _llm(cfg, state):
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.models.qwen2 import Qwen2ForCausalLM

    return load_state(Qwen2ForCausalLM(cfg, compute_dtype=torch.float32,
                                       device="cpu"), state)


def _groups(model):
    from vlaser_tpu_torch.train.train_step import ParamGroup

    return {"all": ParamGroup(list(model.parameters()), lambda i: LR, WD,
                              None)}


def _step(model, mesh=None, rules=True, m=2):
    """A one-step AdamW train step of the pipeline loss; with a mesh over
    a state sharded by stageify_rules (rules) or the default rules."""
    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.train.pipeline import make_pipeline_lm_loss
    from vlaser_tpu_torch.train.train_step import (make_train_step,
                                                   shard_train_state)

    sharded = None
    if mesh is not None:
        r = mesh_lib.default_param_rules()
        sharded = shard_train_state(model, mesh, mesh_lib.stageify_rules(r)
                                    if rules else r)
    loss = make_pipeline_lm_loss(model, n_microbatches=m, mesh=mesh,
                                 remat=False, attn_impl="reference")
    return make_train_step(loss, _groups(model), sharded=sharded), sharded


def _whole(sharded, model):
    return {n: sharded.whole(n, p, p) for n, p in model.named_parameters()}


def _moments_whole(sharded, model, opt):
    return {f"{n}/{k}": (sharded.whole(n, p, v) if v.dim() else v.clone())
            for n, p in model.named_parameters()
            for k, v in opt.state.get(p, {}).items()}


def _max_all(x):
    import torch.distributed as dist

    t = torch.tensor([float(x.detach() if torch.is_tensor(x) else x)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _excess(got, want, rtol):
    """max(|got - want| - rtol |want|) over every rank: assert_allclose
    holds at atol when this is <= atol."""
    return _max_all(((got - want).abs() - rtol * want.abs()).max())


def _stack_case(cases, mesh, res):
    """Case 2 and 3 on (data 2, stage 4): the pipelined logits and the
    layer gradients of mean(logits * tgt), summed over the ranks."""
    import torch.distributed as dist

    import chip_smoke
    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.kernels import ops
    from vlaser_tpu_torch.train import pipeline

    cfg = cases["cfg"]
    i, n = mesh_lib.batch_shard(mesh)
    b = B // n
    rows = slice(i * b, (i + 1) * b)
    ids = torch.as_tensor(cases["ids"][rows])
    seg = torch.as_tensor(cases["seg"][rows])
    tgt = torch.as_tensor(cases["tgt"][rows])
    pos = torch.arange(S)[None].expand(b, S)
    cos, sin = ops.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)

    def run(remat=False):
        model = _llm(cfg, cases["llm_state"])
        h = pipeline.pipeline_llm_forward(
            cfg, model.model.layers, model.embed(ids), cos, sin, seg,
            n_microbatches=4, mesh=mesh, compute_dtype=torch.float32,
            remat=remat, attn_impl="reference")
        logits = model.logits(model.model.norm(h))
        (logits * tgt).sum().div(tgt.numel() * n).backward()
        grads = {}
        for name, p in model.model.layers.named_parameters():
            g = p.grad.clone()
            dist.all_reduce(g)  # each stage's chunk, each data rank's rows
            grads[name] = g
        return logits.detach(), grads

    def errs(logits, grads, want_logits, want_grads):
        return [_excess(logits, want_logits[rows], 2e-5),
                max(_excess(g, want_grads[k], 2e-4)
                    for k, g in grads.items())]

    logits, grads = run()
    res["stack"] = (errs(logits, grads, cases["logits_ref"], cases["g_ref"])
                    + errs(logits, grads, cases["logits_pp"], cases["g_pp"]))
    with chip_smoke.pp_backward_dropped(pipeline):
        c = run()
    res["stack_drop"] = errs(*c, cases["logits_ref"], cases["g_ref"])
    with chip_smoke.pp_consts_misrouted(pipeline):
        c = run()
    res["stack_misroute"] = errs(*c, cases["logits_ref"], cases["g_ref"])
    r_logits, r_grads = run(remat=True)
    res["remat"] = [_max_all((r_logits - logits).abs().max()),
                    _max_all(max(float((r_grads[k] - g).abs().max())
                                 for k, g in grads.items()))]


def _moe_positions(mesh):
    """models/moe.prior_slots on a rank's block of rows and context slice
    of a global batch of routed slots: each slot's position, this rank's
    cumsum plus the slots ahead of it, against the global batch's
    token-major cumsum; -> the largest |difference| over the ranks."""
    import torch.nn.functional as F

    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.models.moe import BatchRanks, prior_slots

    E, k, rows, seq = 6, 2, 8, 12
    g = torch.Generator().manual_seed(3)
    experts = torch.stack([torch.randperm(E, generator=g)[:k]
                           for _ in range(rows * seq)]).reshape(rows, seq, k)
    oh = F.one_hot(experts.reshape(-1), E)
    want = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1).reshape(rows, seq, k)
    i, n = mesh_lib.batch_shard(mesh)
    cp = mesh_lib.axis_size(mesh, mesh_lib.CONTEXT_AXIS)
    b = rows // n
    mine = mesh_lib.context_slice(experts[i * b:(i + 1) * b], mesh)
    want = mesh_lib.context_slice(want[i * b:(i + 1) * b], mesh)
    s = mine.shape[1]
    oh = F.one_hot(mine.reshape(-1), E)
    pos = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1)
    group, size = mesh_lib.batch_group(mesh)
    ahead = prior_slots(oh, b, BatchRanks(group, size, cp))
    got = pos + ahead[torch.arange(b * s * k) // (s * k), mine.reshape(-1)]
    return _max_all((got.reshape(want.shape) - want).abs().max())


def _worker(rank, work):
    import torch.distributed as dist

    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.train.pipeline import spmd_pipeline
    from vlaser_tpu_torch.train.train_step import ShardedState
    from vlaser_tpu_torch.utils import memory_budget as mb
    from vlaser_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)

    cases = torch.load(os.path.join(work, "cases.pt"), weights_only=False)
    res = {}

    # 1. the generic stack at (data 2, stage 4); x and scale replicated
    mesh = mesh_lib.make_mesh(dp=2, pp=4)
    w = torch.as_tensor(cases["w"]).requires_grad_()
    x, sc = torch.as_tensor(cases["x"]), torch.as_tensor(cases["scale"])

    def stage_fn(pw, h, c):
        for wl in pw:
            h = torch.tanh(h @ wl) + c
        return h

    out = spmd_pipeline(stage_fn, n_microbatches=4, mesh=mesh)(w, x, sc)
    (out ** 2).sum().backward()
    g = w.grad.clone()
    dist.all_reduce(g, group=mesh.get_group("stage"))
    res["generic"] = [_excess(out, cases["seq"], 1e-6),
                      _excess(out, cases["seq_pp"], 1e-6),
                      _excess(g, cases["g_seq"], 1e-5),
                      _excess(g, cases["g_seq_pp"], 1e-5)]

    # 2-3. the Qwen2 stack, its controls, remat
    _stack_case(cases, mesh, res)

    cfg, batch = cases["cfg"], cases["batch"]
    # 4. PP x FSDP at (data 2, fsdp 2, stage 2)
    mesh = mesh_lib.make_mesh(dp=-1, fsdp=2, pp=2)
    model = _llm(cfg, cases["llm_state"])
    step, sharded = _step(model, mesh)
    loss = float(step(_rows(batch, mesh))["loss"])
    q = model.model.layers.self_attn.q_proj.kernel
    amesh = mb._abstract_mesh(2, 2, 1, 2)
    want_bytes = mb.sharded_bytes_per_device(
        mb.param_leaves(model.__class__(cfg, device=torch.device("meta"))),
        amesh, mesh_lib.stageify_rules(mesh_lib.default_param_rules()))
    res["ppfsdp"] = [loss, _whole(sharded, model), tuple(q.shape),
                     model.model.layers.self_attn.q_proj._staged,
                     sharded.bytes_per_rank(), want_bytes]

    # 7. the checkpoint of that state
    ck = os.path.join(work, "ck_pp")
    save_checkpoint(ck, 1, model, step)
    want = (_whole(sharded, model),
            _moments_whole(sharded, model, step.optimizer))
    other = {k: v + 1 for k, v in cases["llm_state"].items()}
    m2 = _llm(cfg, other)
    step2, sh2 = _step(m2, mesh)
    restore_checkpoint(ck, m2, step2)
    got = (_whole(sh2, m2), _moments_whole(sh2, m2, step2.optimizer))
    mesh8 = mesh_lib.make_mesh(dp=8)
    m8 = _llm(cfg, other)
    step8, sh8 = _step(m8, mesh8, rules=False)
    restore_checkpoint(ck, m8, step8)
    got8 = (_whole(sh8, m8), _moments_whole(sh8, m8, step8.optimizer))
    equal = lambda a, b: rank != 0 or (a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) for k in a))
    if rank == 0:
        from vlaser_tpu_torch.utils.hf_convert import load_safetensors

        files = load_safetensors(os.path.join(ck, "1", "params.safetensors"))
    res["ckpt"] = [equal(got[0], want[0]), equal(got[1], want[1]),
                   equal(got8[0], want[0]), equal(got8[1], want[1]),
                   rank != 0 or equal(dict(files), want[0]), step2.count]

    # 5. stage x tensor at (fsdp 2, stage 2, tensor 2)
    from vlaser_tpu_torch.core.tensor_parallel import shard_for_training

    mesh = mesh_lib.make_mesh(dp=1, fsdp=2, pp=2, tp=2)
    model = shard_for_training(_llm(cfg, cases["llm_state"]), mesh)
    step, sharded = _step(model, mesh)
    loss = float(step(_rows(batch, mesh))["loss"])
    res["pptp"] = [loss, _whole(sharded, model),
                   model.model.layers.self_attn.heads,
                   model.lm_head.tp is not None]

    # 6. a tied head at (data 2, fsdp 2, stage 2)
    tcfg = cases["tied_cfg"]
    mesh = mesh_lib.make_mesh(dp=-1, fsdp=2, pp=2)
    model = _llm(tcfg, cases["tied_state"])
    step, sharded = _step(model, mesh)
    m = step(_rows(batch, mesh))
    res["tied"] = [float(m["loss"]), float(m["grad_norm"]),
                   _whole(sharded, model)]

    # the MoE slots' global positions over (data 2, fsdp 2, context 2)
    res["moe_positions"] = _moe_positions(
        mesh_lib.make_mesh(dp=2, fsdp=2, cp=2))

    # 8. stage x context
    mesh = mesh_lib.make_mesh(dp=2, pp=2, cp=2)
    try:
        ShardedState(_llm(cfg, cases["llm_state"]), mesh)
        res["context"] = "no error"
    except NotImplementedError as e:
        res["context"] = str(e)
    if rank == 0:
        torch.save(res, os.path.join(work, "res.pt"))


# -- the JAX oracles and the spawn --------------------------------------------

def _jax_generic(jax, jnp, spmd_pipeline, mesh4):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 16, 16)).astype(np.float32) * 0.3
    x = rng.standard_normal((B, 16)).astype(np.float32)
    sc = rng.standard_normal((B, 16)).astype(np.float32)

    def seq(w, x, c):
        return jax.lax.scan(lambda h, wl: (jnp.tanh(h @ wl) + c, None),
                            x, w)[0]

    def stage_fn(pw, h, c):
        return seq(pw, h, c)

    run = spmd_pipeline(stage_fn, n_microbatches=4, mesh=mesh4)
    with jax.set_mesh(mesh4):
        out_pp = jax.jit(run)(w, x, sc)
        g_pp = jax.jit(jax.grad(lambda w: jnp.sum(run(w, x, sc) ** 2)))(w)
    g_seq = jax.grad(lambda w: jnp.sum(seq(w, x, sc) ** 2))(w)
    a = np.array
    return {"w": w, "x": x, "scale": sc, "seq": torch.as_tensor(a(seq(
        w, x, sc))), "seq_pp": torch.as_tensor(a(out_pp)),
        "g_seq": torch.as_tensor(a(g_seq)),
        "g_seq_pp": torch.as_tensor(a(g_pp))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from vlaser_tpu.core import mesh as jmesh
    from vlaser_tpu.core.config import tiny_llm
    from vlaser_tpu.kernels import ops as jops
    from vlaser_tpu.models.qwen2 import Qwen2ForCausalLM as JLM
    from vlaser_tpu.train import pipeline as jpipe
    from vlaser_tpu.train.train_step import (TrainState, make_train_step,
                                             shard_train_state)
    from vlaser_tpu_torch.utils.convert import from_jax_variables

    work = tmp_path_factory.mktemp("pipeline")
    a = np.array
    port = lambda t: from_jax_variables(jax.tree_util.tree_map(a, t))
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("stage",))
    cases = _jax_generic(jax, jnp, jpipe.spmd_pipeline, mesh4)

    # 2. the Qwen2 stack (test_pipeline.py's case on packed segments)
    cfg = dataclasses.replace(tiny_llm(), num_layers=L4)
    model = JLM(cfg, compute_dtype=jnp.float32)
    batch = _batch(cfg, 1)
    ids, seg = jnp.asarray(batch["input_ids"], jnp.int32), jnp.asarray(
        batch["seg_ids"])
    params = model.init(jax.random.PRNGKey(0), ids, seg_ids=seg)
    p = params["params"]
    logits_ref, _, _ = model.apply(params, ids, seg_ids=seg,
                                   attn_impl="reference")
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    cos, sin = jops.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    tgt = np.random.default_rng(2).standard_normal(
        logits_ref.shape).astype(np.float32)

    def head_side(h):
        from vlaser_tpu.models.layers import Dense, RMSNorm

        h = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, jnp.float32).apply(
            {"params": p["model"]["norm"]}, h)
        return Dense(cfg.vocab_size, use_bias=False,
                     compute_dtype=jnp.float32).apply(
            {"params": p["lm_head"]}, h)

    def pp_logits(lp):
        h = jpipe.pipeline_llm_forward(
            cfg, lp, p["embed_tokens"]["embedding"][ids], cos, sin, seg,
            n_microbatches=4, mesh=mesh4, compute_dtype=jnp.float32,
            remat=False, attn_impl="reference")
        return head_side(h)

    def loss_ref(lp):
        p2 = jax.tree_util.tree_map(lambda x: x, params)
        p2["params"]["model"]["layers"] = lp
        lg, _, _ = model.apply(p2, ids, seg_ids=seg, attn_impl="reference")
        return jnp.mean(lg * tgt)

    layers = p["model"]["layers"]
    with jax.set_mesh(mesh4):
        logits_pp = jax.jit(pp_logits)(layers)
        g_pp = jax.jit(jax.grad(lambda lp: jnp.mean(pp_logits(lp) * tgt)))(
            layers)
    g_ref = jax.grad(loss_ref)(layers)
    prefix = "model.layers."
    cases.update(
        cfg=cfg, ids=batch["input_ids"], seg=batch["seg_ids"], tgt=tgt,
        batch=batch, llm_state=port(params),
        logits_ref=torch.as_tensor(a(logits_ref)),
        logits_pp=torch.as_tensor(a(logits_pp)),
        g_ref={k[len(prefix):]: v for k, v in port(
            {"params": {"model": {"layers": g_ref}}}).items()},
        g_pp={k[len(prefix):]: v for k, v in port(
            {"params": {"model": {"layers": g_pp}}}).items()})

    # 4. JAX's PP x FSDP step (test_pipeline.py's) on the same batch
    jm = jmesh.make_mesh(dp=-1, fsdp=2, tp=1, pp=2, devices=jax.devices()[:8])
    tx = optax.adamw(LR)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    state, _ = shard_train_state(
        state, jm, rules=jmesh.stageify_rules(jmesh.default_param_rules()))
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    jb = jax.device_put(jb, jmesh.shard_batch(jb, jm))
    loss_fn = jpipe.make_pipeline_lm_loss(
        cfg, n_microbatches=2, mesh=jm, compute_dtype=jnp.float32,
        remat=False, attn_impl="reference")
    with jax.set_mesh(jm):
        _, metrics = make_train_step(loss_fn, tx, donate=False)(
            state, jb, jax.random.PRNGKey(1))
    refs = {"jax_loss": float(metrics["loss"])}

    # the port's one-device steps: untied, tied
    m1 = _llm(cfg, cases["llm_state"])
    step, _ = _step(m1)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    refs["one"] = [float(step(tb)["loss"]), {
        n: q.detach().clone() for n, q in m1.named_parameters()}]
    tcfg = dataclasses.replace(cfg, tie_word_embeddings=True)
    tstate = {k: v for k, v in cases["llm_state"].items()
              if not k.startswith("lm_head")}
    cases.update(tied_cfg=tcfg, tied_state=tstate)
    mt = _llm(tcfg, tstate)
    step, _ = _step(mt)
    m = step(tb)
    refs["tied"] = [float(m["loss"]), float(m["grad_norm"]), {
        n: q.detach().clone() for n, q in mt.named_parameters()}]

    torch.save(cases, os.path.join(work, "cases.pt"))
    run_ranks(_worker, N_RANKS, work, str(work))
    return {"res": torch.load(os.path.join(work, "res.pt"),
                              weights_only=False),
            "refs": refs, "start": cases["llm_state"],
            "tied_start": tstate}


def _hold_params(got, want, start):
    """Every leaf within 1e-6 of one device's on all but 0.1% of the
    elements and 2 lr on those (test_torch_sharded_train.py's bound), and
    moved by the step."""
    assert sorted(got) == sorted(want)
    n_off = n_all = 0
    for name, w in want.items():
        p, w = got[name].numpy(), w.numpy()
        diff = np.abs(p - w)
        assert diff.max() <= 2 * LR, name
        assert np.abs(p - start[name].numpy()).max() > 0, name
        n_off += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_generic_schedule_matches_jax_and_the_sequential_scan(runs):
    """Outputs atol / rtol 1e-6, gradients 1e-5 (each figure is
    max(|d| - rtol |want|), held to atol)."""
    seq, seq_pp, g_seq, g_pp = runs["res"]["generic"]
    assert seq <= 1e-6 and seq_pp <= 1e-6, (seq, seq_pp)
    assert g_seq <= 1e-5 and g_pp <= 1e-5, (g_seq, g_pp)


def test_qwen2_stack_matches_jax(runs):
    """Logits atol / rtol 2e-5 against the JAX model and the JAX pipeline;
    layer gradients atol 2e-5, rtol 2e-4."""
    l_ref, g_ref, l_pp, g_pp = runs["res"]["stack"]
    assert l_ref <= 2e-5 and l_pp <= 2e-5, (l_ref, l_pp)
    assert g_ref <= 2e-5 and g_pp <= 2e-5, (g_ref, g_pp)


def test_both_controls_break_the_stack_gate(runs):
    """Zeroed backward transfers leave stages 0-2's layers without their
    gradients; microbatch 0's segment ids on every microbatch move the
    logits."""
    _, g_drop = runs["res"]["stack_drop"]
    l_mis, _ = runs["res"]["stack_misroute"]
    assert g_drop > 100 * 2e-5, g_drop
    assert l_mis > 100 * 2e-5, l_mis


def test_remat_equals_no_remat(runs):
    d_logits, d_grads = runs["res"]["remat"]
    assert d_logits <= 1e-6 and d_grads <= 1e-6, (d_logits, d_grads)


def test_pp_fsdp_step_matches_jax_and_one_device(runs):
    loss, params, *_ = runs["res"]["ppfsdp"]
    np.testing.assert_allclose(loss, runs["refs"]["jax_loss"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(loss, runs["refs"]["one"][0], rtol=1e-5)
    _hold_params(params, runs["refs"]["one"][1], runs["start"])


def test_layer_leaves_are_stage_slices_and_bytes_match_the_budget(runs):
    """q_proj [4, 64, 64] is held as [2, 32, 64]: this stage's 2 layers,
    fsdp 2 over its input dim; every rank's parameter bytes equal
    memory_budget.sharded_bytes_per_device under stageify_rules."""
    _, _, shape, staged, held, want = runs["res"]["ppfsdp"]
    assert shape == (L4 // 2, 32, 64), shape
    assert set(staged.values()) == {0}  # rank 0 holds layers 0-1
    assert held == want, (held, want)


def test_stage_by_tensor_step_matches_one_device(runs):
    loss, params, heads, vocab_cut = runs["res"]["pptp"]
    assert heads == 2 and vocab_cut  # 4 / 2 heads and the head cut
    np.testing.assert_allclose(loss, runs["refs"]["one"][0], rtol=1e-5)
    _hold_params(params, runs["refs"]["one"][1], runs["start"])


def test_tied_head_step_matches_one_device(runs):
    loss, gnorm, params = runs["res"]["tied"]
    want_loss, want_norm, want = runs["refs"]["tied"]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(gnorm, want_norm, rtol=1e-5)
    _hold_params(params, want, runs["tied_start"])


def test_checkpoint_round_trips_bit_for_bit(runs):
    """Saved at (data 2, fsdp 2, stage 2): the file holds the one-device
    tree; it restores into another stage-sharded state and at data 8, bit
    for bit, moments and step count included."""
    *equal, count = runs["res"]["ckpt"]
    assert all(equal), equal
    assert count == 1


def test_moe_positions_are_the_global_batchs_over_context(runs):
    """With a capacity factor a MoE slot's position within its expert is
    its global token-major position: this rank's cumsum plus
    models/moe.prior_slots, on (data 2, fsdp 2, context 2), where a rank
    holds a context slice of each of its rows."""
    assert runs["res"]["moe_positions"] == 0


def test_stage_with_context_raises(runs):
    msg = runs["res"]["context"]
    assert "'stage'" in msg and "'context'" in msg, msg

