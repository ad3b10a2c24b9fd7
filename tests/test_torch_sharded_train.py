"""The port's ZeRO-3 train state over a torch.distributed mesh
(train/train_step.shard_train_state, the trainers' mesh_fsdp, the
losses' normalisation over ranks, utils/checkpoint on a sharded state)
against the JAX package's one-device steps on the CPU, on 8 gloo ranks of
one spawn (tests/torch_ranks.py), the cases of tests/test_sharding.py:

- the tiny VLA step (frozen ViT, AdamW) at data 4 x fsdp 2 on the batch's
  own t and x0: loss and grad norm within 1e-4 (test_sharding.py:81),
  the updated parameters within 1e-6 on all but 0.1% of the elements and
  2 lr on those (Adam's g / (|g| + eps) at a gradient near its fp32 noise
  floor, as test_torch_vla_trainer.py), the frozen ViT bit for bit;
- the VLATrainer's own flow draws: every rank draws the global batch's t
  and x0 and keeps its rows, so the sharded step equals the port's
  one-device step from the same generator (loss and norm within 1e-5,
  fp32 summation order; parameters as above);
- gradient accumulation over [2, 16] micro batches at data 4 x fsdp 2
  against JAX's step on the 32-row batch (test_sharding.py:93-130);
- SFTTrainer and MPOTrainer at fsdp 2 (data 4), two steps each, against
  the JAX trainers on one device: losses within 1e-5 (MPO's parts 2e-3,
  as test_torch_mpo.py), grad norms within 1e-4, parameters as above;
  each rank's rows hold another number of trained tokens, so the loss
  only matches if numerator and denominator are reduced apart;
- each rank's parameter, gradient and AdamW moment bytes equal
  utils/memory_budget's per-device terms for the mesh, and the gathered
  weights alive at once stay within the split leaves outside a stack plus
  one layer of each stack;
- a checkpoint saved at fsdp 2 restores at fsdp 1 (data 8) bit for bit,
  and the reverse;
- 8-bit AdamW over fsdp 2 raises NotImplementedError.

The tensor axis (core/tensor_parallel.shard_for_training), on the same
spawn:

- the cases above at JAX's mesh (data 2, fsdp 2, tensor 2) against the
  same JAX one-device steps: the VLA step, its accumulation, the
  VLATrainer's draws, SFTTrainer and MPOTrainer (the SFT CE
  vocab-parallel), 8-bit AdamW raising over tensor;
- the KV pick: the tiny LLM's 4 / 2 heads at (data 2, tensor 4), every
  gradient and the grad norm against one device's (the port's), a
  control that sums the copies over the batch ranks only;
- the MoE: the tiny Qwen3-MoE with its router loss at capacity factor
  1.25 at (2, 2, 2), the router's gradient and every leaf against one
  device's, a control without the stacks' `enter` and one whose capacity
  counts the rank's own tokens;
- the vocab-parallel chunked CE and the three collectives' backward
  passes at tensor 4 against their one-device functions;
- a checkpoint of a VLA whose ViT attention is cut (the strided qkv)
  saved at (fsdp 2, tensor 2) restores at data 8 bit for bit, and the
  reverse; the KV pick's restores at data 8;
- each rank's parameter, gradient and moment bytes: the JAX budget plus
  the port's deliberate copies (_port_bytes).
"""

import os
import types

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

N_RANKS = 8
LR = 1e-3
KEYS = ("input_ids", "pixel_values", "text_mask", "proprios", "actions", "t",
        "x0")


def _vla_batch(cfg, B, seed, fixed=False):
    rng = np.random.default_rng(seed)
    S, img = cfg.max_image_text_tokens, cfg.vlm.vision.image_size
    ids = rng.integers(1, 400, (B, S)).astype(np.int32)
    ids[:, 2] = cfg.vlm.img_context_token_id
    A = (B, cfg.num_action_tokens, cfg.action_dim)
    out = dict(
        input_ids=ids, text_mask=np.ones((B, S), np.int32),
        pixel_values=rng.standard_normal((B, img, img, 3)).astype(np.float32),
        proprios=rng.standard_normal(
            (B, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32),
        actions=rng.standard_normal(A).astype(np.float32))
    if fixed:  # test_sharding.py's deterministic loss: t 0.5, x0 0.1
        out["t"] = np.full((B,), 0.5, np.float32)
        out["x0"] = np.full(A, 0.1, np.float32)
    else:
        out["t"] = rng.uniform(0, 1, B).astype(np.float32)
        out["x0"] = rng.standard_normal(A).astype(np.float32)
    return out


def _sft_batch(cfg, B, seed):
    """Padded rows, each with another number of prompt tokens (-100) and
    its own loss weights."""
    rng = np.random.default_rng(seed)
    n, img = 24, cfg.vision.image_size
    ids = rng.integers(1, 400, (B, n)).astype(np.int32)
    ids[:, 1] = cfg.img_context_token_id
    labels = ids.copy()
    for i in range(B):
        labels[i, :3 + 2 * i] = -100
    return {
        "input_ids": ids, "labels": labels,
        "loss_weight": rng.uniform(0.5, 1.5, (B, n)).astype(np.float32),
        "seg_ids": np.ones((B, n), np.int32),
        "pixel_values": rng.standard_normal((B, img, img, 3)).astype(
            np.float32),
        "image_flags": np.ones((B,), np.int32),
    }


def _pair_batch(cfg, B, seed):
    """preference_collate's layout, one tile a pair, rejected rows shorter
    by a row-dependent count."""
    rng = np.random.default_rng(seed)
    n, img = 32, cfg.vision.image_size
    out = {}
    prompt = rng.integers(1, 400, (B, 10))
    prompt[:, 1:1 + cfg.num_image_token] = cfg.img_context_token_id
    for side in ("chosen", "rejected"):
        ids = np.full((B, n), cfg.pad_token_id, np.int64)
        labels = np.full((B, n), -100, np.int64)
        seg = np.zeros((B, n), np.int32)
        for i in range(B):
            m = n - (i % 5) - (7 if side == "rejected" else 0)
            resp = rng.integers(1, 400, m - 10)
            ids[i, :m] = np.concatenate([prompt[i], resp])
            labels[i, 10:m] = resp
            seg[i, :m] = 1
        out[f"{side}_input_ids"] = ids
        out[f"{side}_labels"] = labels
        out[f"{side}_seg_ids"] = seg
    out["pixel_values"] = rng.standard_normal((B, img, img, 3)).astype(
        np.float32)
    out["image_flags"] = np.ones((B,), np.int32)
    return out


# -- the ranks ----------------------------------------------------------------

def _rows(batch, index, count, dim=0):
    out = {}
    for k, v in batch.items():
        b = v.shape[dim] // count
        out[k] = v.narrow(dim, index * b, b) if torch.is_tensor(v) else v
    return out


def _full(sharded, model):
    return {n: sharded.full(p, p.detach()).clone()
            for n, p in model.named_parameters()}


def _moments(sharded, model, opt):
    out = {}
    for n, p in model.named_parameters():
        for key, v in opt.state.get(p, {}).items():
            out[f"{n}/{key}"] = (sharded.full(p, v) if v.dim() else v).clone()
    return out


def _whole(sharded, model):
    """{name: the one-device parameter} on rank 0 (None elsewhere)."""
    return {n: sharded.whole(n, p, p) for n, p in model.named_parameters()}


def _moments_whole(sharded, model, opt):
    out = {}
    for n, p in model.named_parameters():
        for key, v in opt.state.get(p, {}).items():
            out[f"{n}/{key}"] = (sharded.whole(n, p, v) if v.dim()
                                 else v.clone())
    return out


def _vla(cfg, state, lr, frozen_vit=True, mesh=None):
    """A port VLA from `state`, cut over the mesh's tensor axis before its
    optimizer groups are made."""
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.train.optim import make_optimizer
    from vlaser_tpu_torch.core.tensor_parallel import shard_for_training

    model = shard_for_training(load_state(PiZeroVLA(
        cfg, compute_dtype=torch.float32, attn_impl="reference",
        device="cpu"), state), mesh)
    groups, frozen = make_optimizer(
        model, lr, frozen_patterns=(r"vision_model/",) if frozen_vit else ())
    return model, groups, frozen


def _det_step(model, groups, frozen, mesh, accum=1):
    """The train step on the batch's own t and x0: each rank's share of
    the global mean (over the batch ranks)."""
    from vlaser_tpu_torch.core.mesh import batch_shard
    from vlaser_tpu_torch.train.train_step import (make_train_step,
                                                   shard_train_state)

    sharded = shard_train_state(model, mesh)
    count = batch_shard(mesh)[1]
    step = make_train_step(lambda b: model(*(b[k] for k in KEYS)) / count,
                           groups, accum_steps=accum, frozen=frozen,
                           sharded=sharded)
    return step, sharded


def _worker(rank, work):
    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core.config import tiny_vla, tiny_vlm
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.train import mpo
    from vlaser_tpu_torch.train.trainer import (SFTTrainer, TrainConfig,
                                                VLATrainConfig, VLATrainer)
    from vlaser_tpu_torch.utils import memory_budget as mb
    from vlaser_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)

    cases = torch.load(os.path.join(work, "cases.pt"))
    res = {}
    cfg = tiny_vla(max_image_text_tokens=16)
    mesh = mesh_lib.make_mesh(dp=4, fsdp=2)
    index, count = mesh_lib.batch_shard(mesh)

    # the VLA step at data 4 x fsdp 2, frozen ViT
    model, groups, frozen = _vla(cfg, cases["vla_state"], 1e-4)
    step, sharded = _det_step(model, groups, frozen, mesh)
    m = step(_rows(cases["vla_batch"], index, count))
    res["vla"] = [m["loss"], m["grad_norm"], _full(sharded, model)]
    # the bytes each rank holds against utils/memory_budget's terms
    meta = PiZeroVLA(cfg, compute_dtype=torch.float32,
                     device=torch.device("meta"))
    leaves = mb.param_leaves(meta)
    amesh = mb._abstract_mesh(4, 2, 1)
    rules = mesh_lib.default_param_rules()
    trained = [p for g in groups.values() for p in g.params]
    res["bytes"] = [
        sharded.bytes_per_rank(),
        mb.sharded_bytes_per_device(leaves, amesh, rules),
        sum(st[k].numel() * st[k].element_size() for p in trained
            for st in [step.optimizer.state[p]]
            for k in ("exp_avg", "exp_avg_sq")),
        2 * mb.sharded_bytes_per_device(
            mb._cast(mb._drop_frozen(leaves, (r"vision_model/",)), 4),
            amesh, rules),
        sum(d is not None for d in sharded.dims.values())]
    # gradients and gathered weights: a rank's trained gradients are the
    # budget's grads term (shards), its frozen ones shards too; the
    # gathered weights alive at once stay within the whole split leaves
    # outside a stack plus one layer of every stack, below the whole
    # split leaves
    gbytes = lambda ps: sum(p.grad.numel() * p.grad.element_size()
                            for p in ps)
    root = layer = 0
    for mod in model.modules():
        for leaf in getattr(mod, "_gathered", None) or {}:
            p = getattr(mod, leaf)
            whole = p.numel() * p.element_size() * sharded.fsdp
            root += 0 if mod.stacked else whole
            layer += whole // p.shape[0] if mod.stacked else 0
    whole_split = sum(p.numel() * p.element_size() * sharded.fsdp
                      for p in sharded.split)
    res["grads"] = [
        gbytes(trained),
        mb.sharded_bytes_per_device(
            mb._cast(mb._drop_frozen(leaves, (r"vision_model/",)), 4),
            amesh, rules),
        gbytes(frozen),
        mb.sharded_bytes_per_device(leaves, amesh, rules)
        - mb.sharded_bytes_per_device(
            mb._drop_frozen(leaves, (r"vision_model/",)), amesh, rules),
        sharded.peak_gathered, root + layer, whole_split]

    # checkpoints: fsdp 2 -> fsdp 1 (data 8) and back
    ck = os.path.join(work, "ck")
    save_checkpoint(ck, 1, model, step)
    want = (_full(sharded, model), _moments(sharded, model, step.optimizer))
    mesh1 = mesh_lib.make_mesh(dp=8, fsdp=1)
    other = {k: v + 1 for k, v in cases["vla_state"].items()}
    model1, g1, f1 = _vla(cfg, other, 1e-4)
    step1, sh1 = _det_step(model1, g1, f1, mesh1)
    restore_checkpoint(ck, model1, step1)
    got = (_full(sh1, model1), _moments(sh1, model1, step1.optimizer))
    res["ck_2_to_1"] = [all(torch.equal(got[i][k], want[i][k])
                            for k in want[i]) and got[i].keys() == want[i]
                        .keys() for i in range(2)] + [step1.count]
    ck1 = os.path.join(work, "ck1")
    save_checkpoint(ck1, 1, model1, step1)
    model2, g2, f2 = _vla(cfg, other, 1e-4)
    step2, sh2 = _det_step(model2, g2, f2, mesh)
    restore_checkpoint(ck1, model2, step2)
    back = (_full(sh2, model2), _moments(sh2, model2, step2.optimizer))
    res["ck_1_to_2"] = [all(torch.equal(back[i][k], got[i][k])
                            for k in got[i]) for i in range(2)] + [
        step2.count, sum(p.numel() for p in model2.parameters()) <
        sum(p.numel() for p in model1.parameters())]

    # gradient accumulation: [2, 16] micro batches
    model, groups, frozen = _vla(cfg, cases["vla_state"], LR,
                                 frozen_vit=False)
    step, sharded = _det_step(model, groups, frozen, mesh, accum=2)
    m = step(_rows(cases["accum_batch"], index, count, dim=1))
    res["accum"] = [m["loss"], m["grad_norm"], _full(sharded, model)]

    # the VLATrainer's own draws against its one-device step
    def trainer(mesh_):
        model = load_state(PiZeroVLA(cfg, compute_dtype=torch.float32,
                                     attn_impl="reference", device="cpu"),
                           cases["vla_state"])
        return VLATrainer(model, VLATrainConfig(
            lr_action=LR, lr_vlm=LR, warmup_steps=0, log_every=1),
            generator=torch.Generator().manual_seed(5), mesh=mesh_)

    tr = trainer(mesh)
    batch = {k: v for k, v in cases["vla_batch"].items()
             if k not in ("t", "x0")}
    m = tr.train_steps(iter([_rows(batch, index, count)]), 1)
    full = _full(tr.sharded, tr.model)
    if rank == 0:
        solo = trainer(None)
        ms = solo.train_steps(iter([batch]), 1)
        diffs = torch.cat([(full[n].detach() - p.detach()).abs().reshape(-1)
                           for n, p in solo.model.named_parameters()])
        res["draws"] = [m["loss"], ms["loss"], m["grad_norm"],
                        ms["grad_norm"], float(diffs.max()),
                        int((diffs > 1e-6).sum()), diffs.numel()]
    try:
        VLATrainer(load_state(PiZeroVLA(cfg, compute_dtype=torch.float32,
                                        device="cpu"), cases["vla_state"]),
                   VLATrainConfig(optimizer_8bit=True), mesh=mesh)
        res["adam8bit"] = "no error"
    except NotImplementedError as e:
        res["adam8bit"] = str(e)

    # SFTTrainer and MPOTrainer at fsdp 2 (data 4), two steps each
    vcfg = tiny_vlm()
    model = load_state(InternVLChatModel(
        vcfg, compute_dtype=torch.float32, attn_impl="reference",
        device="cpu"), cases["vlm_state"])
    tr = SFTTrainer(model, TrainConfig(learning_rate=LR, total_steps=2,
                                       log_every=1, mesh_fsdp=2))
    res["sft"] = []
    for b in cases["sft_batches"]:
        m = tr.train(iter([_rows(b, index, count)]))
        res["sft"].append([m["loss"], m["grad_norm"]])
    res["sft_params"] = _full(tr.sharded, model)
    model = load_state(InternVLChatModel(
        vcfg, compute_dtype=torch.float32, attn_impl="reference",
        device="cpu"), cases["vlm_state"])
    pt = mpo.MPOTrainer(model, mpo.MPOConfig(), TrainConfig(
        learning_rate=LR, total_steps=2, mesh_fsdp=2))
    res["mpo"] = [{k: v.clone() for k, v in pt.train(
        iter([_rows(b, index, count)]), 1).items()}
        for b in cases["mpo_batches"]]
    res["mpo_running"] = float(pt.running.mean)
    res["mpo_params"] = _full(pt.sharded, model)
    res["mpo_ref_kept"] = all(
        torch.equal(pt.sharded.full(p, pt.ref_params[n]),
                    cases["vlm_state"][n])
        for n, p in model.named_parameters())
    _tp_worker(rank, work, cases, res, solo if rank == 0 else None)
    if rank == 0:
        torch.save(res, os.path.join(work, "res.pt"))


# -- the tensor axis -----------------------------------------------------------

def _port_bytes(leaves, amesh, kv_pick=False, vit_whole=True):
    """The bytes a rank holds of `leaves` under the port's tensor layout:
    utils/memory_budget's per-device bytes under the JAX rules plus the
    port's deliberate differences (core/tensor_parallel), each leaf's
    exactly: mlp1 whole (the JAX rules split its columns); a ViT with q/k
    norms keeps its attention whole; column-parallel biases cut with
    their columns (replicated in JAX); a KV "pick" holds one head's
    columns of k / v (a copy; JAX splits head_dim), 1 / kv of them."""
    import re

    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.utils import memory_budget as mb

    f, t = mesh_lib.FSDP_AXIS, mesh_lib.TENSOR_AXIS
    mine = []
    if kv_pick:
        mine += [(r"layers/.*(k_proj|v_proj)/kernel", (None, f, "kv")),
                 (r"layers/.*(k_proj|v_proj)/bias", (None, "kv"))]
    mine += [(r"mlp1/.*kernel", ()),
             (r"layers/.*(q_proj|k_proj|v_proj|gate_proj|up_proj)/bias",
              (None, t)),
             (r"encoder/.*fc1/bias", (None, t))]
    if vit_whole:
        mine += [(r"encoder/.*qkv/kernel", (None, f, None)),
                 (r"encoder/.*attn/proj/kernel", (None, None, f))]
    rules = mesh_lib.default_param_rules()
    odd = [leaf for leaf in leaves
           if any(re.search(pat, leaf[0]) for pat, _ in mine)]
    return (mb.sharded_bytes_per_device(leaves, amesh, rules)
            + mb.sharded_bytes_per_device(odd, amesh, mine)
            - mb.sharded_bytes_per_device(odd, amesh, rules))


def _rank_bytes(meta, groups, step, sharded, amesh, **kw):
    """[held, want] for the parameters, the gradients (trained and frozen)
    and the AdamW moments of one rank."""
    from vlaser_tpu_torch.utils import memory_budget as mb

    leaves = mb.param_leaves(meta)
    trained = [p for g in groups.values() for p in g.params]
    nbytes = lambda ts: sum(x.numel() * x.element_size() for x in ts)
    trained_leaves = mb._cast(mb._drop_frozen(leaves, (r"vision_model/",)), 4)
    return [sharded.bytes_per_rank(), _port_bytes(leaves, amesh, **kw),
            nbytes(p.grad for p in sharded.params),
            _port_bytes(leaves, amesh, **kw),
            nbytes(step.optimizer.state[p][k] for p in trained
                   for k in ("exp_avg", "exp_avg_sq")),
            2 * _port_bytes(trained_leaves, amesh, **kw)]


def _grad_errors(sharded, model, want):
    """The largest |local gradient - this rank's part of the one-device
    gradient| over the k / v projections and over every leaf, the
    largest over the ranks (every rank calls it)."""
    import torch.distributed as dist

    errs = torch.zeros(2)
    for name, p in model.named_parameters():
        w = sharded.local(p, sharded.cut(name, want[name]))
        e = float((p.grad - w).abs().max())
        errs[1] = max(errs[1], e)
        if "k_proj" in name or "v_proj" in name:
            errs[0] = max(errs[0], e)
    dist.all_reduce(errs, op=dist.ReduceOp.MAX)
    return errs.tolist()


def _one_device_grads(make, batch):
    """{name: gradient} of one unclipped step of the trainer make(None)
    on the whole batch, and its grad norm."""
    tr = make(None)
    m = tr.train(iter([batch]))
    return ({n: p.grad.clone() for n, p in tr.model.named_parameters()},
            float(m["grad_norm"]))


def _no_enter(tpl, model):
    """A control: every MoE stack's split without its `enter` (the
    dispatch's input and the slots' weights keep their partial
    gradients)."""
    from vlaser_tpu_torch.models.moe import MoEMLP

    class NoEnter(tpl.TensorSplit):
        def enter(self, x):
            return x

    for m in model.modules():
        if isinstance(m, MoEMLP) and m.tp is not None:
            t = m.tp
            m.tp = NoEnter(t.kind, t.size, t.rank, t.group, t.gather, t.lo,
                           t.hi)


def _rank_local_capacity(tr):
    """A control: every MoE stack's capacity and slot positions from the
    rank's own tokens (no batch ranks)."""
    from vlaser_tpu_torch.models.moe import MoEMLP

    for m in tr.model.modules():
        if isinstance(m, MoEMLP):
            m.batch = None


def _ce_case(mesh):
    """chunked_weighted_ce vocab-parallel (the table's block of this
    tensor rank) against the one-device CE on the same inputs: the value,
    the hidden state's and the table's gradients, for the [V, H] table
    and the [H, V] kernel; and every tensor shape the vocab-parallel
    forward and backward make (none may be V wide)."""
    import torch.distributed as dist
    from torch.utils._python_dispatch import TorchDispatchMode

    from vlaser_tpu_torch.core import tensor_parallel as tpl
    from vlaser_tpu_torch.train.losses import chunked_weighted_ce

    group, size, t_rank = tpl.tensor_group(mesh)
    V, H, B, N, chunk = 1000, 24, 2, 37, 16
    g = torch.Generator().manual_seed(4)
    hidden = torch.randn(B, N, H, generator=g)
    table = torch.randn(V, H, generator=g) * 0.3
    labels = torch.randint(0, V, (B, N), generator=g)
    labels[0, :5] = -100
    weight = torch.rand(B, N, generator=g) + 0.5
    n = V // size
    split = tpl.TensorSplit("vocab", size, t_rank, group)
    shapes = []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    shapes.append(tuple(o.shape))
            return out

    errs = []
    for kernel in (False, True):
        h1 = hidden.clone().requires_grad_()
        t1 = (table.T if kernel else table).clone().requires_grad_()
        want = chunked_weighted_ce(h1, t1, labels, weight, chunk=chunk,
                                   table_is_kernel=kernel)
        want.backward()
        h2 = hidden.clone().requires_grad_()
        block = t1.detach().narrow(int(kernel), t_rank * n, n)
        t2 = block.clone().requires_grad_()
        with Shapes():
            got = chunked_weighted_ce(h2, t2, labels, weight, chunk=chunk,
                                      table_is_kernel=kernel, tp=split)
            got.backward()
        tg = t1.grad.narrow(int(kernel), t_rank * n, n)
        errs.append([float((got - want).abs()), float(want.abs()),
                     float((h2.grad - h1.grad).abs().max()),
                     float(h1.grad.abs().max()),
                     float((t2.grad - tg).abs().max()),
                     float(tg.abs().max())])
    wide = [s for s in shapes if V in s]
    out = torch.tensor(errs)
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out.tolist(), wide


def _backward_case(mesh):
    """The three collectives' backward passes over the tensor group of
    `mesh`, against the one-device function each stands for: enter (the
    input of a column-parallel product: its gradient is the sum of the
    ranks' column blocks'), reduce (a row-parallel product's partial
    sums: each rank's slice takes the whole output's gradient) and
    gather_out (a vocab-parallel head: each rank's gradient is its block
    of the whole one). -> the largest error of each, over the ranks."""
    import torch.distributed as dist

    from vlaser_tpu_torch.core import tensor_parallel as tpl

    group, size, r = tpl.tensor_group(mesh)
    split = tpl.TensorSplit("col", size, r, group)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(5, 8, generator=g)
    w = torch.randn(8, 4 * size, generator=g)
    up = torch.randn(5, 4 * size, generator=g)  # d loss / d y
    cols = slice(4 * r, 4 * (r + 1))
    errs = torch.zeros(3)
    # one device: y = x @ w; here y's columns of this rank
    x1 = x.clone().requires_grad_()
    (split.enter(x1) @ w[:, cols]).backward(up[:, cols])
    errs[0] = (x1.grad - up @ w.T).abs().max()
    # row-parallel: x's columns of this rank times w's rows, summed
    xr = x[:, 2 * r:2 * (r + 1)].clone().requires_grad_()
    wr = torch.randn(2 * size, 3, generator=g)
    out = torch.randn(5, 3, generator=g)
    y = split.reduce(xr @ wr[2 * r:2 * (r + 1)])
    y.backward(out)
    errs[1] = ((y - x[:, :2 * size] @ wr).abs().max()
               + (xr.grad - out @ wr[2 * r:2 * (r + 1)].T).abs().max())
    # the gathered head
    h = (x @ w[:, cols]).requires_grad_()
    full = split.gather_out(h)
    full.backward(up)
    errs[2] = ((full - x @ w).abs().max()
               + (h.grad - up[:, cols]).abs().max())
    dist.all_reduce(errs, op=dist.ReduceOp.MAX)
    return errs.tolist()


def _tp_worker(rank, work, cases, res, solo):
    """The tensor-axis cases (the module docstring), on (data 2, fsdp 2,
    tensor 2) and (data 2, tensor 4). `solo`: rank 0's one-device
    VLATrainer after its step (None elsewhere)."""
    import dataclasses

    import torch.distributed as dist

    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core import tensor_parallel as tpl
    from vlaser_tpu_torch.core.config import (tiny_qwen3_moe_vlm, tiny_vla,
                                              tiny_vlm)
    from vlaser_tpu_torch.graft_entry import seeded_
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.train import mpo
    from vlaser_tpu_torch.train.trainer import (SFTTrainer, TrainConfig,
                                                VLATrainConfig, VLATrainer)
    from vlaser_tpu_torch.utils import memory_budget as mb
    from vlaser_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)

    cfg = tiny_vla(max_image_text_tokens=16)
    mesh = mesh_lib.make_mesh(dp=2, fsdp=2, tp=2)
    index, count = mesh_lib.batch_shard(mesh)
    amesh = mb._abstract_mesh(2, 2, 2)

    # the VLA step at (data 2, fsdp 2, tensor 2), the bytes a rank holds
    model, groups, frozen = _vla(cfg, cases["vla_state"], 1e-4, mesh=mesh)
    step, sharded = _det_step(model, groups, frozen, mesh)
    m = step(_rows(cases["vla_batch"], index, count))
    res["vla_tp"] = [m["loss"], m["grad_norm"], _whole(sharded, model)]
    meta = PiZeroVLA(cfg, compute_dtype=torch.float32,
                     device=torch.device("meta"))
    res["bytes_tp"] = _rank_bytes(meta, groups, step, sharded, amesh)

    # gradient accumulation: [2, 16] micro batches
    model, groups, frozen = _vla(cfg, cases["vla_state"], LR,
                                 frozen_vit=False, mesh=mesh)
    step, sharded = _det_step(model, groups, frozen, mesh, accum=2)
    m = step(_rows(cases["accum_batch"], index, count, dim=1))
    res["accum_tp"] = [m["loss"], m["grad_norm"], _whole(sharded, model)]

    # the VLATrainer's own draws: a tensor group's ranks draw alike
    model = load_state(PiZeroVLA(cfg, compute_dtype=torch.float32,
                                 attn_impl="reference", device="cpu"),
                       cases["vla_state"])
    tr = VLATrainer(model, VLATrainConfig(
        lr_action=LR, lr_vlm=LR, warmup_steps=0, log_every=1),
        generator=torch.Generator().manual_seed(5), mesh=mesh)
    batch = {k: v for k, v in cases["vla_batch"].items()
             if k not in ("t", "x0")}
    m = tr.train_steps(iter([_rows(batch, index, count)]), 1)
    full = _whole(tr.sharded, tr.model)
    if rank == 0:
        s = solo.model
        diffs = torch.cat([(full[n] - p.detach()).abs().reshape(-1)
                           for n, p in s.named_parameters()])
        res["draws_tp"] = [m["loss"], res["draws"][1], m["grad_norm"],
                           res["draws"][3], float(diffs.max()),
                           int((diffs > 1e-6).sum()), diffs.numel()]
    try:
        VLATrainer(load_state(PiZeroVLA(cfg, compute_dtype=torch.float32,
                                        device="cpu"), cases["vla_state"]),
                   VLATrainConfig(optimizer_8bit=True),
                   mesh=mesh_lib.make_mesh(dp=4, fsdp=1, tp=2))
        res["adam8bit_tp"] = "no error"
    except NotImplementedError as e:
        res["adam8bit_tp"] = str(e)

    # SFTTrainer and MPOTrainer at (2, 2, 2), two steps each
    vcfg = tiny_vlm()
    model = load_state(InternVLChatModel(
        vcfg, compute_dtype=torch.float32, attn_impl="reference",
        device="cpu"), cases["vlm_state"])
    tr = SFTTrainer(model, TrainConfig(learning_rate=LR, total_steps=2,
                                       log_every=1), mesh=mesh)
    res["sft_tp"] = []
    for b in cases["sft_batches"]:
        m = tr.train(iter([_rows(b, index, count)]))
        res["sft_tp"].append([m["loss"], m["grad_norm"]])
    res["sft_tp_params"] = _whole(tr.sharded, model)
    model = load_state(InternVLChatModel(
        vcfg, compute_dtype=torch.float32, attn_impl="reference",
        device="cpu"), cases["vlm_state"])
    pt = mpo.MPOTrainer(model, mpo.MPOConfig(), TrainConfig(
        learning_rate=LR, total_steps=2), mesh=mesh)
    res["mpo_tp"] = [{k: v.clone() for k, v in pt.train(
        iter([_rows(b, index, count)]), 1).items()}
        for b in cases["mpo_batches"]]
    res["mpo_tp_running"] = float(pt.running.mean)
    res["mpo_tp_params"] = _whole(pt.sharded, model)
    ref = {n: pt.sharded.whole(n, p, pt.ref_params[n])
           for n, p in model.named_parameters()}
    res["mpo_tp_ref_kept"] = rank != 0 or all(
        torch.equal(ref[n], cases["vlm_state"][n]) for n in ref)

    # checkpoints: a VLA whose ViT attention is cut (the strided qkv) at
    # (fsdp 2, tensor 2) -> (data 8) and back
    vit = dataclasses.replace(cfg.vlm.vision, qk_normalization=False)
    ncfg = dataclasses.replace(cfg, vlm=dataclasses.replace(cfg.vlm,
                                                            vision=vit))
    start = {n: p.detach().clone() for n, p in seeded_(PiZeroVLA(
        ncfg, compute_dtype=torch.float32, device="cpu"), 7).state_dict(
        ).items()}
    model, groups, frozen = _vla(ncfg, start, 1e-4, mesh=mesh)
    step, sharded = _det_step(model, groups, frozen, mesh)
    step(_rows(cases["vla_batch"], index, count))
    ck = os.path.join(work, "ck_tp")
    save_checkpoint(ck, 1, model, step)
    want = (_whole(sharded, model),
            _moments_whole(sharded, model, step.optimizer))
    mesh8 = mesh_lib.make_mesh(dp=8)
    other = {k: v + 1 for k, v in start.items()}
    model1, g1, f1 = _vla(ncfg, other, 1e-4, mesh=mesh8)
    step1, sh1 = _det_step(model1, g1, f1, mesh8)
    restore_checkpoint(ck, model1, step1)
    got = (_whole(sh1, model1), _moments_whole(sh1, model1, step1.optimizer))
    equal = lambda a, b: rank != 0 or (a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) for k in a))
    res["ck_tp_to_8"] = [equal(got[0], want[0]), equal(got[1], want[1]),
                         step1.count, "vision_model.encoder.attn.qkv.kernel"
                         in model._tensor_layout]
    ck1 = os.path.join(work, "ck_8")
    save_checkpoint(ck1, 1, model1, step1)
    model2, g2, f2 = _vla(ncfg, other, 1e-4, mesh=mesh)
    step2, sh2 = _det_step(model2, g2, f2, mesh)
    restore_checkpoint(ck1, model2, step2)
    back = (_whole(sh2, model2), _moments_whole(sh2, model2, step2.optimizer))
    res["ck_8_to_tp"] = [equal(back[0], got[0]), equal(back[1], got[1]),
                         step2.count, True]

    # the KV pick: the tiny LLM's 4 / 2 heads at (data 2, tensor 4), one
    # unclipped step against one device's gradients; the control sums
    # each copy over the batch ranks only
    pick = mesh_lib.make_mesh(dp=2, fsdp=1, tp=4)
    b = {k: torch.as_tensor(v) for k, v in _sft_batch(vcfg, 4, 30).items()}
    p_i, p_n = mesh_lib.batch_shard(pick)

    def sft(m_, control=False, **kw):
        model = seeded_(InternVLChatModel(
            kw.pop("conf", vcfg), compute_dtype=torch.float32,
            attn_impl="reference", device="cpu"), 8)
        tr = SFTTrainer(model, TrainConfig(learning_rate=LR, total_steps=2,
                                           grad_clip=None, **kw), mesh=m_)
        if control:
            control(tr)
        return tr

    want, want_norm = _one_device_grads(sft, b)
    tr = sft(pick)
    m = tr.train(iter([_rows(b, p_i, p_n)]))
    kv = [k for k in tr.model._tensor_plan.copies if "k_proj" in k]
    res["kv_pick"] = [_grad_errors(tr.sharded, tr.model, want),
                      float(m["grad_norm"]), want_norm, kv]
    ck = os.path.join(work, "ck_pick")
    save_checkpoint(ck, 1, tr.model, tr.step_fn)
    held = _whole(tr.sharded, tr.model)
    tr8 = sft(mesh8)
    restore_checkpoint(ck, tr8.model, tr8.step_fn)
    res["kv_pick_ck"] = equal(_whole(tr8.sharded, tr8.model), held)
    res["kv_pick_bytes"] = _rank_bytes(
        InternVLChatModel(vcfg, compute_dtype=torch.float32,
                          device=torch.device("meta")),
        tr.groups, tr.step_fn, tr.sharded, types.SimpleNamespace(
            shape={**mb._abstract_mesh(2, 1, 4).shape, "kv": 2}),
        kv_pick=True)

    def holders_dropped(tr):
        sh = tr.sharded
        for key in list(sh.groups):
            if key[1] > 1:
                sh.groups[key] = (sh.batch_group, sh.ranks)

    tr = sft(pick, control=holders_dropped)
    m = tr.train(iter([_rows(b, p_i, p_n)]))
    res["kv_pick_control"] = [_grad_errors(tr.sharded, tr.model, want),
                              float(m["grad_norm"])]

    # the MoE: the tiny Qwen3-MoE with the router loss and a capacity
    # factor, experts over tensor 2 at (2, 2, 2); the controls drop the
    # stacks' `enter`, and count the capacity over the rank's own tokens
    mcfg = tiny_qwen3_moe_vlm(capacity=1.25)
    mb_ = {k: torch.as_tensor(v) for k, v in _sft_batch(mcfg, 4, 31).items()}
    kw = dict(conf=mcfg, moe_aux_coef=0.05)
    want, want_norm = _one_device_grads(lambda m_: sft(m_, **dict(kw)), mb_)
    out = []
    for control in (False, lambda tr: _no_enter(tpl, tr.model),
                    _rank_local_capacity):
        tr = sft(mesh, control=control, **dict(kw))
        m = tr.train(iter([_rows(mb_, index, count)]))
        gate = "language_model.model.layers.mlp.gate"
        p = dict(tr.model.named_parameters())[gate]
        err = torch.tensor([float((p.grad - tr.sharded.local(
            p, want[gate])).abs().max())])
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
        out.append([float(err), _grad_errors(tr.sharded, tr.model, want)[1],
                    float(m["grad_norm"]), want_norm,
                    float(want[gate].abs().max())])
    res["moe"] = out

    # the vocab-parallel chunked CE and the collectives' backward passes
    # at tensor 4
    res["ce"] = _ce_case(pick)
    res["backward"] = _backward_case(pick)


# -- the JAX oracle and the spawn --------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import vlaser_tpu.train.mpo as jmpo
    from vlaser_tpu.core import mesh as jmesh
    from vlaser_tpu.core.config import tiny_vla as j_tiny_vla
    from vlaser_tpu.core.config import tiny_vlm as j_tiny_vlm
    from vlaser_tpu.core.distributed import put_global_batch
    from vlaser_tpu.models.vlm import InternVLChatModel as JVLM
    from vlaser_tpu.policy.pizero import PiZeroVLA as JVLA
    from vlaser_tpu.train.optim import make_optimizer
    from vlaser_tpu.train.train_step import TrainState, make_train_step
    from vlaser_tpu.train.trainer import SFTTrainer as JSFT
    from vlaser_tpu.train.trainer import TrainConfig as JConfig
    from vlaser_tpu_torch.utils.convert import from_jax_variables

    work = tmp_path_factory.mktemp("sharded")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    port = lambda t: from_jax_variables(np_tree(t))
    tb = lambda b: {k: torch.from_numpy(np.array(v, copy=True))
                    for k, v in b.items()}
    cases, refs = {}, {}

    cfg = j_tiny_vla(max_image_text_tokens=16)
    jmodel = JVLA(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    batch = _vla_batch(cfg, 8, 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init(jax.random.PRNGKey(0),
                         *(jb[k][:1] for k in KEYS))
    det = lambda p, b, r: jmodel.apply(p, *(b[k] for k in KEYS))
    tx = make_optimizer(1e-4, frozen_patterns=(r"vision_model/",),
                        params=params)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    s1, m1 = make_train_step(det, tx, donate=False)(
        state, jb, jax.random.PRNGKey(1))
    cases["vla_state"] = port(params)
    cases["vla_batch"] = tb(batch)
    refs["vla"] = [float(m1["loss"]), float(m1["grad_norm"]),
                   port(s1.params)]

    big = _vla_batch(cfg, 32, 1, fixed=True)
    tx = make_optimizer(LR)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    s2, m2 = make_train_step(det, tx, donate=False)(
        state, {k: jnp.asarray(v) for k, v in big.items()},
        jax.random.PRNGKey(0))
    cases["accum_batch"] = tb({k: v.reshape((2, 16) + v.shape[1:])
                               for k, v in big.items()})
    refs["accum"] = [float(m2["loss"]), float(m2["grad_norm"]),
                     port(s2.params)]

    vcfg = j_tiny_vlm()
    vmodel = JVLM(vcfg, compute_dtype=jnp.float32, attn_impl="reference")
    sft = [_sft_batch(vcfg, 8, 10 + i) for i in range(2)]
    vparams = vmodel.init(jax.random.PRNGKey(2),
                          jnp.asarray(sft[0]["input_ids"][:1]),
                          jnp.asarray(sft[0]["pixel_values"][:1]),
                          jnp.asarray(sft[0]["image_flags"][:1]))
    cases["vlm_state"] = port(vparams)
    one = jmesh.make_mesh(devices=jax.devices()[:1])
    path = str(work / "sft_jax.jsonl")
    jt = JSFT(vmodel, jax.tree_util.tree_map(jnp.array, vparams),
              JConfig(learning_rate=LR, total_steps=2, log_every=1,
                      metrics_path=path), mesh=one)
    st = jt.train(iter(sft))
    import json

    with open(path) as f:
        refs["sft"] = [json.loads(line) for line in f]
    refs["sft_params"] = port(st.params)
    cases["sft_batches"] = [tb(b) for b in sft]

    pairs = [_pair_batch(vcfg, 8, 20 + i) for i in range(2)]
    mt = jmpo.MPOTrainer(vmodel, jax.tree_util.tree_map(jnp.array, vparams),
                         jmpo.MPOConfig(),
                         JConfig(learning_rate=LR, total_steps=2), mesh=one)
    rng, refs["mpo"] = jax.random.PRNGKey(0), []
    for b in pairs:  # MPOTrainer.train's loop, its metrics kept
        rng, sub = jax.random.split(rng)
        delta = jnp.asarray(mt.running.mean, jnp.float32)
        mt.state, m = mt._step(mt.state, mt.ref_params,
                               put_global_batch(b, mt.mesh), delta, sub)
        mt.running.update(np.asarray(m.pop("rewards")))
        refs["mpo"].append({k: float(v) for k, v in m.items()})
    refs["mpo_running"] = mt.running.mean
    refs["mpo_params"] = port(mt.state.params)
    cases["mpo_batches"] = [tb(b) for b in pairs]

    torch.save(cases, os.path.join(work, "cases.pt"))
    run_ranks(_worker, N_RANKS, work, str(work))
    return {"res": torch.load(os.path.join(work, "res.pt")), "refs": refs,
            "start": cases["vla_state"], "vlm_start": cases["vlm_state"]}


def _hold_params(got, want, start, lrs, frozen=("vision_model.",)):
    assert sorted(got) == sorted(want)
    n_off = n_all = 0
    for name, w in want.items():
        p, w = got[name].numpy(), w.numpy()
        if name.startswith(frozen):  # frozen: bit for bit
            assert np.array_equal(p, start[name].numpy()), name
            assert np.array_equal(w, start[name].numpy()), name
            continue
        diff = np.abs(p - w)
        assert diff.max() <= 2 * sum(lrs), name
        n_off += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def _vla_step(runs, key):
    (loss, gnorm, params), (l_ref, g_ref, p_ref) = (runs["res"][key],
                                                    runs["refs"]["vla"])
    np.testing.assert_allclose(float(loss), l_ref, rtol=1e-4)
    np.testing.assert_allclose(float(gnorm), g_ref, rtol=1e-4)
    q = "joint.layers.expert.q_proj.kernel"
    assert (params[q] - runs["start"][q]).abs().max() > 0
    _hold_params(params, p_ref, runs["start"], [1e-4])


def test_sharded_vla_step_matches_single_device(runs):
    _vla_step(runs, "vla")


def test_tensor_vla_step_matches_single_device(runs):
    """The same step at JAX's mesh (data 2, fsdp 2, tensor 2)."""
    _vla_step(runs, "vla_tp")


def _accumulation(runs, key):
    (loss, gnorm, params), (l_ref, g_ref, p_ref) = (runs["res"][key],
                                                    runs["refs"]["accum"])
    np.testing.assert_allclose(float(loss), l_ref, rtol=1e-5)
    np.testing.assert_allclose(float(gnorm), g_ref, rtol=1e-4)
    _hold_params(params, p_ref, runs["start"], [LR], frozen=())


def test_grad_accumulation_matches_large_batch(runs):
    _accumulation(runs, "accum")


def test_tensor_grad_accumulation_matches_large_batch(runs):
    _accumulation(runs, "accum_tp")


def _draws(runs, key):
    (loss, solo_loss, gnorm, solo_gnorm, pmax, n_off,
     n_all) = runs["res"][key]
    np.testing.assert_allclose(float(loss), float(solo_loss), rtol=1e-5)
    np.testing.assert_allclose(float(gnorm), float(solo_gnorm), rtol=1e-5)
    assert pmax <= 2 * LR and n_off <= 1e-3 * n_all, (pmax, n_off, n_all)


def test_flow_draws_are_the_global_batchs(runs):
    _draws(runs, "draws")


def test_tensor_ranks_draw_the_global_batchs(runs):
    """A tensor group's ranks draw and keep the same t and x0."""
    _draws(runs, "draws_tp")


@pytest.mark.parametrize("trainer", ["sft", "mpo"])
def test_sharded_trainer_steps_match_jax(runs, trainer):
    _trainer_steps(runs, trainer, "")


@pytest.mark.parametrize("trainer", ["sft", "mpo"])
def test_tensor_trainer_steps_match_jax(runs, trainer):
    """SFTTrainer (its CE vocab-parallel) and MPOTrainer at (2, 2, 2)."""
    _trainer_steps(runs, trainer, "_tp")


def _trainer_steps(runs, trainer, tag):
    res, refs = runs["res"], runs["refs"]
    res = {k: res[k.replace(trainer, trainer + tag, 1)] for k in (
        trainer, f"{trainer}_params", "mpo_running", "mpo_ref_kept")}
    if trainer == "sft":
        for (loss, gnorm), want in zip(res["sft"], refs["sft"]):
            np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
            np.testing.assert_allclose(float(gnorm), want["grad_norm"],
                                       rtol=1e-4)
    else:
        for got, want in zip(res["mpo"], refs["mpo"]):
            np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                       rtol=1e-5)
            for k in ("dpo_loss", "bco_loss", "sft_loss", "reward_margin"):
                np.testing.assert_allclose(float(got[k]), want[k],
                                           rtol=2e-3, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(float(got["grad_norm"]),
                                       want["grad_norm"], rtol=1e-4)
        # two steps from warmup's lr 0: the policy is still the reference
        # when the rewards are taken, they are rounding noise
        np.testing.assert_allclose(res["mpo_running"], refs["mpo_running"],
                                   rtol=2e-3, atol=1e-6)
        assert res["mpo_ref_kept"]
    from vlaser_tpu_torch.train.optim import warmup_cosine

    sched = warmup_cosine(LR, 2)
    _hold_params(res[f"{trainer}_params"], refs[f"{trainer}_params"],
                 runs["vlm_start"], [sched(0), sched(1)])


def test_per_rank_bytes_match_the_memory_budget(runs):
    params, want_params, moments, want_moments, n_split = runs["res"]["bytes"]
    assert params == want_params
    assert moments == want_moments
    assert n_split > 0  # the fsdp rules split some leaves


def test_per_rank_gradients_and_gathers_match_the_memory_budget(runs):
    (trained, want_trained, frozen, want_frozen, peak, bound,
     whole) = runs["res"]["grads"]
    assert trained == want_trained
    assert frozen == want_frozen
    assert 0 < peak <= bound < whole, (peak, bound, whole)


@pytest.mark.parametrize("direction", ["ck_2_to_1", "ck_1_to_2",
                                       "ck_tp_to_8", "ck_8_to_tp"])
def test_checkpoint_moves_between_meshes_bit_for_bit(runs, direction):
    params_equal, moments_equal, count, *rest = runs["res"][direction]
    assert params_equal and moments_equal and count == 1
    assert all(rest)  # fsdp 2 holds fewer elements a rank than fsdp 1


def test_adam8bit_over_fsdp_raises(runs):
    assert "8-bit" in runs["res"]["adam8bit"], runs["res"]["adam8bit"]


def test_adam8bit_over_tensor_raises(runs):
    got = runs["res"]["adam8bit_tp"]
    assert "8-bit" in got and "tensor > 1" in got, got


@pytest.mark.parametrize("case", ["bytes_tp", "kv_pick_bytes"])
def test_tensor_rank_bytes_match_the_port_layout(runs, case):
    """A rank's parameter, gradient (trained and frozen) and AdamW moment
    bytes at (2, 2, 2) and at (2, 1, 4) with the KV pick: the JAX
    budget's per-device terms plus the port's deliberate copies
    (_port_bytes), exactly."""
    held, want, grads, want_g, moments, want_m = runs["res"][case]
    assert held == want and grads == want_g and moments == want_m, \
        runs["res"][case]


KV_TOL = 1e-5  # |d gradient| (fp32; the gradients' maxima are ~1e-2-1)


def test_kv_pick_gradients_match_one_device(runs):
    """The tiny LLM's 4 / 2 heads at (data 2, tensor 4): each rank holds
    the one KV head its q heads read; the copies' gradients, summed over
    their holders, and every other leaf's equal one device's, and so does
    the grad norm (each copy counted once). Without the holders' sum the
    k / v gradients part from one device's."""
    (kv_err, all_err), norm, want_norm, kv = runs["res"]["kv_pick"]
    assert kv, "the layout holds no KV copy"
    assert kv_err <= KV_TOL and all_err <= KV_TOL, (kv_err, all_err)
    np.testing.assert_allclose(norm, want_norm, rtol=1e-5)
    (c_kv, _), c_norm = runs["res"]["kv_pick_control"]
    assert c_kv > 100 * KV_TOL, c_kv
    assert runs["res"]["kv_pick_ck"]  # its checkpoint restores at data 8


def test_moe_router_gradient_matches_one_device(runs):
    """The tiny Qwen3-MoE (router loss on, capacity factor 1.25, experts
    over tensor 2) at (2, 2, 2): the router's gradient and every leaf's
    equal one device's (the q / k norms summed over tensor): each rank
    keeps the slots one device keeps (the capacity and positions of the
    global batch); without the stacks' `enter` the router's gradient
    parts from it."""
    (gate, every, norm, want_norm, scale), (c_gate, *_), _ = (
        runs["res"]["moe"])
    assert gate <= KV_TOL * scale and every <= KV_TOL, (gate, every, scale)
    np.testing.assert_allclose(norm, want_norm, rtol=1e-5)
    assert c_gate > 100 * KV_TOL * scale, (c_gate, scale)


def test_moe_rank_local_capacity_parts_from_one_device(runs):
    """The control of the capacity: counted over each rank's own tokens (C
    and the slots' positions), the same step drops other slots than one
    device, and the gradients part from one device's."""
    *_, (c_gate, c_every, _, _, scale) = runs["res"]["moe"]
    assert c_gate > 100 * KV_TOL * scale, (c_gate, scale)
    assert c_every > 100 * KV_TOL, c_every


def test_tensor_collectives_backward_passes(runs):
    """enter, reduce and gather_out over tensor 4 against the one-device
    product each stands for, forward and backward."""
    assert max(runs["res"]["backward"]) <= 1e-5, runs["res"]["backward"]


def test_vocab_parallel_ce_matches_one_device(runs):
    """chunked_weighted_ce over tensor 4, each rank a 250-row block of a
    1,000-word table: the value and the hidden's and table's gradients
    equal the one-device CE's (the [V, H] table and the [H, V] kernel),
    and no tensor of the vocab-parallel forward or backward is V wide."""
    errs, wide = runs["res"]["ce"]
    for d_val, val, d_h, h, d_t, t in errs:
        assert d_val <= 1e-6 * val and d_h <= 1e-6 * h and d_t <= 1e-6 * t, \
            errs
    assert not wide, wide[:4]
