"""The port's twin of the repository's `__graft_entry__.entry()`: the
north-star path (Vlaser-2B-VLA's cached `infer_action`: the ViT, the joint
prefix and the 10-step denoise) as a callable and its example arguments.

    from vlaser_tpu_torch.graft_entry import entry
    fn, args = entry()          # on the CUDA card
    actions = fn(*args)         # [1, 4, 7]

The model is built in bf16 with every parameter zero (the JAX entry's
zero tree), so the call exercises shapes and routes, not weights. The
example batch is the JAX entry's: one 448 px tile, a 384-token prompt whose
first 256 slots are image-context tokens followed by 44 text tokens, text
mask over those 300, zero proprio and zero noise. `entry(cfg, "cpu")` runs
any config on the CPU (the tests' tiny ones), the prompt cut to fit.

`dryrun_multichip(n)` is the twin of the repository's multi-device gate:
n gloo ranks on the CPU (spawned processes, no card), each section of the
JAX gate at its tiny config and sizes, one line each. Ported: VLA (the
flow-matching train step, frozen ViT, AdamW, on the JAX gate's mesh
make_mesh(dp=-1, fsdp=2, tp=2): (data n/4, fsdp 2, tensor 2) at n = 8,
the model cut over tensor, the state over fsdp), SFT (the packed VLM SFT
step on that mesh, its CE vocab-parallel), TP-serve (the tiny VLA's
infer_action with its policy laid out over (data, fsdp 2, tensor 2):
tensor-parallel columns, fsdp shards; core/tensor_parallel), TP-engine
(the continuous-batching engine on that mesh), CP (the tiny LLM stack
through ring attention over {'context': min(n, 4)}), CPxFSDP-train (the
SFT step with the LLM ring-sharded over context 2 and the state over fsdp
2; n divisible by 8), EP (a tiny MoE stack with its experts split over
the tensor axis), PP (the 2-layer tiny LLM stack through the GPipe
pipeline of train/pipeline.py at stage 2, 2 microbatches) and
PPxFSDP-train (one AdamW step of the pipeline loss on (data, fsdp 2,
stage 2) with the state sharded by stageify_rules; n divisible by 8).
Every section of the JAX gate is ported.

    python -c "from vlaser_tpu_torch.graft_entry import dryrun_multichip
    dryrun_multichip(8)"
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

TEXT_TOKENS = 44  # the JAX entry's text tokens after the image slots
TEXT_ID = 7


def entry(cfg=None, device=None):
    """-> (fn, example_args): fn = model.infer_action of a zero-parameter
    bf16 PiZeroVLA on `device` (None: the CUDA card), example_args =
    (input_ids, pixel_values, text_mask, proprios, noise) on that device."""
    from .core.config import vlaser_2b_vla
    from .policy.pizero import PiZeroVLA

    cfg = cfg if cfg is not None else vlaser_2b_vla()
    bf = torch.bfloat16
    model = PiZeroVLA(cfg, param_dtype=bf, compute_dtype=bf, device=device)
    with torch.no_grad():
        for t in model.parameters():
            t.zero_()
    dev = model.device
    B, S = 1, cfg.max_image_text_tokens
    img = cfg.vlm.vision.image_size
    n_img = cfg.vlm.num_image_token
    n_valid = min(n_img + TEXT_TOKENS, S)
    ids = torch.full((B, S), cfg.vlm.pad_token_id, dtype=torch.long)
    ids[:, n_img:n_valid] = TEXT_ID
    ids[:, :n_img] = cfg.vlm.img_context_token_id
    text_mask = torch.zeros((B, S), dtype=torch.int32)
    text_mask[:, :n_valid] = 1
    f32 = dict(dtype=torch.float32, device=dev)
    args = (ids.to(dev), torch.zeros((B, img, img, 3), **f32),
            text_mask.to(dev),
            torch.zeros((B, cfg.cond_steps, cfg.proprio_dim), **f32),
            torch.zeros((B, cfg.num_action_tokens, cfg.action_dim), **f32))
    return model.infer_action, args


ORDER = ("VLA", "SFT", "TP-serve", "TP-engine", "CP", "PP", "PPxFSDP-train",
         "CPxFSDP-train", "EP")


def _vla_section(n, rng):
    from .core import mesh as mesh_lib
    from .core.config import tiny_vla
    from .core.tensor_parallel import shard_for_training
    from .policy.flow import make_flow_loss
    from .policy.pizero import PiZeroVLA
    from .train.optim import make_optimizer
    from .train.train_step import make_train_step, shard_train_state

    # the JAX gate's mesh: every axis that divides n, tensor, fsdp, data
    tp = 2 if n % 2 == 0 else 1
    fsdp = 2 if n % (tp * 2) == 0 else 1
    mesh = mesh_lib.make_mesh(dp=-1, fsdp=fsdp, tp=tp)
    cfg = tiny_vla(max_image_text_tokens=16)
    B, S = n, cfg.max_image_text_tokens
    img = cfg.vlm.vision.image_size
    ids = rng.integers(1, 400, (B, S))
    ids[:, 2] = cfg.vlm.img_context_token_id
    batch = {
        "input_ids": ids,
        "pixel_values": rng.standard_normal((B, img, img, 3)).astype(
            np.float32),
        "text_mask": np.ones((B, S), np.int32),
        "proprios": np.zeros((B, cfg.cond_steps, cfg.proprio_dim),
                             np.float32),
        "actions": np.zeros((B, cfg.num_action_tokens, cfg.action_dim),
                            np.float32),
    }
    model = shard_for_training(seeded_(PiZeroVLA(
        cfg, compute_dtype=torch.float32, attn_impl="reference",
        device="cpu"), 0), mesh)
    groups, frozen = make_optimizer(model, 1e-4,
                                    frozen_patterns=(r"vision_model/",))
    sharded = shard_train_state(model, mesh)
    gen = torch.Generator().manual_seed(1)
    step = make_train_step(make_flow_loss(model, "beta", gen, mesh=mesh),
                           groups, frozen=frozen, sharded=sharded)
    loss = float(step(_local(batch, mesh))["loss"])
    assert np.isfinite(loss), loss
    return (f"VLA: mesh={mesh_lib.mesh_shape(mesh)} loss={loss:.4f}",
            mesh)


def seeded_(model, seed: int):
    """Every parameter N(0, 0.1^2) from a seeded generator, norm weights
    ("weight") 1 + N(0, 0.1^2): the tiny models' test weights."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            w = torch.randn(p.shape, generator=gen) * 0.1
            p.copy_(w + 1.0 if name.endswith(".weight") else w)
    return model


def _local(batch, mesh):
    """This rank's block of rows of a global numpy batch, as tensors."""
    from .core.mesh import batch_shard

    i, count = batch_shard(mesh)
    b = next(iter(batch.values())).shape[0] // count
    return {k: torch.as_tensor(v[i * b:(i + 1) * b]) for k, v in
            batch.items()}


def _sft_batch(vcfg, n, rng):
    Bv, Nv = n, 24
    vids = rng.integers(1, 400, (Bv, Nv))
    vids[:, 1] = vcfg.img_context_token_id
    labels = vids.copy()
    labels[:, :4] = -100
    img = vcfg.vision.image_size
    return {
        "input_ids": vids,
        "labels": labels,
        "loss_weight": (labels != -100).astype(np.float32),
        "seg_ids": np.ones((Bv, Nv), np.int32),
        "pixel_values": rng.standard_normal((Bv, img, img, 3)).astype(
            np.float32),
        "image_flags": np.ones((Bv,), np.int32),
    }


def _sft_step(vcfg, mesh, batch, seed):
    from .core import mesh as mesh_lib
    from .core.tensor_parallel import shard_for_training
    from .models.vlm import InternVLChatModel
    from .train.losses import make_sft_loss
    from .train.optim import make_optimizer
    from .train.train_step import make_train_step, shard_train_state

    model = shard_for_training(seeded_(InternVLChatModel(
        vcfg, compute_dtype=torch.float32, attn_impl="reference",
        device="cpu"), seed), mesh)
    groups, frozen = make_optimizer(model, 1e-4,
                                    frozen_patterns=(r"vision_model/",))
    sharded = shard_train_state(model, mesh)
    step = make_train_step(make_sft_loss(model, mesh=mesh), groups,
                           frozen=frozen, sharded=sharded)
    with mesh_lib.set_mesh(mesh):
        loss = float(step(_local(batch, mesh))["loss"])
    assert np.isfinite(loss), loss
    return loss


def _cp_section(n, vcfg, rng):
    import dataclasses

    import torch.distributed as dist

    from .core import mesh as mesh_lib
    from .models.qwen2 import Qwen2ForCausalLM

    cp = min(n, 4)
    cp_mesh = mesh_lib.make_mesh(dp=-1, fsdp=1, tp=1, cp=cp)
    lcfg = dataclasses.replace(vcfg.llm, context_parallel_axis="context")
    lmodel = seeded_(Qwen2ForCausalLM(lcfg, compute_dtype=torch.float32,
                                      device="cpu"), 4)
    Sc = 8 * cp
    cids = torch.as_tensor(rng.integers(1, 400, (2, Sc)))
    cseg = torch.ones((2, Sc), dtype=torch.int32)
    with torch.no_grad(), mesh_lib.set_mesh(cp_mesh):
        logits, _, _ = lmodel(cids, seg_ids=cseg, attn_impl="reference")
    parts = [torch.empty_like(logits) for _ in range(cp)]
    dist.all_gather(parts, logits.contiguous(),
                    group=cp_mesh.get_group("context"))
    logits = torch.cat(parts, 1)
    assert torch.isfinite(logits).all()
    return (f"CP: ring attention over {{'context': {cp}}} logits "
            f"{tuple(logits.shape)}")


def _tp_sections(n, vcfg, rng):
    """TP-serve, TP-engine and EP on a (data, fsdp 2, tensor 2) mesh (the
    JAX gate's), each model laid out by core/tensor_parallel."""
    import dataclasses

    from .core import mesh as mesh_lib
    from .core.config import tiny_vla
    from .core.tensor_parallel import shard_for_serving
    from .models.qwen2 import Qwen2ForCausalLM
    from .models.vlm import InternVLChatModel
    from .policy.pizero import PiZeroVLA
    from .serve.engine import ContinuousBatchingEngine, Request

    tp = 2 if n % 4 == 0 else 1
    mesh = mesh_lib.make_mesh(dp=-1, fsdp=2 if n % 2 == 0 else 1, tp=tp)
    shape = mesh_lib.mesh_shape(mesh)
    lines = {}
    cfg = tiny_vla(max_image_text_tokens=16)
    B, S = n, cfg.max_image_text_tokens
    img = cfg.vlm.vision.image_size
    ids = rng.integers(1, 400, (B, S))
    ids[:, 2] = cfg.vlm.img_context_token_id
    model = shard_for_serving(seeded_(PiZeroVLA(
        cfg, compute_dtype=torch.float32, attn_impl="reference",
        device="cpu"), 3), mesh)
    act = model.infer_action(
        torch.as_tensor(ids),
        torch.as_tensor(rng.standard_normal((B, img, img, 3)).astype(
            np.float32)),
        torch.ones((B, S), dtype=torch.int32),
        torch.zeros((B, cfg.cond_steps, cfg.proprio_dim)),
        torch.zeros((B, cfg.num_action_tokens, cfg.action_dim))).numpy()
    assert act.shape == (B, cfg.horizon_steps, cfg.action_dim)
    assert np.isfinite(act).all()
    lines["TP-serve"] = (f"TP-serve: actions {act.shape} "
                         f"mean={float(act.mean()):.4f} mesh={shape}")
    vmodel = seeded_(InternVLChatModel(vcfg, compute_dtype=torch.float32,
                                       attn_impl="reference", device="cpu"),
                     5)
    eng = ContinuousBatchingEngine(
        vmodel, num_slots=2, max_len=64, eos_token_ids=[3], pad_token_id=0,
        prefill_buckets=(16,), cache_dtype=torch.float32, mesh=mesh)
    comps = eng.run([Request(uid=i, input_ids=rng.integers(
        1, 400, (m,)).astype(np.int32), max_new_tokens=4)
        for i, m in enumerate((5, 9, 7))])
    assert sorted(c.uid for c in comps) == [0, 1, 2]
    assert all(1 <= len(c.token_ids) <= 4 for c in comps)
    lines["TP-engine"] = (f"TP-engine: {len(comps)} completions over "
                          f"mesh={shape} lens="
                          f"{[len(c.token_ids) for c in comps]}")
    mcfg = dataclasses.replace(vcfg.llm, num_experts=4,
                               num_experts_per_tok=2,
                               moe_intermediate_size=32)
    mmodel = shard_for_serving(seeded_(Qwen2ForCausalLM(
        mcfg, compute_dtype=torch.float32, device="cpu"), 6), mesh)
    with torch.no_grad():
        logits, _, _ = mmodel(torch.as_tensor(rng.integers(1, 400, (4, 8))),
                              attn_impl="reference")
    assert torch.isfinite(logits).all()
    held = mmodel.model.layers.mlp.experts_gate_proj.shape[1]
    lines["EP"] = (f"EP: MoE logits {tuple(logits.shape)} ({held} of 4 "
                   "experts a rank, over the tensor axis)")
    return lines


def _pp_sections(n, vcfg, rng):
    """PP (every n) and PPxFSDP-train (n divisible by 8) at the JAX gate's
    sizes: the tiny LLM at 2 layers."""
    import dataclasses

    from .core import mesh as mesh_lib
    from .kernels import ops
    from .models.qwen2 import Qwen2ForCausalLM
    from .train.optim import make_optimizer
    from .train.pipeline import make_pipeline_lm_loss, pipeline_llm_forward
    from .train.train_step import make_train_step, shard_train_state

    lines = {}
    pcfg = dataclasses.replace(vcfg.llm, num_layers=2)
    pp = 2 if n % 2 == 0 else 1
    mesh = mesh_lib.make_mesh(dp=-1, pp=pp)
    model = seeded_(Qwen2ForCausalLM(pcfg, compute_dtype=torch.float32,
                                     device="cpu"), 5)
    ids = torch.as_tensor(rng.integers(1, 400, (4, 8)))
    seg = torch.ones((4, 8), dtype=torch.int32)
    pos = torch.arange(8)[None].expand(4, 8)
    cos, sin = ops.rope_cos_sin(pos, pcfg.head_dim, pcfg.rope_theta)
    with torch.no_grad():
        hidden = pipeline_llm_forward(
            pcfg, model.model.layers, model.embed(ids), cos, sin, seg,
            n_microbatches=2, mesh=mesh, compute_dtype=torch.float32,
            remat=False, attn_impl="reference")
    assert torch.isfinite(hidden).all()
    lines["PP"] = (f"PP: {pp}-stage pipeline hidden "
                   f"{tuple(hidden.shape)}")
    if n % 8 == 0:
        mesh = mesh_lib.make_mesh(dp=-1, fsdp=2, pp=2)
        model = seeded_(Qwen2ForCausalLM(pcfg, compute_dtype=torch.float32,
                                         device="cpu"), 7)
        tids = rng.integers(1, 400, (8, 16))
        batch = {"input_ids": tids, "labels": tids,
                 "seg_ids": np.ones((8, 16), np.int32)}
        groups, _ = make_optimizer(model, 1e-4, weight_decay=1e-4,
                                   grad_clip=None)
        sharded = shard_train_state(model, mesh, mesh_lib.stageify_rules(
            mesh_lib.default_param_rules()))
        step = make_train_step(make_pipeline_lm_loss(
            model, n_microbatches=2, mesh=mesh, remat=False,
            attn_impl="reference"), groups, sharded=sharded)
        loss = float(step(_local(batch, mesh))["loss"])
        assert np.isfinite(loss), loss
        lines["PPxFSDP-train"] = (f"PPxFSDP-train: mesh="
                                  f"{mesh_lib.mesh_shape(mesh)} "
                                  f"loss={loss:.4f}")
    return lines


def _dryrun_rank(rank, n, init_file, out_file):
    import dataclasses

    import torch.distributed as dist

    from .core import mesh as mesh_lib
    from .core.config import tiny_vlm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=n)
    try:
        rng = np.random.default_rng(0)
        lines = {}
        lines["VLA"], mesh = _vla_section(n, rng)
        vcfg = tiny_vlm()
        vbatch = _sft_batch(vcfg, n, rng)
        lines["SFT"] = (f"SFT: mesh={mesh_lib.mesh_shape(mesh)} "
                        f"loss={_sft_step(vcfg, mesh, vbatch, 2):.4f}")
        lines.update(_tp_sections(n, vcfg, rng))
        lines["CP"] = _cp_section(n, vcfg, rng)
        lines.update(_pp_sections(n, vcfg, rng))
        if n % 8 == 0:
            cpfm = mesh_lib.make_mesh(dp=-1, fsdp=2, tp=1, cp=2)
            ccfg = dataclasses.replace(vcfg, llm=dataclasses.replace(
                vcfg.llm, context_parallel_axis="context"))
            closs = _sft_step(ccfg, cpfm, vbatch, 9)
            lines["CPxFSDP-train"] = (
                f"CPxFSDP-train: mesh={mesh_lib.mesh_shape(cpfm)} "
                f"loss={closs:.4f}")
        if rank == 0:
            with open(out_file, "w") as f:
                for key in ORDER:
                    if key in lines:
                        f.write(f"dryrun_multichip({n}) {lines[key]}\n")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int):
    """Run the gate's sections on `n_devices` gloo CPU ranks; print and
    return their lines. Raises if a rank fails."""
    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="dryrun_")
    out = os.path.join(work, "lines.txt")
    try:
        mp.spawn(_dryrun_rank, args=(n_devices, os.path.join(work, "init"),
                                     out), nprocs=n_devices)
        with open(out) as f:
            lines = f.read().splitlines()
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    for line in lines:
        print(line, flush=True)
    return lines
