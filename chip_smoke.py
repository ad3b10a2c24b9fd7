#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vlaser_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the Hopper kernels from vlaser_tpu_torch/csrc (one nvcc per source,
all started together, sm_90a), then drives the port's two paths at the full
width and depth of Vlaser-2B-VLA with random weights from seeded
generators:

Serving (bf16 weights N(0, 0.02^2), int8 weight-only quantization):
  1. each serving kernel at the control step's shapes against its plain
     twin on the same CUDA tensors (fused_vit_stack 1x1025x1024 L=24;
     fused_int8_stack R=5 ext=384 and R=4 ext=385), timed. The model's
     packed matrices are kept, but the kernel phase draws its own norms
     1 + N(0, 0.1^2), ViT layer scales ~0.1, ViT q/k columns x4 and
     external K/V ~N(0, 2^2), so every branch shows; the bound on x_out is
     a share of what the stack changes, and controls (input unchanged,
     attention dropped, MLP dropped) must break it;
  2. the fused PolicyServer (reset + 3 steps), launch counters zeroed just
     before and read just after;
  3. the fused actions against the plain infer_action oracle (<= 2e-2 max
     abs, the bound of bench.py's policy_infer_b1 gate), and the control
     step timed on both paths.
Training (fp32 parameters, bf16 compute, remat, batch 32):
  4. flash attention forward and backward at the ViT shape (B 32, S 1025,
     16/16 heads x 64, non-causal) and the joint shape (B 32, S 389, 12/2
     heads x 128, levels [0 x 384 | 1 | 2 x 4], a padded prompt tail of 60
     tokens), plus a causal block with q_offset > 0 at the joint widths,
     against the plain version; controls (levels ignored, padding keys
     unmasked, scale dropped, causal or q_offset dropped) must break the
     bounds. Timed against the plain version and PyTorch's
     scaled_dot_product_attention (a yardstick the port never calls);
  5. RMSNorm forward and backward at 12,288 x 1536 bf16 against the plain
     version; controls (w ignored, the x * sum term of dx dropped). Timed
     against the plain version and torch.nn.functional.rms_norm;
  6. the train step: a parity gate (one loss + backward on the kernel path
     and one on the reference attention and RMSNorm, same weights, batch,
     t and x0: loss and each optimizer group's gradient norm), then 3
     VLATrainer.train_steps with VLATrainConfig() defaults, launch counters
     zeroed just before and read just after and held to the counts the
     code implies; losses, step time, its stage split and peak memory;
     then one more step under torch.profiler: device time per kernel group
     and the device's idle share.
Any failed phase raises (non-zero exit, no result line). The line before
the last lists every kernel; the last line is {"ok": true, "device": ...}.
"""

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

CHANGE_TOL = 0.1  # x_out: max abs err <= 0.1 * max|twin - x_in|; k/v_self
                  # of every layer: <= 0.1 * max|twin| (they ride on x)
KV0_TOL = 2e-2    # k/v_self of layer 0 (no trajectory behind them):
                  # <= 2e-2 * max|twin[0]|
PARITY_TOL = 2e-2  # fused vs plain actions, max abs (bench.py:89)
STEPS = 3
# flash attention, kernel vs plain on the same bf16 inputs: out, dq, dk, dv
# within 2e-2 x max|plain| (bf16 outputs and P rounded to bf16 for P.V);
# lse (fp32 statistics) within 1e-3 absolute
FLASH_REL, LSE_ABS = 2e-2, 1e-3
# RMSNorm: y, dx within 1e-2 x max|plain| (one bf16 rounding each, summation
# order); rrms within 1e-5 x max, dw (fp32 sums over 12,288 rows in another
# order) within 1e-3 x max
RMS_REL, RRMS_REL, DW_REL = 1e-2, 1e-5, 1e-3
# train parity gate, kernel path vs reference path, bf16 compute (the two
# round P and the normalized x to bf16 at other points): loss within 2e-3
# relative, each group's gradient norm within 5e-3 relative
LOSS_REL, GNORM_REL = 2e-3, 5e-3
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 without
# tensor cores, device memory
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def _ms(torch, fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _bound(flops, nbytes, peak_flops):
    """-> (least ms for the work on an H100, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _gate(name, got, ref, x_in, controls):
    """Kernel x_out vs twin; each control (a wrong answer) must fail."""
    ref = ref.float()
    bound = CHANGE_TOL * (ref - x_in.float()).abs().max().item()
    err = (got.float() - ref).abs().max().item()
    print(f"{name}: max_abs_err {err:.3e} (bound {bound:.3e}), finite "
          f"{bool(got.float().isfinite().all())}", flush=True)
    if not (err <= bound and got.float().isfinite().all()):
        raise RuntimeError(f"{name}: kernel disagrees with its twin")
    for cname, c in controls.items():
        ce = (c.float() - ref).abs().max().item()
        print(f"  control '{cname}': {ce:.3e} (must exceed the bound)",
              flush=True)
        if not ce > bound:
            raise RuntimeError(f"{name}: the bound cannot see '{cname}'")
    return err


def _check(name, got, ref, bounds, controls):
    """got/ref: {output: tensor}; bounds: {output: max abs err}. Every
    output within its bound and finite; every control (a dict of wrong
    outputs) must exceed the bound of at least one output. -> errors."""
    errs = {}
    for k, b in bounds.items():
        errs[k] = (got[k].float() - ref[k].float()).abs().max().item()
        fin = bool(got[k].float().isfinite().all())
        print(f"{name} {k} {tuple(got[k].shape)}: max_abs_err "
              f"{errs[k]:.3e} (bound {b:.3e}), finite {fin}", flush=True)
        if not (errs[k] <= b and fin):
            raise RuntimeError(f"{name} {k}: kernel disagrees with plain")
    for cname, c in controls.items():
        # a NaN in a wrong answer counts as breaking the bound
        ratios = {k: (c[k].float() - ref[k].float()).abs().nan_to_num(
            nan=math.inf).max().item() / bounds[k] for k in c}
        worst = max(ratios, key=ratios.get)
        print(f"  control '{cname}': {ratios[worst]:.1f} x the bound of "
              f"{worst} (must exceed 1)", flush=True)
        if not ratios[worst] > 1:
            raise RuntimeError(f"{name}: the bounds cannot see '{cname}'")
    return errs


class SmokeTokenizer:
    """Char-level stand-in: the three image tags map to the config's ids."""

    def __init__(self, vlm_cfg):
        self.pad_token_id = vlm_cfg.pad_token_id
        self.special = (("<IMG_CONTEXT>", vlm_cfg.img_context_token_id),
                        ("<img>", vlm_cfg.img_start_token_id),
                        ("</img>", vlm_cfg.img_end_token_id))

    def __call__(self, text, add_special_tokens=False, **kw):
        ids, i = [], 0
        while i < len(text):
            for tok, tid in self.special:
                if text.startswith(tok, i):
                    ids.append(tid)
                    i += len(tok)
                    break
            else:
                ids.append(100 + ord(text[i]) % 1000)
                i += 1
        return {"input_ids": ids}


# -- serving: phases 1-3 ------------------------------------------------------
def serving_phases(torch, np, dev, cfg, tag, report):
    """-> launches of the server run."""
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.envs.adapters import BridgeSimplerAdapter
    from vlaser_tpu_torch.image.tiling import normalize_uint8
    from vlaser_tpu_torch.kernels import fused_decode, fused_vit, ops
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.policy.fused_infer import pack_expert_stack
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.policy.processing import InternVLAProcessor
    from vlaser_tpu_torch.serve.policy_server import PolicyServer

    t0 = time.perf_counter()
    bf = torch.bfloat16
    model = PiZeroVLA(cfg, param_dtype=bf, compute_dtype=bf, device=dev)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    init_normal_(model, gen, std=0.02)
    quantize_for_serving(model, target="policy", mode="int8")
    torch.cuda.synchronize()
    n_param = sum(t.numel() for t in model.state_dict().values())
    print(f"serving model: Vlaser-2B-VLA, {n_param / 1e9:.3f} G elements, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(0)
    img = cfg.vlm.vision.image_size
    vcfg, ecfg = cfg.vlm.vision, cfg.expert

    # -- kernel phase: fused_vit_stack vs its twin --------------------------
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    frame = rng.integers(0, 256, (img, img, 3), dtype=np.uint8)
    pix = torch.from_numpy(normalize_uint8(frame[None])).to(dev)
    with torch.inference_mode():
        emb = model.vit_embed(pix)[0].to(bf).contiguous()  # [1025, 1024]
        vs = fused_vit.pack_vit_stack(model.vision_model)
        C = vcfg.hidden_size
        vs["qkvw"] = vs["qkvw"].clone()
        vs["qkvw"][:, :, :2 * C] *= 4
        for k in ("ln1w", "ln2w", "qnw", "knw"):
            vs[k] = 1 + 0.1 * rnd(*vs[k].shape)
        for k in ("ln1b", "ln2b"):
            vs[k] = 0.1 * rnd(*vs[k].shape)
        for k in ("ls1", "ls2"):
            vs[k] = 0.1 * (1 + 0.1 * rnd(*vs[k].shape))
        kw = dict(num_heads=vcfg.num_heads, eps=vcfg.layer_norm_eps,
                  qk_norm=vcfg.qk_normalization)
        got = fused_vit.fused_vit_stack(emb, **vs, **kw)
        torch.cuda.synchronize()
        plain = lambda **o: fused_vit.fused_vit_stack_plain(emb, **{**vs, **o},
                                                           **kw)
        err = _gate(f"fused_vit_stack {tuple(emb.shape)} L={vcfg.num_layers}",
                    got, plain(), emb, {
                        "input unchanged": emb,
                        "attention dropped": plain(ls1=0 * vs["ls1"]),
                        "MLP dropped": plain(ls2=0 * vs["ls2"])})
        torch.cuda.synchronize()
        ms = _ms(torch, lambda: fused_vit.fused_vit_stack(emb, **vs, **kw), 10)
        plain_ms = _ms(torch, plain, 3)
        print(f"fused_vit_stack time: kernel {ms:.3f} ms, plain twin "
              f"{plain_ms:.3f} ms {tag}", flush=True)
        S_v, L_v = emb.shape[0], vcfg.num_layers
        flops = L_v * (2 * S_v * 12 * C * C + 4 * S_v * S_v * C)
        nbytes = (sum(vs[k].numel() * vs[k].element_size() for k in vs)
                  + 2 * emb.numel() * 2)
        bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16)
        report["fused_vit_stack"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None)

    # -- kernel phase: fused_int8_stack vs its twin (R=5 / R=4) -------------
    with torch.inference_mode():
        stack = pack_expert_stack(model)
        L, R = ecfg.num_layers, cfg.num_action_tokens
        stack["ln1"] = 1 + 0.1 * rnd(*stack["ln1"].shape)
        stack["ln2"] = 1 + 0.1 * rnd(*stack["ln2"].shape)
        names = ("ln1", "ln2", "bq", "bk", "bv", "wq", "sq", "wk", "sk", "wv",
                 "sv", "wo", "so", "wg", "sg", "wu", "su", "wd", "sd")
        n_p, S = cfg.num_proprio_tokens, cfg.max_image_text_tokens
        eps = ecfg.rms_norm_eps
        dec = {"max_abs_err": 0.0}
        for rows, ext in ((n_p + R, S), (R, S + n_p)):
            x = rnd(rows, ecfg.hidden_size).to(bf)
            pos = torch.arange(1, rows + 1, dtype=torch.float32, device=dev)
            cos, sin = ops.rope_cos_sin(pos, ecfg.head_dim, ecfg.rope_theta)
            cos, sin = cos.to(bf), sin.to(bf)
            selfm = torch.zeros(rows, rows, device=dev)
            if rows > R:
                selfm[:n_p, n_p:] = fused_decode.NEG_INF
            extm = torch.zeros(1, ext, device=dev)
            extm[0, 300:S] = fused_decode.NEG_INF  # padded prompt tail
            kv = (L, ext, ecfg.num_kv_heads, ecfg.head_dim)
            k_e, v_e = (2 * rnd(*kv)).to(bf), (2 * rnd(*kv)).to(bf)

            def run(fn, cs=cos, sn=sin, **over):
                w = {**stack, **over}
                return fn(x, cs, sn, selfm, extm, *[w[k] for k in names],
                          k_e, v_e, eps=eps)

            got = run(fused_decode.fused_int8_stack)
            torch.cuda.synchronize()
            plain = lambda **o: run(fused_decode.fused_int8_stack_plain, **o)
            ref = plain()
            tag_r = f"fused_int8_stack R={rows} ext={ext}"
            e = _gate(f"{tag_r} x_out {tuple(x.shape)}", got[0], ref[0], x, {
                "input unchanged": x,
                "attention dropped": plain(so=0 * stack["so"])[0],
                "MLP dropped": plain(sd=0 * stack["sd"])[0]})
            dec["max_abs_err"] = max(dec["max_abs_err"], e)
            no_rope = plain(cs=torch.ones_like(cos), sn=torch.zeros_like(sin))
            for name, i in (("k_self", 1), ("v_self", 2)):
                a, b = got[i].float(), ref[i].float()
                for what, diff, bound in (
                        ("all layers", a - b,
                         CHANGE_TOL * b.abs().max().item()),
                        ("layer 0", a[0] - b[0],
                         KV0_TOL * b[0].abs().max().item())):
                    e = diff.abs().max().item()
                    print(f"{tag_r} {name} {tuple(a.shape)} {what}: "
                          f"max_abs_err {e:.3e} (bound {bound:.3e})",
                          flush=True)
                    if not (e <= bound and a.isfinite().all()):
                        raise RuntimeError(f"{tag_r} {name} disagrees")
                    dec["max_abs_err"] = max(dec["max_abs_err"], e)
            ce = (no_rope[1][0].float() - ref[1][0].float()).abs().max().item()
            print(f"  control 'rope dropped' on k_self layer 0: {ce:.3e} "
                  f"(must exceed the bound)", flush=True)
            if not ce > KV0_TOL * ref[1][0].float().abs().max().item():
                raise RuntimeError(f"{tag_r}: the bound cannot see the rope")
            torch.cuda.synchronize()
            ms = _ms(torch, lambda: run(fused_decode.fused_int8_stack), 20)
            plain_ms = _ms(torch, plain, 3)
            print(f"fused_int8_stack R={rows} time: kernel {ms:.3f} ms, "
                  f"plain twin {plain_ms:.3f} ms {tag}", flush=True)
            dec[f"ms_r{rows}"], dec[f"plain_ms_r{rows}"] = ms, plain_ms
            if rows == R:
                w_bytes = sum(stack[k].numel() * stack[k].element_size()
                              for k in names)
                nbytes = (w_bytes + 2 * k_e.numel() * 2 + x.numel() * 2 * 3
                          + L * rows * ecfg.num_kv_heads * ecfg.head_dim * 4)
                flops = 2 * rows * sum(stack[k].numel() for k in names
                                       if k[0] == "w")
                dec["bound_ms"], dec["bound_by"] = _bound(flops, nbytes,
                                                          PEAK_BF16)
        dec["ms"], dec["plain_ms"] = dec[f"ms_r{R}"], dec[f"plain_ms_r{R}"]
        dec["library_ms"] = None
        report["fused_int8_stack"] = dec

    # -- server phase: the fused PolicyServer, counters around it ------------
    stats = {"action": {"p01": [-0.05] * 6 + [0.0], "p99": [0.05] * 6 + [1.0],
                        "mean": [0.0] * 7, "std": [1.0] * 7},
             "proprio": {"p01": [-0.5] * 6 + [0.0], "p99": [0.5] * 6 + [1.0],
                         "mean": [0.0] * 7, "std": [1.0] * 7}}
    adapter = BridgeSimplerAdapter(dataset_statistics=stats,
                                   image_size=(img, img))
    proc = InternVLAProcessor(SmokeTokenizer(cfg.vlm),
                              num_image_tokens=cfg.vlm.num_image_token,
                              max_seq_len=S, pad_token_id=cfg.vlm.pad_token_id)
    server = PolicyServer(model, None, adapter, proc, act_steps=4, seed=0,
                          fused=True, device=dev)
    server.reset("put the carrot on the plate")
    n_text = int(server._cached_inputs["text_mask"].sum())
    frames = [rng.integers(0, 256, (img, img, 3), dtype=np.uint8)
              for _ in range(STEPS)]
    obs = {"agent": {"eef_pos": np.array([0.1, 0.0, 0.2, 1, 0, 0, 0, 0.5],
                                         np.float32)}}
    torch.cuda.synchronize()
    fused_vit.launch_count = 0
    fused_decode.launch_count = 0
    chunks = [server.step(obs, f) for f in frames]
    torch.cuda.synchronize()
    launches = {"fused_vit_stack": fused_vit.launch_count,
                "fused_int8_stack": fused_decode.launch_count}
    for i, c in enumerate(chunks):
        print(f"step {i}: env actions {c.shape} finite "
              f"{bool(np.isfinite(c).all())} first {np.round(c[0], 4).tolist()}",
              flush=True)
    print(f"server: {STEPS} steps, prompt {n_text}/{S} tokens, launches "
          f"{launches} (per step: vit {launches['fused_vit_stack'] / STEPS}, "
          f"int8 stack {launches['fused_int8_stack'] / STEPS})", flush=True)
    if not all(c.shape == (4, 7) and np.isfinite(c).all() for c in chunks):
        raise RuntimeError("server returned bad action chunks")
    want = {"fused_vit_stack": STEPS,
            "fused_int8_stack": STEPS * cfg.num_inference_steps}
    if launches != want:
        raise RuntimeError(f"main path launches {launches} != {want}")

    # -- parity gate + control-step timing ---------------------------------
    pre = adapter.preprocess(obs, frames[0])
    inputs = (server._cached_inputs["input_ids"],
              torch.from_numpy(normalize_uint8(pre["image"][None])).to(dev),
              server._cached_inputs["text_mask"],
              torch.from_numpy(pre["proprio"][None, None].copy()).to(dev),
              server.draw_noise())
    with torch.inference_mode():
        a_fused = server._infer(*inputs)
        a_plain = model.infer_action(*inputs)
        torch.cuda.synchronize()
        diff = (a_fused - a_plain).abs().max().item()
        print(f"parity: fused vs plain infer_action {tuple(a_fused.shape)} "
              f"max_abs_diff {diff:.3e} (bound {PARITY_TOL}), |a| max "
              f"{a_plain.abs().max().item():.3e}", flush=True)
        if not (diff <= PARITY_TOL and torch.isfinite(a_fused).all()
                and a_fused.shape == (1, cfg.horizon_steps, cfg.action_dim)):
            raise RuntimeError("fused path disagrees with infer_action")
        step_ms = _ms(torch, lambda: server._infer(*inputs), 10)
        plain_step_ms = _ms(torch, lambda: model.infer_action(*inputs), 3)
        embeds = model.fuse_vit_features(inputs[0], emb[None])
        prefix_ms = _ms(torch, lambda: model.vlm_prefix_from_embeds(
            embeds, inputs[2]), 10)
    print(f"control step (batch 1, median, CUDA events): fused "
          f"{step_ms:.3f} ms, plain infer_action {plain_step_ms:.3f} ms "
          f"{tag}", flush=True)
    vit_ms = report["fused_vit_stack"]["ms"]
    stacks_ms = (dec[f"ms_r{n_p + R}"] + (cfg.num_inference_steps - 1)
                 * dec[f"ms_r{R}"])
    # each stage timed alone; the host-bound prefix varies from run to run,
    # so the stages need not add up to the step
    print(f"stages of the fused step, each timed alone: vit stack "
          f"{vit_ms:.3f} ms, plain vlm prefix {prefix_ms:.3f} ms, "
          f"{cfg.num_inference_steps} int8 stacks {stacks_ms:.3f} ms {tag}",
          flush=True)
    print(f"serving peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}",
          flush=True)
    return launches


# -- training: phase 4, flash attention ----------------------------------------
def _flash_inputs(torch, g, dev, B, Sq, Skv, H, KVH, D):
    bf = torch.bfloat16
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(bf)
    return r(B, Sq, H, D), r(B, Skv, KVH, D), r(B, Skv, KVH, D), r(B, Sq, H, D)


def flash_phase(torch, dev, cfg, tag, report):
    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    vcfg, llm, ecfg = cfg.vlm.vision, cfg.vlm.llm, cfg.expert
    S_it = cfg.max_image_text_tokens
    S_j = cfg.total_tokens
    n_pa = S_j - S_it
    i32 = dict(dtype=torch.int32, device=dev)
    fwd_rep, bwd_rep = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}

    # (name, B, Sq, Skv, H, KVH, D, pad, levels, causal, q_offset)
    cases = [("vit", 32, vcfg.seq_len, vcfg.seq_len, vcfg.num_heads,
              vcfg.num_heads, vcfg.head_dim, 0, False, False, 0),
             ("joint", 32, S_j, S_j, llm.num_heads, llm.num_kv_heads,
              llm.head_dim, 60, True, False, 0),
             ("causal block", 4, 128, S_j, ecfg.num_heads, ecfg.num_kv_heads,
              ecfg.head_dim, 0, False, True, S_j - 128)]
    for name, B, Sq, Skv, H, KVH, D, pad, levels, causal, off in cases:
        q, k, v, do = _flash_inputs(torch, g, dev, B, Sq, Skv, H, KVH, D)
        seg = torch.ones(B, Skv, **i32)
        lev = None
        if levels:  # [img/text 0 | proprio 1 | action 2]
            lev = torch.zeros(B, Skv, **i32)
            lev[:, S_it:S_it + 1] = 1
            lev[:, S_it + 1:] = 2
        if pad:  # the padded prompt tail, just before proprio
            seg[:, S_it - pad:S_it] = 0
        q_seg = seg if Sq == Skv else torch.ones(B, Sq, **i32)
        q_lev = lev if Sq == Skv else None
        qm, km = fa.pack_meta(q_seg, q_lev), fa.pack_meta(seg, lev)
        what = (f"flash {name} B={B} Sq={Sq} Skv={Skv} H={H}/{KVH} D={D}"
                + (f" causal q_offset={off}" if causal else ""))

        def plain(qm_=qm, km_=km, off_=off, causal_=causal, scale=None):
            o, l = fa.flash_attention_fwd_plain(q, k, v, qm_, km_, off_,
                                                causal_, scale)
            dq, dk, dv = fa.flash_attention_bwd_plain(
                q, k, v, qm_, km_, off_, out, lse, do, causal_, scale)
            return {"out": o, "lse": l, "dq": dq, "dk": dk, "dv": dv}

        out, lse = fa.flash_attention_fwd(q, k, v, qm, km, off, causal)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, qm, km, off, out, lse, do,
                                            causal)
        torch.cuda.synchronize()
        got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        ref = plain()
        bounds = {kk: FLASH_REL * ref[kk].float().abs().max().item()
                  for kk in ("out", "dq", "dk", "dv")}
        bounds["lse"] = LSE_ABS
        controls = {"scale dropped": plain(scale=1.0)}
        if levels:
            controls["levels ignored"] = plain(fa.pack_meta(q_seg),
                                               fa.pack_meta(seg))
        if pad:
            ones = torch.ones_like(seg)
            controls["padding keys unmasked"] = plain(fa.pack_meta(ones, lev),
                                                      fa.pack_meta(ones, lev))
        if causal:
            controls["causal dropped"] = plain(causal_=False)
            controls["q_offset dropped"] = plain(off_=0)
        errs = _check(what, got, ref, bounds, controls)
        dead = (q_seg == 0)
        if not ((out[dead] == 0).all() and (dq[dead] == 0).all()):
            raise RuntimeError(f"{what}: fully masked rows must give zeros")
        del ref, controls
        fwd_rep["max_abs_err"] = max(fwd_rep["max_abs_err"], errs["out"])
        bwd_rep["max_abs_err"] = max(bwd_rep["max_abs_err"], errs["dq"],
                                     errs["dk"], errs["dv"])
        if causal:
            continue

        # timing at the train step's shapes, bounds from this data's mask
        pairs = fa._allowed(qm, km, off, causal).sum().item()
        io = (q.numel() + k.numel() + v.numel()) * 2
        meta = (qm.numel() + km.numel()) * 4
        lse_b = lse.numel() * 4
        t_fwd = {
            "ms": _ms(torch, lambda: fa.flash_attention_fwd(
                q, k, v, qm, km, off, causal), 10),
            "plain_ms": _ms(torch, lambda: fa.flash_attention_fwd_plain(
                q, k, v, qm, km, off, causal), 3)}
        t_fwd["bound_ms"], t_fwd["bound_by"] = _bound(
            4 * D * H * pairs, io + q.numel() * 2 + lse_b + meta, PEAK_BF16)
        t_bwd = {
            "ms": _ms(torch, lambda: fa.flash_attention_bwd(
                q, k, v, qm, km, off, out, lse, do, causal), 10),
            "plain_ms": _ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, qm, km, off, out, lse, do, causal), 3)}
        t_bwd["bound_ms"], t_bwd["bound_by"] = _bound(
            10 * D * H * pairs, 2 * io + 2 * q.numel() * 2 + lse_b + meta,
            PEAK_BF16)
        # the yardstick: one PyTorch call on the same inputs, [B, H, S, D],
        # K/V repeated over each group's q heads
        rep = lambda t: t.repeat_interleave(H // KVH, dim=2)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, rep(k), rep(v)))
        dot = do.transpose(1, 2).contiguous()
        mask = None
        if pad or levels:
            mask = fa._allowed(qm, km, off, causal)[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        t_fwd["library_ms"] = _ms(torch, sdpa, 10)
        o_lib = sdpa()
        t_bwd["library_ms"] = _ms(torch, lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), dot, retain_graph=True), 10)
        del o_lib, qt, kt, vt, dot, mask
        for nm, t in (("fwd", t_fwd), ("bwd", t_bwd)):
            print(f"flash {nm} {name} time: kernel {t['ms']:.3f} ms, plain "
                  f"{t['plain_ms']:.3f} ms, sdpa {t['library_ms']:.3f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) {tag}",
                  flush=True)
        if name == "vit":
            fwd_rep.update(t_fwd)
            bwd_rep.update(t_bwd)
        else:
            fwd_rep["joint"], bwd_rep["joint"] = t_fwd, t_bwd
    report["flash_attention_fwd"] = fwd_rep
    report["flash_attention_bwd"] = bwd_rep


# -- training: phase 5, RMSNorm ------------------------------------------------
def rms_phase(torch, dev, cfg, tag, report):
    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import rmsnorm

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    bf = torch.bfloat16
    llm = cfg.vlm.llm
    n, H, eps = 32 * cfg.max_image_text_tokens, llm.hidden_size, \
        llm.rms_norm_eps
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    x, w, gy = r(n, H).to(bf), (1 + 0.1 * r(H)).to(bf), r(n, H).to(bf)
    what = f"rms_norm {n}x{H} bf16"
    y, rrms = rmsnorm.rms_fwd(x, w, eps)
    dx, dw = rmsnorm.rms_bwd(x, w, gy, rrms)
    dx2, dw2 = rmsnorm.rms_bwd(x, w, gy, rrms)
    torch.cuda.synchronize()
    if not torch.equal(dw, dw2):
        raise RuntimeError(f"{what}: dw differs between two runs")

    def plain(w_=w, drop_sum=False):
        yp, rp = rmsnorm.rms_fwd_plain(x, w_, eps)
        dxp, dwp = rmsnorm.rms_bwd_plain(x, w_, gy, rrms)
        if drop_sum:  # dx without the - x * sum(g w x) rrms^3 / H term
            dxp = (gy.float() * w_.float() * rrms).to(bf)
        return {"y": yp, "rrms": rp, "dx": dxp, "dw": dwp}

    ref = plain()
    rel = {"y": RMS_REL, "rrms": RRMS_REL, "dx": RMS_REL, "dw": DW_REL}
    bounds = {k: rel[k] * ref[k].float().abs().max().item() for k in rel}
    errs = _check(what, {"y": y, "rrms": rrms, "dx": dx, "dw": dw}, ref,
                  bounds, {"w ignored": plain(w_=torch.ones_like(w)),
                           "x * sum term of dx dropped": {
                               "dx": plain(drop_sum=True)["dx"]}})
    nb = x.numel() * 2
    f_rep = {"max_abs_err": max(errs["y"], errs["rrms"]),
             "ms": _ms(torch, lambda: rmsnorm.rms_fwd(x, w, eps), 20),
             "plain_ms": _ms(torch, lambda: rmsnorm.rms_fwd_plain(x, w, eps),
                             5),
             "library_ms": _ms(torch, lambda: F.rms_norm(x, (H,), w, eps),
                               20)}
    f_rep["bound_ms"], f_rep["bound_by"] = _bound(
        4 * x.numel(), 2 * nb + H * 2 + n * 4, PEAK_FP32)
    b_rep = {"max_abs_err": max(errs["dx"], errs["dw"]),
             "ms": _ms(torch, lambda: rmsnorm.rms_bwd(x, w, gy, rrms), 20),
             "plain_ms": _ms(torch, lambda: rmsnorm.rms_bwd_plain(
                 x, w, gy, rrms), 5)}
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    yl = F.rms_norm(xl, (H,), wl, eps)
    b_rep["library_ms"] = _ms(torch, lambda: torch.autograd.grad(
        yl, (xl, wl), gy, retain_graph=True), 20)
    b_rep["bound_ms"], b_rep["bound_by"] = _bound(
        8 * x.numel(), 3 * nb + H * 2 + n * 4 + H * 4, PEAK_FP32)
    for nm, t in (("fwd", f_rep), ("bwd", b_rep)):
        print(f"rms_norm {nm} time: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, torch rms_norm "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}) {tag}", flush=True)
    report["_rms_fwd"], report["_rms_bwd"] = f_rep, b_rep


# -- training: phase 6, the train step -----------------------------------------
def _train_init_(torch, model, gen):
    """N(0, 0.02^2) everywhere, then norm weights 1 + N(0, 0.1^2) and ViT
    layer scales ~0.1: at N(0, 0.02^2) norms every branch would vanish."""
    from vlaser_tpu_torch.models.layers import LayerNorm, RMSNorm, init_normal_

    init_normal_(model, gen, std=0.02)
    rnd = lambda t: torch.randn(t.shape, generator=gen, device=t.device)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (LayerNorm, RMSNorm)):
                m.weight.copy_(1 + 0.1 * rnd(m.weight))
        enc = model.vision_model.encoder
        for p in (enc.ls1, enc.ls2):
            p.copy_(0.1 * (1 + 0.1 * rnd(p)))


def _train_batch(torch, np, dev, cfg, B):
    from vlaser_tpu_torch.policy.processing import InternVLAProcessor

    rng = np.random.default_rng(4)
    img = cfg.vlm.vision.image_size
    proc = InternVLAProcessor(SmokeTokenizer(cfg.vlm),
                              num_image_tokens=cfg.vlm.num_image_token,
                              max_seq_len=cfg.max_image_text_tokens,
                              pad_token_id=cfg.vlm.pad_token_id)
    words = ("put", "the", "carrot", "on", "plate", "spoon", "towel", "stack",
             "green", "block", "yellow", "move", "near", "cube")
    text = [" ".join(rng.choice(words, rng.integers(2, 9))) for _ in range(B)]
    frames = rng.integers(0, 256, (B, 1, img, img, 3), dtype=np.uint8)
    p = proc(text, frames)
    A = (B, cfg.num_action_tokens, cfg.action_dim)
    return {
        "input_ids": torch.from_numpy(p["input_ids"]).long().to(dev),
        "pixel_values": torch.from_numpy(p["pixel_values"]).to(dev),
        "text_mask": torch.from_numpy(p["attention_mask"]).to(dev),
        "proprios": torch.from_numpy(rng.uniform(
            -1, 1, (B, cfg.cond_steps, cfg.proprio_dim)).astype(
                np.float32)).to(dev),
        "actions": torch.from_numpy(rng.uniform(-1, 1, A).astype(
            np.float32)).to(dev)}


def train_phase(torch, np, dev, cfg, tag, report):
    """-> launches of the 3 trainer steps."""
    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import rmsnorm
    from vlaser_tpu_torch.models.layers import set_rms_impl
    from vlaser_tpu_torch.policy.flow import sample_fm_time
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.train.train_step import group_grad_norms
    from vlaser_tpu_torch.train.trainer import VLATrainConfig, VLATrainer

    B = 32
    t0 = time.perf_counter()
    model = PiZeroVLA(cfg, param_dtype=torch.float32,
                      compute_dtype=torch.bfloat16, device=dev, remat=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    _train_init_(torch, model, gen)
    batch = _train_batch(torch, np, dev, cfg, B)
    trainer = VLATrainer(model, VLATrainConfig(), generator=gen)
    torch.cuda.synchronize()
    n_param = sum(p.numel() for p in model.parameters())
    n_text = batch["text_mask"].sum(1)
    print(f"train model: Vlaser-2B-VLA, remat, fp32 params / bf16 compute, "
          f"{n_param / 1e9:.3f} G parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, "
          f"{time.perf_counter() - t0:.1f} s; batch {B}, prompt tokens "
          f"{int(n_text.min())}-{int(n_text.max())} of "
          f"{cfg.max_image_text_tokens}", flush=True)

    # -- parity gate: kernel path vs reference path, same everything --------
    t = sample_fm_time(gen, B, trainer.cfg.flow_sampling, cfg.flow_alpha,
                       cfg.flow_beta, cfg.flow_t_max, device=dev)
    x0 = torch.randn((B, cfg.num_action_tokens, cfg.action_dim),
                     generator=gen, device=dev)
    args = [batch[k] for k in ("input_ids", "pixel_values", "text_mask",
                               "proprios", "actions")] + [t, x0]
    gate = {}
    for impl in ("auto", "reference"):
        model.set_attn_impl(impl)
        set_rms_impl(model, impl)
        model.zero_grad(set_to_none=True)
        counts = (fa.fwd_launch_count, rmsnorm.fwd_launch_count)
        loss = model(*args)
        loss.backward()
        torch.cuda.synchronize()
        used = (fa.fwd_launch_count - counts[0],
                rmsnorm.fwd_launch_count - counts[1])
        norms = {k: v.item() for k, v in group_grad_norms(
            trainer.groups).items()}
        finite = all(bool(p.grad.isfinite().all()) for p in model.parameters()
                     if p.grad is not None)
        gate[impl] = (loss.item(), norms)
        print(f"parity gate, {impl} path: loss {loss.item():.6f}, group "
              f"grad norms {norms}, all grads finite {finite}, kernel "
              f"launches (flash fwd, rms fwd) {used}", flush=True)
        if not (finite and math.isfinite(loss.item())):
            raise RuntimeError(f"train parity gate: {impl} path not finite")
        if (impl == "reference") != (used == (0, 0)):
            raise RuntimeError(f"train parity gate: {impl} path launches "
                               f"{used}")
    model.set_attn_impl("auto")
    set_rms_impl(model, "auto")
    model.zero_grad(set_to_none=True)
    (lk, nk), (lr, nr) = gate["auto"], gate["reference"]
    loss_rel = abs(lk - lr) / abs(lr)
    norm_rel = {k: abs(nk[k] - nr[k]) / nr[k] for k in nr}
    print(f"parity gate: loss rel diff {loss_rel:.3e} (bound {LOSS_REL}), "
          f"group grad norm rel diffs "
          f"{ {k: f'{v:.3e}' for k, v in norm_rel.items()} } "
          f"(bound {GNORM_REL})", flush=True)
    if not (loss_rel <= LOSS_REL and max(norm_rel.values()) <= GNORM_REL):
        raise RuntimeError("train step: kernel path disagrees with reference")
    del loss
    gc.collect()

    # -- the main path: 3 VLATrainer steps, counters around them -------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launch_count = fa.bwd_launch_count = 0
    rmsnorm.fwd_launch_count = rmsnorm.bwd_launch_count = 0
    times, losses, gnorms = [], [], []
    for _ in range(STEPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        m = trainer.train_steps(iter([batch]), 1)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": fa.fwd_launch_count,
                "flash_attention_bwd": fa.bwd_launch_count,
                "_rms_fwd": rmsnorm.fwd_launch_count,
                "_rms_bwd": rmsnorm.bwd_launch_count}
    peak = torch.cuda.max_memory_allocated() / 2**30
    # derived from the code: every ViT layer and every joint layer runs one
    # flash forward, again in the remat recompute, and one flash backward;
    # each joint layer runs two VLM RMSNorms (12,288 rows; the expert's 160
    # rows stay on the reference) twice, plus the final vlm_norm once; the
    # last layer's post-attention norm and vlm_norm never reach the loss,
    # so they have no backward
    n_vit, L = cfg.vlm.vision.num_layers, cfg.vlm.llm.num_layers
    want = {"flash_attention_fwd": STEPS * 2 * (n_vit + L),
            "flash_attention_bwd": STEPS * (n_vit + L),
            "_rms_fwd": STEPS * (2 * 2 * L + 1),
            "_rms_bwd": STEPS * (2 * L - 1)}
    print(f"train: {STEPS} VLATrainer steps, losses "
          f"{[round(v, 6) for v in losses]}, grad norms "
          f"{[round(v, 4) for v in gnorms]}, step ms "
          f"{[round(v, 3) for v in times]} (median "
          f"{statistics.median(times):.3f} ms, CUDA events), peak device "
          f"memory {peak:.2f} GiB {tag}", flush=True)
    print(f"train launches {launches} (derived {want})", flush=True)
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise RuntimeError("train step gave a non-finite loss or norm")
    if launches != want:
        raise RuntimeError(f"train launches {launches} != {want}")

    # -- stage split of one more step (after the counters were read) ----------
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt = trainer.step_fn.optimizer
    model.zero_grad(set_to_none=True)
    ev[0].record()
    loss = model(*args)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    ev[3].synchronize()
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    print(f"train step split (CUDA events): forward {split[0]:.3f} ms, "
          f"backward with remat {split[1]:.3f} ms, AdamW {split[2]:.3f} ms "
          f"{tag}", flush=True)
    _profile_step(torch, trainer, batch, tag)
    return launches


KERNEL_GROUPS = (("flash attention", ("fa::",)), ("RMSNorm", ("rms::",)),
                 ("GEMM", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
                 ("AdamW", ("adam",)))


def _profile_step(torch, trainer, batch, tag):
    """One train step under torch.profiler: device time by kernel group
    and the share of the step's wall time with no kernel running."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_steps(iter([batch]), 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels = {}, []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if (ev.device_type != torch.autograd.DeviceType.CUDA or not us
                or getattr(ev, "is_user_annotation", False)
                or ev.key.startswith("Optimizer.")):
            continue  # a range around kernels, not a kernel
        name = ev.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        kernels.append((us / 1e3, ev.count, ev.key[:90]))
    busy = sum(groups.values())
    print(f"profiled train step: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle {100 * (1 - busy / wall_ms):.1f}% {tag}",
          flush=True)
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {ms:.1f} ms ({100 * ms / busy:.1f}%)", flush=True)
    for ms, n, key in sorted(kernels, reverse=True)[:12]:
        print(f"  {ms:9.2f} ms {n:5d}x {key}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from vlaser_tpu_torch.core.config import vlaser_2b_vla
    from vlaser_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = _card()
    tag = f"[{card}]"
    print(f"device: {torch.cuda.get_device_name(0)} | {card}", flush=True)
    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda, flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.last_build_seconds:.1f} s) -> {_build.BUILD_DIR}",
          flush=True)

    cfg = vlaser_2b_vla()
    report = {}
    launches = serving_phases(torch, np, dev, cfg, tag, report)
    gc.collect()
    torch.cuda.empty_cache()
    flash_phase(torch, dev, cfg, tag, report)
    rms_phase(torch, dev, cfg, tag, report)
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(train_phase(torch, np, dev, cfg, tag, report))
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "vlaser_tpu")]
    if bad:
        raise RuntimeError(f"the port imported {bad[:4]}")

    kernels = []
    for name, src, rep in (
            ("fused_vit_stack", "fused_vit.cu", "fused_vit.py:455"),
            ("fused_int8_stack", "fused_decode.cu", "fused_decode.py:303"),
            ("flash_attention_fwd", "flash_attention.cu",
             "flash_attention.py:159"),
            ("flash_attention_bwd", "flash_attention.cu",
             "flash_attention.py:416"),
            ("_rms_fwd", "rmsnorm.cu", "rmsnorm.py:64"),
            ("_rms_bwd", "rmsnorm.cu", "rmsnorm.py:89")):
        r = report[name]
        entry = {"name": name, "route": "cuda",
                 "source": "vlaser_tpu_torch/csrc/" + src,
                 "replaces": "vlaser_tpu/kernels/" + rep,
                 "launches": launches[name]}
        entry.update({k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")})
        if "joint" in r:
            entry["joint"] = r["joint"]
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
