#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vlaser_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the Hopper kernels from vlaser_tpu_torch/csrc (nvcc, sm_90a), builds
Vlaser-2B-VLA at full width with random N(0, 0.02^2) bf16 weights from a
seeded torch.Generator, quantizes it (int8 weight-only, POLICY_PATTERNS),
then:
  1. runs each kernel at the control step's shapes against its plain twin
     on the same CUDA tensors (fused_vit_stack 1x1025x1024 L=24;
     fused_int8_stack R=5 ext=384 and R=4 ext=385) and times both. The
     model's packed matrices are kept, but at N(0, 0.02^2) norms and layer
     scales every branch would vanish below bf16 rounding, so the kernel
     phase draws its own norms 1 + N(0, 0.1^2), ViT layer scales ~0.1, ViT
     q/k columns x4 (a peaked softmax) and external K/V ~N(0, 2^2). The
     bound on x_out is a share of what the stack changes, and controls
     (input unchanged, attention dropped, MLP dropped) must break it;
  2. drives the fused PolicyServer (reset + 3 steps on synthetic frames) with
     the launch counters zeroed just before and read just after;
  3. holds the fused actions to the plain infer_action oracle (<= 2e-2 max
     abs, the bound of bench.py's policy_infer_b1 gate) and times the
     control step on both paths with CUDA events.
Any failed phase raises (non-zero exit, no result line). The last line is
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

import json
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from vlaser_tpu.core.config import vlaser_2b_vla
    from vlaser_tpu.envs.adapters import BridgeSimplerAdapter
    from vlaser_tpu.image.tiling import normalize_uint8
    from vlaser_tpu.policy.processing import InternVLAProcessor
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.kernels import _build, fused_decode, fused_vit, ops
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.policy.fused_infer import pack_expert_stack
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.serve.policy_server import PolicyServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = _card()
    tag = f"[{card}]"
    print(f"device: {torch.cuda.get_device_name(0)} | {card}", flush=True)
    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda, flush=True)

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.last_build_seconds:.1f} s) -> {_build.BUILD_DIR}",
          flush=True)

    # -- model ------------------------------------------------------------
    cfg = vlaser_2b_vla()
    t0 = time.perf_counter()
    bf = torch.bfloat16
    model = PiZeroVLA(cfg, param_dtype=bf, compute_dtype=bf, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    init_normal_(model, gen, std=0.02)
    quantize_for_serving(model, target="policy", mode="int8")
    torch.cuda.synchronize()
    n_param = sum(b.numel() for b in model.buffers())
    print(f"model: Vlaser-2B-VLA, {n_param / 1e9:.3f} G elements, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(0)
    img = cfg.vlm.vision.image_size
    vcfg, ecfg = cfg.vlm.vision, cfg.expert
    report = {}

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
        report["fused_vit_stack"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=plain_ms)

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
        dec["ms"], dec["plain_ms"] = dec[f"ms_r{R}"], dec[f"plain_ms_r{R}"]
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
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB {tag}", flush=True)
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")

    kernels = []
    for name, src, rep in (
            ("fused_vit_stack", "vlaser_tpu_torch/csrc/fused_vit.cu",
             "vlaser_tpu/kernels/fused_vit.py:455"),
            ("fused_int8_stack", "vlaser_tpu_torch/csrc/fused_decode.cu",
             "vlaser_tpu/kernels/fused_decode.py:303")):
        r = report[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
