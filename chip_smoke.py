#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vlaser_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--ab PARENT_TREE]

With --ab (or its older name --flash-ab), the flash kernels, the int8 GEMM
(one Qwen2.5-1.5B layer's 7 GEMMs at 384, 3,072 and 3,584 rows, the
InternViT-300M stack's 4 products at 13,325 rows), the layer's activation
quantization at the same rows (the parent's route of 7 quantize_rows
launches and an eager silu * u against 4 launches), the RMSNorm backward
(12,288 x 1536), the fused ViT stack (bf16 at B 1, act_quant at B 1, 8 and
13) and the decoder stack (the decode at 384, 3,592 and 32,768 slots in
both weight modes, the denoise suffix at R 4 and 5) are also timed against
those of another tree (a `git archive` of the parent commit unpacked into
a git-ignored directory), each built alone, in turns: parent, change,
change, parent.

Builds the Hopper kernels from vlaser_tpu_torch/csrc (one nvcc per source,
all started together, sm_90a), then drives the port's paths at the full
width and depth of Vlaser-2B-VLA (phases 1-11), of the Vlaser-2B chat
model (phases 12-16), of the PaliGemma VLA (phases 17-19), of the
Vlaser-2B serving engine (phases 20-22, run first) and of the Vlaser-2B
SFT train step (phases 23-26, after 19) with random weights from seeded
generators:

Serving, weight-only int8 (bf16 weights N(0, 0.02^2),
quantize_for_serving(mode="int8")):
  1. each serving kernel at the control step's shapes against its plain
     twin on the same CUDA tensors (fused_vit_stack 1x1025x1024 L=24;
     fused_int8_stack R=5 ext=384 and R=4 ext=385), timed. The model's
     packed matrices are kept, but the kernel phase draws its own norms
     1 + N(0, 0.1^2), ViT layer scales ~0.1, ViT q/k columns x4 and
     external K/V ~N(0, 2^2), so every branch shows; the bound on x_out is
     a share of what the stack changes, and controls (input unchanged,
     attention dropped, MLP dropped) must break it; the twin's norm-bound
     shift is read over its 24 attentions (least m - max s, least d; a row
     with d == 0 fails); each stack call is one kernel launch under the
     profiler;
  2. the fused PolicyServer (reset + 3 steps), launch counters zeroed just
     before and read just after;
  3. the fused actions against the plain infer_action oracle (<= 2e-2 max
     abs, the bound of bench.py's policy_infer_b1 gate), and the control
     step timed on both paths; one fused step under torch.profiler.
Serving, w8a8 (the default: quantize_for_serving(target="policy")):
  4. quantize_rows and int8_gemm at the VLM prefix's 7 GEMM shapes (384
     and 3,072 rows) against their plain versions: int8 rows bit-identical,
     each y within one fp32 rounding; controls (half-away rounding on a row
     of exact .5 ties, row scale dropped, column scale dropped) must break
     the checks; timed against the plain versions and torch._int_mm; then
     quantize_silu_mul (down's input, h = silu(g) * u never stored) bit for
     bit against the eager product's rows (control: the product unrounded)
     and the layer's 4 quantizer launches timed against their bound;
  5. fused_vit_stack in act_quant mode at batch 1 and batch 8 against its
     twin, with phase 1's visible draws and bound; controls (input
     unchanged, activation scale dropped, MLP dropped, and at batch 8 fc2
     quantized as one group on weights whose fc1 halves differ 40x) must
     break it; timed, with the bound at the int8 and bf16 peaks, and the
     norm-bound shift's margins read as in phase 1;
  6. the two main paths, counters zeroed just before and read just after
     each, held to the counts the code implies: the fused PolicyServer
     (reset + 3 steps) and make_batched_infer_action at batch 8 (3 calls);
  7. bench.py's parity gates: fused vs plain at batch 1 (2e-2), w8a8 vs
     the unquantized bf16 model (2.5e-2), fused-ViT prefix K/V vs the plain
     encoder's (0.2), batched vs plain at batch 8 with distinct pixels and
     noise per row (2e-2);
  8. the w8a8 control step at batch 1 (median of 10) and batch 8 (median
     of 5), its stages, actions/s and peak device memory; one step of each
     under torch.profiler (device time by kernel group, idle share).
Training (fp32 parameters, bf16 compute, remat, batch 32):
  9. flash attention forward and backward at the ViT shape (B 32, S 1025,
     16/16 heads x 64, non-causal) and the joint shape (B 32, S 389, 12/2
     heads x 128, levels [0 x 384 | 1 | 2 x 4], a padded prompt tail of 60
     tokens), plus a causal block with q_offset > 0 at the joint widths,
     against the plain version; controls (levels ignored, padding keys
     unmasked, scale dropped, causal or q_offset dropped) must break the
     bounds. Timed against the plain version and PyTorch's
     scaled_dot_product_attention (a yardstick the port never calls), with
     the achieved TFLOP/s of both (the allowed pairs' flop over the time);
  10. RMSNorm forward and backward at 12,288 x 1536 bf16 against the plain
     version, and the forward again at the batch-8 serving prefix's 3,072 x
     1536 under inference_mode; controls (w ignored, the x * sum term of dx
     dropped). Timed against the plain version and
     torch.nn.functional.rms_norm;
  11. the train step: a parity gate (one loss + backward on the kernel path
     and one on the reference attention and RMSNorm, same weights, batch,
     t and x0: loss and each optimizer group's gradient norm), then 3
     VLATrainer.train_steps with VLATrainConfig() defaults, launch counters
     zeroed just before and read just after and held to the counts the
     code implies; losses, step time, its stage split and peak memory;
     then one more step under torch.profiler: device time per kernel group
     and the device's idle share.
Chat (Vlaser-2B: InternViT-300M + Qwen2.5-1.5B, bf16 weights N(0, 0.02^2),
quantize_for_serving(model) with its defaults, target "vlm", mode "w8a8"):
  12. fused_int8_stack in the decode configuration (R = 1, C = 1536, L = 28,
     fp32 rope tables) over caches of 384, the 13-tile chat's and 32,768
     slots, int8 and bf16-weight (dequantized weights, unit scales) modes,
     with visible norms and K/V ~N(0, 2^2), against its twin; controls
     (input unchanged, attention dropped, MLP dropped, cache mask ignored,
     rope dropped on k_self, and past 12,288 slots, where q is doubled so
     that a few keys carry each head, the keys from slot 12,288 on
     dropped) must break the bounds; timed,
     with one call's kernel launches (one) and device busy time from the
     profiler; the split-KV attention alone (R 1 over E keys, 12 / 2 x 128)
     against the plain split-KV attention (itself held to the unsplit
     softmax), timed beside SDPA;
  13. the other kernels at the chat shapes against their plain versions,
     with controls: act_quant fused_vit_stack on the chat's own tiles at
     B = 1, 8 and 13 (each bound no less than VIT_WITNESS_K x the distance
     of a witness twin that rounds its LayerNorm in another order; the
     13-tile output bit-equal to the kernel's at B = 8 and 5 on the same
     tiles; layer 0's differing int8 fc2 inputs counted; the attention
     kernel alone at B 13 x 1025 x 16 x 64 against its twin, timed beside
     SDPA), quantize_rows, quantize_silu_mul and
     int8_gemm at the prefill's rows, the causal flash prefill over the
     cache buffer (padded and future slots segment 0), again under a
     sliding window of 1,024 (control: window ignored), _rms_fwd at the
     prefill's rows;
  14. VlaserChat.chat with 13 tiles, 8 new tokens, bench.py's stub
     tokenizer: a warm-up, then 3 calls with the launch counters zeroed just
     before and read just after, held to the counts the code implies; the
     stage times (ViT, prefill, decode per token, lm_head per token); one
     prefill under torch.profiler: 4 quantizer launches a layer, no eager
     silu;
  15. one 13-tile chat call under torch.profiler;
  16. bench.py's decode configuration (1 tile, a 320-token prompt, 64 new
     tokens, mode "int8"): vlm_decode_tok_mismatches of the fused vs the
     plain generator, the fused decoder held to the plain one teacher-forced
     (DECODE_REL) with an ln1-ignored control; where the greedy streams
     first differ, the plain top-2 margin must be within the bound (a
     near-tie); tok/s and ms per token.
PaliGemma VLA (pizero_paligemma: SigLIP-So400m, the Gemma-2B mixture and
the 1024-wide Gemma expert; attn_impl "kernel"):
  17. flash attention forward and backward at its shapes against the plain
     version: the joint train pass (B 32, S 281, 8/1 heads x 256, softcap
     50, levels, a padded prompt tail), the serving suffix (B 1, 4 rows over
     281 keys) and SigLIP (B 32, S 256, 16/16 heads x 72), q and k drawn so
     that the logits' std is ~50; controls (softcap dropped, its 1 - t^2
     factor dropped, scale dropped, levels ignored, padding keys unmasked,
     at D 72 the last 8 dims of k zeroed) must break the bounds; timed
     against the plain version and, for SigLIP, SDPA;
  18. infer_action at batch 1 (276 prompt tokens, 10 Euler steps), bf16
     weights, the kernel route against the reference route on the same
     weights and inputs (<= PARITY_TOL), launch counters zeroed just before
     one call and read just after, held to the count the code implies; both
     routes timed; one call under torch.profiler;
  19. the flow-matching train step at batch 32 (or the largest batch that
     fits): a parity gate of loss and group gradient norms against the
     reference attention (LOSS_REL, GNORM_REL), 3 VLATrainer steps with
     derived launch counts, step time, peak memory, one step profiled.
The continuous-batching engine (Vlaser-2B, bf16 weights N(0, 0.02^2),
quantize_for_serving(model) with its defaults):
  20. the kernels at the engine's shapes against their plain versions
     (quantize_rows, quantize_silu_mul and int8_gemm at its largest
     admission group, 4 x 320 rows; flash at its ViT group of 4 tiles;
     _rms_fwd at the offline runner's 16 x 320 wave); then bench.py's
     _bench_engine workload (16 requests, prompts of 64-320 tokens, the
     320-token ones with a 448 px tile, max_new 16 / 32 / 64) through the
     engine (16 slots, max_len 448, buckets 64-320, chunk 64, pipeline
     depth 1), the engine with speculative_draft_len 4, the offline runner
     and the static batch-8 make_generate_fn: useful tokens/s (median of
     3 wall-clock runs after a warm-up), rows that differ from the solo
     plain decode (bf16, informational) with the first divergence and the
     plain top-2 margin there, the schedule (decode steps queued against
     steps with a live row); launch counters zeroed before the solo
     decodes and read after the four paths: flash_attention_fwd,
     int8_gemm, quantize_rows, quantize_silu_mul and _rms_fwd must each
     have launched;
  21. bench.py's engine fp32 gate on the card (tiny_vlm, fp32 compute and
     cache, default_rng(97)'s 16 requests, 3 slots, max_len 64): the
     bucketed, offline, speculative, prefix-cached and automatic-prefix
     rows must each be 0;
  22. VlaserChat(speculative_draft_len=4) at full width against the plain
     generator (1 tile, 64 new tokens; tokens reported, bf16), and at fp32
     on tiny_vlm, where the tokens must be equal.
The SFT train step (Vlaser-2B, N(0, 0.02^2) draws with norms 1 + N(0,
0.1^2) and ViT layer scales ~0.1; bench.py's synthetic batches):
  23. the SFT path's kernels at its shapes against their plain versions,
     with controls, timed: flash forward and backward (B 1, causal, 12 / 2
     heads x 128) at 2,048 tokens in per-token segments 1..4 (control:
     segments ignored) and at 16,384 in segment blocks of 2,048 (held
     block by block; controls: segments ignored, causal dropped); _rms_fwd
     / _rms_bwd at 2,048 and 16,384 x 1,536; quantize_rows and int8_gemm
     at one layer's 7 shapes at 2,048 and 16,384 rows;
  24. the QLoRA step of bench.py's _bench_sft_train (bf16, remat, the int8
     base with w8a8 on the LLM layers, LoRA r 64 alpha 128 on the LLM
     targets, the vocab-chunked CE in chunks of 512, AdamW 1e-4 with decay
     0.01 on the factors alone, no clip; B 1 x 2,048 tokens): a gate of
     one loss + backward on the kernel route against the reference
     attention and RMSNorm (loss LOSS_REL, LoRA gradient norm GNORM_REL,
     layer 0's and the final hidden states LAYER0_REL / HIDDEN_REL, max
     |dL/db| > 0; control: segments ignored), then a warm-up and 5 steps
     with the launch counters zeroed just before and read just after,
     held to the counts the code implies; tok/s, step ms, bench.py's fwd
     / bwd / optimizer split, peak memory; one step under torch.profiler;
  25. the same step at 16,384 tokens in segment blocks of 2,048
     (_bench_sft_16k): a warm-up and 2 counted steps, tok/s, peak memory;
     then merge_qlora_into_quant's float model against the int8 + LoRA
     model, weight-only, on a 384-token input (MERGE_REL);
  26. SFTTrainer with full parameters as scripts/train_sft.py builds it
     (fp32 parameters, bf16 compute, remat, TrainConfig() defaults, the
     ViT frozen) on one batch packed as PackedDataset emits it: 3 steps
     with derived launch counts, losses, grad norms, step ms, peak memory,
     the ViT bit for bit unchanged, and the cost of the ViT backward that
     grad_norm's parity with the JAX step takes.
Any failed phase raises (non-zero exit, no result line). The line before
the last lists every kernel; the last line is {"ok": true, "device": ...}.
"""

import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

CHANGE_TOL = 0.1  # x_out: max abs err <= 0.1 * max|twin - x_in|; k/v_self
                  # of every layer: <= 0.1 * max|twin| (they ride on x)
# act_quant ViT stack on the chat's uint8-noise tiles, where int8 rounding
# flips through 24 layers outgrow CHANGE_TOL: the bound is no less than this
# many times the distance of the witness twin (its LayerNorm rounded in
# another order) from the twin; the kernel lay 0.90-1.14x that distance on
# an H100 (_vit_bound)
VIT_WITNESS_K = 2.0
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
PEAK_INT8 = 1979e12  # int8 tensor cores, dense (operations/s)
# w8a8 (bench.py's bounds): fused vs plain actions at batch 8, w8a8 vs the
# unquantized bf16 model, fused-ViT prefix K/V vs the plain encoder's
PARITY_B8_TOL, W8A8_VS_BF16_TOL, VIT_KV_TOL = 2e-2, 2.5e-2, 0.2
# int8_gemm vs its plain version on the same int8 rows: the integer
# products are exact on both sides, so each y within one fp32 rounding
ONE_ROUNDING = 2.0 ** -23
B8 = 8  # the multi-robot serving batch (bench.py's batch-8 step)


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


SLEEP_CYCLES = 100_000_000  # ~50 ms of a device sleep at H100 clocks


def _kernel_ms(torch, fn, iters):
    """Device ms of one call of fn: after a warm-up call, a sleep kernel
    holds the stream while the host queues `iters` calls, so the events
    around them time the device, not the host's launch overhead (which
    per-call events of a short kernel would measure instead). If the sleep
    is still running once all are queued, there was no gap. Else (a long
    call whose launches fill the launch queue, which blocks the host until
    the device catches up, or a host slower than the device) the time is
    taken again with a marker event after each call: before a call is
    queued, the marker of the call before it (the start event, for the
    first) must still be pending, or the device ran dry. After two such
    tries (the second with a sleep 4x as long) that both saw a gap, the
    last time is returned and a line says it holds host gaps. Markers cost
    the device a few us a call, so short calls are timed without them."""
    fn()
    torch.cuda.synchronize()
    ms, gap = _queued_ms(torch, fn, iters, SLEEP_CYCLES, markers=False)
    for cycles in (SLEEP_CYCLES, 4 * SLEEP_CYCLES):
        if not gap:
            return ms
        ms, gap = _queued_ms(torch, fn, iters, cycles, markers=True)
    if gap:
        print(f"  (the time taken at chip_smoke.py:"
              f"{sys._getframe(1).f_lineno} holds host gaps: the host queues "
              f"this call slower than the device runs it)", flush=True)
    return ms


# more than the H100's 50 MB of L2: inputs cycled through this many bytes
# are read from device memory on every call
COLD_BYTES = 64 << 20


def _cold_ms(torch, fn, args, iters):
    """_kernel_ms of fn(*args) with args cycled through copies that hold
    COLD_BYTES or more together, so that each call reads its inputs from
    device memory (the bytes a bound counts), not from the L2 in which a
    repeated small input would stay."""
    n = sum(t.numel() * t.element_size() for t in args)
    sets = [tuple(args)] + [tuple(t.clone() for t in args)
                            for _ in range(-(-COLD_BYTES // n) - 1)]
    it = itertools.cycle(sets)
    ms = _kernel_ms(torch, lambda: fn(*next(it)), iters)
    del sets, it
    return ms


def _queued_ms(torch, fn, iters, cycles, markers):
    """-> (device ms a call over `iters` calls queued behind a sleep, whether
    the device may have run dry while they were queued)."""
    torch.cuda._sleep(cycles)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    mark, gap = s, False
    for _ in range(iters):
        if markers:
            gap = gap or mark.query()
        fn()
        if markers:
            mark = torch.cuda.Event()
            mark.record()
    if not markers:
        gap = s.query()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters, gap


def _bound(flops, nbytes, peak_flops):
    """-> (least ms for the work on an H100, what bounds it)."""
    return _bound_s(flops / peak_flops, nbytes)


def _bound_s(ops_seconds, nbytes):
    """As _bound, for work whose operations run at several peaks: the
    seconds those operations need at their peaks, summed by the caller."""
    t_ops, t_bytes = ops_seconds * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _counters():
    """Every kernel wrapper's launch counter: name -> (module, attribute)."""
    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import fused_decode, fused_vit, rmsnorm, w8a8

    return {"fused_vit_stack": (fused_vit, "launch_count"),
            "fused_vit_stack_w8a8": (fused_vit, "act_quant_launch_count"),
            "fused_int8_stack": (fused_decode, "launch_count"),
            "quantize_rows": (w8a8, "quant_launch_count"),
            "quantize_silu_mul": (w8a8, "silu_quant_launch_count"),
            "int8_gemm": (w8a8, "gemm_launch_count"),
            "flash_attention_fwd": (fa, "fwd_launch_count"),
            "flash_attention_bwd": (fa, "bwd_launch_count"),
            "_rms_fwd": (rmsnorm, "fwd_launch_count"),
            "_rms_bwd": (rmsnorm, "bwd_launch_count")}


def _zero_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def _stack_gate(torch, what, run, x, cos, sin, controls):
    """fused_int8_stack vs its twin: run(fn, cs=cos, sn=sin, **over) calls
    fn on one case. x_out within CHANGE_TOL of what the stack changes; the
    self K/V of every layer within CHANGE_TOL and layer 0's within KV0_TOL;
    each control (keyword overrides of the twin's arguments), the input
    itself and the rope dropped on k_self must break its bound."""
    from vlaser_tpu_torch.kernels import fused_decode

    got = run(fused_decode.fused_int8_stack)
    torch.cuda.synchronize()
    plain = lambda **o: run(fused_decode.fused_int8_stack_plain, **o)
    ref = plain()
    err = _gate(f"{what} x_out {tuple(x.shape)}", got[0], ref[0], x, {
        "input unchanged": x,
        **{k: plain(**o)[0] for k, o in controls.items()}})
    no_rope = plain(cs=torch.ones_like(cos), sn=torch.zeros_like(sin))
    for name, i in (("k_self", 1), ("v_self", 2)):
        a, b = got[i].float(), ref[i].float()
        for part, diff, bound in (
                ("all layers", a - b, CHANGE_TOL * b.abs().max().item()),
                ("layer 0", a[0] - b[0], KV0_TOL * b[0].abs().max().item())):
            e = diff.abs().max().item()
            print(f"{what} {name} {tuple(a.shape)} {part}: max_abs_err "
                  f"{e:.3e} (bound {bound:.3e})", flush=True)
            if not (e <= bound and a.isfinite().all()):
                raise RuntimeError(f"{what} {name} disagrees")
            err = max(err, e)
    ce = (no_rope[1][0].float() - ref[1][0].float()).abs().max().item()
    print(f"  control 'rope dropped' on k_self layer 0: {ce:.3e} (must "
          f"exceed the bound)", flush=True)
    if not ce > KV0_TOL * ref[1][0].float().abs().max().item():
        raise RuntimeError(f"{what}: the bound cannot see the rope")
    return err


def _stack_phases(torch, fn, L, dev):
    """One fused_int8_stack call (fn) with the kernel's trace on: -> mean
    us of each of a layer's 8 phases over the L layers (block 0's clock
    between grid barriers: a phase's slowest block and the barrier)."""
    from vlaser_tpu_torch.kernels import fused_decode

    fused_decode.trace = torch.zeros(1 + 8 * L, dtype=torch.int64,
                                     device=dev)
    try:
        fn()
        torch.cuda.synchronize()
        t = fused_decode.trace.double().cpu()
    finally:
        fused_decode.trace = None
    per = (t[1:] - t[:-1]).view(L, 8).mean(0) / 1e3
    return dict(zip(fused_decode.PHASES, [round(v, 2) for v in per.tolist()]))


def stack_launch_phase(torch, dev, llm, tag):
    """One fused_int8_stack call is one kernel launch: under torch.profiler,
    at R 1, 4 and 5 in both weight modes (2 layers of the model's widths;
    the count does not depend on depth). Run before any other tree's
    library is loaded: with one loaded, the profiler has been seen to miss
    cooperative launches."""
    from vlaser_tpu_torch.core.quant import quantize_int8
    from vlaser_tpu_torch.kernels import fused_decode, ops

    g = torch.Generator(device=dev)
    g.manual_seed(29)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    bf, L = torch.bfloat16, 2
    C, H, KVH, D, I = (llm.hidden_size, llm.num_heads, llm.num_kv_heads,
                       llm.head_dim, llm.intermediate_size)
    w = {}
    for n_, k, n in (("q", C, H * D), ("k", C, KVH * D), ("v", C, KVH * D),
                     ("o", H * D, C), ("g", C, I), ("u", C, I), ("d", I, C)):
        w["w" + n_], w["s" + n_] = quantize_int8(0.02 * r(L, k, n), -2)
    counts = {}
    for mode in ("int8", "bf16"):
        ws = dict(w)
        if mode == "bf16":
            for k in [k for k in w if k[0] == "w"]:
                ws[k] = (w[k].float() * w["s" + k[1:]]).to(bf)
                ws["s" + k[1:]] = torch.ones_like(w["s" + k[1:]])
        for R in (1, 4, 5):
            cos, sin = ops.rope_cos_sin(torch.arange(R, device=dev) + 3.0, D,
                                        llm.rope_theta)
            args = (r(R, C).to(bf), cos, sin, torch.zeros(R, R, device=dev),
                    torch.zeros(1, 384, device=dev), 1 + 0.1 * r(L, C),
                    1 + 0.1 * r(L, C), 0.02 * r(L, H * D),
                    0.02 * r(L, KVH * D), 0.02 * r(L, KVH * D),
                    *[ws[k] for k in ("wq", "sq", "wk", "sk", "wv", "sv", "wo",
                                      "so", "wg", "sg", "wu", "su", "wd",
                                      "sd")],
                    r(L, 384, KVH, D).to(bf), r(L, 384, KVH, D).to(bf))
            fused_decode.fused_int8_stack(*args)
            prof = _profile(torch, lambda: fused_decode.fused_int8_stack(
                *args), "", tag, quiet=True)
            counts[mode, R] = (prof["launches"], sorted(prof["kernels"]))
    print(f"fused_int8_stack: kernel launches in one call under the profiler "
          f"(weight mode, rows): {counts} {tag}", flush=True)
    if any(n != 1 for n, _ in counts.values()):
        raise RuntimeError("a fused_int8_stack call is not one launch")


def _gate(name, got, ref, x_in, controls, bound=None):
    """Kernel x_out vs twin within `bound` (default: CHANGE_TOL of what the
    twin changes); each control (a wrong answer) must break it."""
    ref = ref.float()
    if bound is None:
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
        what = f"fused_vit_stack {tuple(emb.shape)} L={vcfg.num_layers}"
        with _vit_shift_margins(torch, what):
            ref = plain()
        err = _gate(what, got, ref, emb, {
                        "input unchanged": emb,
                        "attention dropped": plain(ls1=0 * vs["ls1"]),
                        "MLP dropped": plain(ls2=0 * vs["ls2"])})
        torch.cuda.synchronize()
        ms = _kernel_ms(torch, lambda: fused_vit.fused_vit_stack(
            emb, **vs, **kw), 10)
        plain_ms = _kernel_ms(torch, plain, 3)
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

            tag_r = f"fused_int8_stack R={rows} ext={ext}"
            e = _stack_gate(torch, tag_r, run, x, cos, sin, {
                "attention dropped": dict(so=0 * stack["so"]),
                "MLP dropped": dict(sd=0 * stack["sd"])})
            dec["max_abs_err"] = max(dec["max_abs_err"], e)
            plain = lambda: run(fused_decode.fused_int8_stack_plain)
            torch.cuda.synchronize()
            ms = _kernel_ms(torch, lambda: run(fused_decode.fused_int8_stack),
                            20)
            plain_ms = _kernel_ms(torch, plain, 3)
            prof = _profile(torch, lambda: run(fused_decode.fused_int8_stack),
                            tag_r, tag, quiet=True)
            phases = _stack_phases(
                torch, lambda: run(fused_decode.fused_int8_stack), L, dev)
            print(f"fused_int8_stack R={rows} time: kernel {ms:.3f} ms, "
                  f"plain twin {plain_ms:.3f} ms; one call under the "
                  f"profiler: {prof['launches']} kernel launch(es), device "
                  f"busy {prof['busy']:.3f} ms, grid "
                  f"{fused_decode.grid_blocks(rows, False, dev)} blocks; "
                  f"us a layer by phase {phases} {tag}", flush=True)
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
    _zero_counts()
    chunks = [server.step(obs, f) for f in frames]
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counts().items() if v}
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
        # the int8 step's device time and idle share, beside the w8a8 one's
        _profile(torch, lambda: server._infer(*inputs), "int8 batch-1 step",
                 tag)
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


# -- serving w8a8: phases 4-8 ------------------------------------------------
def _kmajor_gb(model):
    """The device memory of the K-major int8 copies (the non-persistent
    `kernel_qt` buffers that a w8a8 Dense derives on its first w8a8 call,
    the act_quant ViT's packing included), by tower."""
    by = {}
    for name, buf in model.named_buffers():
        if name.endswith("kernel_qt"):
            k = ("ViT" if name.startswith("vision_model.") else
                 "expert" if ".expert." in name else "LLM")
            by[k] = by.get(k, 0) + buf.numel() * buf.element_size()
    return "of which K-major int8 copies: " + (", ".join(
        f"{k} {v / 1e9:.3f} GB" for k, v in sorted(by.items())) or "none")


def tmap_cache_ab(torch, step, launch, tag):
    """The tensor-map cache of csrc/sm90.cuh on and off, in turns (on, off,
    off, on): the host time of one int8_gemm call (the least mean of 20
    batches of 50 calls queued without a sync, so that neither the device
    nor a busy moment of the shared host counts) and the step (median of
    10, CUDA events). Then the maps one step asks for and how many the
    cache served. The cache is left on."""
    from vlaser_tpu_torch.kernels import _build

    host, steps = {True: [], False: []}, {True: [], False: []}
    for on in (True, False, False, True):
        _build.tmap_cache(on)
        step()  # fills the cache when it is on
        torch.cuda.synchronize()
        per_call = []
        for _ in range(20):
            t0 = time.perf_counter()
            for _ in range(50):
                launch()
            per_call.append((time.perf_counter() - t0) / 50 * 1e6)
            torch.cuda.synchronize()
        host[on].append(min(per_call))
        steps[on].append(_ms(torch, step, 10))
    _build.tmap_cache(True)
    before = _build.tmap_cache()
    step()
    torch.cuda.synchronize()
    after = _build.tmap_cache()
    hits = after["hits"] - before["hits"]
    misses = after["misses"] - before["misses"]
    fmt = lambda v: [round(x, 3) for x in v]
    print(f"tensor-map cache A/B (on, off, off, on): host us a int8_gemm "
          f"call: on {fmt(host[True])}, off {fmt(host[False])}; batch-1 "
          f"w8a8 step ms: on {fmt(steps[True])}, off {fmt(steps[False])}; "
          f"one step asks for {hits + misses} maps ({hits} from the cache, "
          f"{misses} encoded), {after['maps']} maps held {tag}", flush=True)
    return {"host_us": host, "step_ms": steps, "maps_a_step": hits + misses}


def _tie_row(torch, K, dev):
    """127 at column 0 (so 127 / amax = 1), exact .5 ties elsewhere: half to
    even and half away from zero round them differently."""
    row = (torch.arange(K, device=dev) % 120 - 60 + 0.5).float()
    row[0] = 127.0
    return row


def _gemm_sites(att, mlp):
    """The 7 w8a8 Dense sites of a Qwen2 layer stack."""
    return (("q_proj", att.q_proj), ("k_proj", att.k_proj),
            ("v_proj", att.v_proj), ("o_proj", att.o_proj),
            ("gate_proj", mlp.gate_proj), ("up_proj", mlp.up_proj),
            ("down_proj", mlp.down_proj))


# the sites whose inputs the main path quantizes with quantize_rows, once
# each: q/k/v share q_proj's input, gate/up gate_proj's; down_proj's input
# is quantize_silu_mul's (layer_quant_phase)
QUANT_SITES = ("q_proj", "o_proj", "gate_proj")


def gemm_phase(torch, sites, rows_list, dev, tag):
    """K1 (quantize_rows) and K2 (int8_gemm) at one layer's 7 GEMM shapes
    (layer 0's int8 weights of `sites`) for each row count, against the
    plain versions, with controls; timed against the plain versions and
    torch._int_mm, each K1 call on inputs cycled through COLD_BYTES
    (_cold_ms). Each report's ms, plain_ms and bound_ms sum the 7 shapes
    (as in every run since the port began); K1's "main_path" sums the 3
    inputs the main path quantizes with it (QUANT_SITES). Then the layer's
    4-launch quantization and K3 (quantize_silu_mul, layer_quant_phase).
    -> {rows: (K1, K2, K3 reports)}."""
    from vlaser_tpu_torch.kernels import w8a8

    g = torch.Generator(device=dev)
    g.manual_seed(6)
    out = {}
    for rows in rows_list:
        # sums over the 7 shapes; "by": bound ms per bounding resource
        k1 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "by": {}, "library_ms": None}
        main = {"inputs": len(QUANT_SITES), "ms": 0.0, "plain_ms": 0.0,
                "bound_ms": 0.0}
        k2 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "by": {}, "library_ms": 0.0, "torch_w8a8_ms": 0.0}
        for name, d in sites:
            kq, ks = d.kernel_kmajor(0), d.kernel_scale[0]  # [N, K], [1, N]
            N, K = kq.shape
            x = torch.randn(rows, K, generator=g, device=dev)
            x[0] = _tie_row(torch, K, dev)
            x[1] = 0.0
            x = x.to(torch.bfloat16)
            what = f"w8a8 {name} {rows}x{K} -> {N}"
            q, am = w8a8.quantize_rows(x)
            y = w8a8.int8_gemm(q, am, kq, ks)
            yb = w8a8.int8_gemm(q, am, kq, ks, torch.bfloat16)
            torch.cuda.synchronize()
            p_q, p_am = w8a8.quantize_rows_plain(x)
            p_y = w8a8.int8_gemm_plain(p_q, p_am, kq, ks)
            bad_q = int((q != p_q).sum())
            excess = ((y - p_y).abs() - ONE_ROUNDING * p_y.abs()).max().item()
            err = (y - p_y).abs().max().item()
            print(f"{what}: int8 rows differing {bad_q}, am equal "
                  f"{torch.equal(am, p_am)}; y max_abs_err {err:.3e} (each "
                  f"within one fp32 rounding: {excess <= 0}); bf16 out = "
                  f"fp32 out rounded: {torch.equal(yb, y.to(torch.bfloat16))}",
                  flush=True)
            if bad_q or not torch.equal(am, p_am) or excess > 0 or \
                    not torch.equal(yb, y.to(torch.bfloat16)):
                raise RuntimeError(f"{what}: kernel disagrees with plain")
            # controls: each must break its check
            v = x.float() * (torch.full_like(p_am, 127.0) / p_am)
            away = (torch.sign(v) * torch.floor(v.abs() + 0.5)).to(torch.int8)
            brk = {"half-away rounding": int((away != q).sum()),
                   "row scale dropped": (w8a8.int8_gemm_plain(
                       p_q, torch.full_like(p_am, 127.0), kq, ks) - y).abs(),
                   "column scale dropped": (w8a8.int8_gemm_plain(
                       p_q, p_am, kq, torch.ones_like(ks)) - y).abs()}
            for c in ("row scale dropped", "column scale dropped"):
                brk[c] = int((brk[c] > ONE_ROUNDING * p_y.abs()).sum())
            if rows == rows_list[0] and name == "q_proj":
                print(f"  controls, elements breaking the check (must be > "
                      f"0): {brk}", flush=True)
            if min(brk.values()) == 0:
                raise RuntimeError(f"{what}: a control passes the check {brk}")
            k1["max_abs_err"] = max(k1["max_abs_err"], float(bad_q))
            k2["max_abs_err"] = max(k2["max_abs_err"], err)

            # timing: the main path's call (bf16 out)
            t1 = _cold_ms(torch, w8a8.quantize_rows, (x,), 20)
            t2 = _kernel_ms(torch, lambda: w8a8.int8_gemm(q, am, kq, ks,
                                                   torch.bfloat16), 20)
            p1 = _kernel_ms(torch, lambda: w8a8.quantize_rows_plain(x), 5)
            p2 = _kernel_ms(torch, lambda: w8a8.int8_gemm_plain(
                p_q, p_am, kq, ks, torch.bfloat16), 5)
            kq_lib = kq.t()  # [K, N] column-major, as cuBLASLt's int8 GEMM
            lib = _kernel_ms(torch, lambda: torch._int_mm(q, kq_lib), 20)

            def torch_w8a8():
                xf = x.float()
                a = xf.abs().amax(-1, keepdim=True).clamp_min(1e-9)
                qa = torch.round(xf * (127.0 / a)).to(torch.int8)
                return (torch._int_mm(qa, kq_lib).float() * (a * (1 / 127))
                        * ks).to(torch.bfloat16)

            tw = _kernel_ms(torch, torch_w8a8, 20)
            b1_ms, b1_by = _bound_s(0, rows * K * 3 + rows * 4)
            b2_ms, b2_by = _bound(2 * rows * K * N, rows * K + K * N + N * 4
                                  + rows * 4 + rows * N * 2, PEAK_INT8)
            if name in QUANT_SITES:
                main["ms"] += t1
                main["plain_ms"] += p1
                main["bound_ms"] += b1_ms
            for rep, t, pt, bd, by in ((k1, t1, p1, b1_ms, b1_by),
                                       (k2, t2, p2, b2_ms, b2_by)):
                rep["ms"] += t
                rep["plain_ms"] += pt
                rep["bound_ms"] += bd
                rep["by"][by] = rep["by"].get(by, 0.0) + bd
            k2["library_ms"] += lib
            k2["torch_w8a8_ms"] += tw
            print(f"  {what} time: quantize_rows {t1:.4f} ms (plain {p1:.4f},"
                  f" bound {b1_ms:.4f}), int8_gemm {t2:.4f} ms (plain "
                  f"{p2:.3f}, bound {b2_ms:.4f}, torch._int_mm {lib:.4f}; "
                  f"torch w8a8 in eager ops {tw:.4f}) {tag}", flush=True)
        for rep in (k1, k2):
            by = rep.pop("by")
            rep["bound_by"] = max(by, key=by.get)
        k1["main_path"] = main
        print(f"w8a8 one layer's 7 prefix GEMMs at {rows} rows: quantize_rows "
              f"{k1['ms']:.4f} ms at the 7 shapes (bound "
              f"{k1['bound_ms']:.4f}; at the main path's 3 inputs "
              f"{main['ms']:.4f}, bound {main['bound_ms']:.4f}), int8_gemm "
              f"{k2['ms']:.4f} ms (bound {k2['bound_ms']:.4f}, "
              f"{k2['bound_by']}), torch._int_mm {k2['library_ms']:.4f} ms "
              f"{tag}", flush=True)
        k3, k1["layer"] = layer_quant_phase(
            torch, rows, dict(sites)["q_proj"].kernel_q.shape[-2],
            dict(sites)["down_proj"].kernel_q.shape[-2], dev, tag)
        out[rows] = (k1, k2, k3)
    return out


def _silu_mul_inputs(torch, g, rows, I, dev):
    """g, u bf16 [rows, I] (N(0, 2^2), N(0, 1)): row 0 makes h the tie row
    (silu(64) = 64, u = tie / 64, exact in bf16), row 1 makes h zero."""
    gg = torch.randn(rows, I, generator=g, device=dev) * 2
    uu = torch.randn(rows, I, generator=g, device=dev)
    gg[0], uu[0] = 64.0, _tie_row(torch, I, dev) / 64.0
    gg[1], uu[1] = 0.0, 0.0
    return gg.to(torch.bfloat16), uu.to(torch.bfloat16)


def layer_quant_phase(torch, rows, C, I, dev, tag):
    """One Qwen2 layer's activation quantization as its main path runs it
    at `rows` rows: quantize_rows on the 3 distinct C-wide inputs (q/k/v's,
    o's, gate/up's) and quantize_silu_mul on g, u [rows, I] (down's).
    quantize_silu_mul against its plain version (the eager F.silu(g) * u,
    then quantize_rows_plain): int8 rows and am bit for bit; control: the
    product left in fp32 (no bf16 rounding) must break it. Timed: the
    silu-mul kernel beside its plain version and the eager silu * u alone;
    the 4 launches together beside their bound, rows x (3 x (3C + 4) + 5I +
    4) bytes (58,640 a row for Qwen2.5-1.5B); the kernels on inputs cycled
    through COLD_BYTES (_cold_ms). -> (K3 report, layer report)."""
    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import w8a8

    g = torch.Generator(device=dev)
    g.manual_seed(28)
    bf = torch.bfloat16
    xs = [torch.randn(rows, C, generator=g, device=dev).to(bf)
          for _ in range(3)]
    gg, uu = _silu_mul_inputs(torch, g, rows, I, dev)
    q, am = w8a8.quantize_silu_mul(gg, uu)
    torch.cuda.synchronize()
    p_q, p_am = w8a8.quantize_silu_mul_plain(gg, uu)
    bad = int((q != p_q).sum())
    ctrl = int((w8a8.quantize_rows_plain(F.silu(gg).float() * uu.float())[0]
                != q).sum())
    what = f"quantize_silu_mul {rows}x{I}"
    print(f"{what}: int8 rows differing {bad}, am equal "
          f"{torch.equal(am, p_am)}; control (the product unrounded) "
          f"breaks {ctrl} (must be > 0) {tag}", flush=True)
    if bad or not torch.equal(am, p_am) or ctrl == 0:
        raise RuntimeError(f"{what}: kernel disagrees with plain")
    t3 = _cold_ms(torch, w8a8.quantize_silu_mul, (gg, uu), 20)
    p3 = _kernel_ms(torch, lambda: w8a8.quantize_silu_mul_plain(gg, uu), 5)
    eager = _kernel_ms(torch, lambda: F.silu(gg) * uu, 20)
    b3, b3_by = _bound_s(0, rows * I * 5 + rows * 4)

    def layer(*ins):
        for x in ins[:3]:
            w8a8.quantize_rows(x)
        w8a8.quantize_silu_mul(*ins[3:])

    tl = _cold_ms(torch, layer, (*xs, gg, uu), 20)
    bl, _ = _bound_s(0, rows * (3 * (3 * C + 4) + 5 * I + 4))
    print(f"  {what} time: {t3:.4f} ms (plain {p3:.4f}, bound {b3:.4f}; the "
          f"eager F.silu(g) * u alone {eager:.4f}) {tag}", flush=True)
    print(f"w8a8 one layer's quantization at {rows} rows: 4 launches "
          f"{tl:.4f} ms (bound {bl:.4f}, {bl / tl:.1%} of it) {tag}",
          flush=True)
    k3 = {"max_abs_err": float(bad), "ms": t3, "plain_ms": p3,
          "bound_ms": b3, "bound_by": b3_by, "library_ms": None,
          "eager_silu_mul_ms": eager}
    return k3, {"launches": 4, "ms": tl, "bound_ms": bl}


@contextmanager
def _vit_patched(**over):
    """kernels.fused_vit with some of its helpers replaced: a twin that is
    wrong (a control) or rounds at other points (a witness)."""
    from vlaser_tpu_torch.kernels import fused_vit

    old = {k: getattr(fused_vit, k) for k in over}
    for k, v in over.items():
        setattr(fused_vit, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(fused_vit, k, v)


@contextmanager
def _vit_shift_margins(torch, what):
    """Around twin runs of the ViT stack: over every layer's attention, the
    gap between the norm-bound shift m and each row's largest score (log2
    units; the least and the largest), the rows whose d under the bound
    falls below MIN_D, which the port shifts by their largest score, and
    among them those where the TPU kernel's exponents all underflow (its d
    = 0: a NaN row); and the least d of the port's shift, printed after. A
    row whose d is 0 or not finite fails the phase."""
    from vlaser_tpu_torch.kernels import fused_vit

    orig = fused_vit.shifted_attention
    seen = {"gap": math.inf, "gap_max": -math.inf, "d": math.inf,
            "tpu_zero": 0, "out": 0, "calls": 0}

    def record(q, k, v):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        m = fused_vit.norm_bound(q, k)
        mx = s.amax(-1, keepdim=True)
        gap = m - mx
        seen["gap"] = min(seen["gap"], gap.min().item())
        seen["gap_max"] = max(seen["gap_max"], gap.max().item())
        bf = torch.bfloat16
        d_tpu = torch.exp2(s - m).to(bf).float().sum(-1, keepdim=True)
        out = d_tpu < fused_vit.MIN_D
        seen["out"] += int(out.sum())
        seen["tpu_zero"] += int((d_tpu == 0).sum())
        d = torch.exp2(s - torch.where(out, mx, m)).to(bf).float().sum(-1)
        seen["d"] = min(seen["d"], d.min().item())
        seen["calls"] += 1
        del s, d
        return orig(q, k, v)

    with _vit_patched(shifted_attention=record):
        yield seen
    print(f"{what}: norm-bound shift over the twin's {seen['calls']} "
          f"attentions: m - max s from {seen['gap']:.2f} to "
          f"{seen['gap_max']:.2f} (log2 units); rows whose d under the bound "
          f"is below 2^-100, shifted by their largest score: {seen['out']}; "
          f"of them the TPU kernel's d == 0 (a NaN row): {seen['tpu_zero']}; "
          f"least d {seen['d']:.4e}", flush=True)
    if not (math.isfinite(seen["d"]) and seen["d"] > 0 and seen["gap"] >= 0):
        raise RuntimeError(f"{what}: a row's softmax denominator is 0")


def _vit_w8a8_stacks(torch, vision_model, vcfg, dev):
    """The model's int8 encoder weights with the kernel phase's visible
    norms: -> (stack, the same with fc1's halves 40x apart, kwargs)."""
    from vlaser_tpu_torch.kernels.fused_vit import pack_vit_stack

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    C, L, inter = vcfg.hidden_size, vcfg.num_layers, vcfg.intermediate_size
    vs = pack_vit_stack(vision_model)
    if vs.pop("act_quant", False) is not True:
        raise RuntimeError("the w8a8 encoder did not pack to act_quant")
    vs["qkvs"] = vs["qkvs"].clone()
    vs["qkvs"][:, :2 * C] *= 4
    for k in ("ln1w", "ln2w", "qnw", "knw"):
        vs[k] = 1 + 0.1 * rnd(*vs[k].shape)
    for k in ("ln1b", "ln2b"):
        vs[k] = 0.1 * rnd(*vs[k].shape)
    for k in ("ls1", "ls2"):
        vs[k] = 0.1 * (1 + 0.1 * rnd(*vs[k].shape))
    kw = dict(num_heads=vcfg.num_heads, eps=vcfg.layer_norm_eps,
              qk_norm=vcfg.qk_normalization, act_quant=True)
    # fc2's groups matter when the two halves of the GELU output differ in
    # size: fc1's second half x40 (int8 fc2 rows of that half / 40)
    half = inter // 2
    vg = dict(vs)
    vg["fc1s"], vg["fc1b"] = vs["fc1s"].clone(), vs["fc1b"].clone()
    vg["fc1s"][:, half:] *= 40
    vg["fc1b"][:, half:] *= 40
    vg["fc2w"] = vs["fc2w"].clone()  # K-major [L, C, inter]: K halves are
    vg["fc2w"][:, :, half:] = (vs["fc2w"][:, :, half:].float()  # columns
                               / 40).round().to(torch.int8)
    return vs, vg, kw


def _qdot_no_row_scale(a, w8, s):
    """The act_quant dot with the activation's row scale dropped."""
    from vlaser_tpu_torch.kernels import w8a8

    q, _ = w8a8.quantize_rows_plain(a)
    return w8a8.int_mm_exact(q, w8) * s.float()


def _vit_ln_two_pass(x, w, b, eps):
    """fused_vit._ln with its variance summed as mean((x - mean)^2): the same
    LayerNorm, rounded in another order (the witness twin's one change)."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    return xc * (xc * xc).mean(-1, keepdim=True).add(eps).rsqrt() * w.float() \
        + b.float()


def _vit_bound(what, got, ref, x, plain, v):
    """The act_quant stack's bound where int8 rounding flips, amplified
    through 24 layers, outgrow CHANGE_TOL: no less than VIT_WITNESS_K x the
    distance of the witness twin (the twin with its LayerNorm variance
    summed in another order, no other change) from the twin. Prints the
    readings: the error per tile, where the largest lies and how many bf16
    steps of the twin's value it spans."""
    with _vit_patched(_ln=_vit_ln_two_pass):
        wit = plain(v).float()
    ref = ref.float()
    diff = (got.float() - ref).abs()
    w = (wit - ref).abs().max().item()
    change = CHANGE_TOL * (ref - x.float()).abs().max().item()
    err = diff.max().item()
    at = [int(i) for i in _unravel(int(diff.argmax()), diff.shape)]
    val = ref[tuple(at)].item()
    step = 2.0 ** (math.floor(math.log2(max(abs(val), 1e-30))) - 7)
    tiles = ([round(t, 4) for t in diff.amax((1, 2)).tolist()]
             if diff.dim() == 3 else [round(err, 4)])
    print(f"{what}: kernel vs twin {err:.3e}, {err / change:.2f} x CHANGE_TOL"
          f"'s bound {change:.3e}; witness twin vs twin {w:.3e}, the kernel "
          f"{err / max(w, 1e-30):.2f} x that; per tile {tiles}; largest at {at}, twin "
          f"{val:.4f}, {err / step:.0f} bf16 steps there", flush=True)
    return max(change, VIT_WITNESS_K * w)


def _unravel(flat, shape):
    """A flat index -> its index along each of `shape`'s dimensions."""
    out = []
    for n in reversed(shape):
        flat, r = divmod(flat, n)
        out.append(r)
    return out[::-1]


def _vit_layer0_flips(torch, x, vs, kw):
    """Layer 0 of the act_quant stack on x: the int8 activations fc2 takes
    (the kernel's scratch after an L = 1 launch, laid out as
    fused_vit._launch lays it out) against the twin's, and the witness
    twin's against the twin's. -> {pair: (int8 values that differ, of how
    many, the largest difference in int8 steps)}."""
    from vlaser_tpu_torch.kernels import _build, fused_vit
    from vlaser_tpu_torch.kernels.fused_vit import fused_vit_stack_plain
    from vlaser_tpu_torch.kernels.w8a8 import quantize_rows_plain

    v1 = {k: t[:1].contiguous() for k, t in vs.items()}
    xb = x if x.dim() == 3 else x[None]
    B, S, C = xb.shape
    inter, M, G = v1["fc1w"].shape[1], B * S, fused_vit._fc2_groups(B)
    vecs = [v1[k] for k in ("ln1w", "ln1b", "ln2w", "ln2b", "ls1", "ls2",
                            "qnw", "knw", "qkvb", "projb", "fc1b", "fc2b")]
    scales = [v1[k] for k in ("qkvs", "projs", "fc1s", "fc2s")]
    mats = [v1[k] for k in ("qkvw", "projw", "fc1w", "fc2w")]
    fused_vit._check_args(x, vecs, mats, scales, kw["num_heads"])
    scratch, n_ws = fused_vit.w8a8_scratch(B, S, C, inter, x.device)
    aq = scratch[0]
    ptrs = [xb.reshape(M, C).clone(), *vecs, *scales, *mats, *scratch]
    heads = kw["num_heads"]
    code = fused_vit._kernel("vit_stack_forward_w8a8")(
        *[t.data_ptr() for t in ptrs], B, S, C, inter, heads, 1, kw["eps"],
        int(kw["qk_norm"]), (C // heads) ** -0.5 * fused_vit.LOG2E, n_ws,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "vit_stack_forward_w8a8")
    torch.cuda.synchronize()
    kernel_q = aq[:, :inter]

    def fc2_input(**over):  # the int8 fc2 input of the twin's layer 0
        seen, dot = [], fused_vit._qdot

        def record(a, w8, s):
            seen.append(a)
            return dot(a, w8, s)

        with _vit_patched(_qdot=record, **over):
            fused_vit_stack_plain(x, **v1, **kw)
        return torch.cat([quantize_rows_plain(a)[0] for a in seen[3:]], 1)

    twin_q = fc2_input()
    out = {}
    for pair, q in (("kernel vs twin", kernel_q),
                    ("witness vs twin", fc2_input(_ln=_vit_ln_two_pass))):
        d = (q.int() - twin_q.int()).abs()
        out[pair] = (int((d > 0).sum()), d.numel(), int(d.max()))
    return out


def vit_chat_phase(torch, vision_model, vcfg, dev, tiles, tag):
    """Phase 13 (part): the act_quant ViT stack on the chat's own tiles
    (uint8 noise, normalized as chat() gets it), at B = 1, 8 and 13 against
    its twin with controls, each bound no less than VIT_WITNESS_K x the
    witness twin's distance (_vit_bound); the 13-tile kernel output bit-equal
    to a second 13-tile run and to the kernel's at B = 8 and B = 5 on the
    same tiles; the int8 fc2 inputs of layer 0 that differ, kernel vs twin
    and witness twin vs twin, at each batch. -> the 13-tile report."""
    from vlaser_tpu_torch.kernels.fused_vit import fused_vit_stack

    B = tiles.shape[0]
    rep = vit_w8a8_phase(torch, vision_model, vcfg, dev, tiles, (1, B8, B),
                         tag, witness=True)[B]
    vs, _, kw = _vit_w8a8_stacks(torch, vision_model, vcfg, dev)
    with torch.inference_mode():
        x = vision_model.embed(tiles).to(torch.bfloat16).contiguous()
        run = lambda t: fused_vit_stack(t.contiguous(), **vs, **kw)
        a = run(x)
        same = {"a second run": torch.equal(a, run(x)),
                f"B = {B8}, tiles 0-{B8 - 1}": torch.equal(a[:B8], run(x[:B8])),
                f"B = {B - B8}, tiles {B8}-{B - 1}": torch.equal(
                    a[B8:], run(x[B8:]))}
        print(f"fused_vit_stack act_quant, {B} chat tiles: the kernel's "
              f"output bit-equal to {same}", flush=True)
        if not all(same.values()):
            raise RuntimeError("the 13-tile ViT stack differs from the same "
                               "kernel at other batches or on a second run")
        for Bf in (1, B8, B):
            flips = _vit_layer0_flips(torch, x[0] if Bf == 1 else x[:Bf], vs,
                                      kw)
            print(f"fused_vit_stack act_quant B={Bf} layer 0, int8 fc2 "
                  f"inputs that differ (count, of, largest step): {flips}",
                  flush=True)
        del a, x
    rep["attention"] = vit_attention_alone(torch, dev, B, vcfg, tag)
    return rep


def vit_attention_alone(torch, dev, B, vcfg, tag):
    """The ViT stack's one-pass attention alone at B x 1025 x 16 x 64 (q/k
    drawn with phase 1's x4 columns' spread) against the twin's, timed
    beside SDPA on the same q, k, v (a yardstick the port does not call).
    -> report."""
    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import fused_vit

    g = torch.Generator(device=dev)
    g.manual_seed(14)
    S = (vcfg.image_size // vcfg.patch_size) ** 2 + 1
    H, C = vcfg.num_heads, vcfg.hidden_size
    D, bf = C // H, torch.bfloat16
    r = lambda: torch.randn(B * S, C, generator=g, device=dev)
    qs = (r() * 0.5 * D ** -0.5 * fused_vit.LOG2E).to(bf)
    ks, vs = (r() * 0.5).to(bf), r().to(bf)
    what = f"fused_vit attention alone B={B} S={S} H={H} D={D}"
    with torch.inference_mode():
        got = fused_vit.attention(qs, ks, vs, B, S, H)
        torch.cuda.synchronize()
        ref = fused_vit._attention(qs, ks, vs, B, S, H)
        err = (got.float() - ref.float()).abs().max().item()
        bound = FLASH_REL * ref.float().abs().max().item()
        print(f"{what}: kernel vs twin max_abs_err {err:.3e} (bound "
              f"{bound:.3e})", flush=True)
        if not (err <= bound and got.float().isfinite().all()):
            raise RuntimeError(f"{what}: disagrees with the twin")
        del ref
        norms = fused_vit.attention_norms(qs, ks, B, S, H)
        ms = _kernel_ms(torch, lambda: fused_vit.attention(qs, ks, vs, B, S,
                                                           H, norms), 10)
        t = lambda x: x.view(B, S, H, D).transpose(1, 2).contiguous()
        qt, kt, vt = t(qs), t(ks), t(vs)
        lib = _kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt), 10)
    flops = 4 * B * S * S * C
    bound_ms, bound_by = _bound(flops, 4 * B * S * C * 2, PEAK_BF16)
    print(f"{what} time: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s), sdpa {lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s), "
          f"bound {bound_ms:.4f} ms ({bound_by}) {tag}", flush=True)
    return dict(max_abs_err=err, ms=ms, library_ms=lib, bound_ms=bound_ms,
                bound_by=bound_by)


def vit_w8a8_phase(torch, vision_model, vcfg, dev, frames, batches, tag,
                   witness=False):
    """fused_vit_stack act_quant vs its twin at each batch (the first B
    frames) on the model's int8 encoder weights, with the kernel phase's
    visible norms. With `witness`, each bound is also no less than
    VIT_WITNESS_K x the witness twin's distance from the twin (_vit_bound).
    -> {B: report}."""
    from vlaser_tpu_torch.kernels.fused_vit import (fused_vit_stack,
                                                    fused_vit_stack_plain)

    C, L, inter = vcfg.hidden_size, vcfg.num_layers, vcfg.intermediate_size
    vs, vg, kw = _vit_w8a8_stacks(torch, vision_model, vcfg, dev)
    rep = {}
    with torch.inference_mode():
        for B in batches:
            emb = vision_model.embed(frames[:B]).to(
                torch.bfloat16).contiguous()
            x = emb[0] if B == 1 else emb
            got = fused_vit_stack(x, **vs, **kw)
            torch.cuda.synchronize()
            plain = lambda v=vs, **o: fused_vit_stack_plain(x, **{**v, **o},
                                                            **kw)
            with _vit_patched(_qdot=_qdot_no_row_scale):
                no_row_scale = plain()
            what = f"fused_vit_stack act_quant {tuple(x.shape)} L={L}"
            with _vit_shift_margins(torch, what):
                ref = plain()
            bound = _vit_bound(what, got, ref, x, plain, vs) if witness \
                else None
            err = _gate(what, got, ref, x, {
                "input unchanged": x,
                "activation scale dropped": no_row_scale,
                "MLP dropped": plain(ls2=0 * vs["ls2"])}, bound)
            del no_row_scale, ref
            if B > 1:
                got_g = fused_vit_stack(x, **vg, **kw)
                with _vit_patched(_fc2_groups=lambda b: 1):
                    one_group = plain(vg)
                ref = plain(vg)
                bound = _vit_bound(what + " fc1 halves x1/x40", got_g, ref, x,
                                   plain, vg) if witness else None
                err = max(err, _gate(what + " fc1 halves x1/x40", got_g,
                                     ref, x,
                                     {"fc2 quantized as one group":
                                      one_group}, bound))
                del got_g, one_group, ref
            torch.cuda.synchronize()
            ms = _kernel_ms(torch, lambda: fused_vit_stack(x, **vs, **kw),
                     10 if B == 1 else 5)
            plain_ms = _kernel_ms(torch, plain, 1)
            S_v, M = emb.shape[1], B * emb.shape[1]
            ops_s = (2 * M * L * (4 * C * C + 2 * C * inter) / PEAK_INT8
                     + 4 * B * S_v * S_v * C * L / PEAK_BF16)
            nbytes = (sum(v.numel() * v.element_size() for v in vs.values())
                      + 2 * x.numel() * 2)
            bound_ms, bound_by = _bound_s(ops_s, nbytes)
            print(f"{what} time: kernel {ms:.3f} ms, plain twin "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
                  f"{tag}", flush=True)
            rep[B] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None)
            del got, emb, x
            gc.collect()
            torch.cuda.empty_cache()
    return rep


def w8a8_phases(torch, np, dev, cfg, tag, report):
    """The w8a8 serving default: -> launches of the two main paths (the
    batch-1 server and the batch-8 batched path)."""
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.envs.adapters import BridgeSimplerAdapter
    from vlaser_tpu_torch.kernels import w8a8
    from vlaser_tpu_torch.kernels.fused_vit import (fused_vit_stack,
                                                    pack_vit_stack)
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.policy.fused_infer import make_batched_infer_action
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
    S, img = cfg.max_image_text_tokens, cfg.vlm.vision.image_size
    A = (cfg.num_action_tokens, cfg.action_dim)
    proc = InternVLAProcessor(SmokeTokenizer(cfg.vlm),
                              num_image_tokens=cfg.vlm.num_image_token,
                              max_seq_len=S, pad_token_id=cfg.vlm.pad_token_id)
    p = proc(["put the carrot on the plate"],
             np.zeros((1, 1, img, img, 3), np.uint8))
    ids1 = torch.from_numpy(p["input_ids"]).to(dev)
    mask1 = torch.from_numpy(p["attention_mask"]).to(dev)
    # bench.py's parity inputs: uniform pixels, normal noise, distinct for
    # every row at batch 8; one prompt for all rows; zero proprio
    g = torch.Generator(device=dev)
    g.manual_seed(42)
    px8 = torch.rand((B8, img, img, 3), generator=g, device=dev)
    nz8 = torch.randn((B8, *A), generator=g, device=dev)
    pr8 = torch.zeros((B8, cfg.cond_steps, cfg.proprio_dim), device=dev)
    ids8, mask8 = ids1.expand(B8, -1).contiguous(), mask1.expand(
        B8, -1).contiguous()
    in1 = (ids1, px8[:1], mask1, pr8[:1], nz8[:1])
    in8 = (ids8, px8, mask8, pr8, nz8)
    with torch.inference_mode():
        a_bf16 = model.infer_action(*in1)  # the unquantized model
    quantize_for_serving(model, target="policy")  # w8a8, the default
    torch.cuda.synchronize()
    n_param = sum(t.numel() for t in model.state_dict().values())
    print(f"w8a8 serving model: Vlaser-2B-VLA, {n_param / 1e9:.3f} G "
          f"elements, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on "
          f"device, {time.perf_counter() - t0:.1f} s", flush=True)

    vlm = model.joint.layers.vlm
    out = gemm_phase(torch, _gemm_sites(vlm, vlm.mlp),
                     (S, B8 * S), dev, tag)
    (k1, k2, k3), (k1b8, k2b8, k3b8) = out[S], out[B8 * S]
    k1["b8"], k2["b8"], k3["b8"] = k1b8, k2b8, k3b8
    report["quantize_rows"], report["int8_gemm"] = k1, k2
    report["quantize_silu_mul"] = k3
    rep = vit_w8a8_phase(torch, model.vision_model, cfg.vlm.vision, dev, px8,
                         (1, B8), tag)
    rep[1]["b8"] = rep[B8]
    report["fused_vit_stack_w8a8"] = rep[1]
    gc.collect()
    torch.cuda.empty_cache()

    # -- main path 1: the fused PolicyServer at batch 1 ---------------------
    L = cfg.vlm.llm.num_layers
    # the VLM prefix's layers: q/k/v share one quantization, o its own,
    # gate/up one, down the silu-mul kernel; 7 GEMMs
    per_step = {"fused_vit_stack_w8a8": 1,
                "fused_int8_stack": cfg.num_inference_steps,
                "quantize_rows": 3 * L, "quantize_silu_mul": L,
                "int8_gemm": 7 * L}
    stats = {"action": {"p01": [-0.05] * 6 + [0.0], "p99": [0.05] * 6 + [1.0],
                        "mean": [0.0] * 7, "std": [1.0] * 7},
             "proprio": {"p01": [-0.5] * 6 + [0.0], "p99": [0.5] * 6 + [1.0],
                         "mean": [0.0] * 7, "std": [1.0] * 7}}
    adapter = BridgeSimplerAdapter(dataset_statistics=stats,
                                   image_size=(img, img))
    server = PolicyServer(model, None, adapter, proc, act_steps=4, seed=0,
                          fused=True, device=dev)
    server.reset("put the carrot on the plate")
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (img, img, 3), dtype=np.uint8)
              for _ in range(STEPS)]
    obs = {"agent": {"eef_pos": np.array([0.1, 0.0, 0.2, 1, 0, 0, 0, 0.5],
                                         np.float32)}}
    torch.cuda.synchronize()
    _zero_counts()
    chunks = [server.step(obs, f) for f in frames]
    torch.cuda.synchronize()
    got = {k: v for k, v in _read_counts().items() if v}
    want = {k: STEPS * v for k, v in per_step.items()}
    print(f"w8a8 server: {STEPS} steps, actions finite "
          f"{all(bool(np.isfinite(c).all()) for c in chunks)}, first "
          f"{np.round(chunks[0][0], 4).tolist()}; launches {got} (derived "
          f"{want})", flush=True)
    if not all(c.shape == (4, 7) and np.isfinite(c).all() for c in chunks):
        raise RuntimeError("w8a8 server returned bad action chunks")
    if got != want:
        raise RuntimeError(f"w8a8 server launches {got} != {want}")
    launches = dict(got)

    # -- main path 2: the batched path at batch 8 ---------------------------
    batched = make_batched_infer_action(model)
    per_step8 = {"fused_vit_stack_w8a8": 1, "quantize_rows": 3 * L,
                 "quantize_silu_mul": L, "int8_gemm": 7 * L}
    if B8 * S >= 2048 and cfg.vlm.llm.hidden_size <= 2048:
        per_step8["_rms_fwd"] = 2 * L  # the VLM mixture's two norms a layer
    torch.cuda.synchronize()
    _zero_counts()
    with torch.inference_mode():
        outs8 = [batched(*in8) for _ in range(STEPS)]
    torch.cuda.synchronize()
    got = {k: v for k, v in _read_counts().items() if v}
    want = {k: STEPS * v for k, v in per_step8.items()}
    print(f"w8a8 batched path: {STEPS} calls at batch {B8}, actions "
          f"{tuple(outs8[0].shape)} finite "
          f"{all(bool(o.isfinite().all()) for o in outs8)}; launches {got} "
          f"(derived {want})", flush=True)
    if not all(o.isfinite().all() and o.shape == (B8, cfg.horizon_steps,
                                                  cfg.action_dim)
               for o in outs8):
        raise RuntimeError("batched path returned bad actions")
    if got != want:
        raise RuntimeError(f"batched path launches {got} != {want}")
    _add(launches, got)
    print(f"w8a8 serving model after both main paths: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device "
          f"({_kmajor_gb(model)}) {tag}", flush=True)

    # -- parity at bench.py's bounds -----------------------------------------
    with torch.inference_mode():
        a_fused = server._infer(*in1)
        a_plain = model.infer_action(*in1)
        vit = pack_vit_stack(model.vision_model)
        vcfg = cfg.vlm.vision
        vkw = dict(num_heads=vcfg.num_heads, eps=vcfg.layer_norm_eps,
                   qk_norm=vcfg.qk_normalization)
        emb = model.vit_embed(in1[1])
        hidden = fused_vit_stack(emb[0].to(bf).contiguous(), **vit, **vkw)
        kv_f = model.vlm_prefix_from_embeds(
            model.fuse_vit_features(ids1, hidden[None].to(emb.dtype)), mask1)
        kv_p = model.vlm_prefix_from_embeds(
            model._image_text_embeds(ids1, in1[1]), mask1)
        a8_f = batched(*in8)
        a8_p = model.infer_action(*in8)
        torch.cuda.synchronize()
    gates = (
        ("fused vs plain, batch 1", (a_fused - a_plain).abs().max().item(),
         PARITY_TOL),
        ("w8a8 vs the bf16 model (plain)",
         (a_plain - a_bf16).abs().max().item(), W8A8_VS_BF16_TOL),
        ("fused-ViT prefix K/V vs plain", max(
            (kv_f[i].float() - kv_p[i].float()).abs().max().item()
            for i in (0, 1)), VIT_KV_TOL),
        ("batched vs plain, batch 8", (a8_f - a8_p).abs().max().item(),
         PARITY_B8_TOL))
    for name, d, tol in gates:
        print(f"w8a8 parity: {name}: max_abs_diff {d:.3e} (bound {tol})",
              flush=True)
    print(f"  |a| max: b1 {a_plain.abs().max().item():.3e}, b8 "
          f"{a8_p.abs().max().item():.3e}; prefix |k| max "
          f"{kv_p[0].float().abs().max().item():.3e}", flush=True)
    finite = all(bool(t.isfinite().all()) for t in (a_fused, a8_f, *kv_f))
    if not finite or any(not d <= tol for _, d, tol in gates):
        raise RuntimeError("w8a8 parity gate failed")
    del kv_f, kv_p, a8_p

    # -- timing: control steps and their stages ------------------------------
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        step_ms = _ms(torch, lambda: server._infer(*in1), 10)
        q_s, am_s = w8a8.quantize_rows(torch.randn(
            S, vlm.q_proj.kernel_q.shape[-2], device=dev).to(bf))
        kt_s, ks_s = vlm.q_proj.kernel_kmajor(0), vlm.q_proj.kernel_scale[0]
        tmap_cache_ab(torch, lambda: server._infer(*in1),
                      lambda: w8a8.int8_gemm(q_s, am_s, kt_s, ks_s), tag)
        step8_ms = _ms(torch, lambda: batched(*in8), 5)
        emb8 = model.vit_embed(px8).to(bf).contiguous()
        vit_ms = _ms(torch, lambda: fused_vit_stack(emb8[0], **vit, **vkw), 10)
        vit8_ms = _ms(torch, lambda: fused_vit_stack(emb8, **vit, **vkw), 5)
        hid8 = fused_vit_stack(emb8, **vit, **vkw)
        embeds8 = model.fuse_vit_features(ids8, hid8)
        prefix_ms = _ms(torch, lambda: model.vlm_prefix_from_embeds(
            embeds8[:1], mask1), 10)
        prefix8_ms = _ms(torch, lambda: model.prefix_forward_from_embeds(
            embeds8, mask8, pr8), 5)
        pre8 = model.prefix_forward_from_embeds(embeds8, mask8, pr8)

        def denoise8():  # infer_action_from_embeds after its prefix
            action, dt = nz8, 1.0 / cfg.num_inference_steps
            for i in range(cfg.num_inference_steps):
                t = torch.full((B8,), float(i), device=dev) * dt
                action = action + dt * model.denoise_step(action, t, *pre8)
            return action

        denoise8_ms = _ms(torch, denoise8, 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    dec, R = report["fused_int8_stack"], cfg.num_action_tokens
    stacks_ms = (dec[f"ms_r{cfg.num_proprio_tokens + R}"]
                 + (cfg.num_inference_steps - 1) * dec[f"ms_r{R}"])
    n_a = cfg.horizon_steps
    print(f"w8a8 control step (median, CUDA events): batch 1 {step_ms:.3f} "
          f"ms ({1e3 * n_a / step_ms:.1f} actions/s), batch {B8} "
          f"{step8_ms:.3f} ms ({1e3 * B8 * n_a / step8_ms:.1f} actions/s); "
          f"peak device memory {peak:.2f} GiB {tag}", flush=True)
    # each stage timed alone; host-bound stages vary from run to run, so
    # the stages need not add up to the step
    print(f"w8a8 stages, each timed alone: batch 1: vit stack {vit_ms:.3f} "
          f"ms, vlm prefix {prefix_ms:.3f} ms, denoise "
          f"{cfg.num_inference_steps} int8 stacks {stacks_ms:.3f} ms (phase "
          f"1's kernel times); batch {B8}: vit stack {vit8_ms:.3f} ms, joint "
          f"prefix {prefix8_ms:.3f} ms, denoise {cfg.num_inference_steps} "
          f"plain steps {denoise8_ms:.3f} ms {tag}", flush=True)
    with torch.inference_mode():
        _profile(torch, lambda: server._infer(*in1), "w8a8 batch-1 step", tag)
        _profile(torch, lambda: batched(*in8), f"w8a8 batch-{B8} step", tag)
    return launches


# -- training: phase 9, flash attention ---------------------------------------
def _flash_inputs(torch, g, dev, B, Sq, Skv, H, KVH, D, gain=1.0):
    """q, k, v, dout ~ N(0, 1) in bf16; q and k x gain."""
    bf = torch.bfloat16
    r = lambda *s, m=1.0: (torch.randn(s, generator=g, device=dev) * m).to(bf)
    return (r(B, Sq, H, D, m=gain), r(B, Skv, KVH, D, m=gain),
            r(B, Skv, KVH, D), r(B, Sq, H, D))


def _bwd_plain_no_cap_factor(fa, *args, **kw):
    """flash_attention_bwd_plain with the cap's derivative 1 - t^2 dropped
    (a control: the logits stay capped)."""
    capped = fa._capped
    fa._capped = lambda s, cap: (capped(s, cap)[0], None)
    try:
        return fa.flash_attention_bwd_plain(*args, **kw)
    finally:
        fa._capped = capped


def _flash_case(torch, dev, g, tag, name, B, Sq, Skv, H, KVH, D, q_seg,
                q_lev, seg, lev, causal=False, off=0, cap=None, gain=1.0,
                timed=True):
    """flash_attention_fwd / _bwd at one shape against the plain versions on
    the same CUDA tensors. Controls, where they apply: scale dropped, levels
    ignored, padding keys unmasked, packed segments ignored, causal and
    q_offset dropped, softcap
    and its 1 - t^2 factor dropped, and at D = 72 the last 8 dims of k
    zeroed. Fully masked rows must give zeros. When `timed`: times against
    the plain version and, without a softcap (which no PyTorch call
    computes), scaled_dot_product_attention, with bounds from this data's
    mask. -> (fwd report, bwd report)."""
    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = _flash_inputs(torch, g, dev, B, Sq, Skv, H, KVH, D, gain)
    qm, km = fa.pack_meta(q_seg, q_lev), fa.pack_meta(seg, lev)
    what = (f"flash {name} B={B} Sq={Sq} Skv={Skv} H={H}/{KVH} D={D}"
            + (f" causal q_offset={off}" if causal else "")
            + (f" softcap={cap}" if cap else ""))
    out, lse = fa.flash_attention_fwd(q, k, v, qm, km, off, causal,
                                      softcap=cap)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, qm, km, off, out, lse, do,
                                        causal, softcap=cap)
    torch.cuda.synchronize()
    keys = ("out", "lse", "dq", "dk", "dv")

    def plain(qm_=qm, km_=km, off_=off, causal_=causal, scale=None, cap_=cap,
              k_=k, factor=True):
        o, l = fa.flash_attention_fwd_plain(q, k_, v, qm_, km_, off_, causal_,
                                            scale, cap_)
        bwd = (fa.flash_attention_bwd_plain if factor else
               lambda *a: _bwd_plain_no_cap_factor(fa, *a))
        grads = bwd(q, k_, v, qm_, km_, off_, out, lse, do, causal_, scale,
                    cap_)
        return dict(zip(keys, (o, l, *grads)))

    got, ref = dict(zip(keys, (out, lse, dq, dk, dv))), plain()
    bounds = {kk: FLASH_REL * ref[kk].float().abs().max().item()
              for kk in ("out", "dq", "dk", "dv")}
    bounds["lse"] = LSE_ABS
    controls = {"scale dropped": plain(scale=1.0)}
    if lev is not None and Sq == Skv:
        controls["levels ignored"] = plain(fa.pack_meta(q_seg),
                                           fa.pack_meta(seg))
    if not bool(seg.all()):
        controls["padding keys unmasked"] = plain(
            km_=fa.pack_meta(torch.ones_like(seg), lev))
    if int(seg.max()) > 1 and Sq == Skv:  # packed segments
        controls["segments ignored"] = plain(
            fa.pack_meta(torch.ones_like(q_seg), q_lev),
            fa.pack_meta(torch.ones_like(seg), lev))
    if causal:
        controls["causal dropped"] = plain(causal_=False)
    if off:
        controls["q_offset dropped"] = plain(off_=0)
    if cap:
        controls["softcap dropped"] = plain(cap_=None)
        controls["(1 - t^2) dropped"] = {
            kk: plain(factor=False)[kk] for kk in ("dq", "dk")}
    if D % 16:  # D = 72: the 8 dims past the last full 16-wide step
        k0 = k.clone()
        k0[..., D - 8:] = 0
        controls["last 8 dims of k zeroed"] = plain(k_=k0)
    live = q_seg != 0  # fully masked rows: lse -1e30 on both sides
    pick = lambda d: {**d, "lse": d["lse"].transpose(1, 2)[live]} \
        if "lse" in d else d
    errs = _check(what, pick(got), pick(ref), bounds,
                  {c: pick(d) for c, d in controls.items()})
    if not ((out[~live] == 0).all() and (dq[~live] == 0).all()):
        raise RuntimeError(f"{what}: fully masked rows must give zeros")
    del ref, controls
    t_fwd = {"max_abs_err": errs["out"]}
    t_bwd = {"max_abs_err": max(errs["dq"], errs["dk"], errs["dv"])}
    if not timed:
        return t_fwd, t_bwd

    pairs = fa._allowed(qm, km, off, causal).sum().item()
    io = (q.numel() + k.numel() + v.numel()) * 2
    meta = (qm.numel() + km.numel()) * 4
    lse_b = lse.numel() * 4
    fwd_args = (q, k, v, qm, km, off, causal)
    bwd_args = (q, k, v, qm, km, off, out, lse, do, causal)
    t_fwd.update(
        ms=_kernel_ms(torch, lambda: fa.flash_attention_fwd(
            *fwd_args, softcap=cap), 10),
        plain_ms=_kernel_ms(torch, lambda: fa.flash_attention_fwd_plain(
            *fwd_args, softcap=cap), 3), library_ms=None)
    t_fwd["bound_ms"], t_fwd["bound_by"] = _bound(
        4 * D * H * pairs, io + q.numel() * 2 + lse_b + meta, PEAK_BF16)
    t_bwd.update(
        ms=_kernel_ms(torch, lambda: fa.flash_attention_bwd(
            *bwd_args, softcap=cap), 10),
        plain_ms=_kernel_ms(torch, lambda: fa.flash_attention_bwd_plain(
            *bwd_args, softcap=cap), 3), library_ms=None)
    t_bwd["bound_ms"], t_bwd["bound_by"] = _bound(
        10 * D * H * pairs, 2 * io + 2 * q.numel() * 2 + lse_b + meta,
        PEAK_BF16)
    if not cap:
        # the yardstick: one PyTorch call on the same inputs, [B, H, S, D],
        # K/V repeated over each group's q heads
        rep = lambda t: t.repeat_interleave(H // KVH, dim=2)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, rep(k), rep(v)))
        dot = do.transpose(1, 2).contiguous()
        mask = None
        if lev is not None or not bool(seg.all()):
            mask = fa._allowed(qm, km, off, causal)[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        t_fwd["library_ms"] = _kernel_ms(torch, sdpa, 10)
        o_lib = sdpa()
        t_bwd["library_ms"] = _kernel_ms(torch, lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), dot, retain_graph=True), 10)
        del o_lib, qt, kt, vt, dot, mask
    for nm, t, flop in (("fwd", t_fwd, 4 * D * H * pairs),
                        ("bwd", t_bwd, 10 * D * H * pairs)):
        _flash_rate(t, flop)
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.3f} ms "
                    f"({t['library_tflops']:.1f} TFLOP/s)")
        print(f"flash {nm} {name} time: kernel {t['ms']:.3f} ms "
              f"({t['tflops']:.1f} TFLOP/s), plain {t['plain_ms']:.3f} ms, "
              f"sdpa {lib}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}) "
              f"{tag}", flush=True)
    return t_fwd, t_bwd


def _flash_rate(rep, flop):
    """Achieved TFLOP/s of the kernel (and of the library call, where there
    is one): the flop the allowed pairs need over the measured time."""
    rep["tflops"] = flop / rep["ms"] / 1e9
    if rep.get("library_ms") is not None:
        rep["library_tflops"] = flop / rep["library_ms"] / 1e9


def flash_phase(torch, dev, cfg, tag, report):
    """Phase 9: the train step's shapes (the ViT and the joint) and a causal
    block with q_offset > 0 at the joint widths (_flash_case)."""
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    vcfg, llm, ecfg = cfg.vlm.vision, cfg.vlm.llm, cfg.expert
    S_it = cfg.max_image_text_tokens
    S_j = cfg.total_tokens
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
        t_fwd, t_bwd = _flash_case(torch, dev, g, tag, name, B, Sq, Skv, H,
                                   KVH, D, q_seg, q_lev, seg, lev, causal,
                                   off, timed=not causal)
        fwd_rep["max_abs_err"] = max(fwd_rep["max_abs_err"],
                                     t_fwd.pop("max_abs_err"))
        bwd_rep["max_abs_err"] = max(bwd_rep["max_abs_err"],
                                     t_bwd.pop("max_abs_err"))
        if name == "vit":
            fwd_rep.update(t_fwd)
            bwd_rep.update(t_bwd)
        elif name == "joint":
            fwd_rep["joint"], bwd_rep["joint"] = t_fwd, t_bwd
    report["flash_attention_fwd"] = fwd_rep
    report["flash_attention_bwd"] = bwd_rep


def rms_serving(torch, g, dev, ns, H, eps, label, tag, cold=False):
    """_rms_fwd at a serving shape (ns x H bf16, bf16 weights, under
    inference_mode) against the plain version, with the w-ignored control;
    timed against the plain version and F.rms_norm, each on inputs cycled
    through COLD_BYTES when `cold` (_cold_ms), else on the one repeated
    input. -> report."""
    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import rmsnorm

    bf = torch.bfloat16
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    rel = {"y": RMS_REL, "rrms": RRMS_REL}
    with torch.inference_mode():
        xs, ws = r(ns, H).to(bf), (1 + 0.1 * r(H)).to(bf)
        ys, rs = rmsnorm.rms_fwd(xs, ws, eps)
        torch.cuda.synchronize()

        def plain_s(w_=ws):
            return dict(zip(("y", "rrms"), rmsnorm.rms_fwd_plain(xs, w_, eps)))

        ref_s = plain_s()
        errs_s = _check(f"rms_norm {ns}x{H} bf16 (serving, {label})",
                        {"y": ys, "rrms": rs}, ref_s,
                        {k: rel[k] * ref_s[k].float().abs().max().item()
                         for k in ref_s},
                        {"w ignored": plain_s(torch.ones_like(ws))})
        if cold:
            timed = lambda fn, n: _cold_ms(torch, lambda x, w: fn(x, w, eps),
                                           (xs, ws), n)
        else:
            timed = lambda fn, n: _kernel_ms(torch, lambda: fn(xs, ws, eps),
                                             n)
        s_rep = {"max_abs_err": max(errs_s.values()),
                 "ms": timed(rmsnorm.rms_fwd, 20),
                 "plain_ms": timed(rmsnorm.rms_fwd_plain, 5),
                 "library_ms": timed(lambda x, w, e: F.rms_norm(
                     x, (H,), w, e), 20)}
    s_rep["bound_ms"], s_rep["bound_by"] = _bound(
        4 * xs.numel(), 2 * xs.numel() * 2 + H * 2 + ns * 4, PEAK_FP32)
    print(f"rms_norm fwd {ns} rows (serving, {label}"
          f"{', cold inputs' if cold else ''}) time: kernel "
          f"{s_rep['ms']:.4f} ms, plain {s_rep['plain_ms']:.4f} ms, torch "
          f"rms_norm {s_rep['library_ms']:.4f} ms, bound "
          f"{s_rep['bound_ms']:.4f} ms ({s_rep['bound_by']}) {tag}",
          flush=True)
    return s_rep


# -- training: phase 10, RMSNorm ----------------------------------------------
def rms_phase(torch, dev, cfg, tag, report):
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    llm = cfg.vlm.llm
    f_rep, b_rep = rms_train_case(
        torch, g, dev, 32 * cfg.max_image_text_tokens, llm.hidden_size,
        llm.rms_norm_eps, "", tag)
    # the forward at the batch-8 serving prefix's shape (8 x 384 rows, bf16
    # weights, under inference_mode as make_batched_infer_action runs it)
    f_rep["b8"] = rms_serving(torch, g, dev, B8 * cfg.max_image_text_tokens,
                              llm.hidden_size, llm.rms_norm_eps,
                              f"batch {B8}", tag)
    report["_rms_fwd"], report["_rms_bwd"] = f_rep, b_rep


def rms_train_case(torch, g, dev, n, H, eps, label, tag):
    """_rms_fwd and _rms_bwd at n x H bf16 (a training shape) against the
    plain versions, dw twice bit-equal; controls (w ignored, the x * sum
    term of dx dropped); timed against the plain versions and
    F.rms_norm's forward and backward. -> (fwd report, bwd report)."""
    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import rmsnorm

    bf = torch.bfloat16
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
             "ms": _kernel_ms(torch, lambda: rmsnorm.rms_fwd(x, w, eps), 20),
             "plain_ms": _kernel_ms(torch, lambda: rmsnorm.rms_fwd_plain(
                 x, w, eps),
                             5),
             "library_ms": _kernel_ms(torch, lambda: F.rms_norm(
                 x, (H,), w, eps),
                               20)}
    f_rep["bound_ms"], f_rep["bound_by"] = _bound(
        4 * x.numel(), 2 * nb + H * 2 + n * 4, PEAK_FP32)
    b_rep = {"max_abs_err": max(errs["dx"], errs["dw"]),
             "ms": _kernel_ms(torch, lambda: rmsnorm.rms_bwd(
                 x, w, gy, rrms), 20),
             "plain_ms": _kernel_ms(torch, lambda: rmsnorm.rms_bwd_plain(
                 x, w, gy, rrms), 5)}
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    yl = F.rms_norm(xl, (H,), wl, eps)
    b_rep["library_ms"] = _kernel_ms(torch, lambda: torch.autograd.grad(
        yl, (xl, wl), gy, retain_graph=True), 20)
    b_rep["bound_ms"], b_rep["bound_by"] = _bound(
        8 * x.numel(), 3 * nb + H * 2 + n * 4 + H * 4, PEAK_FP32)
    for nm, t in (("fwd", f_rep), ("bwd", b_rep)):
        print(f"rms_norm {nm}{label} {n} rows time: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, torch rms_norm "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}) {tag}", flush=True)
    return f_rep, b_rep


# -- training: phase 11, the train step ---------------------------------------
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
    _zero_counts()
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
    launches = {k: v for k, v in _read_counts().items() if v}
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


# -- chat: phases 12-16 ------------------------------------------------------
CHAT_TILES, CHAT_NEW = 13, 8  # bench.py's 13-tile chat prefill, 8 tokens
DECODE_PROMPT, DECODE_NEW = 320, 64  # bench.py's decode: 1 tile, 320 tokens
# decode parity, fused vs plain decoder teacher-forced on the plain stream:
# every step's logits within DECODE_REL x max |plain logits| (both round to
# bf16 at other points through 28 layers); greedy tokens equal wherever the
# plain top-2 margin exceeds that bound
DECODE_REL = 2e-2
LONG_CACHE = 32768  # Qwen2.5-1.5B's max_position_embeddings
FAR_KEYS = 12288  # the long cache's control drops the keys from this slot on
CHAT_WINDOW = 1024  # the windowed prefill case: keys at most 1,024 back


class ChatStubTokenizer:
    """bench.py's offline stand-in for the HF tokenizer (no model files on
    disk): <IMG_CONTEXT> maps to the config's image token id, everything
    else hashes per character into the normal-token range; EOS is id 2."""

    IC = "<IMG_CONTEXT>"

    def __init__(self, img_context_token_id: int):
        self._img_id = int(img_context_token_id)

    def __call__(self, text, add_special_tokens=False):
        ids, i = [], 0
        while i < len(text):
            if text.startswith(self.IC, i):
                ids.append(self._img_id)
                i += len(self.IC)
            else:
                ids.append(7 + (ord(text[i]) % 89))
                i += 1
        return {"input_ids": ids}

    def convert_tokens_to_ids(self, tok):
        return 2

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _chat_model(torch, dev, cfg, seed):
    """Vlaser-2B (or `cfg`) with bf16 weights N(0, 0.02^2) from a seeded
    generator, as bench.py draws them; float, not yet quantized."""
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.models.vlm import InternVLChatModel

    bf = torch.bfloat16
    model = InternVLChatModel(cfg, param_dtype=bf, compute_dtype=bf,
                              device=dev)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init_normal_(model, gen, std=0.02)


def decode_kernel_phase(torch, model, dev, cache_lens, tag):
    """Phase 12: fused_int8_stack in the decode configuration (R = 1, the
    model's LLM stack, fp32 rope tables) over caches of each length, int8
    and bf16-weight modes, against its twin with controls; timed, with the
    attention kernel's share of a call from the profiler."""
    from vlaser_tpu_torch.inference.fused_runner import (STACK_ARGS,
                                                         pack_qwen2_stack)
    from vlaser_tpu_torch.kernels import fused_decode, ops

    llm = model.cfg.llm
    L, D, KVH = llm.num_layers, llm.head_dim, llm.num_kv_heads
    bf = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    stack = pack_qwen2_stack(model.language_model)
    stack["ln1"] = 1 + 0.1 * rnd(*stack["ln1"].shape)
    stack["ln2"] = 1 + 0.1 * rnd(*stack["ln2"].shape)
    stacks = {"int8": stack, "bf16": dict(stack)}
    for k in STACK_ARGS:  # the same weights dequantized, unit scales
        if k[0] == "w":
            w, sname = stack[k], "s" + k[1:]
            stacks["bf16"][k] = (w.float() * stack[sname]).to(bf)
            stacks["bf16"][sname] = torch.ones_like(stack[sname])
    out = {"int8": {}, "bf16": {}, "attention": {}}
    for E in cache_lens:
        x = rnd(1, llm.hidden_size).to(bf)
        pos = torch.tensor([E - 40.0], device=dev)
        cos, sin = ops.rope_cos_sin(pos, D, llm.rope_theta)  # fp32 tables
        selfm = torch.zeros(1, 1, device=dev)
        extm = torch.zeros(1, E, device=dev)
        # a bucket's padded prompt slots and the empty future slots
        extm[0, int(0.85 * E):int(0.9 * E)] = fused_decode.NEG_INF
        extm[0, int(0.98 * E):] = fused_decode.NEG_INF
        k_e, v_e = (2 * rnd(L, E, KVH, D)).to(bf), (2 * rnd(L, E, KVH, D)).to(bf)
        past = extm.clone()  # the far half of a long cache dropped
        past[0, FAR_KEYS:] = fused_decode.NEG_INF
        for mode, st in stacks.items():
            if E > FAR_KEYS:
                # over this many keys a softmax of the draws' scores (std
                # ~1.6) is near uniform and attention adds ~0: q x2 (exact
                # in both modes) leaves a few keys to carry each head
                st = dict(st)
                w = "sq" if mode == "int8" else "wq"
                st[w], st["bq"] = 2 * st[w], 2 * st["bq"]

            def run(fn, cs=cos, sn=sin, em=extm, st=st, **over):
                w = {**st, **over}
                return fn(x, cs, sn, selfm, em, *[w[k] for k in STACK_ARGS],
                          k_e, v_e, eps=llm.rms_norm_eps)

            what = f"fused_int8_stack decode {mode} R=1 C={llm.hidden_size} E={E}"
            controls = {"attention dropped": dict(so=0 * st["so"]),
                        "MLP dropped": dict(sd=0 * st["sd"]),
                        "cache mask ignored": dict(em=torch.zeros_like(extm))}
            if E > FAR_KEYS:
                controls[f"keys from slot {FAR_KEYS} on dropped"] = \
                    dict(em=past)
            err = _stack_gate(torch, what, run, x, cos, sin, controls)
            torch.cuda.synchronize()
            ms = _kernel_ms(torch, lambda: run(fused_decode.fused_int8_stack),
                            20 if E < LONG_CACHE else 5)
            plain_ms = _kernel_ms(torch, lambda: run(
                fused_decode.fused_int8_stack_plain), 3)
            w_bytes = sum(st[k].numel() * st[k].element_size()
                          for k in STACK_ARGS)
            nbytes = (w_bytes + 2 * k_e.numel() * 2 + extm.numel() * 4
                      + x.numel() * 2 * 2 + 2 * L * KVH * D * 2)
            flops = (2 * sum(st[k].numel() for k in STACK_ARGS if k[0] == "w")
                     + 4 * L * llm.num_heads * D * (E + 1))
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_FP32)
            prof = _profile(torch, lambda: run(fused_decode.fused_int8_stack),
                            what, tag, quiet=True)
            phases = _stack_phases(
                torch, lambda: run(fused_decode.fused_int8_stack), L, dev)
            print(f"{what} time: kernel {ms:.3f} ms, plain twin "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                  f"one call under the profiler: {prof['launches']} kernel "
                  f"launch(es), device busy {prof['busy']:.3f} ms; us a "
                  f"layer by phase {phases} {tag}", flush=True)
            out[mode][E] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=None, launches_per_call=prof[
                                    "launches"], profiled_busy_ms=prof["busy"],
                                phase_us=phases)
        out["attention"][E] = decode_attention_alone(
            torch, dev, llm, k_e[0], v_e[0], extm, g, tag)
        del k_e, v_e, past
        gc.collect()
        torch.cuda.empty_cache()
    return out


def decode_attention_alone(torch, dev, llm, k_e, v_e, extm, g, tag):
    """The stack's split-KV attention alone at the decode shape (R = 1 over
    E keys, 12 / 2 heads x 128; layer-0 K/V of phase 12): against the plain
    split-KV attention at the planner's chunk, which is held against the
    unsplit softmax; timed beside SDPA on the same keys (a yardstick the
    port does not call). -> report."""
    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import fused_decode as fd

    H, KVH, D = llm.num_heads, llm.num_kv_heads, llm.head_dim
    E, G, bf = k_e.shape[0], H // KVH, torch.bfloat16
    q = (2 * torch.randn(1, H * D, generator=g, device=dev)).to(bf)
    ks = (2 * torch.randn(1, KVH, D, generator=g, device=dev)).to(bf)
    vs = (2 * torch.randn(1, KVH, D, generator=g, device=dev)).to(bf)
    selfm = torch.zeros(1, 1, device=dev)
    chunk = fd.kv_chunk(E + 1, KVH, 1)
    what = f"split-KV attention alone R=1 E={E} H={H}/{KVH} D={D} chunk {chunk}"
    with torch.inference_mode():
        got = fd.split_kv_attention(q, k_e, v_e, ks, vs, selfm, extm)
        torch.cuda.synchronize()
        keys = torch.cat([k_e, ks]).float()  # [E + 1, KVH, D]
        vals = torch.cat([v_e, vs]).float()
        mask = torch.cat([extm, selfm], 1)
        qf = q.float().view(H, D) * D ** -0.5
        split = torch.cat([fd.split_kv_attention_plain(
            qf[h:h + 1], keys[:, h // G], vals[:, h // G], mask, chunk)
            for h in range(H)], 1)
        whole = torch.cat([torch.softmax(qf[h:h + 1] @ keys[:, h // G].T
                                         + mask, -1) @ vals[:, h // G]
                           for h in range(H)], 1)
        split_err = (split - whole).abs().max().item()
        split_bound = 1e-5 * max(1.0, whole.abs().max().item())
        err = (got.float() - split).abs().max().item()
        bound = FLASH_REL * split.abs().max().item()
        print(f"{what}: kernel vs plain split-KV max_abs_err {err:.3e} "
              f"(bound {bound:.3e}); plain split-KV vs the unsplit softmax "
              f"{split_err:.3e} (bound {split_bound:.3e})", flush=True)
        if not (err <= bound and split_err <= split_bound
                and got.float().isfinite().all()):
            raise RuntimeError(f"{what}: disagrees")
        ms = _kernel_ms(torch, lambda: fd.split_kv_attention(
            q, k_e, v_e, ks, vs, selfm, extm), 20)
        qt = q.view(1, H, 1, D)
        kt = torch.cat([k_e, ks]).repeat_interleave(G, 1).transpose(0, 1)[None]
        vt = torch.cat([v_e, vs]).repeat_interleave(G, 1).transpose(0, 1)[None]
        lib = _kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt.contiguous(), vt.contiguous(), attn_mask=mask.to(bf)), 20)
    nbytes = 2 * (E + 1) * KVH * D * 2 + (E + 1) * 4 + 2 * H * D * 2
    bound_ms, bound_by = _bound(4 * H * D * (E + 1), nbytes, PEAK_FP32)
    print(f"{what} time: kernel {ms:.4f} ms, sdpa {lib:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}) {tag}", flush=True)
    return dict(max_abs_err=err, ms=ms, library_ms=lib, bound_ms=bound_ms,
                bound_by=bound_by)


def flash_prefill_phase(torch, dev, llm, n_valid, Sq, Skv, tag, window=None):
    """Phase 13 (part): flash_attention_fwd as the chat prefill calls it:
    causal, q_offset 0, K/V the cache buffer (Skv = Sq + new tokens) whose
    bucket padding and future slots are segment 0; with `window`, the
    sliding window of a Qwen2 config that sets one. Padded query rows have
    no allowed key (out 0 on both sides). Controls: causal dropped, padded
    queries unmasked, scale dropped (causality alone hides the padded keys
    from every valid query), window ignored. -> report."""
    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    H, KVH, D = llm.num_heads, llm.num_kv_heads, llm.head_dim
    q, k, v, _ = _flash_inputs(torch, g, dev, 1, Sq, Skv, H, KVH, D)
    i32 = dict(dtype=torch.int32, device=dev)
    q_seg = torch.zeros(1, Sq, **i32)
    q_seg[:, :n_valid] = 1
    kv_seg = torch.zeros(1, Skv, **i32)
    kv_seg[:, :n_valid] = 1
    qm, km = fa.pack_meta(q_seg), fa.pack_meta(kv_seg)
    what = (f"flash chat prefill Sq={Sq} Skv={Skv} H={H}/{KVH} D={D} causal"
            + (f" window={window}" if window is not None else ""))
    with torch.inference_mode():
        out, lse = fa.flash_attention_fwd(q, k, v, qm, km, 0, True,
                                          window=window)
        torch.cuda.synchronize()

        def plain(qm_=qm, causal=True, scale=None, window_=window):
            o, l = fa.flash_attention_fwd_plain(q, k, v, qm_, km, 0, causal,
                                                scale, window=window_)
            return {"out": o, "lse": l}

        ref = plain()
        valid = q_seg[0] == 1  # padded query rows: lse is -1e30 on both
        pick = lambda d: {"out": d["out"], "lse": d["lse"][..., valid]}
        ones = fa.pack_meta(torch.ones_like(q_seg))
        controls = {"causal dropped": pick(plain(causal=False)),
                    "padded queries unmasked": pick(plain(qm_=ones)),
                    "scale dropped": pick(plain(scale=1.0))}
        if window is not None:
            controls["window ignored"] = pick(plain(window_=None))
        errs = _check(what, pick({"out": out, "lse": lse}), pick(ref),
                      {"out": FLASH_REL * ref["out"].float().abs().max().item(),
                       "lse": LSE_ABS}, controls)
        if not (out[0, ~valid] == 0).all():
            raise RuntimeError(f"{what}: padded query rows must give zeros")
        del ref, controls
        rep = {"max_abs_err": errs["out"],
               "ms": _kernel_ms(torch, lambda: fa.flash_attention_fwd(
                   q, k, v, qm, km, 0, True, window=window), 10),
               "plain_ms": _kernel_ms(torch, lambda: fa.flash_attention_fwd_plain(
                   q, k, v, qm, km, 0, True, window=window), 2)}
        allowed = fa._allowed(qm, km, 0, True, window)
        pairs = allowed.sum().item()
        io = (q.numel() * 2 + k.numel() + v.numel()) * 2
        rep["bound_ms"], rep["bound_by"] = _bound(
            4 * D * H * pairs, io + lse.numel() * 4 + (Sq + Skv) * 4,
            PEAK_BF16)
        rep_ = lambda t: t.repeat_interleave(H // KVH, dim=2)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, rep_(k),
                                                              rep_(v)))
        mask = allowed[:, None]
        rep["library_ms"] = _kernel_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=mask), 10)
    _flash_rate(rep, 4 * D * H * pairs)
    print(f"{what} time: kernel {rep['ms']:.3f} ms ({rep['tflops']:.1f} "
          f"TFLOP/s), plain {rep['plain_ms']:.3f} ms, sdpa "
          f"{rep['library_ms']:.3f} ms ({rep['library_tflops']:.1f} TFLOP/s), "
          f"bound {rep['bound_ms']:.4f} ms ({rep['bound_by']}) {tag}",
          flush=True)
    return rep


def prefill_quant_profile(torch, prefill, L, n, tag):
    """One prefill under torch.profiler: the activation quantizer's kernel
    must launch 4 times a layer (q/k/v, o, gate/up, the silu-mul of down)
    and no eager silu kernel may run."""
    keys = _profile(torch, prefill, f"{n}-row prefill", tag,
                    quiet=True)["launch_keys"]
    nq = sum(c for k, c in keys.items() if "w8a8::quantize" in k)
    ns = sum(c for k, c in keys.items() if "silu" in k.lower())
    print(f"profiled {n}-row prefill: {nq} quantizer launches ({nq / L:g} a "
          f"layer, {L} layers), {ns} eager silu launches {tag}", flush=True)
    if nq != 4 * L or ns:
        raise RuntimeError(f"prefill: {nq} quantizer and {ns} silu launches, "
                           f"not {4 * L} and 0")


def chat_phases(torch, np, dev, cfg, tag, report):
    """Phases 12-16, the Vlaser-2B chat path: -> launches of the main path
    (3 timed 13-tile VlaserChat.chat calls)."""
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.image.tiling import normalize_uint8
    from vlaser_tpu_torch.inference import fused_runner as fr
    from vlaser_tpu_torch.inference.chat import VlaserChat
    from vlaser_tpu_torch.inference.kv_cache import KVCache
    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import rmsnorm
    from vlaser_tpu_torch.tokenizer.conversation import build_chat_query

    t0 = time.perf_counter()
    llm, vcfg = cfg.llm, cfg.vision
    L = llm.num_layers
    model = quantize_for_serving(_chat_model(torch, dev, cfg, 9))  # defaults
    torch.cuda.synchronize()
    n_param = sum(t.numel() for t in model.state_dict().values())
    print(f"chat model: Vlaser-2B, quantize_for_serving defaults (vlm, "
          f"w8a8), {n_param / 1e9:.3f} G elements, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    tok = ChatStubTokenizer(cfg.img_context_token_id)
    chat = VlaserChat(model, tok, max_new_tokens=CHAT_NEW)
    if chat._fused_gen is None:
        raise RuntimeError("VlaserChat did not route to the fused runner")
    question = "What is shown in this image?"
    rng = np.random.default_rng(12)
    img = vcfg.image_size
    tiles = torch.from_numpy(normalize_uint8(rng.integers(
        0, 256, (CHAT_TILES, img, img, 3), dtype=np.uint8))).to(dev)
    query = build_chat_query(cfg.template, "<image>\n" + question,
                             [CHAT_TILES], cfg.num_image_token)
    ids, seg = chat._encode([query])
    n, n_valid = ids.shape[1], int(seg.sum())
    E = n + CHAT_NEW

    # -- phase 12: the decode kernel, int8 and bf16-weight modes ------------
    dec = decode_kernel_phase(torch, model, dev,
                              (DECODE_PROMPT + DECODE_NEW, E, LONG_CACHE),
                              tag)
    # -- phase 13: the other kernels at the chat shapes ---------------------
    vit = vit_chat_phase(torch, model.vision_model, vcfg, dev, tiles, tag)
    lay = model.language_model.model.layers
    (k1, k2, k3), = gemm_phase(torch, _gemm_sites(lay.self_attn, lay.mlp),
                               (n,), dev, tag).values()
    flash = flash_prefill_phase(torch, dev, llm, n_valid, n, E, tag)
    # the same prefill under a sliding window short enough to bite (a Qwen2
    # config's sliding_window; Vlaser-2B ships without one)
    flash_w = flash_prefill_phase(torch, dev, llm, n_valid, n, E, tag,
                                  window=CHAT_WINDOW)
    rms = rms_serving(torch, torch.Generator(device=dev).manual_seed(13), dev,
                      n, llm.hidden_size, llm.rms_norm_eps, "chat prefill",
                      tag)
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 14: VlaserChat.chat, 13 tiles, counters around 3 calls -------
    resp = chat.chat(question, tiles)  # warm-up
    torch.cuda.synchronize()
    # derived from the code: one act_quant ViT stack; 7 w8a8 Dense a layer
    # in the prefill (>= 128 rows) on 4 quantizations (q/k/v, o, gate/up,
    # the silu-mul of down); the prefill's attention and its 2 norms a
    # layer plus the final norm take their kernels at the JAX dispatch's row
    # thresholds; one fused stack per decoded token after the first
    per_call = {"fused_vit_stack_w8a8": 1, "quantize_rows": 3 * L,
                "quantize_silu_mul": L, "int8_gemm": 7 * L,
                "fused_int8_stack": CHAT_NEW - 1}
    if n >= fa.SQ_MIN:
        per_call["flash_attention_fwd"] = L
    if n >= rmsnorm.MIN_ROWS and llm.hidden_size <= rmsnorm.MAX_HIDDEN:
        per_call["_rms_fwd"] = 2 * L + 1
    _zero_counts()
    times = []
    for _ in range(STEPS):
        t1 = time.perf_counter()
        r = chat.chat(question, tiles)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    got = {k: v for k, v in _read_counts().items() if v}
    want = {k: STEPS * v for k, v in per_call.items()}
    print(f"chat: {CHAT_TILES} tiles, prompt {n_valid} tokens in a bucket of "
          f"{n}, {CHAT_NEW} new tokens; {STEPS} calls "
          f"{[round(t, 1) for t in times]} ms (median "
          f"{statistics.median(times):.1f} ms, host clock around "
          f"synchronize); response {r[:60]!r}; launches {got} (derived "
          f"{want}) {tag}", flush=True)
    if got != want:
        raise RuntimeError(f"chat launches {got} != {want}")
    if not (isinstance(r, str) and r == resp):
        raise RuntimeError("chat answered differently to the same request")
    print(f"chat model after its main path: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device "
          f"({_kmajor_gb(model)}) {tag}", flush=True)
    with torch.inference_mode():
        tokens, num = chat._fused_gen(ids, seg, tiles)
        vit_stack = fr.pack_vit_stack(model.vision_model)
        feats = fr.fused_visual_features(model, tiles, vit_stack)
        cache = KVCache.create(L, 1, E, llm.num_kv_heads, llm.head_dim,
                               torch.bfloat16, dev)
        logits, _, cache = model.prefill(ids, None, seg, cache,
                                         visual_features=feats)
        torch.cuda.synchronize()
        if not (tokens.shape == (1, CHAT_NEW) and bool(logits.isfinite().all())
                and logits.shape == (1, n, llm.vocab_size)
                and 0 <= int(tokens.min()) and int(tokens.max())
                < llm.vocab_size and int(num[0]) >= 1):
            raise RuntimeError("chat generate gave bad tokens or logits")
        # stage times, each alone (CUDA events around the call)
        stack = fr.pack_qwen2_stack(model.language_model)
        head = fr.head_of(model.language_model)
        lengths = seg.sum(1)
        token = logits[0, n_valid - 1].argmax(-1)[None]
        del logits
        vit_ms = _ms(torch, lambda: fr.fused_visual_features(
            model, tiles, vit_stack), 5)
        prefill_ms = _ms(torch, lambda: model.prefill(
            ids, None, seg, KVCache.create(L, 1, E, llm.num_kv_heads,
                                           llm.head_dim, torch.bfloat16, dev),
            visual_features=feats), 3)
        step_ms = _ms(torch, lambda: fr.fused_decode_step(
            stack, model.language_model.embed_tokens, head, llm, token, cache,
            lengths), 10)
        hidden = torch.randn(1, llm.hidden_size, device=dev).to(torch.bfloat16)
        head_ms = _kernel_ms(torch, lambda: fr._head_logits(head, hidden), 10)
        prefill_quant_profile(torch, lambda: model.prefill(
            ids, None, seg, KVCache.create(L, 1, E, llm.num_kv_heads,
                                           llm.head_dim, torch.bfloat16, dev),
            visual_features=feats), L, n, tag)
    print(f"chat stages, each timed alone (CUDA events): ViT "
          f"({CHAT_TILES} tiles, fused act_quant) {vit_ms:.3f} ms, prefill "
          f"({n} rows) {prefill_ms:.3f} ms, decode {step_ms:.3f} ms per "
          f"token (fused stack {dec['int8'][E]['ms']:.3f} ms of it on the "
          f"device, int8 lm_head {head_ms:.3f} ms) {tag}", flush=True)
    del cache
    # -- phase 15: one chat call under the profiler -------------------------
    with torch.inference_mode():
        _profile(torch, lambda: chat.chat(question, tiles),
                 f"{CHAT_TILES}-tile chat call", tag)
    launches = dict(got)
    del chat, model, tiles, feats
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 16: bench.py's decode configuration (int8, 1 tile) -----------
    decode_parity_phase(torch, dev, cfg, tag)
    # the kernels at the chat shapes, beside the earlier phases' entries
    st = report["fused_int8_stack"]
    for Ek, r in dec["int8"].items():
        st[f"decode_e{Ek}"] = r
    report["fused_int8_stack_bf16"] = {**dec["bf16"][E], **{
        f"decode_e{Ek}": r for Ek, r in dec["bf16"].items() if Ek != E}}
    for Ek, r in dec["attention"].items():
        st[f"attention_alone_e{Ek}"] = r
    for name, r in (("fused_vit_stack_w8a8", vit), ("quantize_rows", k1),
                    ("quantize_silu_mul", k3),
                    ("int8_gemm", k2), ("flash_attention_fwd", flash),
                    ("_rms_fwd", rms)):
        report[name]["chat"] = r
    report["flash_attention_fwd"]["chat_window"] = flash_w
    return launches


def _margin(logits):
    """-> (top-2 margin of a [V] logits row, DECODE_REL x its max |logit|)."""
    top2 = logits.float().topk(2).values
    return ((top2[0] - top2[1]).item(),
            DECODE_REL * logits.float().abs().max().item())


def decode_parity_phase(torch, dev, cfg, tag):
    """Phase 16, bench.py's decode configuration: 1 tile, a 320-token prompt
    with 256 image tokens, 64 new tokens, quantize_for_serving(target="vlm",
    mode="int8"); the fused generator and the plain make_generate_fn on the
    same weights. Prints vlm_decode_tok_mismatches (bench.py's bound is 0),
    then holds the fused decoder to the plain one teacher-forced on the
    plain stream (DECODE_REL); a stack whose ln1 is ignored must break it.
    Where the two greedy streams first differ, the plain top-2 margin there
    (token 0: the plain prefill's logits; token t: teacher-forced step t - 1)
    must be within the bound: a near-tie, else the fused path is at fault.
    Times the fused generate (tok/s as bench.py counts it) and a step."""
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.inference import fused_runner as fr
    from vlaser_tpu_torch.inference.kv_cache import KVCache
    from vlaser_tpu_torch.inference.sampling import make_generate_fn

    llm, L = cfg.llm, cfg.llm.num_layers
    model = quantize_for_serving(_chat_model(torch, dev, cfg, 14),
                                 target="vlm", mode="int8")
    N, NEW, img = DECODE_PROMPT, DECODE_NEW, cfg.vision.image_size
    ids = torch.full((1, N), 7, dtype=torch.int64, device=dev)
    ids[:, 1:1 + cfg.num_image_token] = cfg.img_context_token_id
    seg = torch.ones((1, N), dtype=torch.int32, device=dev)
    px = torch.full((1, img, img, 3), 0.5, device=dev)
    kw = dict(max_new_tokens=NEW, eos_token_ids=[2], pad_token_id=0)
    fused = fr.make_fused_generate_fn(model, **kw)
    plain = make_generate_fn(model, **kw)
    tok_f, num_f = fused(ids, seg, px)
    tok_p, num_p = plain(ids, seg, px)
    torch.cuda.synchronize()
    mismatches = int((tok_f != tok_p).sum())
    print(f"vlm_decode_tok_mismatches {mismatches} (fused vs plain "
          f"generator, {NEW} greedy tokens, bench.py's bound 0; emitted "
          f"{int(num_f[0])} / {int(num_p[0])})", flush=True)
    diverge = (tok_f[0] != tok_p[0]).nonzero()
    first = int(diverge[0]) if diverge.numel() else None

    # teacher forcing on the plain stream, from one prefilled cache
    stack = fr.pack_qwen2_stack(model.language_model)
    head = fr.head_of(model.language_model)
    embed = model.language_model.embed_tokens
    with torch.inference_mode():
        cache = KVCache.create(L, 1, N + NEW, llm.num_kv_heads, llm.head_dim,
                               torch.bfloat16, dev)
        logits, _, cache = model.prefill(ids, px, seg, cache)
        lengths = seg.sum(1)
        # the plain top-2 margin and the bound of every pick: token 0 from
        # the plain prefill's logits, token t > 0 from teacher-forced step
        # t - 1
        margins = [_margin(logits[0, lengths[0] - 1])]
        c_p, c_f, c_x = cache, cache.clone(), cache.clone()
        bad = {**stack, "ln1": torch.ones_like(stack["ln1"])}
        worst, checked, flips, ctrl, ctrl_flips = 0.0, 0, 0, 0.0, 0
        for t in range(NEW - 1):
            tk = tok_p[:, t]
            lp, _, c_p = model.decode_step(tk[:, None], c_p,
                                           (lengths + t)[:, None])
            lp = lp[:, 0]
            lf, c_f = fr.fused_decode_step(stack, embed, head, llm, tk, c_f,
                                           lengths + t)
            bound = DECODE_REL * lp.abs().max().item()
            worst = max(worst, (lf - lp).abs().max().item() / bound)
            lx, c_x = fr.fused_decode_step(bad, embed, head, llm, tk, c_x,
                                           lengths + t)  # ln1 ignored
            ctrl = max(ctrl, (lx - lp).abs().max().item() / bound)
            margins.append(_margin(lp[0]))
            if margins[-1][0] > bound:
                checked += 1
                flips += int(lf[0].argmax() != lp[0].argmax())
                ctrl_flips += int(lx[0].argmax() != lp[0].argmax())
        torch.cuda.synchronize()
    print(f"decode parity, teacher-forced on the plain stream: worst step "
          f"{worst:.3f} x the bound (DECODE_REL {DECODE_REL} x max |plain "
          f"logits|), greedy tokens compared at {checked} of {NEW - 1} "
          f"steps (top-2 margin above the bound), {flips} differ; control "
          f"'ln1 ignored': {ctrl:.1f} x the bound, {ctrl_flips} tokens "
          f"differ (must break the gate)", flush=True)
    if not (worst <= 1 and flips == 0 and (ctrl > 1 or ctrl_flips > 0)):
        raise RuntimeError("fused decode disagrees with the plain decoder")
    if first is None:
        print("decode streams: the fused and plain greedy streams are "
              "identical", flush=True)
    else:
        margin, bound = margins[first]
        print(f"decode streams: first divergence at token {first} (fused "
              f"{int(tok_f[0, first])}, plain {int(tok_p[0, first])}); the "
              f"plain top-2 margin there {margin:.5g} vs the bound "
              f"{bound:.5g} (DECODE_REL {DECODE_REL} x max |plain logits|): "
              f"{'a near-tie' if margin <= bound else 'NOT a near-tie'}",
              flush=True)
        if margin > bound:
            raise RuntimeError(
                f"the fused decode's greedy stream diverges at token {first} "
                f"where the plain top-2 margin {margin:.5g} exceeds the bound "
                f"{bound:.5g}: a fault of the fused path")

    ms = _ms(torch, lambda: fused(ids, seg, px), 3)
    plain_ms = _ms(torch, lambda: plain(ids, seg, px), 1)
    with torch.inference_mode():
        cache = KVCache.create(L, 1, N + NEW, llm.num_kv_heads, llm.head_dim,
                               torch.bfloat16, dev)
        _, _, cache = model.prefill(ids, px, seg, cache)
        step_ms = _ms(torch, lambda: fr.fused_decode_step(
            stack, embed, head, llm, tok_p[:, 0], cache, lengths), 20)
    print(f"decode (bench.py's configuration): fused generate {ms:.1f} ms "
          f"-> {1e3 * NEW / ms:.1f} tok/s ({NEW} / the whole generate), "
          f"plain generate {plain_ms:.1f} ms; fused decode step "
          f"{step_ms:.3f} ms per token (CUDA events) {tag}", flush=True)


# -- the continuous-batching engine: phases 20-22 ----------------------------
ENGINE_BUCKETS = (64, 128, 192, 256, 320)  # bench.py's _bench_engine
ENGINE_REPS = 3  # timed runs a path (after one warm-up run), median
ENGINE_KW = dict(num_slots=16, max_len=448, eos_token_ids=[2],
                 pad_token_id=0, chunk_size=64, pipeline_depth=1)
ENGINE_GATE_ROWS = ("bucketed", "offline", "spec", "prefix_cached",
                    "auto_prefix")


def _tiny_fp32_vlm(torch, dev, seed):
    """tiny_vlm at fp32 compute with seeded weights: N(0, 0.1^2) (about
    1 / sqrt(fan-in) at its widths), norm scales and the ViT's layer scales
    1, norm biases 0."""
    from vlaser_tpu_torch.core.config import tiny_vlm
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.models.vlm import InternVLChatModel

    model = InternVLChatModel(tiny_vlm(), compute_dtype=torch.float32,
                              device=dev)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init_normal_(model, gen, std=0.1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            parent, leaf = name.split(".")[-2:]
            if "norm" in parent:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf in ("ls1", "ls2"):
                p.fill_(1.0)
    return model


def _solo_oracle(torch, np, model, eos, cache_dtype):
    """-> oracle(request) -> its tokens from the plain make_generate_fn
    alone (one generator a max_new_tokens)."""
    from vlaser_tpu_torch.inference.sampling import make_generate_fn, \
        trim_output

    dev, gens = model.device, {}

    def oracle(r):
        if r.max_new_tokens not in gens:
            gens[r.max_new_tokens] = make_generate_fn(
                model, max_new_tokens=r.max_new_tokens, eos_token_ids=eos,
                pad_token_id=0, cache_dtype=cache_dtype)
        ids = torch.as_tensor(np.asarray(r.input_ids, np.int64),
                              device=dev)[None]
        px = (None if r.pixel_values is None
              else torch.as_tensor(r.pixel_values, device=dev))
        with torch.inference_mode():
            toks, num = gens[r.max_new_tokens](
                ids, torch.ones_like(ids, dtype=torch.int32), px)
        return trim_output(toks, num, eos)[0]

    return oracle


def engine_fp32_gate(torch, np, dev):
    """bench.py's _engine_fp32_gate_impl on the port: tiny_vlm at fp32
    compute and cache, the same 16 requests from default_rng(97) (prompt
    lengths 8-32, a 32-token prompt holds one image, max_new 4 / 7 / 11),
    3 slots, max_len 64, EOS 3; then 8 text tails over one image prefix,
    registered and automatic. -> {row: requests whose tokens differ from
    the solo plain decode} (the automatic row + 100 when the store was
    never hit)."""
    from vlaser_tpu_torch.serve.engine import ContinuousBatchingEngine, \
        Request
    from vlaser_tpu_torch.serve.offline import run_offline

    model = _tiny_fp32_vlm(torch, dev, 3)
    cfg = model.cfg
    rng = np.random.default_rng(97)
    npt, img = cfg.num_image_token, cfg.vision.image_size
    rng.integers(1, 400, (1, 8 + npt))  # bench.py's init prompt (unused)
    px0 = rng.standard_normal((1, img, img, 3)).astype(np.float32)
    EOS = [3]
    oracle = _solo_oracle(torch, np, model, EOS, torch.float32)
    reqs = []
    for i in range(16):
        n = (8, 14, 20, 26, 32)[i % 5]
        row = rng.integers(1, 400, (n,)).astype(np.int64)
        px = None
        if n >= 32:
            row[2:2 + npt] = cfg.img_context_token_id
            px = px0
        reqs.append(Request(uid=i, input_ids=row, pixel_values=px,
                            max_new_tokens=(4, 7, 11)[i % 3]))
    want = {r.uid: oracle(r) for r in reqs}
    bad = lambda done, w: float(sum(c.token_ids != w[c.uid] for c in done))
    ekw = dict(num_slots=3, max_len=64, eos_token_ids=EOS, pad_token_id=0,
               cache_dtype=torch.float32)
    rows = {}
    rows["bucketed"] = bad(ContinuousBatchingEngine(
        model, prefill_buckets=(16, 32, 48), **ekw).run(reqs), want)
    rows["offline"] = bad(run_offline(
        model, reqs, num_slots=3, max_len=64, eos_token_ids=EOS,
        pad_token_id=0, cache_dtype=torch.float32), want)
    rows["spec"] = bad(ContinuousBatchingEngine(
        model, prefill_buckets=(16, 32, 48), speculative_draft_len=4,
        speculative_adaptive=False, **ekw).run(reqs), want)
    prefix = rng.integers(1, 400, (4 + npt,)).astype(np.int64)
    prefix[2:2 + npt] = cfg.img_context_token_id
    tails = [rng.integers(1, 400, ((5, 9, 3, 12)[i % 4],)).astype(np.int64)
             for i in range(8)]
    full = [Request(uid=i, input_ids=np.concatenate([prefix, t]),
                    pixel_values=px0, max_new_tokens=6)
            for i, t in enumerate(tails)]
    want_pc = {r.uid: oracle(r) for r in full}
    eng = ContinuousBatchingEngine(model, prefill_buckets=(16, 32), **ekw)
    pid = eng.register_prefix(prefix, px0)
    rows["prefix_cached"] = bad(eng.run([
        Request(uid=i, input_ids=t, prefix_id=pid, max_new_tokens=6)
        for i, t in enumerate(tails)]), want_pc)
    apc = ContinuousBatchingEngine(model, prefill_buckets=(16, 24, 32, 48),
                                   auto_prefix_block=4, **ekw)
    rows["auto_prefix"] = bad(apc.run(full), want_pc) + (
        100.0 if apc.auto_prefix_hits < 1 else 0.0)
    return rows


def _engine_requests(np, cfg, Request):
    """bench.py's _bench_engine workload: 16 requests from default_rng(7),
    prompt lengths cycling 64 / 128 / 192 / 256 / 320 (a 320-token prompt
    holds 256 <IMG_CONTEXT> tokens and one 448 px tile of 0.5), max_new
    cycling 16 / 32 / 64."""
    rng = np.random.default_rng(7)
    img = cfg.vision.image_size
    reqs = []
    for i in range(16):
        n = ENGINE_BUCKETS[i % 5]
        row = rng.integers(4, 1000, (n,)).astype(np.int64)
        px = None
        if n >= 320:
            row[1:257] = cfg.img_context_token_id
            px = np.full((1, img, img, 3), 0.5, np.float32)
        reqs.append(Request(uid=i, input_ids=row, pixel_values=px,
                            max_new_tokens=(16, 32, 64)[i % 3]))
    return reqs


def _divergence(torch, np, model, reqs, got, want):
    """-> (rows whose tokens differ from the solo plain decode, the first
    such row's (uid, token index), the plain top-2 margin there: the
    prompt and the plain tokens before it, prefilled)."""
    from vlaser_tpu_torch.inference.kv_cache import KVCache

    bad = [r for r in reqs if got[r.uid] != want[r.uid]]
    if not bad:
        return 0, None, None
    r = bad[0]
    a, b = got[r.uid], want[r.uid]
    pos = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
               min(len(a), len(b)))
    dev, llm = model.device, model.cfg.llm
    ids = torch.as_tensor(np.concatenate([np.asarray(r.input_ids, np.int64),
                                          np.asarray(b[:pos], np.int64)]),
                          device=dev)[None]
    px = (None if r.pixel_values is None
          else torch.as_tensor(r.pixel_values, device=dev))
    with torch.inference_mode():
        cache = KVCache.create(llm.num_layers, 1, ids.shape[1],
                               llm.num_kv_heads, llm.head_dim,
                               torch.bfloat16, dev)
        logits, _, _ = model.prefill(ids, px, torch.ones_like(
            ids, dtype=torch.int32), cache)
        top = logits[0, -1].float().topk(2).values
    return len(bad), (r.uid, pos), float(top[0] - top[1])


def _wall_ms(torch, fn, reps):
    """Median wall ms of fn() (host included, synchronized) over `reps`
    runs after one warm-up run; -> (ms, the warm-up's result)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def engine_wall(torch, np, dev, cfg, profile_first, tag):
    """--engine-wall: the engine's wall time on _bench_engine's workload in
    this process, after one torch.profiler session when `profile_first`;
    with the host's cost of a launch (x.add_ on 16 floats, 20,000 queued).
    Fresh processes alternated with and without the session show what a
    session leaves behind in the host's launch path."""
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.serve.engine import ContinuousBatchingEngine, \
        Request

    if profile_first:
        _profile(torch, lambda: torch.ones(8, device=dev).add_(1), "warm-up",
                 tag, quiet=True)
    x = torch.ones(16, device=dev)
    for _ in range(500):
        x.add_(1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20000):
        x.add_(1)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t) / 20000 * 1e6
    model = quantize_for_serving(_chat_model(torch, dev, cfg, 1))
    reqs = _engine_requests(np, cfg, Request)
    eng = ContinuousBatchingEngine(model, prefill_buckets=ENGINE_BUCKETS,
                                   **ENGINE_KW)
    with torch.inference_mode():
        ms, out = _wall_ms(torch, lambda: eng.run(reqs), ENGINE_REPS)
    n_tok = sum(len(c.token_ids) for c in out)
    print(f"engine wall, profiler session first: {profile_first}: "
          f"{us:.3f} us a launch; engine {ms:.1f} ms (median of "
          f"{ENGINE_REPS}) -> {1e3 * n_tok / ms:.1f} tok/s {tag}", flush=True)


def engine_phases(torch, np, dev, cfg, tag, report):
    """Phases 20-22, the continuous-batching engine, first in the process:
    its wall times are host-bound, and a profiler session leaves later
    launches in its process slower (engine_profile_phase profiles it, last).
    -> launches of its main path (phase 20's four serving paths)."""
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.inference.chat import VlaserChat
    from vlaser_tpu_torch.inference.sampling import make_generate_fn, \
        trim_output
    from vlaser_tpu_torch.serve.engine import ContinuousBatchingEngine, \
        Request
    from vlaser_tpu_torch.serve.offline import run_offline

    t0 = time.perf_counter()
    llm, vcfg = cfg.llm, cfg.vision
    model = quantize_for_serving(_chat_model(torch, dev, cfg, 1))
    torch.cuda.synchronize()
    print(f"engine model: Vlaser-2B, quantize_for_serving defaults (vlm, "
          f"w8a8), {time.perf_counter() - t0:.1f} s {tag}", flush=True)
    reqs = _engine_requests(np, cfg, Request)
    N, EOS = ENGINE_BUCKETS[-1], ENGINE_KW["eos_token_ids"]

    # -- the kernels at the engine's shapes, against their plain versions:
    # the w8a8 GEMMs and quantizers at its largest admission group (4 x 320
    # rows), flash at its ViT group (4 tiles), _rms_fwd at the offline
    # runner's [16, 320] wave
    lay = model.language_model.model.layers
    rows = 4 * N
    (k1, k2, k3), = gemm_phase(torch, _gemm_sites(lay.self_attn, lay.mlp),
                               (rows,), dev, tag).values()
    i32 = dict(dtype=torch.int32, device=dev)
    S = vcfg.seq_len
    seg = torch.ones(4, S, **i32)
    flash, _ = _flash_case(torch, dev, torch.Generator(device=dev).manual_seed(
        20), tag, "engine vit", 4, S, S, vcfg.num_heads, vcfg.num_heads,
        vcfg.head_dim, seg, None, seg, None)
    rms = rms_serving(torch, torch.Generator(device=dev).manual_seed(21), dev,
                      16 * N, llm.hidden_size, llm.rms_norm_eps,
                      "engine offline wave", tag, cold=True)
    # main() files these under each kernel's "engine" key at the end (this
    # phase runs before the phases that make those entries)
    report["engine_kernels"] = {
        "quantize_rows": k1, "quantize_silu_mul": k3, "int8_gemm": k2,
        "flash_attention_fwd": flash, "_rms_fwd": rms}
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 20: bench.py's _bench_engine at full width -------------------
    engine = ContinuousBatchingEngine(model, prefill_buckets=ENGINE_BUCKETS,
                                      **ENGINE_KW)
    spec = ContinuousBatchingEngine(model, prefill_buckets=ENGINE_BUCKETS,
                                    speculative_draft_len=4, **ENGINE_KW)
    static_gen = make_generate_fn(model, max_new_tokens=64,
                                  eos_token_ids=EOS, pad_token_id=0)

    def run_static():
        out = {}
        for half in (reqs[:8], reqs[8:]):
            ids = torch.zeros((8, N), dtype=torch.int64, device=dev)
            sg = torch.zeros((8, N), **i32)
            tiles = []
            for j, r in enumerate(half):
                ids[j, :len(r.input_ids)] = torch.as_tensor(r.input_ids)
                sg[j, :len(r.input_ids)] = 1
                if r.pixel_values is not None:
                    tiles.append(torch.as_tensor(r.pixel_values))
            px = torch.cat(tiles).to(dev) if tiles else None
            with torch.inference_mode():
                toks, num = static_gen(ids, sg, px)
            for r, row in zip(half, trim_output(toks, num, EOS)):
                out[r.uid] = row[:r.max_new_tokens]
        return out

    paths = (("engine", lambda: engine.run(reqs)),
             ("speculative engine (draft 4)", lambda: spec.run(reqs)),
             ("offline runner", lambda: run_offline(
                 model, reqs, num_slots=16, max_len=448, eos_token_ids=EOS,
                 pad_token_id=0, chunk_size=64)),
             ("static batch-8 make_generate_fn", run_static))
    oracle = _solo_oracle(torch, np, model, EOS, torch.bfloat16)
    want = {r.uid: oracle(r) for r in reqs}
    print(f"engine: solo plain decodes of the 16 requests done "
          f"({time.perf_counter() - t0:.0f} s into the phase) {tag}",
          flush=True)
    # the kernels each path must launch: admission groups of <= 1,280 rows
    # stay under _rms_fwd's 2,048-row threshold; the offline runner's
    # [16, 320] wave and the static generator's [8, 320] prefills reach it
    need = ("flash_attention_fwd", "int8_gemm", "quantize_rows",
            "quantize_silu_mul")
    needs = {"offline runner": need + ("_rms_fwd",),
             "static batch-8 make_generate_fn": need + ("_rms_fwd",)}
    rep, launches, missing = {}, {}, {}
    for name, fn in paths:
        _zero_counts()
        ms, out = _wall_ms(torch, fn, ENGINE_REPS)
        used = {k: v for k, v in _read_counts().items() if v}
        _add(launches, used)
        lack = [k for k in needs.get(name, need) if not used.get(k)]
        if lack:
            missing[name] = lack
        got = out if isinstance(out, dict) else {
            c.uid: c.token_ids for c in out}
        n_tok = sum(len(t) for t in got.values())
        bad, first, margin = _divergence(torch, np, model, reqs, got, want)
        stats = ""
        if name.startswith(("engine", "speculative")):
            e = engine if name == "engine" else spec
            stats = (f"; last run's schedule {e.stats} (steps_run: decode "
                     f"steps queued, steps_live: steps with a live row)")
            if e is spec:
                stats += (f", spec chunks {spec.spec_chunks_run} / plain "
                          f"{spec.plain_chunks_run}, acceptance EMA "
                          f"{spec.spec_last_ema}")
        print(f"engine phase, {name}: {n_tok} useful tokens in {ms:.1f} ms "
              f"(median of {ENGINE_REPS}, wall, host included) -> "
              f"{1e3 * n_tok / ms:.1f} tok/s; {bad} of 16 rows differ from "
              f"the solo plain decode (bf16, informational)"
              + (f", the first at uid {first[0]} token {first[1]}, plain "
                 f"top-2 margin there {margin:.5g}" if first else "")
              + f"; its own launches over {ENGINE_REPS + 1} runs {used}"
              + (f" (MISSING {lack})" if lack else "") + f"{stats} ("
              f"{time.perf_counter() - t0:.0f} s into the phase) {tag}",
              flush=True)
        rep[name] = dict(tok_s=1e3 * n_tok / ms, ms=ms, mismatched_rows=bad,
                         launches=used)
    print(f"engine phase launches (the 4 paths, {ENGINE_REPS + 1} runs "
          f"each; the solo decodes not counted): {launches} {tag}",
          flush=True)
    if missing:
        raise RuntimeError(f"engine phase paths never launched: {missing}")
    report["engine"] = rep

    # -- phase 22: speculative chat (VlaserChat, speculative_draft_len 4) ---
    tok = ChatStubTokenizer(cfg.img_context_token_id)
    img = vcfg.image_size
    tile = torch.full((1, img, img, 3), 0.5, device=dev)
    question = "What is shown in this image? " * 4
    kw = dict(max_new_tokens=64)
    chat_s = VlaserChat(model, tok, speculative_draft_len=4, **kw)
    chat_p = VlaserChat(model, tok, use_fused=False, **kw)
    ms_s, out_s = _wall_ms(torch, lambda: chat_s.chat(question, tile), 1)
    ms_p, out_p = _wall_ms(torch, lambda: chat_p.chat(question, tile), 1)
    ids_s, ids_p = out_s.split(), out_p.split()
    first = next((i for i in range(min(len(ids_s), len(ids_p)))
                  if ids_s[i] != ids_p[i]), None)
    print(f"speculative chat (Vlaser-2B, 1 tile, 64 new tokens, bf16): "
          f"{ms_s:.1f} ms vs {ms_p:.1f} ms for the plain generator (wall); "
          f"tokens {'equal' if out_s == out_p else 'differ'} ("
          f"{len(ids_s)} / {len(ids_p)} tokens"
          + (f", first difference at token {first}" if first is not None
             else "") + f"; informational in bf16) {tag}", flush=True)
    rep["spec_chat_ms"] = ms_s
    rep["plain_chat_ms"] = ms_p
    del engine, spec, static_gen, model, chat_s, chat_p
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 21: the fp32 gate (bench.py's engine_fp32_* rows) ------------
    t1 = time.perf_counter()
    gate = engine_fp32_gate(torch, np, dev)
    print(f"engine fp32 gate (tiny_vlm, fp32 compute and cache, on the "
          f"card): mismatched rows {gate} ({time.perf_counter() - t1:.1f} s) "
          f"{tag}", flush=True)
    if set(gate) != set(ENGINE_GATE_ROWS) or any(gate.values()):
        raise RuntimeError(f"engine fp32 gate failed: {gate}")

    # -- phase 22 at fp32: speculative chat equals the plain chat -----------
    tiny = _tiny_fp32_vlm(torch, dev, 5)
    ttok = ChatStubTokenizer(tiny.cfg.img_context_token_id)
    timg = tiny.cfg.vision.image_size
    ttile = torch.randn(1, timg, timg, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
    kw = dict(max_new_tokens=24, cache_dtype=torch.float32, bucket=64)
    a = VlaserChat(tiny, ttok, speculative_draft_len=4, **kw).chat(
        "describe the scene", ttile)
    b = VlaserChat(tiny, ttok, use_fused=False, **kw).chat(
        "describe the scene", ttile)
    verdict = "equal" if a == b else "DIFFERENT"
    print(f"speculative chat at fp32 (tiny_vlm): {verdict} to the plain chat "
          f"({len(a.split())} tokens); the engine phases took "
          f"{time.perf_counter() - t0:.0f} s {tag}", flush=True)
    if a != b:
        raise RuntimeError("speculative chat differs from greedy at fp32")
    del tiny
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def engine_profile_phase(torch, np, dev, cfg, tag, report):
    """One engine run of phase 20's workload under torch.profiler, last in
    the process: after a profile of a run this large, later profiles have
    missed the cooperative stack kernel's launches (PERF.md)."""
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.serve.engine import ContinuousBatchingEngine, \
        Request

    model = quantize_for_serving(_chat_model(torch, dev, cfg, 1))
    engine = ContinuousBatchingEngine(model, prefill_buckets=ENGINE_BUCKETS,
                                      **ENGINE_KW)
    reqs = _engine_requests(np, cfg, Request)
    with torch.inference_mode():
        engine.run(reqs)
        prof = _profile(torch, lambda: engine.run(reqs),
                        "engine run (16 requests)", tag)
    report["engine"]["engine"]["profiled_busy_ms"] = prof["busy"]
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()


# -- PaliGemma: phases 17-19 -------------------------------------------------
# q and k x this in the kernel phase: the logits' std near 50, where Gemma's
# cap of 50 bites (at N(0, 0.02^2) weights it never does)
PALI_GAIN = 50.0 ** 0.5
PALI_PAD = 8  # the padded prompt tail of the kernel phase's joint shape
INFER_REPS = 10


def pali_flash_phase(torch, dev, cfg, tag):
    """Phase 17: flash_attention_fwd / _bwd at the PaliGemma VLA's shapes
    (_flash_case): the joint train pass (B 32, S 281, 8/1 heads x 256,
    softcap 50, levels [0 x 276 | 1 | 2 x 4], a padded prompt tail), the
    serving suffix (B 1, 4 action rows over the 281 keys) and SigLIP (B 32,
    S 256, 16/16 heads x 72, non-causal). q and k are drawn x PALI_GAIN so
    that the cap bites. -> {shape: (fwd report, bwd report)}."""
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    llm, sc = cfg.vlm.llm, cfg.siglip
    S_it, S_j, n_a = (cfg.max_image_text_tokens, cfg.total_tokens,
                      cfg.num_action_tokens)
    i32 = dict(dtype=torch.int32, device=dev)
    joint = (llm.num_heads, llm.num_kv_heads, llm.head_dim, llm.attn_softcap)
    out_rep = {}
    # (name, B, Sq, Skv, (H, KVH, D, softcap))
    for name, B, Sq, Skv, (H, KVH, D, cap) in (
            ("pali_joint", 32, S_j, S_j, joint),
            ("pali_suffix", 1, n_a, S_j, joint),
            ("siglip", 32, sc.num_tokens, sc.num_tokens,
             (sc.num_heads, sc.num_heads, sc.head_dim, None))):
        seg, lev = torch.ones(B, Skv, **i32), None
        q_seg, q_lev = torch.ones(B, Sq, **i32), None
        if cap:  # [img/text 0 | proprio 1 | action 2], a padded prompt tail
            seg[:, S_it - PALI_PAD:S_it] = 0
            lev = torch.zeros(B, Skv, **i32)
            lev[:, S_it] = 1
            lev[:, S_it + 1:] = 2
            q_seg, q_lev = ((seg, lev) if Sq == Skv
                            else (q_seg, torch.full((B, Sq), 2, **i32)))
        out_rep[name] = _flash_case(
            torch, dev, g, tag, name, B, Sq, Skv, H, KVH, D, q_seg, q_lev,
            seg, lev, cap=cap, gain=PALI_GAIN if cap else 1.0)
    return out_rep


def _pali_init_(torch, model, gen):
    """N(0, 0.02^2) everywhere, then LayerNorm and plain RMSNorm weights
    1 + N(0, 0.1^2) and Gemma's plus-one RMSNorm weights N(0, 0.1^2)
    (scale 1 + w)."""
    from vlaser_tpu_torch.models.layers import LayerNorm, RMSNorm, init_normal_

    init_normal_(model, gen, std=0.02)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (LayerNorm, RMSNorm)):
                w = 0.1 * torch.randn(m.weight.shape, generator=gen,
                                      device=m.weight.device)
                m.weight.copy_(w if getattr(m, "plus_one", False) else 1 + w)


def _pali_batch(torch, np, dev, cfg, B, seed):
    """B PaliGemma prompts (256 image tokens first, then 5-20 text tokens
    and padding up to 276), 224 px frames, proprio, actions, noise."""
    rng = np.random.default_rng(seed)
    S, n_img, img = (cfg.max_image_text_tokens, cfg.siglip.num_tokens,
                     cfg.siglip.image_size)
    ids = np.zeros((B, S), np.int64)
    mask = np.zeros((B, S), np.int32)
    for i in range(B):
        n = n_img + int(rng.integers(5, S - n_img + 1))
        ids[i, :n] = rng.integers(1, cfg.vlm.img_context_token_id, n)
        ids[i, :n_img] = cfg.vlm.img_context_token_id
        mask[i, :n] = 1
    A = (B, cfg.num_action_tokens, cfg.action_dim)
    t = lambda a: torch.from_numpy(a).to(dev)
    return {"input_ids": t(ids), "text_mask": t(mask),
            "pixel_values": t(rng.uniform(-1, 1, (B, img, img, 3)).astype(
                np.float32)),
            "proprios": t(rng.uniform(-1, 1, (B, cfg.cond_steps,
                                              cfg.proprio_dim)).astype(
                np.float32)),
            "actions": t(rng.uniform(-1, 1, A).astype(np.float32)),
            "noise": t(rng.standard_normal(A).astype(np.float32))}


def pali_infer_phase(torch, np, dev, cfg, tag):
    """Phase 18: PiZeroVLA.infer_action at batch 1, full width (SigLIP
    So400m, the Gemma-2B mixture, the 1024-wide expert; 276 prompt tokens,
    10 Euler steps), bf16 weights N(0, 0.02^2), attn_impl "kernel" against
    "reference" on the same weights and inputs (<= PARITY_TOL), launch
    counters zeroed just before one kernel-route call and read just after,
    held to the count the code implies; both routes timed (median of
    INFER_REPS, CUDA events). -> launches."""
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA

    t0 = time.perf_counter()
    model = PiZeroVLA(cfg, param_dtype=torch.bfloat16,
                      compute_dtype=torch.bfloat16, device=dev,
                      attn_impl="kernel")
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    _pali_init_(torch, model, gen)
    b = _pali_batch(torch, np, dev, cfg, 1, 18)
    args = [b[k] for k in ("input_ids", "pixel_values", "text_mask",
                           "proprios", "noise")]
    torch.cuda.synchronize()
    n_param = sum(p.numel() for p in model.parameters())
    print(f"pali serving model: PaliGemma VLA (pizero_paligemma), bf16 "
          f"weights and compute, {n_param / 1e9:.3f} G parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, "
          f"{time.perf_counter() - t0:.1f} s; prompt "
          f"{int(b['text_mask'].sum())} of {cfg.max_image_text_tokens} "
          f"tokens", flush=True)
    # derived from the code: one flash forward per SigLIP layer, per joint
    # layer of the prefix and per joint layer of each Euler step's suffix;
    # the plus-one norms take ops.rms_norm, the prefix never runs the final
    # vlm norm and the suffix's expert norm has 4 rows (reference)
    L, steps = cfg.vlm.llm.num_layers, cfg.num_inference_steps
    want = {"flash_attention_fwd": cfg.siglip.num_layers + L + steps * L}
    model.infer_action(*args)  # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    got = model.infer_action(*args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counts().items() if v}
    model.set_attn_impl("reference")
    ref = model.infer_action(*args)
    ref_ms = _ms(torch, lambda: model.infer_action(*args), INFER_REPS)
    model.set_attn_impl("kernel")
    ms = _ms(torch, lambda: model.infer_action(*args), INFER_REPS)
    err = (got - ref).abs().max().item()
    shape = (1, cfg.horizon_steps, cfg.action_dim)
    print(f"pali infer_action: kernel vs reference route max abs diff "
          f"{err:.3e} (bound {PARITY_TOL}), shape {tuple(got.shape)}, "
          f"launches {launches} (derived {want}); median of {INFER_REPS}: "
          f"kernel route {ms:.2f} ms, reference route {ref_ms:.2f} ms "
          f"(CUDA events) {tag}", flush=True)
    if not (tuple(got.shape) == shape and bool(got.isfinite().all())
            and err <= PARITY_TOL and got.abs().max().item() <= 1.0):
        raise RuntimeError("pali infer_action: kernel route disagrees")
    if launches != want:
        raise RuntimeError(f"pali infer launches {launches} != {want}")
    with torch.inference_mode():
        _profile(torch, lambda: model.infer_action(*args),
                 "pali batch-1 infer_action", tag)
    return launches


def pali_train_phase(torch, np, dev, cfg, tag):
    """Phase 19: the flow-matching train step of the PaliGemma VLA at batch
    32 (fp32 parameters, bf16 compute, remat, two-group AdamW,
    attn_impl "kernel"), or the largest batch of 32, 16, 8 that fits the
    card. -> launches of its 3 VLATrainer steps."""
    for B in (32, 16, 8):
        try:
            return _pali_train(torch, np, dev, cfg, B, tag)
        except torch.cuda.OutOfMemoryError as e:
            msg = str(e).splitlines()[0]
        print(f"pali train at batch {B} does not fit the card: {msg}",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    raise RuntimeError("pali train does not fit the card at batch 8")


def _pali_train(torch, np, dev, cfg, B, tag):
    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import rmsnorm
    from vlaser_tpu_torch.models.layers import set_rms_impl
    from vlaser_tpu_torch.policy.flow import sample_fm_time
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.train.train_step import group_grad_norms
    from vlaser_tpu_torch.train.trainer import VLATrainConfig, VLATrainer

    t0 = time.perf_counter()
    model = PiZeroVLA(cfg, param_dtype=torch.float32,
                      compute_dtype=torch.bfloat16, device=dev, remat=True,
                      attn_impl="kernel")
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    _pali_init_(torch, model, gen)
    batch = _pali_batch(torch, np, dev, cfg, B, 19)
    batch.pop("noise")
    trainer = VLATrainer(model, VLATrainConfig(), generator=gen)
    torch.cuda.synchronize()
    n_param = sum(p.numel() for p in model.parameters())
    print(f"pali train model: PaliGemma VLA, remat, fp32 params / bf16 "
          f"compute, {n_param / 1e9:.3f} G parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, "
          f"{time.perf_counter() - t0:.1f} s; batch {B}", flush=True)

    # -- parity gate: kernel attention vs reference attention ---------------
    t = sample_fm_time(gen, B, trainer.cfg.flow_sampling, cfg.flow_alpha,
                       cfg.flow_beta, cfg.flow_t_max, device=dev)
    x0 = torch.randn((B, cfg.num_action_tokens, cfg.action_dim),
                     generator=gen, device=dev)
    args = [batch[k] for k in ("input_ids", "pixel_values", "text_mask",
                               "proprios", "actions")] + [t, x0]
    gate = {}
    for impl in ("kernel", "reference"):
        model.set_attn_impl(impl)
        set_rms_impl(model, "auto" if impl == "kernel" else "reference")
        model.zero_grad(set_to_none=True)
        n0 = fa.fwd_launch_count
        loss = model(*args)
        loss.backward()
        torch.cuda.synchronize()
        norms = {k: v.item() for k, v in group_grad_norms(
            trainer.groups).items()}
        finite = all(bool(p.grad.isfinite().all()) for p in model.parameters()
                     if p.grad is not None)
        gate[impl] = (loss.item(), norms)
        used = fa.fwd_launch_count - n0
        print(f"pali parity gate, {impl} attention: loss {loss.item():.6f}, "
              f"group grad norms {norms}, all grads finite {finite}, flash "
              f"forward launches {used}", flush=True)
        if not (finite and math.isfinite(loss.item())):
            raise RuntimeError(f"pali parity gate: {impl} path not finite")
        if (impl == "reference") != (used == 0):
            raise RuntimeError(f"pali parity gate: {impl} launches {used}")
        del loss
    model.set_attn_impl("kernel")
    set_rms_impl(model, "auto")
    model.zero_grad(set_to_none=True)
    (lk, nk), (lr, nr) = gate["kernel"], gate["reference"]
    loss_rel = abs(lk - lr) / abs(lr)
    norm_rel = {k: abs(nk[k] - nr[k]) / nr[k] for k in nr}
    print(f"pali parity gate: loss rel diff {loss_rel:.3e} (bound "
          f"{LOSS_REL}), group grad norm rel diffs "
          f"{ {k: f'{v:.3e}' for k, v in norm_rel.items()} } (bound "
          f"{GNORM_REL})", flush=True)
    if not (loss_rel <= LOSS_REL and max(norm_rel.values()) <= GNORM_REL):
        raise RuntimeError("pali train: kernel path disagrees with reference")
    gc.collect()

    # -- the main path: 3 VLATrainer steps, counters around them -------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    times, losses = [], []
    for _ in range(STEPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        m = trainer.train_steps(iter([batch]), 1)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
        losses.append(m["loss"].item())
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    # derived from the code: every SigLIP and joint layer runs one flash
    # forward, again in the remat recompute, and one flash backward; the
    # final vlm_norm (B x 276 rows x 2048, a plain RMSNorm) takes the
    # kernel once a step and never reaches the loss (no backward); the
    # layers' plus-one norms take ops.rms_norm, the expert's final norm has
    # B x 5 rows (reference)
    n_att = cfg.siglip.num_layers + cfg.vlm.llm.num_layers
    want = {"flash_attention_fwd": STEPS * 2 * n_att,
            "flash_attention_bwd": STEPS * n_att}
    if (B * cfg.max_image_text_tokens >= rmsnorm.MIN_ROWS
            and cfg.vlm.llm.hidden_size <= rmsnorm.MAX_HIDDEN):
        want["_rms_fwd"] = STEPS
    print(f"pali train: batch {B}, {STEPS} VLATrainer steps, losses "
          f"{[round(v, 6) for v in losses]}, step ms "
          f"{[round(v, 3) for v in times]} (median "
          f"{statistics.median(times):.3f} ms, CUDA events), peak device "
          f"memory {peak:.2f} GiB; launches {launches} (derived {want}) "
          f"{tag}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError("pali train step gave a non-finite loss")
    if launches != want:
        raise RuntimeError(f"pali train launches {launches} != {want}")
    _profile_step(torch, trainer, batch, tag)
    return launches


def pali_phases(torch, np, dev, cfg, tag, report):
    """Phases 17-19, the PaliGemma VLA: -> launches of its main paths."""
    flash = pali_flash_phase(torch, dev, cfg, tag)
    for name, (f, b) in flash.items():
        report["flash_attention_fwd"][name] = f
        report["flash_attention_bwd"][name] = b
    gc.collect()
    torch.cuda.empty_cache()
    launches = pali_infer_phase(torch, np, dev, cfg, tag)
    gc.collect()
    torch.cuda.empty_cache()
    return _add(launches, pali_train_phase(torch, np, dev, cfg, tag))


# -- SFT: phases 23-26 ---------------------------------------------------------
SFT_TOKENS = 2048  # _bench_sft_train's packed batch (B 1)
SFT_LONG, SFT_BLOCK = 16384, 2048  # _bench_sft_16k's, segment blocks of 2,048
SFT_ITERS, SFT_LONG_ITERS = 5, 2  # timed steps, each after one warm-up step
SFT_CHUNK, SFT_RANK, SFT_ALPHA, SFT_LR = 512, 64, 128.0, 1e-4
MERGE_TOKENS = 384
# QLoRA gate, the decoder's hidden states on the kernel route against the
# reference route's, relative L2 distance: layer 0's output within
# LAYER0_REL (the reference RMSNorm rounds x rrms to bf16 before the
# weight, the kernel rounds once, and each one-step bf16 difference can
# flip an int8 activation by amax / 127; 1.2e-2 at a cut config on the
# CPU), the final norm's within HIDDEN_REL (that noise compounds through 28
# layers of random weights: 8.2e-2 on an H100, segments ignored 0.38)
LAYER0_REL, HIDDEN_REL = 5e-2, 0.2
# the merged float model's logits against the int8 + LoRA model's (weight-
# only): relative L2 distance (the merged kernels are rounded to bf16 once,
# the int8 route rounds x W and (x a) b apart, through 28 layers)
MERGE_REL = 5e-2


def _sft_batch(torch, np, dev, cfg, n, seed, block=None):
    """bench.py's synthetic SFT batch (_bench_sft_train, _bench_sft_16k):
    B 1 x n ids in [4, 1000), the first num_image_token of them IMG_CONTEXT,
    labels the ids, weights 1, segment ids drawn per token in 1..4 (block
    None) or in blocks of `block` tokens, one 448 px tile of 0.5."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 1000, (1, n))
    ids[0, :cfg.num_image_token] = cfg.img_context_token_id
    seg = (rng.integers(0, 4, (1, n)) + 1 if block is None
           else (np.arange(n) // block + 1)[None])
    img = cfg.vision.image_size
    ids = torch.from_numpy(ids).to(dev)
    return {"input_ids": ids, "labels": ids.clone(),
            "loss_weight": torch.ones((1, n), device=dev),
            "seg_ids": torch.from_numpy(seg).to(dev, torch.int32),
            "pixel_values": torch.full((1, img, img, 3), 0.5, device=dev),
            "image_flags": torch.ones((1,), dtype=torch.int32, device=dev)}


def _packed_batch(np, cfg, n, seed, lengths):
    """One B 1 x n batch as PackedDataset._emit (vlaser_tpu/data/
    chat_dataset.py:624-648) lays it out, in numpy: contiguous segments of
    `lengths` tokens whose positions restart at 0, the first holding one
    tile's IMG_CONTEXT tokens after its first token; the prompt (the first
    token, the image and 16 more) labelled -100; the tail segment 0, pad
    ids, labels -100, weight 0."""
    rng = np.random.default_rng(seed)
    ids = np.full((n,), cfg.pad_token_id, np.int64)
    labels = np.full((n,), -100, np.int64)
    weights = np.zeros((n,), np.float32)
    seg = np.zeros((n,), np.int32)
    pos = np.zeros((n,), np.int32)
    ofs, T = 0, cfg.num_image_token
    for k, m in enumerate(lengths):
        s_ids = rng.integers(4, 1000, m)
        if k == 0:
            s_ids[1:1 + T] = cfg.img_context_token_id
        s_lab = s_ids.copy()
        s_lab[:1 + (T if k == 0 else 0) + 16] = -100
        ids[ofs:ofs + m], labels[ofs:ofs + m] = s_ids, s_lab
        weights[ofs:ofs + m] = 1.0
        seg[ofs:ofs + m], pos[ofs:ofs + m] = k + 1, np.arange(m)
        ofs += m
    img = cfg.vision.image_size
    return {"input_ids": ids[None], "labels": labels[None],
            "loss_weight": weights[None], "seg_ids": seg[None],
            "positions": pos[None],
            "pixel_values": rng.uniform(-1, 1, (1, img, img, 3)).astype(
                np.float32),
            "image_flags": np.ones((1,), np.int32)}


def _flash_blocks(torch, dev, g, tag, name, n, block, H, KVH, D):
    """flash_attention_fwd / _bwd over B 1 x n causal tokens packed in
    segments of `block`, against the plain versions taken block by block:
    the segments make the mask block-diagonal, so each block's plain pass
    is the whole pass's on its rows (the plain version over all n would
    hold [H, n, n] fp32 logits). Controls: segments ignored (block 1's rows
    over keys 0 .. 2 block, causal at q_offset block) and causal dropped
    (block 0). Timed against the plain block loop and SDPA under the
    block-diagonal causal mask. -> (fwd report, bwd report)."""
    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import flash_attention as fa

    q, k, v, do = _flash_inputs(torch, g, dev, 1, n, n, H, KVH, D)
    seg = (torch.arange(n, device=dev) // block + 1).to(torch.int32)[None]
    meta = fa.pack_meta(seg)
    what = f"flash {name} B=1 S={n} H={H}/{KVH} D={D} causal, {block}-blocks"
    out, lse = fa.flash_attention_fwd(q, k, v, meta, meta, 0, True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, meta, meta, 0, out, lse, do,
                                        True)
    torch.cuda.synchronize()
    keys = ("out", "lse", "dq", "dk", "dv")

    def plain_blocks():
        parts = []
        for i in range(0, n, block):
            r = slice(i, i + block)
            o, l = fa.flash_attention_fwd_plain(
                q[:, r], k[:, r], v[:, r], meta[:, r], meta[:, r], 0, True)
            parts.append((o, l, *fa.flash_attention_bwd_plain(
                q[:, r], k[:, r], v[:, r], meta[:, r], meta[:, r], 0,
                out[:, r], lse[:, :, r], do[:, r], True)))
        return {kk: torch.cat([p[j] for p in parts], dim=2 if kk == "lse"
                              else 1) for j, kk in enumerate(keys)}

    ref = plain_blocks()
    bounds = {kk: FLASH_REL * ref[kk].float().abs().max().item()
              for kk in ("out", "dq", "dk", "dv")}
    bounds["lse"] = LSE_ABS
    b0, b1 = slice(0, block), slice(block, 2 * block)
    ones = fa.pack_meta(torch.ones_like(seg))
    o_seg = ref["out"].clone()
    o_seg[:, b1] = fa.flash_attention_fwd_plain(
        q[:, b1], k[:, :2 * block], v[:, :2 * block], ones[:, b1],
        ones[:, :2 * block], block, True)[0]
    o_cau = ref["out"].clone()
    o_cau[:, b0] = fa.flash_attention_fwd_plain(
        q[:, b0], k[:, b0], v[:, b0], meta[:, b0], meta[:, b0], 0, False)[0]
    errs = _check(what, dict(zip(keys, (out, lse, dq, dk, dv))), ref, bounds,
                  {"segments ignored": {"out": o_seg},
                   "causal dropped": {"out": o_cau}})
    del ref, o_seg, o_cau
    pairs = (n // block) * block * (block + 1) // 2
    io = (q.numel() + k.numel() + v.numel()) * 2
    meta_b, lse_b = 2 * meta.numel() * 4, lse.numel() * 4
    t_fwd = {"max_abs_err": errs["out"],
             "ms": _kernel_ms(torch, lambda: fa.flash_attention_fwd(
                 q, k, v, meta, meta, 0, True), 10),
             "plain_ms": _ms(torch, lambda: [fa.flash_attention_fwd_plain(
                 q[:, i:i + block], k[:, i:i + block], v[:, i:i + block],
                 meta[:, i:i + block], meta[:, i:i + block], 0, True)
                 for i in range(0, n, block)], 2)}
    t_fwd["bound_ms"], t_fwd["bound_by"] = _bound(
        4 * D * H * pairs, io + q.numel() * 2 + lse_b + meta_b, PEAK_BF16)
    t_bwd = {"max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]),
             "ms": _kernel_ms(torch, lambda: fa.flash_attention_bwd(
                 q, k, v, meta, meta, 0, out, lse, do, True), 10),
             "plain_ms": _ms(torch, lambda: [fa.flash_attention_bwd_plain(
                 q[:, i:i + block], k[:, i:i + block], v[:, i:i + block],
                 meta[:, i:i + block], meta[:, i:i + block], 0,
                 out[:, i:i + block], lse[:, :, i:i + block],
                 do[:, i:i + block], True) for i in range(0, n, block)], 2)}
    t_bwd["bound_ms"], t_bwd["bound_by"] = _bound(
        10 * D * H * pairs, 2 * io + 2 * q.numel() * 2 + lse_b + meta_b,
        PEAK_BF16)
    rep = lambda t: t.repeat_interleave(H // KVH, dim=2)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, rep(k), rep(v)))
    dot = do.transpose(1, 2).contiguous()
    mask = fa._allowed(meta, meta, 0, True)[:, None]
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    t_fwd["library_ms"] = _kernel_ms(torch, sdpa, 10)
    o_lib = sdpa()
    t_bwd["library_ms"] = _kernel_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), dot, retain_graph=True), 10)
    del o_lib, qt, kt, vt, dot, mask
    for nm, t, flop in (("fwd", t_fwd, 4 * D * H * pairs),
                        ("bwd", t_bwd, 10 * D * H * pairs)):
        _flash_rate(t, flop)
        print(f"flash {nm} {name} time: kernel {t['ms']:.3f} ms "
              f"({t['tflops']:.1f} TFLOP/s), plain (block loop) "
              f"{t['plain_ms']:.3f} ms, sdpa {t['library_ms']:.3f} ms "
              f"({t['library_tflops']:.1f} TFLOP/s), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}) {tag}", flush=True)
    return t_fwd, t_bwd


def sft_kernel_phase(torch, np, dev, cfg, sites, tag, report):
    """Phase 23: the SFT path's kernels at its shapes against their plain
    versions, with controls, timed: flash forward and backward (B 1, causal,
    the LLM's heads) at SFT_TOKENS with bench.py's per-token segments 1..4
    (_flash_case) and at SFT_LONG in blocks of SFT_BLOCK (_flash_blocks);
    _rms_fwd / _rms_bwd at SFT_TOKENS and SFT_LONG rows x hidden; and
    quantize_rows and int8_gemm at one layer's 7 shapes at both row counts
    (gemm_phase, on `sites`: the QLoRA model's layer-0 int8 weights). Each
    report is filed under its kernel as "sft_<rows>"."""
    llm = cfg.llm
    H, KVH, D = llm.num_heads, llm.num_kv_heads, llm.head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    seg = _sft_batch(torch, np, dev, cfg, SFT_TOKENS, 0)["seg_ids"]
    short = f"sft_{SFT_TOKENS}"
    flash = {short: _flash_case(torch, dev, g, tag, f"sft {SFT_TOKENS}", 1,
                                SFT_TOKENS, SFT_TOKENS, H, KVH, D, seg, None,
                                seg, None, causal=True)}
    gc.collect()
    torch.cuda.empty_cache()
    flash[f"sft_{SFT_LONG}"] = _flash_blocks(
        torch, dev, g, tag, f"sft {SFT_LONG}", SFT_LONG, SFT_BLOCK, H, KVH, D)
    for name, (f, b) in flash.items():
        report["flash_attention_fwd"][name] = f
        report["flash_attention_bwd"][name] = b
    gc.collect()
    torch.cuda.empty_cache()
    for n in (SFT_TOKENS, SFT_LONG):
        f, b = rms_train_case(torch, g, dev, n, llm.hidden_size,
                              llm.rms_norm_eps, " (sft)", tag)
        report["_rms_fwd"][f"sft_{n}"], report["_rms_bwd"][f"sft_{n}"] = f, b
    for n, (k1, k2, _) in gemm_phase(torch, sites, (SFT_TOKENS, SFT_LONG),
                                     dev, tag).items():
        report["quantize_rows"][f"sft_{n}"] = k1
        report["int8_gemm"][f"sft_{n}"] = k2
    gc.collect()
    torch.cuda.empty_cache()


def _qlora_model(torch, dev, cfg, seed):
    """_bench_sft_train's model: Vlaser-2B in bf16 (parameters and
    compute), remat, draws as _train_init_, every LLM layer kernel, the
    embedding and the lm_head int8 (DEFAULT_PATTERNS) with the layer
    kernels flagged w8a8 (VLM_W8A8_ACT_PATTERNS), every weight frozen, LoRA
    r SFT_RANK, alpha SFT_ALPHA, bf16 on LLM_TARGETS. -> (model, factors)."""
    from vlaser_tpu_torch.core import quant
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.train.lora import LLM_TARGETS, init_qlora_collection

    bf = torch.bfloat16
    model = InternVLChatModel(cfg, param_dtype=bf, compute_dtype=bf,
                              device=dev, remat=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    _train_init_(torch, model, gen)
    quant.quantize_module(model, quant.DEFAULT_PATTERNS,
                          act_quant_patterns=quant.VLM_W8A8_ACT_PATTERNS)
    model.requires_grad_(False)
    factors = init_qlora_collection(model, LLM_TARGETS, r=SFT_RANK,
                                    alpha=SFT_ALPHA, dtype=bf, generator=gen)
    return model, factors


def _qlora_want(L, steps):
    """The launches `steps` QLoRA steps imply: every decoder layer runs one
    flash forward and its 7 w8a8 Dense (each a quantize_rows and an
    int8_gemm: a Dense with LoRA factors never shares int8 rows, so no
    quantize_silu_mul) twice (the remat recompute), one flash backward, its
    two RMSNorms twice; the final norm runs once; every norm but layer 0's
    input norm (over the frozen embeddings) has a backward. The ViT (1,025
    tokens, one tile) takes the reference attention."""
    return {"flash_attention_fwd": steps * 2 * L,
            "flash_attention_bwd": steps * L,
            "_rms_fwd": steps * (4 * L + 1), "_rms_bwd": steps * 2 * L,
            "quantize_rows": steps * 14 * L, "int8_gemm": steps * 14 * L}


def qlora_gate(torch, model, factors, loss_fn, batch, tag):
    """One loss + backward of the QLoRA loss on the kernel route (flash,
    RMSNorm kernels) and one on the reference attention and RMSNorm, same
    weights and batch: the loss within LOSS_REL, the LoRA gradient norm
    within GNORM_REL, max |dL/db| > 0 (the STE backward of the w8a8 Dense
    is alive; b starts at 0, so only b has a gradient), and, in one more
    forward, the decoder's hidden states: layer 0's output within
    LAYER0_REL and the final norm's (the CE's input) within HIDDEN_REL in
    relative L2 norm (over random weights the logits are near uniform, so
    the loss and the gradient norm hardly see what attention attends; every
    layer's distance is printed). Control: the kernel route with the
    segment ids ignored must break the gate."""
    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import rmsnorm
    from vlaser_tpu_torch.models.layers import set_rms_impl
    from vlaser_tpu_torch.train.train_step import grad_norm

    def run(impl, b, label):
        model.set_attn_impl(impl)
        set_rms_impl(model, impl)
        for p in factors.values():
            p.grad = None
        n0 = (fa.fwd_launch_count, rmsnorm.fwd_launch_count)
        loss = loss_fn(b)
        loss.backward()
        torch.cuda.synchronize()
        used = (fa.fwd_launch_count - n0[0], rmsnorm.fwd_launch_count - n0[1])
        norm = grad_norm(factors.values()).item()
        bmax = max(p.grad.abs().max().item() for n, p in factors.items()
                   if n.endswith("lora_b"))
        finite = all(bool(p.grad.isfinite().all()) for p in factors.values())
        outs = {}
        hook = layers.register_forward_hook(
            lambda mod, args, out: outs.__setitem__(args[1], out.float()))
        try:
            with torch.no_grad():
                hidden = model(b["input_ids"], b["pixel_values"],
                               b["image_flags"], seg_ids=b["seg_ids"],
                               return_logits=False)[1].float()
        finally:
            hook.remove()
        hidden = [outs[l] for l in range(len(outs))] + [hidden]
        finite = finite and bool(hidden[-1].isfinite().all())
        print(f"QLoRA gate, {label}: loss {loss.item():.6f}, LoRA grad norm "
              f"{norm:.6e}, max |dL/db| {bmax:.3e}, finite {finite}, kernel "
              f"launches (flash fwd, rms fwd) {used}", flush=True)
        if not (finite and math.isfinite(loss.item())):
            raise RuntimeError(f"QLoRA gate: {label} not finite")
        if (impl == "reference") != (used == (0, 0)):
            raise RuntimeError(f"QLoRA gate: {label} launches {used}")
        return loss.item(), norm, bmax, hidden

    layers = model.language_model.model.layers
    ref = run("reference", batch, "reference route")
    got = run("auto", batch, "kernel route")
    ctrl = run("auto", {**batch, "seg_ids": None},
               "control: kernel route, segments ignored")
    for p in factors.values():
        p.grad = None
    dist = lambda a: [(torch.linalg.vector_norm(h - r)
                       / torch.linalg.vector_norm(r)).item()
                      for h, r in zip(a[3], ref[3])]
    print(f"QLoRA gate: hidden states' rel L2 distance from the reference "
          f"route, layer by layer, then the final norm: kernel route "
          f"{[f'{v:.1e}' for v in dist(got)]}; control "
          f"{[f'{v:.1e}' for v in dist(ctrl)]}", flush=True)
    rel = lambda a: (abs(a[0] - ref[0]) / abs(ref[0]),
                     abs(a[1] - ref[1]) / ref[1], dist(a)[0], dist(a)[-1])
    bounds = (LOSS_REL, GNORM_REL, LAYER0_REL, HIDDEN_REL)
    r_got, r_ctrl = rel(got), rel(ctrl)
    print(f"QLoRA gate: rel diffs of the loss, the LoRA grad norm, layer "
          f"0's output and the final hidden states "
          f"{[f'{v:.3e}' for v in r_got]} (bounds {bounds}); control "
          f"{[f'{v:.3e}' for v in r_ctrl]} (must break one) {tag}",
          flush=True)
    if not (all(v <= b for v, b in zip(r_got, bounds)) and got[2] > 0):
        raise RuntimeError("QLoRA step: kernel route disagrees with reference")
    if all(v <= b for v, b in zip(r_ctrl, bounds)):
        raise RuntimeError("QLoRA gate cannot see the segments ignored")


def _timed_steps(torch, step, batch, iters):
    """`iters` steps, each between CUDA events (host included). -> (ms a
    step, losses, grad norms)."""
    times, losses, gnorms = [], [], []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        m = step(batch)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    return times, losses, gnorms


def _held(launches, want, what):
    print(f"{what} launches {launches} (derived {want})", flush=True)
    if launches != want:
        raise RuntimeError(f"{what} launches {launches} != {want}")


def qlora_phases(torch, np, dev, cfg, tag, report):
    """Phases 23-25: the kernels at the SFT shapes (sft_kernel_phase); the
    QLoRA step at SFT_TOKENS (bench.py's _bench_sft_train): the gate, a
    warm-up and SFT_ITERS timed steps with the launch counters zeroed just
    before and read just after, held to _qlora_want; the fwd / bwd /
    optimizer split as bench.py defines it (the forward alone, loss +
    backward minus it, the whole step minus loss + backward); one step
    under torch.profiler; the step at SFT_LONG in segment blocks of
    SFT_BLOCK (_bench_sft_16k, batch seed 1), counted the same way; then
    merge_qlora_into_quant's float model against the int8 + LoRA model.
    -> launches of both steps."""
    from vlaser_tpu_torch.train.losses import make_sft_loss_chunked
    from vlaser_tpu_torch.train.train_step import ParamGroup, make_train_step

    t0 = time.perf_counter()
    model, factors = _qlora_model(torch, dev, cfg, 24)
    lay = model.language_model.model.layers
    torch.cuda.synchronize()
    n_lora = sum(p.numel() for p in factors.values())
    print(f"QLoRA model: Vlaser-2B, bf16, remat, int8 base (LLM layers w8a8, "
          f"embedding and lm_head weight-only), LoRA r {SFT_RANK} alpha "
          f"{SFT_ALPHA} on {len(factors) // 2} targets ({n_lora / 1e6:.2f} M "
          f"parameters), {torch.cuda.memory_allocated() / 2**30:.2f} GiB on "
          f"device, {time.perf_counter() - t0:.1f} s", flush=True)
    sft_kernel_phase(torch, np, dev, cfg, _gemm_sites(lay.self_attn, lay.mlp),
                     tag, report)

    batch = _sft_batch(torch, np, dev, cfg, SFT_TOKENS, 0)
    loss_fn = make_sft_loss_chunked(model, chunk=SFT_CHUNK)
    qlora_gate(torch, model, factors, loss_fn, batch, tag)
    step = make_train_step(loss_fn, {"lora": ParamGroup(
        list(factors.values()), lambda i: SFT_LR, 0.01, None)})
    L = cfg.llm.num_layers
    launches = {}
    for n, iters, b in ((SFT_TOKENS, SFT_ITERS, batch), (SFT_LONG,
                        SFT_LONG_ITERS, None)):
        if b is None:
            b = _sft_batch(torch, np, dev, cfg, n, 1, block=SFT_BLOCK)
        step(b)  # the warm-up, outside the counted window
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        times, losses, _ = _timed_steps(torch, step, b, iters)
        counts = {k: v for k, v in _read_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
        med = statistics.median(times)
        print(f"QLoRA step, {n} tokens: losses "
              f"{[round(v, 6) for v in losses]}, step ms "
              f"{[round(v, 3) for v in times]} (median {med:.3f} ms, CUDA "
              f"events), {n / med * 1e3:.1f} tok/s, peak device memory "
              f"{peak:.2f} GiB {tag}", flush=True)
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError("QLoRA step gave a non-finite loss")
        _held(counts, _qlora_want(L, iters), f"QLoRA {n}")
        _add(launches, counts)
        if n != SFT_TOKENS:
            continue

        def fwd():
            with torch.no_grad():
                loss_fn(b)

        def grad():
            for p in factors.values():
                p.grad = None
            loss_fn(b).backward()

        t_fwd, t_grad = _ms(torch, fwd, iters), _ms(torch, grad, iters)
        print(f"QLoRA step split (bench.py's phases, CUDA events): fwd "
              f"{t_fwd:.3f} ms, bwd (with the remat recompute) "
              f"{max(t_grad - t_fwd, 0):.3f} ms, optimizer "
              f"{max(med - t_grad, 0):.3f} ms, step {med:.3f} ms {tag}",
              flush=True)
        _profile(torch, lambda: step(b), f"QLoRA step ({n} tokens)", tag)
        del b
        gc.collect()
        torch.cuda.empty_cache()
    merge_phase(torch, np, dev, cfg, model, factors, tag)
    return launches


def merge_phase(torch, np, dev, cfg, model, factors, tag):
    """merge_qlora_into_quant's float model (bf16) against the int8 + LoRA
    model after its steps, both weight-only (the w8a8 flags dropped), on one
    MERGE_TOKENS-token input with a tile: the logits within MERGE_REL in
    relative L2 distance. Informational: how far the logits move when the
    LoRA term is dropped."""
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.train.lora import merge_qlora_into_quant

    flt = InternVLChatModel(cfg, param_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16, device=dev)
    load_state(flt, merge_qlora_into_quant(model.state_dict()))
    for m in model.modules():
        m._buffers.pop("kernel_aq", None)
    b = _sft_batch(torch, np, dev, cfg, MERGE_TOKENS, 3)
    args = (b["input_ids"], b["pixel_values"], b["image_flags"])
    with torch.no_grad():
        lq, lf = model(*args)[0], flt(*args)[0]
        for n, p in factors.items():
            if n.endswith("lora_b"):
                p.zero_()
        l0 = model(*args)[0]
    dist = lambda a: (torch.linalg.vector_norm(a - lq)
                      / torch.linalg.vector_norm(lq)).item()
    err, moved = dist(lf), dist(l0)
    fin = bool(lf.isfinite().all())
    print(f"merge: merged float model vs int8 + LoRA logits [{MERGE_TOKENS} x "
          f"{lq.shape[-1]}] rel L2 {err:.3e} (bound {MERGE_REL}), max_abs_err "
          f"{(lf - lq).abs().max().item():.3e}, finite {fin}; the LoRA term "
          f"moves them {moved:.3e} {tag}", flush=True)
    if not (fin and err <= MERGE_REL):
        raise RuntimeError("merge_qlora_into_quant: merged model disagrees")


def sft_trainer_phase(torch, np, dev, cfg, tag):
    """Phase 26: SFTTrainer with full parameters as scripts/train_sft.py
    builds it (fp32 parameters, bf16 compute, remat, TrainConfig()
    defaults: the ViT frozen, AdamW 2e-5 cosine with warmup, clip 1.0) on
    one packed batch (_packed_batch): 3 steps with the launch counters
    zeroed just before and read just after, held to the counts the code
    implies; losses, grad norms (the frozen ViT's gradients included, as
    the JAX step's), step ms, peak memory; the ViT bit for bit unchanged;
    the cost of the ViT's backward (loss + backward with and without the
    ViT taking gradients). -> launches of the 3 steps."""
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.train.losses import make_sft_loss
    from vlaser_tpu_torch.train.trainer import SFTTrainer, TrainConfig

    t0 = time.perf_counter()
    model = InternVLChatModel(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.bfloat16, device=dev,
                              remat=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    _train_init_(torch, model, gen)
    trainer = SFTTrainer(model, TrainConfig())
    lengths = (SFT_TOKENS * 3 // 8, SFT_TOKENS * 5 // 16, SFT_TOKENS // 4)
    batch = _packed_batch(np, cfg, SFT_TOKENS, 26, lengths)
    vit = {n: p.detach().clone()
           for n, p in model.vision_model.named_parameters()}
    torch.cuda.synchronize()
    n_param = sum(p.numel() for p in model.parameters())
    n_vit = sum(p.numel() for p in vit.values())
    print(f"SFTTrainer model: Vlaser-2B, fp32 params / bf16 compute, remat, "
          f"{n_param / 1e9:.3f} G parameters ({n_vit / 1e9:.3f} G frozen "
          f"ViT), {torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, "
          f"{time.perf_counter() - t0:.1f} s; batch 1 x {SFT_TOKENS}, "
          f"segments {lengths}, {SFT_TOKENS - sum(lengths)} padding tokens",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    times, losses, gnorms = _timed_steps(
        torch, lambda b: trainer.train(iter([b])), batch, STEPS)
    counts = {k: v for k, v in _read_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"SFTTrainer: {STEPS} steps, losses {[round(v, 6) for v in losses]}"
          f", grad norms {[round(v, 4) for v in gnorms]}, step ms "
          f"{[round(v, 3) for v in times]} (median "
          f"{statistics.median(times):.3f} ms, CUDA events), peak device "
          f"memory {peak:.2f} GiB {tag}", flush=True)
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise RuntimeError("SFTTrainer gave a non-finite loss or norm")
    # as _qlora_want, without w8a8 and with every norm's backward (the
    # embeddings are trained)
    L = cfg.llm.num_layers
    _held(counts, {"flash_attention_fwd": STEPS * 2 * L,
                   "flash_attention_bwd": STEPS * L,
                   "_rms_fwd": STEPS * (4 * L + 1),
                   "_rms_bwd": STEPS * (2 * L + 1)}, "SFTTrainer")
    changed = [n for n, p in model.vision_model.named_parameters()
               if not torch.equal(p.detach(), vit[n])]
    print(f"SFTTrainer: frozen ViT parameters changed: {len(changed)} of "
          f"{len(vit)}", flush=True)
    if changed:
        raise RuntimeError(f"SFTTrainer moved the frozen ViT: {changed[:4]}")
    del vit
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    loss_fn = make_sft_loss(model)

    def grad():
        model.zero_grad(set_to_none=True)
        loss_fn(tb).backward()

    ms = {}
    for label, on in (("with", True), ("without", False), ("with", True)):
        model.vision_model.requires_grad_(on)
        ms.setdefault(label, []).append(_ms(torch, grad, 2))
    model.zero_grad(set_to_none=True)
    with_, without = statistics.mean(ms["with"]), ms["without"][0]
    print(f"SFTTrainer: loss + backward {with_:.3f} ms with the ViT's "
          f"gradients, {without:.3f} ms without: the ViT backward that "
          f"grad_norm parity costs is {with_ - without:.3f} ms "
          f"({(with_ - without) / statistics.median(times):.1%} of a step) "
          f"{tag}", flush=True)
    return counts


def sft_phases(torch, np, dev, cfg, tag, report):
    """Phases 23-26, the Vlaser-2B SFT slice: -> launches of its main
    paths."""
    launches = qlora_phases(torch, np, dev, cfg, tag, report)
    gc.collect()
    torch.cuda.empty_cache()
    return _add(launches, sft_trainer_phase(torch, np, dev, cfg, tag))


# -- the A/B against a parent tree's kernels (--ab DIR) ------------------------
# (name, B, Sq, Skv, H, KVH, D, causal, softcap, window, backward): the flash
# shapes of PERF.md's kernel table (phases 9, 13 and 17)
AB_SHAPES = (("vit", 32, 1025, 1025, 16, 16, 64, False, None, None, True),
             ("joint", 32, 389, 389, 12, 2, 128, False, None, None, True),
             ("chat prefill", 1, 3584, 3592, 12, 2, 128, True, None, None,
              False),
             ("chat prefill window", 1, 3584, 3592, 12, 2, 128, True, None,
              CHAT_WINDOW, False),
             ("pali_joint", 32, 281, 281, 8, 1, 256, False, 50.0, None, True),
             ("pali_suffix", 1, 4, 281, 8, 1, 256, False, 50.0, None, True),
             ("siglip", 32, 256, 256, 16, 16, 72, False, None, None, True))


def _parent_lib(parent, stem, *extra):
    """Build a parent tree's csrc/<stem>.cu (and csrc/<extra>.cu, the
    sources it calls into, with their headers) into its own library, as
    kernels/_build.py builds ours; -> (ctypes.CDLL, the source's text).
    -fno-gnu-unique: g++ would otherwise export a template function's local
    statics (a kernel's one-time shared-memory attribute, a tensor-map
    cache) as process-wide unique symbols, and a parent kernel of the same
    name as ours would then skip its own cudaFuncSetAttribute and fail to
    launch."""
    import ctypes
    import hashlib

    from vlaser_tpu_torch.kernels import _build

    src = os.path.join(os.path.abspath(parent), "vlaser_tpu_torch", "csrc")
    stems = (stem, *extra)
    h = hashlib.sha256()
    for f in sorted(os.listdir(src)):
        if f.split(".")[0] in stems or f.endswith(".cuh"):
            h.update(open(os.path.join(src, f), "rb").read())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / f"libparent_{stem}_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xcompiler",
                        "-fno-gnu-unique", "-shared", "-o", str(lib),
                        *[os.path.join(src, t + ".cu") for t in stems]],
                       check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib)), open(os.path.join(src, stem + ".cu")).read()


def _parent_flash(parent):
    """The parent's flash kernels -> (fwd, bwd) C functions with the
    parent's signatures (bwd: 12 pointers, its delta kernel filling the
    delta scratch)."""
    import ctypes

    cdll, _ = _parent_lib(parent, "flash_attention")
    tail = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
    fwd, bwd = cdll.flash_attention_fwd, cdll.flash_attention_bwd
    fwd.argtypes = [ctypes.c_void_p] * 7 + tail
    bwd.argtypes = [ctypes.c_void_p] * 12 + tail
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _build_report(build):
    """ptxas's registers and spills of each kernel of the flash, int8 GEMM,
    RMSNorm, fused ViT and decoder-stack sources (the launch's register
    count: the warp-specialized
    kernels then move registers from the producer to the consumers), the
    dynamic shared memory of the flash and GEMM kernels, and every ptxas
    warning of those sources, such as a note that it serialized wgmma
    instructions."""
    import ctypes
    import re

    lib = build.library()
    fsmem, gsmem = lib.flash_attention_smem, lib.w8a8_gemm_smem
    fsmem.argtypes, fsmem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    gsmem.argtypes, gsmem.restype = [ctypes.c_int], ctypes.c_int
    vsmem = lib.vit_smem
    vsmem.argtypes, vsmem.restype = [ctypes.c_int], ctypes.c_int
    which = {"fwd_kernel": 0, "dq_kernel": 1, "dkv_kernel": 2}
    for stem in ("flash_attention", "w8a8", "rmsnorm", "fused_vit",
                 "fused_decode"):
        for r in build.ptxas_report(stem):
            if "warning" in r:
                print(f"ptxas {stem}: {r['warning']}", flush=True)
                continue
            if stem == "flash_attention":
                m = re.search(r"fa\d+([a-z_]+?)(?:ILi(\d+)E(?:Lb([01])E)?)?E",
                              r["kernel"])
                if not m:
                    continue
                name, d = m.group(1), m.group(2)
                cap = ("" if m.group(3) is None
                       else f", softcap {m.group(3) == '1'}")
                sm = (f", {fsmem(int(d), which[name])} bytes dynamic shared "
                      f"memory" if name in which else "")
                label = f"{name}{'' if d is None else f' D {d}'}{cap}"
            else:
                m = re.search(r"\d([a-z][a-z_]*?_kernel)(?:I(\w*?)E)?[Ev]",
                              r["kernel"])
                if not m:
                    continue
                name, targs = m.group(1), m.group(2) or ""
                ints = [int(v) for v in re.findall(r"Li(\d+)", targs)]
                sm = ""
                if stem == "fused_vit" and name == "gemm_kernel":
                    label = f"{name} epilogue {ints[0]}, BN {ints[1]}"
                    sm = f", {vsmem(ints[1])} bytes dynamic shared memory"
                elif stem == "fused_vit" and name == "attention_kernel":
                    label = name
                    sm = f", {vsmem(0)} bytes dynamic shared memory"
                elif stem == "fused_decode" and name == "stack_kernel":
                    w = "bf16" if "bfloat16" in targs else "int8"
                    label = f"stack_kernel rows {ints[0]}, {w} weights"
                elif name == "gemm_kernel" and len(ints) == 2:
                    label = f"gemm_kernel epilogue {ints[0]}, BN {ints[1]}"
                    sm = (f", {gsmem(ints[1])} bytes dynamic shared memory")
                elif name == "bwd_kernel" and ints:
                    dt = "bf16" if "bfloat16" in targs else "fp32"
                    label = f"bwd_kernel {dt}, {ints[0]} chunks of 256"
                    sm = f", {8 * 256 * ints[0] * 4} bytes shared memory"
                else:
                    label = f"{name}{f' <{targs}>' if targs else ''}"
            print(f"ptxas {stem}: {label}: {r.get('registers')} registers, "
                  f"{r.get('spill_bytes')} spill bytes{sm}", flush=True)


def flash_ab_phase(torch, dev, parent, tag):
    """The flash kernels against a parent tree's, on the same inputs, timed
    in turns (parent, change, change, parent) at AB_SHAPES. Outputs are
    compared too. -> {shape: {"fwd"/"bwd": [4 times]}}."""
    from vlaser_tpu_torch.kernels import flash_attention as fa

    pfwd, pbwd = _parent_flash(parent)
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    i32 = dict(dtype=torch.int32, device=dev)
    res = {}
    for name, B, Sq, Skv, H, KVH, D, causal, cap, win, bwd in AB_SHAPES:
        gain = PALI_GAIN if cap else 1.0
        q, k, v, do = _flash_inputs(torch, g, dev, B, Sq, Skv, H, KVH, D, gain)
        qm = fa.pack_meta(torch.ones(B, Sq, **i32))
        km = fa.pack_meta(torch.ones(B, Skv, **i32))
        if causal:  # the prefill's cache: the new-token slots are empty
            km[:, Sq:] = 0
        opts = (int(causal), 0, 1.0 / math.sqrt(D), cap or 0.0,
                -1 if win is None else win)
        stream = lambda: torch.cuda.current_stream(dev).cuda_stream
        out, lse = fa.flash_attention_fwd(q, k, v, qm, km, 0, causal,
                                          softcap=cap, window=win)

        def parent_fwd():
            o = torch.empty_like(q)
            l = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
            code = pfwd(*[t.data_ptr() for t in (q, k, v, qm, km, o, l)],
                        B, Sq, Skv, H, KVH, D, *opts, stream())
            if code:
                raise RuntimeError(f"parent flash fwd: CUDA error {code}")
            return o, l

        def parent_bwd():
            grads = [torch.empty_like(t) for t in (q, k, v)]
            ptrs = (q, k, v, out, do, qm, km, lse, torch.empty_like(lse),
                    *grads)
            code = pbwd(*[t.data_ptr() for t in ptrs],
                        B, Sq, Skv, H, KVH, D, *opts, stream())
            if code:
                raise RuntimeError(f"parent flash bwd: CUDA error {code}")
            return grads

        change_fwd = lambda: fa.flash_attention_fwd(q, k, v, qm, km, 0, causal,
                                                    softcap=cap, window=win)
        change_bwd = lambda: fa.flash_attention_bwd(
            q, k, v, qm, km, 0, out, lse, do, causal, softcap=cap, window=win)
        pairs = [("fwd", parent_fwd, change_fwd)]
        if bwd:
            pairs.append(("bwd", parent_bwd, change_bwd))
        res[name] = {}
        for kind, par, chg in pairs:
            a, b_ = par(), chg()
            torch.cuda.synchronize()
            diff = max((x.float() - y.float()).abs().max().item()
                       for x, y in zip(a, b_))
            ts = [_kernel_ms(torch, f, 10) for f in (par, chg, chg, par)]
            res[name][kind] = ts
            print(f"flash A/B {kind} {name}: parent {ts[0]:.4f} / change "
                  f"{ts[1]:.4f} / change {ts[2]:.4f} / parent {ts[3]:.4f} ms "
                  f"(parent / change {(ts[0] + ts[3]) / (ts[1] + ts[2]):.2f}x;"
                  f" max |parent - change| {diff:.3g}) {tag}", flush=True)
            if kind == "bwd":  # the change's two kernels, by device time
                ks = _profile(torch, chg, "", tag, quiet=True)["kernels"]
                print(f"  change bwd {name} by kernel: " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in sorted(ks.items())),
                    flush=True)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return res


# (name, rows, [(site, K, N)]): the int8 GEMM shapes of the A/B: one
# Qwen2.5-1.5B layer's 7 GEMMs at the VLA prefix (384), its batch-8 prefix
# (3,072) and the 13-tile chat prefill (3,584) rows; the InternViT-300M
# stack's 4 products at 13 tiles (13 x 1025 rows)
QWEN_GEMMS = (("q", 1536, 1536), ("k", 1536, 256), ("v", 1536, 256),
              ("o", 1536, 1536), ("gate", 1536, 8960), ("up", 1536, 8960),
              ("down", 8960, 1536))
VIT_GEMMS = (("qkv", 1024, 3072), ("proj", 1024, 1024), ("fc1", 1024, 4096),
             ("fc2", 4096, 1024))
GEMM_AB = (("layer", 384, QWEN_GEMMS), ("layer", 3072, QWEN_GEMMS),
           ("layer", 3584, QWEN_GEMMS), ("vit", 13 * 1025, VIT_GEMMS))


def _parent_gemm(parent):
    """The parent's int8 GEMM (w8a8_gemm_rows, bf16 out) -> fn(q, am, kq
    [K, N], kt [N, K], ks) -> y, in the parent's own weight layout: K-major
    with its int32 scratch where its source has w8a8_gemm_workspace, else
    the JAX [K, N]."""
    import ctypes

    import torch

    cdll, text = _parent_lib(parent, "w8a8")
    fn, P, I = cdll.w8a8_gemm_rows, ctypes.c_void_p, ctypes.c_int
    fn.restype = I
    kmajor = "w8a8_gemm_workspace" in text
    if kmajor:
        ws_fn = cdll.w8a8_gemm_workspace
        ws_fn.argtypes, ws_fn.restype = [I, I, I], ctypes.c_longlong
        fn.argtypes = [P] * 6 + [I] * 4 + [ctypes.c_longlong, P]
    else:
        fn.argtypes = [P] * 5 + [I] * 4 + [P]

    def run(q, am, kq, kt, ks):
        (M, K), N = q.shape, ks.numel()
        y = torch.empty((M, N), dtype=torch.bfloat16, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kmajor:
            n = int(ws_fn(M, N, K))
            ws = torch.empty(max(n, 1), dtype=torch.int32, device=q.device)
            code = fn(q.data_ptr(), am.data_ptr(), kt.data_ptr(),
                      ks.data_ptr(), y.data_ptr(), ws.data_ptr(), M, N, K, 1,
                      n, stream)
        else:
            code = fn(q.data_ptr(), am.data_ptr(), kq.data_ptr(),
                      ks.data_ptr(), y.data_ptr(), M, N, K, 1, stream)
        if code:
            raise RuntimeError(f"parent w8a8_gemm_rows: CUDA error {code}")
        return y
    return run


def _parent_quant(parent):
    """The parent's w8a8_quantize_rows -> fn(x [M, K]) -> (q, am)."""
    import ctypes

    import torch

    cdll, _ = _parent_lib(parent, "w8a8")
    fn, P, I = cdll.w8a8_quantize_rows, ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [P] * 3 + [I] * 4 + [P], I

    def run(x):
        M, K = x.shape
        q = torch.empty((M, K), dtype=torch.int8, device=x.device)
        am = torch.empty((M, 1), dtype=torch.float32, device=x.device)
        code = fn(x.data_ptr(), q.data_ptr(), am.data_ptr(), M, K, 1,
                  int(x.dtype == torch.bfloat16),
                  torch.cuda.current_stream(x.device).cuda_stream)
        if code:
            raise RuntimeError(f"parent w8a8_quantize_rows: CUDA error {code}")
        return q, am
    return run


def quant_ab_phase(torch, dev, parent, tag):
    """One Qwen2.5-1.5B layer's activation quantization against a parent
    tree's, at the rows of GEMM_AB's layers: the parent's route (7
    quantize_rows launches, one per Dense, and the eager F.silu(g) * u
    before down's) against this tree's (3 quantize_rows and
    quantize_silu_mul), in turns (parent, change, change, parent); the
    change's 4 results must equal the parent's matching ones bit for bit.
    The eager silu * u alone is timed in the same run. -> {rows: [4
    times]}."""
    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import w8a8

    pq = _parent_quant(parent)
    (_, C, _), I = QWEN_GEMMS[0], QWEN_GEMMS[-1][1]
    g = torch.Generator(device=dev)
    g.manual_seed(29)
    bf = torch.bfloat16
    res = {}
    for name, rows, _ in GEMM_AB:
        if name != "layer":
            continue
        h, attn, h2 = (torch.randn(rows, C, generator=g, device=dev).to(bf)
                       for _ in range(3))
        gg, uu = _silu_mul_inputs(torch, g, rows, I, dev)
        par = lambda: [pq(h), pq(h), pq(h), pq(attn), pq(h2), pq(h2),
                       pq(F.silu(gg) * uu)]
        chg = lambda: [w8a8.quantize_rows(h), w8a8.quantize_rows(attn),
                       w8a8.quantize_rows(h2), w8a8.quantize_silu_mul(gg, uu)]
        a, b_ = par(), chg()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for i, j in zip((0, 3, 4, 6), range(4))
                   for x, y in zip(a[i], b_[j]))
        ts = [_kernel_ms(torch, f, 20) for f in (par, chg, chg, par)]
        eager = _kernel_ms(torch, lambda: F.silu(gg) * uu, 20)
        res[rows] = ts
        print(f"w8a8 quantization A/B, one layer at {rows} rows: parent (7 "
              f"launches + eager silu * u) {ts[0]:.4f} / change (4 launches) "
              f"{ts[1]:.4f} / change {ts[2]:.4f} / parent {ts[3]:.4f} ms "
              f"(parent / change {(ts[0] + ts[3]) / (ts[1] + ts[2]):.2f}x); "
              f"the eager silu * u alone {eager:.4f} ms; int8 rows and am "
              f"bit-equal {same} {tag}", flush=True)
        if not same:
            raise RuntimeError(f"quantization A/B at {rows} rows: the change's "
                               f"int8 rows differ from the parent's")
        del h, attn, h2, gg, uu, a, b_
    return res


def gemm_ab_phase(torch, dev, parent, tag):
    """The int8 GEMM against a parent tree's, on the same int8 rows, each
    in its own weight layout, bf16 out (the w8a8 Dense's call), timed in
    turns (parent, change, change, parent) at GEMM_AB; the outputs are
    compared; then the layer's quantization (quant_ab_phase). -> {(name,
    rows): [4 summed times]}."""
    from vlaser_tpu_torch.kernels import w8a8

    pgemm = _parent_gemm(parent)
    g = torch.Generator(device=dev)
    g.manual_seed(24)
    res = {}
    for name, rows, sites in GEMM_AB:
        turns, diff = [0.0] * 4, 0.0
        for site, K, N in sites:
            q = torch.randint(-127, 128, (rows, K), generator=g, device=dev,
                              dtype=torch.int8)
            am = torch.rand((rows, 1), generator=g, device=dev) + 0.5
            kq = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                               dtype=torch.int8)
            kt = kq.t().contiguous()
            ks = torch.rand(N, generator=g, device=dev) * 1e-3
            par = lambda: pgemm(q, am, kq, kt, ks)
            chg = lambda: w8a8.int8_gemm(q, am, kt, ks, torch.bfloat16)
            a, b_ = par(), chg()
            torch.cuda.synchronize()
            d = (a.float() - b_.float()).abs().max().item()
            diff = max(diff, d)
            ts = [_kernel_ms(torch, f, 20) for f in (par, chg, chg, par)]
            turns = [t + u for t, u in zip(turns, ts)]
            print(f"  int8 GEMM A/B {name} {site} {rows}x{K} -> {N}: parent "
                  f"{ts[0]:.4f} / change {ts[1]:.4f} / change {ts[2]:.4f} / "
                  f"parent {ts[3]:.4f} ms (max |parent - change| {d:.3g}) "
                  f"{tag}", flush=True)
            del q, kq, kt
        res[name, rows] = turns
        print(f"int8 GEMM A/B, {name}'s {len(sites)} GEMMs at {rows} rows: "
              f"parent {turns[0]:.4f} / change {turns[1]:.4f} / change "
              f"{turns[2]:.4f} / parent {turns[3]:.4f} ms (parent / change "
              f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x; max "
              f"|parent - change| {diff:.3g}) {tag}", flush=True)
        torch.cuda.empty_cache()
    res["quantization"] = quant_ab_phase(torch, dev, parent, tag)
    return res


def rms_ab_phase(torch, dev, cfg, parent, tag):
    """_rms_bwd against a parent tree's at the training shape (12,288 x
    1536 bf16), on the same inputs, in turns (parent, change, change,
    parent), with F.rms_norm's backward timed in the same run; dx and dw
    compared. The parent's rows per block: its wrapper's ROWS_PER_BLOCK,
    or, where it has none, this tree's rows_per_block."""
    import ctypes
    import re

    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import rmsnorm

    cdll, _ = _parent_lib(parent, "rmsnorm")
    fn = cdll.rms_norm_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    src = open(os.path.join(parent, "vlaser_tpu_torch", "kernels",
                            "rmsnorm.py")).read()
    m = re.search(r"^ROWS_PER_BLOCK = (\d+)", src, re.M)
    g = torch.Generator(device=dev)
    g.manual_seed(25)
    bf = torch.bfloat16
    n, H = 32 * cfg.max_image_text_tokens, cfg.vlm.llm.hidden_size
    R = int(m.group(1)) if m else rmsnorm.rows_per_block(n)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    x, w, gy = r(n, H).to(bf), (1 + 0.1 * r(H)).to(bf), r(n, H).to(bf)
    rrms = rmsnorm.rms_fwd(x, w, cfg.vlm.llm.rms_norm_eps)[1]

    def par():
        dx = torch.empty_like(x)
        part = torch.empty((-(-n // R), H), dtype=torch.float32, device=dev)
        dw = torch.empty(H, dtype=torch.float32, device=dev)
        code = fn(*[t.data_ptr() for t in (x, w, gy, rrms, dx, part, dw)], n,
                  H, R, 1, torch.cuda.current_stream(dev).cuda_stream)
        if code:
            raise RuntimeError(f"parent rms_norm_bwd: CUDA error {code}")
        return dx, dw

    chg = lambda: rmsnorm.rms_bwd(x, w, gy, rrms)
    a, b_ = par(), chg()
    torch.cuda.synchronize()
    diff = {k: (u.float() - v.float()).abs().max().item()
            for k, u, v in zip(("dx", "dw"), a, b_)}
    ts = [_kernel_ms(torch, f, 20) for f in (par, chg, chg, par)]
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    yl = F.rms_norm(xl, (H,), wl, cfg.vlm.llm.rms_norm_eps)
    lib = _kernel_ms(torch, lambda: torch.autograd.grad(
        yl, (xl, wl), gy, retain_graph=True), 20)
    print(f"_rms_bwd A/B {n}x{H} bf16: parent {ts[0]:.4f} / change "
          f"{ts[1]:.4f} / change {ts[2]:.4f} / parent {ts[3]:.4f} ms (parent "
          f"/ change {(ts[0] + ts[3]) / (ts[1] + ts[2]):.2f}x); torch "
          f"rms_norm backward {lib:.4f} ms in the same run; max |parent - "
          f"change| {diff} {tag}", flush=True)
    return ts, lib


def _ab(torch, label, par, chg, iters, tag):
    """Parent / change / change / parent device times of two calls that
    compute the same function; their outputs' largest difference. -> the 4
    times."""
    a, b_ = par(), chg()
    torch.cuda.synchronize()
    diff = max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b_))
    del a, b_
    ts = [_kernel_ms(torch, f, iters) for f in (par, chg, chg, par)]
    print(f"{label}: parent {ts[0]:.4f} / change {ts[1]:.4f} / change "
          f"{ts[2]:.4f} / parent {ts[3]:.4f} ms (parent / change "
          f"{(ts[0] + ts[3]) / (ts[1] + ts[2]):.2f}x; max |parent - change| "
          f"{diff:.3g}) {tag}", flush=True)
    return ts


def _vit_ab_weights(torch, dev, vcfg, act_quant):
    """Random InternViT-300M stack arguments (N(0, 0.02^2) weights, phase
    1's visible norms and x4 q/k columns): bf16 [L, K, N], or int8 K-major
    [L, N, K] with scales."""
    from vlaser_tpu_torch.core.quant import quantize_int8

    g = torch.Generator(device=dev)
    g.manual_seed(26)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    L, C, I = vcfg.num_layers, vcfg.hidden_size, vcfg.intermediate_size
    vs = dict(ln1w=1 + 0.1 * r(L, C), ln1b=0.1 * r(L, C),
              ln2w=1 + 0.1 * r(L, C), ln2b=0.1 * r(L, C),
              ls1=0.1 * (1 + 0.1 * r(L, C)), ls2=0.1 * (1 + 0.1 * r(L, C)),
              qnw=torch.ones(L, C, device=dev),
              knw=torch.ones(L, C, device=dev),
              qkvb=0.02 * r(L, 3 * C), projb=0.02 * r(L, C),
              fc1b=0.02 * r(L, I), fc2b=0.02 * r(L, C))
    for w, sc, k, n in (("qkvw", "qkvs", C, 3 * C), ("projw", "projs", C, C),
                        ("fc1w", "fc1s", C, I), ("fc2w", "fc2s", I, C)):
        m = 0.02 * r(L, k, n)
        if w == "qkvw":
            m[:, :, :2 * C] *= 4
        if act_quant:
            q8, s8 = quantize_int8(m, -2)
            vs[w] = q8.transpose(1, 2).contiguous()
            vs[sc] = s8[:, 0].contiguous()
        else:
            vs[w] = m.to(torch.bfloat16)
        del m
    return vs


@contextmanager
def _parent_route(mod, cdll, fns):
    """Within: the wrappers of kernels module `mod` bind and launch the
    C functions of a parent tree's library `cdll` (which must have this
    tree's C signatures), keeping their bindings in `fns` from call to
    call; every other library call of the wrapper (its scratch sizes) goes
    to the parent's library too."""
    from vlaser_tpu_torch.kernels import _build

    old = mod._fns, _build._lib
    mod._fns, _build._lib = fns, cdll
    try:
        yield
    finally:
        mod._fns, _build._lib = old


def vit_ab_phase(torch, dev, parent, vcfg, tag):
    """fused_vit_stack against a parent tree's (its fused_vit.cu with its
    w8a8.cu, called through this tree's wrapper): bf16 mode at B 1,
    act_quant at B 1, 8 and 13, on the same inputs, in turns (parent,
    change, change, parent). -> {(mode, B): [4 times]}."""
    from vlaser_tpu_torch.kernels import fused_vit

    cdll, _ = _parent_lib(parent, "fused_vit", "w8a8")
    pfns = {}
    S = (vcfg.image_size // vcfg.patch_size) ** 2 + 1
    g = torch.Generator(device=dev)
    g.manual_seed(27)
    res = {}
    for act_quant, batches in ((False, (1,)), (True, (1, B8, 13))):
        vs = _vit_ab_weights(torch, dev, vcfg, act_quant)
        kw = dict(num_heads=vcfg.num_heads, eps=vcfg.layer_norm_eps,
                  qk_norm=False, act_quant=act_quant)
        for B in batches:
            x = torch.randn(B, S, vcfg.hidden_size, generator=g,
                            device=dev).to(torch.bfloat16)
            chg = lambda: (fused_vit.fused_vit_stack(x, **vs, **kw),)

            def par():
                with _parent_route(fused_vit, cdll, pfns):
                    return chg()

            mode = "act_quant" if act_quant else "bf16"
            res[mode, B] = _ab(torch, f"fused_vit_stack A/B {mode} B={B}",
                               par, chg, 5 if B == 1 else 3, tag)
            del x
        del vs
        gc.collect()
        torch.cuda.empty_cache()
    return res


def stack_ab_phase(torch, dev, parent, cfg, tag):
    """fused_int8_stack against a parent tree's (called through this tree's
    wrapper), on the same inputs, in turns: the VLM decode (R 1,
    Qwen2.5-1.5B, fp32 rope) over 384, 3,592 and 32,768 slots in both
    weight modes, and the denoise suffix (the 768-wide expert, bf16 rope) at
    R 4 and 5 over the 384-token prompt. -> {(what, R, E): [4 times]}."""
    from vlaser_tpu_torch.core.quant import quantize_int8
    from vlaser_tpu_torch.kernels import fused_decode, ops

    cdll, _ = _parent_lib(parent, "fused_decode")
    pfns = {}
    g = torch.Generator(device=dev)
    g.manual_seed(28)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    bf = torch.bfloat16
    S = cfg.max_image_text_tokens
    cases = [("decode", cfg.vlm.llm, 1, E, mode) for mode in ("int8", "bf16")
             for E in (DECODE_PROMPT + DECODE_NEW, 3592, LONG_CACHE)]
    cases += [("denoise", cfg.expert, R, S + cfg.num_proprio_tokens
               if R == cfg.num_action_tokens else S, "int8")
              for R in (cfg.num_action_tokens,
                        cfg.num_action_tokens + cfg.num_proprio_tokens)]
    res, weights = {}, {}
    for what, m, R, E, mode in cases:
        C, H, KVH, D, I = (m.hidden_size, m.num_heads, m.num_kv_heads,
                           m.head_dim, m.intermediate_size)
        L = m.num_layers
        if (what, mode) not in weights:
            weights.clear()
            gc.collect()
            torch.cuda.empty_cache()
            w = {}
            for n_, k, n in (("q", C, H * D), ("k", C, KVH * D),
                             ("v", C, KVH * D), ("o", H * D, C), ("g", C, I),
                             ("u", C, I), ("d", I, C)):
                q8, s8 = quantize_int8(0.02 * r(L, k, n), -2)
                if mode == "bf16":
                    q8, s8 = (q8.float() * s8).to(bf), torch.ones_like(s8)
                w["w" + n_], w["s" + n_] = q8, s8
            w["ln1"], w["ln2"] = 1 + 0.1 * r(L, C), 1 + 0.1 * r(L, C)
            w["bq"], w["bk"], w["bv"] = (0.02 * r(L, H * D),
                                         0.02 * r(L, KVH * D),
                                         0.02 * r(L, KVH * D))
            weights[what, mode] = w
        w = weights[what, mode]
        x = r(R, C).to(bf)
        cos, sin = ops.rope_cos_sin(torch.arange(R, device=dev) + E - 40.0,
                                    D, m.rope_theta)
        if what == "denoise":
            cos, sin = cos.to(bf), sin.to(bf)
        selfm = torch.zeros(R, R, device=dev)
        extm = torch.zeros(1, E, device=dev)
        extm[0, int(0.9 * E):] = fused_decode.NEG_INF
        k_e, v_e = (2 * r(L, E, KVH, D)).to(bf), (2 * r(L, E, KVH, D)).to(bf)
        args = (x, cos, sin, selfm, extm, w["ln1"], w["ln2"], w["bq"],
                w["bk"], w["bv"], w["wq"], w["sq"], w["wk"], w["sk"],
                w["wv"], w["sv"], w["wo"], w["so"], w["wg"], w["sg"],
                w["wu"], w["su"], w["wd"], w["sd"], k_e, v_e)
        chg = lambda: fused_decode.fused_int8_stack(*args, eps=m.rms_norm_eps)

        def par():
            with _parent_route(fused_decode, cdll, pfns):
                return chg()

        res[what, mode, R, E] = _ab(
            torch, f"fused_int8_stack A/B {what} {mode} R={R} E={E}", par,
            chg, 10 if E < LONG_CACHE else 5, tag)
        del k_e, v_e, args
    weights.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return res


KERNEL_GROUPS = (("flash attention", ("fa::",)), ("RMSNorm", ("rms::",)),
                 ("w8a8 quantizer + int8 GEMM", ("w8a8::",)),
                 ("fused ViT", ("vit::",)), ("int8 stack", ("dec::",)),
                 ("GEMM", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
                 ("AdamW", ("adam",)))


def _profile_step(torch, trainer, batch, tag):
    _profile(torch, lambda: trainer.train_steps(iter([batch]), 1),
             "train step", tag)


def _profile(torch, fn, label, tag, quiet=False):
    """One call of fn under torch.profiler: device time by kernel group
    and the share of the call's wall time with no kernel running. -> {"busy":
    device ms, "groups": ms by group, "kernels": ms by kernel name (its
    name before any template or argument list), "launches": kernels
    launched (copies and fills not counted), "launch_keys": launches by
    the profiler's full kernel name}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels, by_name, launches, keys = {}, [], {}, 0, {}
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
        if not ev.key.startswith(("Memcpy", "Memset")):
            launches += ev.count
            keys[ev.key] = keys.get(ev.key, 0) + ev.count
        short = ev.key.split("(")[0].split("<")[0].split("::")[-1]
        by_name[short] = by_name.get(short, 0.0) + us / 1e3
    busy = sum(groups.values())
    if not quiet:
        print(f"profiled {label}: wall {wall_ms:.1f} ms, device busy "
              f"{busy:.1f} ms, idle {100 * (1 - busy / wall_ms):.1f}% {tag}",
              flush=True)
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  {g}: {ms:.1f} ms ({100 * ms / busy:.1f}%)", flush=True)
        for ms, n, key in sorted(kernels, reverse=True)[:12]:
            print(f"  {ms:9.2f} ms {n:5d}x {key}", flush=True)
    return {"busy": busy, "groups": groups, "kernels": by_name,
            "launches": launches, "launch_keys": keys}


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ab", "--flash-ab", dest="ab", metavar="DIR",
                    help="also time the flash kernels, the int8 GEMM and the "
                         "activation quantizer, the "
                         "RMSNorm backward, the fused ViT stack and the "
                         "decoder stack against those of the tree unpacked "
                         "at DIR (parent, change, change, parent)")
    ap.add_argument("--engine-wall", action="store_true",
                    help="only build the kernels and time the engine on "
                         "bench.py's _bench_engine workload (wall, host "
                         "included) in this process, then exit")
    ap.add_argument("--profile-first", action="store_true",
                    help="with --engine-wall: one torch.profiler session "
                         "before the timing")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from vlaser_tpu_torch.core.config import (pizero_paligemma, vlaser_2b,
                                              vlaser_2b_vla)
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

    if args.engine_wall:
        engine_wall(torch, np, dev, vlaser_2b(), args.profile_first, tag)
        return 0
    _build_report(_build)
    report = {}
    # first: its wall times are host-bound, and a profiler session leaves
    # later launches in the process slower (PERF.md)
    launches = engine_phases(torch, np, dev, vlaser_2b(), tag, report)
    gc.collect()
    torch.cuda.empty_cache()
    # the profiler's first trace in a process can miss its first kernels
    _profile(torch, lambda: torch.ones(8, device=dev).add_(1), "warm-up", tag,
             quiet=True)
    stack_launch_phase(torch, dev, vlaser_2b().llm, tag)
    if args.ab:  # before the slices, so that their failure keeps it
        flash_ab_phase(torch, dev, args.ab, tag)
        gc.collect()
        torch.cuda.empty_cache()
        gemm_ab_phase(torch, dev, args.ab, tag)
        rms_ab_phase(torch, dev, vlaser_2b_vla(), args.ab, tag)
        gc.collect()
        torch.cuda.empty_cache()
        vit_ab_phase(torch, dev, args.ab, vlaser_2b().vision, tag)
        stack_ab_phase(torch, dev, args.ab, vlaser_2b_vla(), tag)
        gc.collect()
        torch.cuda.empty_cache()
    cfg = vlaser_2b_vla()
    _add(launches, serving_phases(torch, np, dev, cfg, tag, report))
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, w8a8_phases(torch, np, dev, cfg, tag, report))
    gc.collect()
    torch.cuda.empty_cache()
    flash_phase(torch, dev, cfg, tag, report)
    rms_phase(torch, dev, cfg, tag, report)
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, train_phase(torch, np, dev, cfg, tag, report))
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, chat_phases(torch, np, dev, vlaser_2b(), tag, report))
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, pali_phases(torch, np, dev, pizero_paligemma(), tag,
                               report))
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, sft_phases(torch, np, dev, vlaser_2b(), tag, report))
    gc.collect()
    torch.cuda.empty_cache()
    engine_profile_phase(torch, np, dev, vlaser_2b(), tag, report)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "vlaser_tpu")]
    if bad:
        raise RuntimeError(f"the port imported {bad[:4]}")

    for name, r in report.pop("engine_kernels").items():
        report[name]["engine"] = r
    kernels = []
    for name, src, rep in (
            ("fused_vit_stack", "fused_vit.cu", "kernels/fused_vit.py:455"),
            ("fused_vit_stack_w8a8", "fused_vit.cu",
             "kernels/fused_vit.py:455"),
            ("quantize_rows", "w8a8.cu", "models/layers.py:49"),
            ("quantize_silu_mul", "w8a8.cu", "models/layers.py:49"),
            ("int8_gemm", "w8a8.cu", "models/layers.py:49"),
            ("fused_int8_stack", "fused_decode.cu",
             "kernels/fused_decode.py:303"),
            ("fused_int8_stack_bf16", "fused_decode.cu",
             "kernels/fused_decode.py:303"),
            ("flash_attention_fwd", "flash_attention.cu",
             "kernels/flash_attention.py:159"),
            ("flash_attention_bwd", "flash_attention.cu",
             "kernels/flash_attention.py:416"),
            ("_rms_fwd", "rmsnorm.cu", "kernels/rmsnorm.py:64"),
            ("_rms_bwd", "rmsnorm.cu", "kernels/rmsnorm.py:89")):
        r = report[name]
        entry = {"name": name, "route": "cuda",
                 "source": "vlaser_tpu_torch/csrc/" + src,
                 "replaces": "vlaser_tpu/" + rep,
                 "launches": launches.get(name, 0)}
        entry.update({k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")})
        for extra, v in r.items():  # the same kernel at other shapes
            if isinstance(v, dict):
                entry[extra] = v
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
