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
Vlaser-2B serving engine (phases 20-22, run first), of the Vlaser-2B
SFT train step (phases 23-26, after 19), of the training entry points
(phases 27-31, after 26; the LLM's depth cut to CUT_LAYERS), of the VLA
recipe's 8-bit trainer (phases
32-34, right after 11), of the VLM's serving and evaluation entry
points (phases 35-37, right after 22), of the closed-loop evaluations
(phases 38-39, right after 37), of the RoboTwin parallel-decoding VLA's
training (phase 40, right after 26), of the dense families beyond
Vlaser-2B (phases 41-43, right after 39: Vlaser-8B chat, InternVL3.5-2B,
then the Vlaser-8B-VLA control step), of the native image loader and
the Qwen3-MoE family (phases 44-45, between 43 and 42) and of the VLA's
text head, its adaLN-Zero and vision-in-expert ablations, InternViT-6B and
the graft entry's twin (phases 46-49, after 27-31, before the engine's
profiled run), of the data-generation pipelines (phases 50-52, right after
37), of the data / fsdp / context layouts (phases 54-56, after 46-49: the
ring's chunk route, the trainers over a one-rank NCCL mesh, the gate's
8-rank gloo mirror on the host), of the tensor axis for serving (phase 57,
right after 56: two processes share the card over a gloo group on CUDA
tensors, PolicyServer(mesh=) and ContinuousBatchingEngine(mesh=) at
tensor 2 against one process), of the tensor axis for training (phase
58, right after 57: SFTTrainer(TrainConfig(mesh_tp=2)) in two such
processes against one), of the stage axis for training (phase 59, right
after 58: the GPipe pipeline of Vlaser-2B's LLM at stage 2 in two such
processes against one) and of the memory budget (phase 53, last)
with random weights from seeded generators; each group's wall seconds are printed on a line of
its own ("phase wall: ..."). The native image libraries
(vlaser_tpu_torch/native, g++) build beside nvcc:

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
     and the static batch-8 make_generate_fn: useful tokens/s (ENGINE_REPS
     wall-clock runs after a warm-up, their median), rows that differ from
     the solo plain decode of ENGINE_ORACLE_ROWS of the requests (bf16,
     informational) with the first divergence and the
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
The training entry points (vlaser_tpu_torch/scripts: train_sft, pretrain,
train_mpo; Vlaser-2B, the byte tokenizer, seeded JSONL files of text-only
conversations, each with one blank tile, in a temporary directory that
the run removes):
  27. the converter round trip: a seeded Vlaser-2B exported to an HF
     checkpoint directory (utils/convert.to_jax_params ->
     hf_convert.export_internvl_chat, bf16, save_hf_checkpoint_dir) and
     read back as the CLIs read one (load_safetensors_dir ->
     convert_internvl_chat -> from_jax_variables): every tensor equal to
     its bf16-rounded source (control: the fp32 source differs); GB and
     seconds;
  28. train_sft's stages at full width and depth from that checkpoint:
     160 conversations of 64-1,500 text tokens, --packed --max_seq 2048,
     4 steps, a checkpoint directory: the packer's fill rate, tokens/s over
     real tokens, step ms, each step's wait on the prefetch queue, the
     host's packing time, peak memory, launch counts held to the derived
     ones (the blank tiles of a pack send the ViT to flash from 2 tiles on),
     one step under torch.profiler; the final checkpoint's GB, free disk,
     save and restore seconds; restored into a fresh model and trainer it
     equals the live trainer (every parameter and AdamW entry, the step
     counter, the saved data state) bit for bit; control: the same
     comparison against the state one step earlier fails;
  29. pretrain --stage 1's recipe on that model: 2 steps, derived launch
     counts, only mlp1 changes, every other parameter bit for bit;
  30. train_mpo's stages at full width: 3 MPOTrainer steps on one pair of
     2,000 tokens, the losses, reward accuracy, step ms, peak memory,
     derived launch counts (the reference forward and the policy's); the
     reference copy bit for bit the initial parameters in storage of its
     own; control: a reference aliasing the live parameters moved;
  31. each CLI's main through argparse with --tiny on the card: it must
     train there and leave its checkpoint (train_mpo takes none).
The VLA recipe's trainer (Vlaser-2B-VLA, batch 32, phase 11's seeded
batch: the card's machine has no tensorflow, so train_vla's RLDS stream is
not run there; its stages build the model and the trainer with --adam8bit,
EMA 0.999 from step 0 and a metrics log):
  32. 3 VLATrainer steps timed with CUDA events, launch counters zeroed
     just before and read just after, held to phase 11's flash and RMSNorm
     counts plus one adamw8bit launch a leaf of >= 4,096 elements a step;
     losses, grad norms, the metrics log's lines, peak memory beside phase
     11's fp32 AdamW; the checkpoint of step 3 (15 GB, uint8 codes
     included) saved, restored into a fresh trainer and equal to the live
     one bit for bit (control: the state after step 2 differs);
  33. the adamw8bit kernel against its twin on the live state and
     gradients, from cloned state, at the largest leaf and the patch conv
     (HWIO blocking): codes, scales and parameters bit for bit (control: b1
     one fp32 ulp up differs); a small leaf's fp32 route on the card equals
     the host's; the step split (forward, backward with remat, 8-bit AdamW,
     EMA);
  34. evaluate on 8 rows under the EMA parameters: action accuracy, L1,
     ms; then the step's 50 kernel launches timed against their bound, the
     twin over every leaf, AdamW8bit.step with its host work, fused fp32
     AdamW over the same parameters (another function, for reference) and
     the peak memory of a step without the EMA.
The VLM's serving and evaluation entry points (one Vlaser-2B, bf16 N(0,
0.02^2), through serve_vlm's config stage with the byte tokenizer's image
tokens and its quantize stage: w8a8; the byte tokenizer encodes every
prompt, its 237-token template included, and each decoded id shows as its
decimal; it has no EOS, so every completion runs to its budget):
  35. beam search: VlaserChat(num_beams=K) on 13 seeded tiles, a 320-token
     message, 64 new tokens, K 2 and 4 (bucket 256): make_beam_generate_fn
     with K = 1 against make_generate_fn's greedy decoder on the same
     prompt (every logit row before the first difference bit for bit equal,
     the tokens equal unless they first differ at a top-2 margin within the
     fp32 rounding of the beam's summed log-probabilities); one call of each
     K with the launch counters zeroed just before and read just after, held
     to the counts the code implies (the plain prefill: the ViT layer by
     layer, 4 w8a8 Dense and flash a layer; the LLM's w8a8, flash and
     RMSNorm; the K-row steps none); call ms, tok/s of the best beam, the
     prefill, a beam step, the cache reorder against its bound, peak memory;
     then the fp32 gate on tiny_vlm (phase 21's setup), K 2 and 3, card
     against the host's run of the same weights, an EOS never reached and
     one emitted mid-beam: tokens and lengths equal;
  36. serve_vlm's stages (--engine, the CLI's defaults, max_len 640: a
     320-token message behind the template) behind ChatHTTPServer on
     127.0.0.1: a warm-up burst, then SERVE_BURSTS bursts of 16
     concurrent requests (messages of phase 20's lengths, 64-320 tokens,
     max_tokens 16 / 32 / 64, every 4th streaming), each response 200,
     each completion its max_tokens long, usage.max_new_tokens the
     request's, each stream's deltas concatenating to its final text,
     fewer batches than requests;
     requests/s, p50 / p95 latency, the time to the first SSE delta,
     useful tok/s beside phase 20's; the bursts' launches (7 int8_gemm on
     3 quantize_rows and 1 quantize_silu_mul a prefill layer); then 4
     sequential requests, one streaming (the shim), to serve_vlm's
     VlaserChat backend (the fused runner, 256 tokens), launches held to
     the derived counts; then the fp32 gate: tiny_vlm behind the server,
     16 concurrent requests, 4 streaming, equal to EngineChat.chat_many on
     the same items token for token;
  37. eval_vlm's stages on the same model (phase 27's HF checkpoint is
     written later in the run; its load is phase 27's gate): 32 seeded
     text-only multiple-choice items (4 choices, questions of 40-300
     tokens) through the generic route (--batch 8, --max_new_tokens 16)
     with VlaserChat at 1 and 2 beams and --engine, and through
     RUNNERS["scienceqa"] (run_mc_benchmark): the JAX CLI's result keys,
     items/s, launches (accuracy on random weights means nothing).
The closed-loop evaluations (mock environments copied from the JAX
package's tests: SAPIEN, SimplerEnv and RoboTwin are not on the card's
machine):
  38. eval_simpler's stages on a seeded Vlaser-2B-VLA (bf16 N(0, 0.02^2)),
     --robot fractal (EDRSimplerAdapter over a statistics JSON the phase
     writes), act_steps 4: 4 mock episodes of 24 env steps (seeded frames at
     448 px and poses that do not depend on the actions) through EvalRunner
     on the plain server (--no-fused: the unquantized model's
     infer_action), then on the fused server (--fused over the same model
     quantized in place with quantize_for_serving(target="policy"), w8a8,
     before build_server, whose own weight-only int8 then leaves it as it
     is),
     then run_variant_aggregation over 2 variants with the
     BridgeSimplerAdapter; every control step's raw action chunk, fused
     against plain, within PARITY_TOL; the fused runs' launches held to the
     policy calls x phase 6's per-step counts (the plain run's: none); ms a
     control step (CUDA events, host included), env steps/s, success;
  39. deploy_robotwin's stages on a seeded ParallelDecodingVLA
     (train_robotwin's config stage: vlaser_2b at 224 px, select_layer -2,
     its vocabulary grown by the 12 RoboTwin markers and 512 <state_i> to
     152,198 words, the byte tokenizer inside it; fp32 parameters, bf16
     compute) behind PolicyHTTPServer on 127.0.0.1: 32 sequential /act
     requests and a burst of 8 concurrent ones with 224-px uint8 frames,
     every response 200 and bit-equal to the in-process policy_fn on the
     same input; the round trip's p50 / p95; the control step (median of
     10, CUDA events, host included); eval_policy over 4 mock episodes with
     one expert failure; launches held to none (at B 1 the JAX dispatch
     keeps attention and RMSNorm on the eager reference).
The RoboTwin parallel-decoding VLA's training (train_robotwin's recipe:
batch 8, fp32 parameters with bf16 compute, AdamW, the ViT frozen; 8
in-memory samples with _make_synthetic_episodes' fields at 224 px through
collate_robotwin, as the card's machine has no h5py):
  40. 4 steps on the auto route (the JAX dispatch: no kernel at 8 x 236
     LLM rows or 8 x 257 ViT rows; launches held to none); the step split
     and peak memory; then from the same init one step on the auto route
     and one with the flash and RMSNorm kernel routes forced: the forced
     step's loss within LOSS_REL and grad_norm within GNORM_REL of the auto
     step's, every gradient finite, the text padding rows' input gradients
     exactly 0 (the live rows' not), launches held to the derived counts
     (23 ViT and 28 LLM flash forwards and backwards, 57 RMSNorm forwards
     and backwards); a B 1 forward, forced against auto, within
     PARITY_TOL, its launches held; the forced step's checkpoint (~23 GB,
     under a temporary directory) restored into a fresh model and step bit
     for bit; flash forward and backward at the ViT (B 8 x 257, 16 x 64)
     and the LLM shape (B 8 x 236, 12 / 2 x 128, non-causal, the batch's
     text padding as segment 0) against the plain version with controls and
     timed beside SDPA under the same mask, and _rms_fwd / _rms_bwd at
     1,888 x 1,536.
The dense families beyond Vlaser-2B (no profiler session before them):
  41. Vlaser-8B chat (InternViT-300M + Qwen2.5-7B: 28 q / 4 kv heads x
     128, intermediate 18,944; scripts/train_sft.random_init_'s draws;
     quantize_for_serving defaults, vlm w8a8): VlaserChat's route must be
     the fused runner; 3 counted 13-tile chat calls (launches held to the
     derived counts; no RMSNorm kernel at hidden 3,584, as the JAX dispatch
     keeps), stage times, decode tok/s and peak memory; fused_int8_stack
     R 1 over 384 and 3,592 slots against its twin with controls, the
     layer's 7 GEMMs and quantizers at 384 and 3,584 rows (the 18,944-wide
     down projection input: quantize_rows and the silu-mul past 16,384
     values a row) with controls and torch._int_mm, the causal flash
     prefill at 28 / 4 heads with controls and SDPA; then bench.py's
     _bench_decode_8b on its draws (int8, 1 tile, a 320-token prompt, 32
     new tokens): vlm8b_decode_tok_per_sec, the teacher-forced parity gate
     and its 'ln1 ignored' control;
  43. InternVL3.5-2B (InternViT-300M + Qwen3-1.7B: per-head q/k RMSNorm,
     tied embeddings; random_init_'s draws, the q/k kernels x4, which only
     the norms undo; vlm w8a8): a 224 px frame through a 448 px-config
     ViT (the bicubically resized position embeddings) against the same
     function on the CPU in fp32, with a control; VlaserChat's route must
     be the plain generator and use_fused=True must raise; 3 counted
     13-tile chat calls (flash, _rms_fwd, both quantizers and the GEMM
     each launched, no fused stack); the 13-tile prefill's logits on the
     kernel route against every kernel off (control: the q/k norms
     dropped); EngineChat.chat_many over 4 items against the plain
     generator (equal, or apart first at a near-tie);
  42. the Vlaser-8B-VLA control step (vlaser_8b_vla, bench.py's draws):
     PolicyServer(fused=True) at batch 1 on the weight-only int8 tree (3
     counted steps, fused vs plain <= PARITY_TOL, ms a step),
     fused_int8_stack at R 5 / 4 on the 8B expert (768 -> 3,584 q, 5,600
     intermediate) against its twin with controls; the w8a8 tree: the
     PolicyServer at batch 1 and make_batched_infer_action at batch 8 (3
     counted calls each), bench.py's gates (fused vs plain, w8a8 vs bf16,
     fused-ViT K/V, batched vs plain), ms a step, peak memory; one b1 step
     under torch.profiler (idle share).
The native image loader and the Qwen3-MoE family (no profiler session
before them):
  44. the native loader on this machine: the toolchain (g++, jpeglib.h,
     libjpeg) and the build; the image-ops library against its float64
     numpy twin on the committed fixtures' stored pixels (resize to 448 x
     448, to the 4:3 fixture's 4 x 3 grid and to their own size; normalize;
     the tile crop; control: the pixels flipped), the 4:3 fixture's 13
     tiles, two runs bit-equal. Where libjpeg is present, also the fixture
     JPEGs decoded against their stored pixels (control: flipped),
     load_image_tiles_native's 13 tiles (two runs and 1 vs 4 threads
     bit-equal), NativeImageLoader over 64 jobs and
     ConversationDataset(use_native_loader=True) with PIL never imported;
     without it a line says that the JPEG half is not built. ms a 13-tile
     image and images/s;
  45. InternVL3.5-30B-A3B (InternViT-300M + Qwen3-30B-A3B: 48 layers,
     hidden 2,048, 32 / 4 heads x 128, 128 experts top-8 of 768, capacity
     factor 1.25; 30.85 G parameters) built on the card in bf16 from
     random_init_'s draws (the experts one layer slice at a time, the q/k
     kernels x4), quantize_for_serving defaults (vlm, w8a8; the router and
     experts stay bf16): VlaserChat on phase 44's 13 tiles (route: the
     plain generator), 3 counted chats of 8 tokens (launches held to the
     derived counts of flash, _rms_fwd, quantize_rows and int8_gemm; no
     silu-mul, no fused stack), a 32-token chat; the stage split, decode tok/s beside the
     every-expert and routed-expert bounds, the MoE layer's ms at the
     prefill's T and at T 1, peak memory. Gates: layer 0's MoE at the
     prefill's T against an fp32 slot-count oracle (MOE_REL; controls:
     renormalization dropped, capacity ignored, experts 0 and 1 swapped;
     dropped slots printed); the cached decode against one full forward
     over 32 teacher-forced tokens at capacity None (PREFILL_REL, greedy
     tokens apart only at near-ties) and at 1.25 (the first divergence
     printed); the 4 attention GEMMs and their quantizer, _rms_fwd and
     flash at the prefill's shapes with controls; EngineChat.chat_many over
     4 text items at fp32 compute, capacity None, equal to the plain
     generator.
The VLA's text head and ablations (random_init_'s draws):
  46. Vlaser-2B-VLA with use_lm_head (a 151,930-row bf16 head): infer_text
     (TEXT_NEW greedy tokens) and forward_vlm at B 1 and 8 over right-padded
     384-slot prompts (256 image slots), on the bf16 tree, then on the w8a8
     policy tree: the cached stream against teacher-forced forward_vlm
     (tokens apart only at near-ties, DECODE_REL; on the w8a8 tree, whose
     decode rows are weight-only and forward_vlm's w8a8, the stream is its
     own teacher-forced logits' argmax, those logits within W8A8_STREAM_REL
     of forward_vlm's, tokens apart only where the difference allows,
     controls at B 8); the w8a8 ViT's 4 GEMMs and their quantizer at B 1
     and 8 tiles' rows against the plain versions (gemm_phase); the forced
     kernel route against the dispatch route on the teacher-forced cached
     logits and forward_vlm (TEXT_ROUTE_REL; controls on the bf16 tree at
     B 8: causal dropped, padding segments ignored); 3 counted kernel-route infer_text
     calls on the w8a8 tree at each batch, launches held to the derived
     counts; prefill and per-token ms, tok/s, peak memory; flash at the
     B 8 prefill and one-row decode shapes against its plain version;
  47. Vlaser-2B-VLA with adaLN-Zero (time_hidden_size 256) and
     vision-in-expert, fp32 parameters, bf16 compute, remat: B 1
     infer_action against infer_action_naive (PARITY_TOL; controls: the
     suffix's adaLN condition dropped, the action positions not shifted
     past the expert image); one loss and
     backward whose gradients on the VLM-side tower and mlp1 are exactly 0;
     2 counted VLATrainer steps at B 32 (halved on out-of-memory, printed)
     with the derived counts, step ms, peak memory; the w8a8 serving tree
     (the gates' raw kernels int8): B 1 infer_action against the naive
     oracle (the same controls) and 3 counted calls, the expert's 7 GEMMs
     and its quantizers at its 257 prefix rows against the plain versions;
     flash at the joint B 32 x 645 and RMSNorm
     at the expert's rows against their plain versions (plain adaLN is held
     on the CPU only, tests/test_torch_vla_variants.py);
  48. InternViT-6B (45 layers x 3,200, 25 x 128; bf16): 13 tiles through
     the layer loop, 3 counted calls (flash by the dispatch rule), ms and
     TFLOP/s against the bf16 peak, peak memory; the flash route against
     the eager reference at B 1 and 13 (PREFILL_REL of the change;
     controls: attention scale dropped, attention dropped); flash at the 6B shape against its
     plain version;
  49. graft_entry.entry() once (actions [1, 4, 7], finite) and 100,000
     Beta(2, 3) flow times drawn on the card's generator (KS distance).
The data-generation pipelines (phases 50-52, right after 37 on its model
and tokenizer; seeded uint8 448 px frames, each one tile without PIL):
  50. generate_qa's stages on its default route (VlaserChat: the fused
     act_quant ViT and the fused decode stack at R 1): 4 frames, --kind
     general, 64 new tokens, launches held to the derived counts; then its
     --filter stage on the items written and on 4 parsed items of a file
     of their own (text-only scoring, launches derived); ms a frame, the
     ViT / prefill / decode stages each timed alone, items written / kept;
  51. generate_qa --engine --kind all: 8 frames x 3 kinds, 16 new tokens,
     through the shared-image function (one image prefill a frame) and the
     batched generate function (one a request), launches counted from 0:
     wall, frames/s, useful tok/s, the ViT tiles each route prefilled (the
     shared route at most one a frame), every request completed with a
     token; the share of responses token-equal between the routes;
  52. the MPO rollouts (sample_responses over EngineChat at temperature
     0.7, top_p 0.9: 4 items x 4 samples in one engine run; pairs built,
     written and read back by PreferenceDataset) and VisualPRM
     (build_process_supervision: 1 item x 2 solutions, 2 continuations a
     step, max_steps 3): generations/s and the counts.
  53. (last of all) utils/memory_budget at one device for the train
     recipes of 11 / 32-34, 26 and 47 beside the peaks they measured, and
     the 8B-VLA, 30B-A3B, 38B and 78B rows against the card's memory;
     gate: the Vlaser-2B-VLA budget's params_gib is the bytes of the fp32
     PiZeroVLA built on the card; then log_device_memory and profile_trace
     (host and device activity) around one small call, in this process
     and in a fresh one, whose trace must hold the call's device kernel.
Parallel layouts (run after 46-49; NCCL refuses two ranks on one card):
  54. ring attention's chunk route (kernels/ring_attention.virtual_ring: 4
      virtual context ranks in one process, each running exactly the
      flash calls of its 4 ring steps, forward and backward) at 16,384
      causal packed tokens, 12 / 2 heads x 128, bf16, contiguous and
      zigzag, against one whole-sequence flash call (a q_offset-0
      control must break it) and, at 2,048 tokens, the eager fp32 chunk
      twin; each rank's device ms against the one call; launches derived
      from the block pairs;
  55. SFTTrainer (phase 26's step) over (data 1, fsdp 1, tensor 1) and
      over a context axis of 1, VLATrainer (phase 11's) over (data 1,
      fsdp 1, tensor 1), a one-rank NCCL group: 2 steps each against the
      same trainer without a mesh from the same weights (loss and grad
      norm within SHARD_REL), launches derived, ms a step, peaks;
  56. a CPU check: graft_entry.dryrun_multichip(8) on 8 gloo ranks of the
      host (the gate's VLA and SFT lines on (data 2, fsdp 2, tensor 2),
      TP-serve, TP-engine, CP, PP, PPxFSDP-train, CPxFSDP-train and EP).
The tensor axis (run after 56; two processes share the card over a gloo
group on CUDA tensors; --tp-serve / --tp-train run one phase alone):
  57. serving: PolicyServer(mesh=) and ContinuousBatchingEngine(mesh=) at
      tensor 2 against one process (see tp_serve_phase);
  58. training: flash forward and backward at a tensor-2 rank's 6 / 1
      heads x 128 (2 packed causal rows of SFT_TOKENS) against the plain
      version with phase 9's controls, timed beside SDPA; phase 26's
      full-parameter Vlaser-2B SFT step on 2 packed rows, SFTTrainer in
      this process, then SFTTrainer(TrainConfig(mesh_tp=2)) in two: each
      step's loss and grad norm within MULTI_REL of one process's, with
      two controls that must break it (down_proj's all-reduce dropped;
      the vocab-parallel CE's sum of exp not all-reduced); rank 0's
      launches of its 2 steps held to phase 26's counts; ms a step (a
      gloo wall, not a speed figure) and each rank's peak beside
      utils/memory_budget.vlm_sft_budget(1, 1, 2).
The stage axis (run after 58; two processes share the card over a gloo
group on CUDA tensors, transfers staged through host memory; --pp-train
runs it alone at full depth):
  59. Vlaser-2B's LLM (Qwen2.5-1.5B, untied 151,674-word head; fp32
      parameters, bf16 compute, remat, AdamW) on 4 packed rows of
      SFT_TOKENS: the plain stack in this process, 2 steps, then
      train/pipeline.make_pipeline_lm_loss at stage 2 and 4 microbatches
      over a stageify_rules state in two processes: each step's loss and
      grad norm within MULTI_REL of one process's on both ranks, two
      controls that must break it (the backward's transfers zeroed;
      every microbatch given microbatch 0's segment ids); each rank's
      launches held to the derivation (_pp_want); ms a step (a gloo wall),
      time blocked in receives beside GPipe's bubble, peaks. The whole
      script runs it at PP_LAYERS of the 28 layers.
Every other profiler session records device activity only (host ops made
the trace's post-processing the bulk of the engine's profiled run).
Any failed phase raises (non-zero exit, no result line). The line before
the last lists every kernel; the last line is {"ok": true, "device": ...}.
"""

import argparse
import gc
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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


def _cut_depth(cfg, layers):
    """cfg at `layers` LLM layers (full width): a VLMConfig's LLM, or both
    mixtures of a VLAConfig; cfg itself for None. The script's time limit
    cuts the depth of some phases (their constants say which)."""
    import dataclasses

    if layers is None:
        return cfg
    if hasattr(cfg, "expert"):
        return dataclasses.replace(
            cfg, vlm=_cut_depth(cfg.vlm, layers),
            expert=dataclasses.replace(cfg.expert, num_layers=layers))
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_layers=layers))


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
    from vlaser_tpu_torch.kernels import (adam8bit, fused_decode, fused_vit,
                                          rmsnorm, w8a8)

    return {"fused_vit_stack": (fused_vit, "launch_count"),
            "fused_vit_stack_w8a8": (fused_vit, "act_quant_launch_count"),
            "fused_int8_stack": (fused_decode, "launch_count"),
            "quantize_rows": (w8a8, "quant_launch_count"),
            "quantize_silu_mul": (w8a8, "silu_quant_launch_count"),
            "int8_gemm": (w8a8, "gemm_launch_count"),
            "flash_attention_fwd": (fa, "fwd_launch_count"),
            "flash_attention_bwd": (fa, "bwd_launch_count"),
            "_rms_fwd": (rmsnorm, "fwd_launch_count"),
            "_rms_bwd": (rmsnorm, "bwd_launch_count"),
            "adamw8bit": (adam8bit, "launch_count")}


MAIN_SPLIT = {}  # fused_int8_stack's launches on the main paths, by rows
PEAKS = {}  # the train phases' peak device memory (GiB), batch and the GiB
#             earlier phases left allocated, by phase


def _count_split():
    """Add fused_int8_stack's launches by row count since the last
    _zero_counts() (a main path's) to MAIN_SPLIT."""
    from vlaser_tpu_torch.kernels import fused_decode

    for rows, n in fused_decode.rows_launch_count.items():
        MAIN_SPLIT[rows] = MAIN_SPLIT.get(rows, 0) + n


def _zero_counts():
    from vlaser_tpu_torch.kernels import fused_decode

    fused_decode.rows_launch_count.clear()
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
    counts, missed = {}, 0
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
            # a session that records no kernel at all missed the call (seen
            # in a whole run, the bf16 mode at R 5): the call is profiled
            # again, at most twice; any other count fails
            for _ in range(3):
                prof = _profile(torch, lambda: fused_decode.fused_int8_stack(
                    *args), "", tag, quiet=True)
                if prof["launches"]:
                    break
                missed += 1
            counts[mode, R] = (prof["launches"], sorted(prof["kernels"]))
    print(f"fused_int8_stack: kernel launches in one call under the profiler "
          f"(weight mode, rows): {counts}; sessions that recorded no kernel "
          f"and were taken again: {missed} {tag}", flush=True)
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


def denoise_stack_phase(torch, dev, model, rnd, tag, profile=True):
    """fused_int8_stack at the denoise rows (R = 1 + 4 over the prompt, R =
    4 over the prompt and the proprio token) on the VLA's expert weights
    with visible norms (rnd draws them) and K/V ~N(0, 2^2), against its
    twin with controls (_stack_gate: input unchanged, attention dropped,
    MLP dropped, rope dropped); timed beside the twin, with the kernel's
    phase trace and, with `profile`, one call's launches under the
    profiler. -> report (ms_r5 / ms_r4, bound at R = 4)."""
    from vlaser_tpu_torch.kernels import fused_decode, ops
    from vlaser_tpu_torch.policy.fused_infer import pack_expert_stack

    cfg = model.cfg
    ecfg, bf = cfg.expert, torch.bfloat16
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
        prof = ""
        if profile:
            p = _profile(torch, lambda: run(fused_decode.fused_int8_stack),
                         tag_r, tag, quiet=True)
            prof = (f"one call under the profiler: {p['launches']} kernel "
                    f"launch(es), device busy {p['busy']:.3f} ms, ")
        phases = _stack_phases(
            torch, lambda: run(fused_decode.fused_int8_stack), L, dev)
        print(f"fused_int8_stack R={rows} time: kernel {ms:.3f} ms, "
              f"plain twin {plain_ms:.3f} ms; {prof}grid "
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
    return dec


# -- serving: phases 1-3 ------------------------------------------------------
def serving_phases(torch, np, dev, cfg, tag, report):
    """-> launches of the server run."""
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.envs.adapters import BridgeSimplerAdapter
    from vlaser_tpu_torch.image.tiling import normalize_uint8
    from vlaser_tpu_torch.kernels import fused_vit
    from vlaser_tpu_torch.models.layers import init_normal_
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
        dec = denoise_stack_phase(torch, dev, model, rnd, tag)
        n_p, R = cfg.num_proprio_tokens, cfg.num_action_tokens
        S = cfg.max_image_text_tokens
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
    _count_split()
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


def gemm_phase(torch, sites, rows_list, dev, tag, silu_mul=True,
               quant_sites=QUANT_SITES):
    """K1 (quantize_rows) and K2 (int8_gemm) at one layer's 7 GEMM shapes
    (layer 0's int8 weights of `sites`) for each row count, against the
    plain versions, with controls; timed against the plain versions and
    torch._int_mm, each K1 call on inputs cycled through COLD_BYTES
    (_cold_ms). Each report's ms, plain_ms and bound_ms sum the 7 shapes
    (as in every run since the port began); K1's "main_path" sums the
    inputs the main path quantizes with it (`quant_sites`: a Qwen2 layer's
    3, an InternViT layer's 4). Then the layer's
    4-launch quantization and K3 (quantize_silu_mul, layer_quant_phase),
    unless `silu_mul` is False (a layer without a dense SiLU MLP: `sites`
    its GEMMs, K3 None). -> {rows: (K1, K2, K3 reports)}."""
    from vlaser_tpu_torch.kernels import w8a8

    g = torch.Generator(device=dev)
    g.manual_seed(6)
    out = {}
    for rows in rows_list:
        # sums over the 7 shapes; "by": bound ms per bounding resource
        k1 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "by": {}, "library_ms": None}
        main = {"inputs": sum(n in quant_sites for n, _ in sites),
                "ms": 0.0, "plain_ms": 0.0,
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
            if rows == rows_list[0] and name == sites[0][0]:
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
            if name in quant_sites:
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
        print(f"w8a8 one layer's {len(sites)} prefix GEMMs at {rows} rows: "
              f"quantize_rows {k1['ms']:.4f} ms at the {len(sites)} shapes "
              f"(bound "
              f"{k1['bound_ms']:.4f}; at the main path's {main['inputs']} inputs "
              f"{main['ms']:.4f}, bound {main['bound_ms']:.4f}), int8_gemm "
              f"{k2['ms']:.4f} ms (bound {k2['bound_ms']:.4f}, "
              f"{k2['bound_by']}), torch._int_mm {k2['library_ms']:.4f} ms "
              f"{tag}", flush=True)
        k3 = None
        if silu_mul:
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
    _count_split()
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
    from vlaser_tpu_torch.scripts.train_sft import random_init_
    from vlaser_tpu_torch.train.train_step import group_grad_norms
    from vlaser_tpu_torch.train.trainer import VLATrainConfig, VLATrainer

    B = 32
    t0 = time.perf_counter()
    left = torch.cuda.memory_allocated()  # by earlier phases
    model = PiZeroVLA(cfg, param_dtype=torch.float32,
                      compute_dtype=torch.bfloat16, device=dev, remat=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    random_init_(model, gen)
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
    report["train_peak_gib"] = peak
    PEAKS["11"] = (peak, B, left / 2**30)

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


# -- the VLA training recipe, 8-bit AdamW: phases 32-34 (after 11) ----------
VLA8_STEPS = 3
EVAL_ROWS = 8
EMA_DECAY = 0.999


def _adam8_leaves(model, opt):
    """The leaves the kernel is held on: the largest, one with a tail block,
    the patch conv (HWIO blocking) and one under MIN_8BIT_SIZE."""
    from vlaser_tpu_torch.train.optim8bit import MIN_8BIT_SIZE
    from vlaser_tpu_torch.utils.convert import is_patch_conv

    named = list(model.named_parameters())
    big = [(n, p) for n, p in named if p.numel() >= MIN_8BIT_SIZE]
    out = {"largest": max(big, key=lambda np_: np_[1].numel())}
    tails = [(n, p) for n, p in big if p.numel() % 256]
    if tails:
        out["tail"] = tails[0]
    out["patch conv"] = next((n, p) for n, p in big if is_patch_conv(n))
    out["small"] = next((n, p) for n, p in named
                        if p.numel() < MIN_8BIT_SIZE)
    return out


def _adam8_inputs(opt, p, b1_ulps=0):
    """(g, a clone of p and of its state in block order, the next update's
    constants) of one live leaf; b1 moved by b1_ulps fp32 ulps."""
    import numpy as np

    from vlaser_tpu_torch.train import optim8bit as o

    group = next(g for g in opt.param_groups
                 if any(q is p for q in g["params"]))
    st = opt.state[p]
    b1, b2 = group["betas"]
    h = o.hyper(b1, b2, group["eps"], group["weight_decay"], group["lr"],
                int(st["step"].item()) + 1)
    if b1_ulps:
        h = o.Hyper(**{**h.__dict__, "b1": float(np.nextafter(
            np.float32(h.b1), np.float32(1)))})
    g, flat = ((p.grad, p.detach()) if "m" in st else opt._leaf(p, p.grad))
    return g, flat.clone(), {k: v.clone() for k, v in st.items()}, h


def adam8_kernel_phase(torch, np, dev, trainer, tag):
    """Phase 32: the 8-bit step's kernel against its twin on a live
    trainer's state and gradients, leaf by leaf from cloned state: codes
    equal in every entry, scales and parameters bit for bit; control: b1
    one fp32 ulp up must differ. The small leaf's fp32 route on the card
    against the same on the host. -> the largest leaf's report."""
    from vlaser_tpu_torch.kernels import adam8bit
    from vlaser_tpu_torch.train import optim8bit as o

    opt, model = trainer.step_fn.optimizer, trainer.model
    keys = ("m_q", "m_scale", "v_q", "v_scale")
    rep = {}
    leaves = _adam8_leaves(model, opt)
    if "tail" not in leaves:
        print("adamw8bit: no leaf of >= 4,096 elements has a tail block "
              "(n % 256 != 0) in this model; the cuda tests hold tails",
              flush=True)
    for what, (name, p) in leaves.items():
        if what == "small":
            g, flat, st, h = _adam8_inputs(opt, p)
            host = [t.cpu() for t in (g, flat, st["m"], st["v"])]
            o.adam_fp32_update(g, flat, st["m"], st["v"], h)
            o.adam_fp32_update(*host, h)
            same = all(torch.equal(a.cpu(), b) for a, b in zip(
                (flat, st["m"], st["v"]), host[1:]))
            print(f"adamw8bit {what} leaf {name} {tuple(p.shape)}: the fp32 "
                  f"route on the card equals the host's bit for bit: {same} "
                  f"{tag}", flush=True)
            if not same:
                raise RuntimeError("the small-leaf fp32 Adam route differs")
            continue
        g, pk, sk, h = _adam8_inputs(opt, p)
        _, pt, stw, _ = _adam8_inputs(opt, p)
        adam8bit.adamw8bit(g, pk, *(sk[k] for k in keys), h)
        o.adam8bit_update_plain(g, pt, *(stw[k] for k in keys), h)
        torch.cuda.synchronize()
        diff = {k: int((sk[k] != stw[k]).sum()) for k in keys}
        diff["p"] = int((pk != pt).sum())
        err = (pk - pt).abs().max().item()
        _, pc, sc, hc = _adam8_inputs(opt, p, b1_ulps=1)
        adam8bit.adamw8bit(g, pc, *(sc[k] for k in keys), hc)
        ctrl = {k: int((sc[k] != stw[k]).sum()) for k in keys}
        ctrl["p"] = int((pc != pt).sum())
        n, nb = p.numel(), o.num_blocks(p.numel())
        print(f"adamw8bit {what} leaf {name} {tuple(p.shape)} ({n:,} "
              f"elements, {nb:,} blocks, tail {n % 256}): kernel vs twin "
              f"differing entries {diff}, max |dp| {err:.3e}; control (b1 "
              f"one ulp up) {ctrl} {tag}", flush=True)
        if any(diff.values()):
            raise RuntimeError(f"adamw8bit: kernel != twin on {name}")
        if not any(ctrl.values()):
            raise RuntimeError("adamw8bit control: b1 + 1 ulp showed no "
                               "difference")
        if what == "largest":
            nbytes = 3 * 4 * n + 2 * 2 * nb * 256 + 4 * 4 * nb
            bound = nbytes / PEAK_BYTES * 1e3
            ms = _kernel_ms(torch, lambda: adam8bit.adamw8bit(
                g, pk, *(sk[k] for k in keys), h), 10)
            plain = _ms(torch, lambda: o.adam8bit_update_plain(
                g, pt, *(stw[k] for k in keys), h), 2)
            rep = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
                   "shape": list(p.shape)}
            print(f"adamw8bit largest leaf: kernel {ms:.4f} ms "
                  f"({nbytes / ms / 1e6:.0f} GB/s), bound {bound:.4f} ms "
                  f"(bytes, {100 * bound / ms:.1f}% of it), twin {plain:.3f} "
                  f"ms {tag}", flush=True)
        del g, pk, sk, pt, stw, pc, sc
    return rep


def _step_bytes(model):
    """Bytes the step's kernel launches must move: each leaf of at least
    MIN_8BIT_SIZE elements reads g, p and its codes and scales and writes
    p, codes and scales (the small leaves' fp32 route, ~10 k elements, is
    not the kernel's)."""
    from vlaser_tpu_torch.train import optim8bit as o

    total = 0
    for p in model.parameters():
        n = p.numel()
        if n >= o.MIN_8BIT_SIZE:
            nb = o.num_blocks(n)
            total += 3 * 4 * n + 2 * 2 * nb * 256 + 4 * 4 * nb
    return total


def vla8bit_phases(torch, np, dev, cfg, tag, report, work):
    """Phases 32-34: the VLA recipe's 8-bit trainer at Vlaser-2B-VLA batch
    32 (the train_vla CLI's stages, --adam8bit, EMA 0.999 from step 0, a
    metrics log): 3 timed steps with derived launch counts, peak memory
    with and without the EMA, the checkpoint round trip, the kernel against
    its twin, the step split, evaluate, and the whole optimizer step against
    the twin and fused fp32 AdamW. -> launches of the 3 steps."""
    import importlib.util

    from vlaser_tpu_torch.kernels import adam8bit
    from vlaser_tpu_torch.policy.flow import sample_fm_time
    from vlaser_tpu_torch.scripts import train_vla as cli
    from vlaser_tpu_torch.train import optim8bit as o
    from vlaser_tpu_torch.train.model_averaging import (AveragingConfig,
                                                        ModelAveraging)
    from vlaser_tpu_torch.utils import checkpoint as ck

    print("train_vla's RLDS stream: not run on the card (tensorflow "
          f"installed: {importlib.util.find_spec('tensorflow') is not None}, "
          "tensorflow_datasets: "
          f"{importlib.util.find_spec('tensorflow_datasets') is not None}); "
          "the phases feed phase 11's seeded batch", flush=True)
    B = 32
    ckdir, mpath = os.path.join(work, "vla_ckpt"), os.path.join(
        work, "vla_metrics.jsonl")
    args = cli.build_parser().parse_args([
        "--model_path", "-", "--rlds_dir", "-", "--adam8bit",
        "--checkpoint_dir", ckdir])
    t0 = time.perf_counter()
    left = torch.cuda.memory_allocated()  # by earlier phases
    model = cli.build_model(args, cfg, dev)
    trainer = cli.build_trainer(
        args, model, averaging=AveragingConfig("ema", start=0,
                                               ema_decay=EMA_DECAY),
        metrics_path=mpath, log_every=1)
    opt = trainer.step_fn.optimizer
    batch = _train_batch(torch, np, dev, cfg, B)
    torch.cuda.synchronize()
    n_param = sum(p.numel() for p in model.parameters())
    big = [p for p in model.parameters() if p.numel() >= o.MIN_8BIT_SIZE]
    print(f"vla 8-bit trainer: {n_param:,} parameters in "
          f"{len(list(model.parameters()))} leaves, {len(big)} of >= "
          f"{o.MIN_8BIT_SIZE} elements ({sum(p.numel() for p in big):,}); "
          f"built in {time.perf_counter() - t0:.1f} s {tag}", flush=True)

    # -- phase 32: 3 timed steps, counters around them ----------------------
    marks, snap = [], {}  # (the end of a step, the start of the next)

    def fed():
        for i in range(VLA8_STEPS + 1):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            s = e
            if i == VLA8_STEPS - 1:  # the state after step VLA8_STEPS - 1
                snap.update(_train_state(torch, model, trainer.step_fn,
                                         None, host=True))
                s = torch.cuda.Event(enable_timing=True)
                s.record()
            marks.append((e, s))
            yield batch

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    m = trainer.train_steps(fed(), VLA8_STEPS)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counts().items() if v}
    peak_ema = torch.cuda.max_memory_allocated() / 2**30
    times = [marks[i][1].elapsed_time(marks[i + 1][0])
             for i in range(VLA8_STEPS)]
    with open(mpath) as f:
        logged = [json.loads(line) for line in f]
    n_vit, L = cfg.vlm.vision.num_layers, cfg.vlm.llm.num_layers
    want = {"flash_attention_fwd": VLA8_STEPS * 2 * (n_vit + L),
            "flash_attention_bwd": VLA8_STEPS * (n_vit + L),
            "_rms_fwd": VLA8_STEPS * (2 * 2 * L + 1),
            "_rms_bwd": VLA8_STEPS * (2 * L - 1),
            "adamw8bit": VLA8_STEPS * len(big)}
    print(f"vla 8-bit: {VLA8_STEPS} steps, losses "
          f"{[round(r['loss'], 6) for r in logged]}, grad norms "
          f"{[round(r['grad_norm'], 4) for r in logged]}, step ms "
          f"{[round(v, 3) for v in times]} (CUDA events; each with its EMA "
          f"update, the first the EMA's copy), peak device memory "
          f"{peak_ema:.2f} GiB with the EMA (phase 11's fp32 AdamW: "
          f"{report.get('train_peak_gib', float('nan')):.2f} GiB) {tag}",
          flush=True)
    print(f"vla 8-bit launches {launches} (derived {want})", flush=True)
    if [r["step"] for r in logged] != list(range(1, VLA8_STEPS + 1)):
        raise RuntimeError(f"metrics log steps {[r['step'] for r in logged]}")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in logged) or not math.isfinite(m["loss"].item()):
        raise RuntimeError("vla 8-bit step gave a non-finite loss or norm")
    if launches != want:
        raise RuntimeError(f"vla 8-bit launches {launches} != {want}")
    state_gb = sum(v.numel() * v.element_size() for st in opt.state.values()
                   for k, v in st.items() if k != "step") / 1e9
    ema_gb = sum(v.numel() * 4 for v in
                 trainer.averaging.avg_params.values()) / 1e9
    print(f"vla 8-bit memory: optimizer state {state_gb:.3f} GB (fp32 "
          f"AdamW's would be {8 * n_param / 1e9:.3f} GB), EMA {ema_gb:.3f} "
          f"GB {tag}", flush=True)

    # -- the checkpoint round trip --------------------------------------------
    s = time.perf_counter()
    path = trainer.save(VLA8_STEPS)
    save_s = time.perf_counter() - s
    gb = _dir_gb(path)
    live = _train_state(torch, model, trainer.step_fn, None)
    model2 = cli.build_model(args, cfg, dev, seed=1)
    trainer2 = cli.build_trainer(args, model2)
    s = time.perf_counter()
    ck.restore_checkpoint(ckdir, model2, trainer2.step_fn)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - s
    restored = _state_diff(torch, _train_state(torch, model2,
                                               trainer2.step_fn, None), live)
    earlier = _state_diff(torch, _train_state(torch, model2,
                                              trainer2.step_fn, None), snap)
    n_u8 = sum(1 for v in live.values() if torch.is_tensor(v)
               and v.dtype == torch.uint8)
    print(f"vla 8-bit checkpoint (step {VLA8_STEPS}): {gb:.3f} GB, saved in "
          f"{save_s:.1f} s, restored in {restore_s:.1f} s; {len(live)} "
          f"entries ({n_u8} uint8 code tensors), {len(restored)} differ "
          f"from the live trainer; control (the state after step "
          f"{VLA8_STEPS - 1}): {len(earlier)} differ {tag}", flush=True)
    if restored:
        raise RuntimeError(f"the restored checkpoint differs: {restored[:4]}")
    if not ("step" in earlier and any(k.startswith("param/") for k in earlier)
            and any(k.endswith("/m_q") for k in earlier)):
        raise RuntimeError(f"restore control: the state one step earlier "
                           f"differs only in {earlier[:4]}")
    del model2, trainer2, live, snap
    shutil.rmtree(ckdir)
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 33: the kernel against its twin, the step split -----------------
    report["adamw8bit"] = adam8_kernel_phase(torch, np, dev, trainer, tag)
    gc.collect()
    torch.cuda.empty_cache()
    t = sample_fm_time(trainer.generator, B, "beta", cfg.flow_alpha,
                       cfg.flow_beta, cfg.flow_t_max, device=dev)
    x0 = torch.randn((B, cfg.num_action_tokens, cfg.action_dim),
                     generator=trainer.generator, device=dev)
    args5 = [batch[k] for k in ("input_ids", "pixel_values", "text_mask",
                                "proprios", "actions")] + [t, x0]
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    model.zero_grad(set_to_none=True)
    evs[0].record()
    loss = model(*args5)
    evs[1].record()
    loss.backward()
    evs[2].record()
    opt.step()
    evs[3].record()
    trainer.averaging.update(1, trainer.params())
    evs[4].record()
    evs[4].synchronize()
    split = [evs[i].elapsed_time(evs[i + 1]) for i in range(4)]
    ema_bound = 3 * 4 * n_param / PEAK_BYTES * 1e3
    print(f"vla 8-bit step split (CUDA events): forward {split[0]:.3f} ms, "
          f"backward with remat {split[1]:.3f} ms, 8-bit AdamW "
          f"{split[2]:.3f} ms, EMA {split[3]:.3f} ms (bound {ema_bound:.3f} "
          f"ms: 12 B a parameter) {tag}", flush=True)
    del loss

    # -- phase 34: evaluate under the EMA --------------------------------------
    rows = {k: v[:EVAL_ROWS] for k, v in batch.items()}
    ev_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        s = time.perf_counter()
        out = trainer.evaluate(rows)
        ev_ms.append((time.perf_counter() - s) * 1e3)
    print(f"vla evaluate ({EVAL_ROWS} rows, {cfg.num_inference_steps} Euler "
          f"steps, EMA parameters): action accuracy "
          f"{[round(float(a), 4) for a in out['action_accuracy']]} at "
          f"{list(trainer.cfg.eval_thresholds)}, L1 {out['l1']:.5f}; ms "
          f"{[round(v, 1) for v in ev_ms]} (host clock, synchronized) {tag}",
          flush=True)
    if not (np.isfinite(out["action_accuracy"]).all()
            and math.isfinite(out["l1"])):
        raise RuntimeError("evaluate gave a non-finite metric")

    # -- the whole optimizer step: kernel, twin, fused fp32 AdamW --------------
    trainer.averaging = ModelAveraging(AveragingConfig())  # EMA freed
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_steps(iter([batch]), 1)
    torch.cuda.synchronize()
    peak_plain = torch.cuda.max_memory_allocated() / 2**30
    PEAKS["32-34"] = (peak_plain, B, left / 2**30)
    nbytes = _step_bytes(model)
    bound = nbytes / PEAK_BYTES * 1e3
    n0 = adam8bit.launch_count
    opt.step()
    per_step = adam8bit.launch_count - n0
    step_ms = _ms(torch, opt.step, 3)  # host included
    group = opt.param_groups[0]  # timing only: one group's constants
    h = o.hyper(*group["betas"], group["eps"], group["weight_decay"],
                group["lr"], 2)
    # every kernel launch of a step, its arguments made ahead (the patch
    # conv's flat OIHW view: the same bytes as its HWIO copy)
    leaves = [(p.grad.view(-1), p.detach().view(-1),
               *(opt.state[p][k] for k in ("m_q", "m_scale", "v_q",
                                           "v_scale"))) for p in big]
    kernel_ms = _kernel_ms(torch, lambda: [adam8bit.adamw8bit(*a, h)
                                           for a in leaves], 5)
    del leaves

    def twin_all():
        for p in big:
            g, flat = opt._leaf(p, p.grad)
            st = opt.state[p]
            o.adam8bit_update_plain(g, flat, st["m_q"], st["m_scale"],
                                    st["v_q"], st["v_scale"], h)

    plain_ms = _ms(torch, twin_all, 1, warmup=0)
    opt.state.clear()  # the 8-bit state goes; fp32 AdamW's comes
    gc.collect()
    torch.cuda.empty_cache()
    ref = torch.optim.AdamW(list(model.parameters()), lr=5e-5,
                            weight_decay=0.01, fused=True)
    fused_ms = _kernel_ms(torch, ref.step, 5)
    fused_bound = 7 * 4 * n_param / PEAK_BYTES * 1e3
    print(f"vla optimizer step over all {len(list(model.parameters()))} "
          f"leaves: the {per_step} kernel launches {kernel_ms:.3f} ms "
          f"(device; bound {bound:.3f} ms, bytes {nbytes / 1e9:.2f} GB, "
          f"{100 * bound / kernel_ms:.1f}% of it); AdamW8bit.step "
          f"{step_ms:.3f} ms (CUDA events, host included: the small leaves' "
          f"fp32 ops and the patch conv's HWIO copies); twin "
          f"{plain_ms:.1f} ms; another function for reference: "
          f"torch.optim.AdamW(fused=True) over fp32 moments {fused_ms:.3f} ms "
          f"(bound {fused_bound:.3f} ms, 28 B a parameter); peak memory "
          f"without the EMA {peak_plain:.2f} GiB, with it {peak_ema:.2f} GiB "
          f"{tag}", flush=True)
    report["adamw8bit"]["largest_leaf"] = {
        k: report["adamw8bit"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "shape")}
    report["adamw8bit"].update(ms=kernel_ms, plain_ms=plain_ms,
                               bound_ms=bound)
    report["adamw8bit"]["optimizer_step_ms"] = {"ms": step_ms}
    report["adamw8bit"]["fused_adamw_fp32_ms"] = {"ms": fused_ms,
                                                  "bound_ms": fused_bound}
    del ref, trainer, model, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
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


def _chat_model(torch, dev, cfg, seed, visible_norms=False,
                compute=None):
    """Vlaser-2B (or `cfg`) with bf16 weights N(0, 0.02^2) from a seeded
    generator, as bench.py draws them; with `visible_norms`, as
    scripts/train_sft.random_init_ draws them (norms 1 + N(0, 0.1^2), ViT
    layer scales ~0.1). Computes in `compute` (bf16 unless given). Float,
    not yet quantized."""
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.scripts.train_sft import random_init_

    model = InternVLChatModel(cfg, param_dtype=torch.bfloat16,
                              compute_dtype=compute or torch.bfloat16,
                              device=dev)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if visible_norms:
        return random_init_(model, gen)
    return init_normal_(model, gen, std=0.02)


def decode_kernel_phase(torch, model, dev, cache_lens, tag,
                        modes=("int8", "bf16"), profile=True):
    """Phase 12: fused_int8_stack in the decode configuration (R = 1, the
    model's LLM stack, fp32 rope tables) over caches of each length, in
    each weight mode of `modes`, against its twin with controls; timed,
    with the kernel's phase trace and, with `profile`, one call's launches
    and device time from the profiler."""
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
        if k[0] == "w" and "bf16" in modes:
            w, sname = stack[k], "s" + k[1:]
            stacks["bf16"][k] = (w.float() * stack[sname]).to(bf)
            stacks["bf16"][sname] = torch.ones_like(stack[sname])
    stacks = {m: stacks[m] for m in modes}
    out = {**{m: {} for m in modes}, "attention": {}}
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
            out[mode][E] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=None)
            prof = ""
            if profile:
                p = _profile(torch, lambda: run(
                    fused_decode.fused_int8_stack), what, tag, quiet=True)
                prof = (f"one call under the profiler: {p['launches']} "
                        f"kernel launch(es), device busy {p['busy']:.3f} "
                        f"ms; ")
                out[mode][E].update(launches_per_call=p["launches"],
                                    profiled_busy_ms=p["busy"])
            phases = _stack_phases(
                torch, lambda: run(fused_decode.fused_int8_stack), L, dev)
            out[mode][E]["phase_us"] = phases
            print(f"{what} time: kernel {ms:.3f} ms, plain twin "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                  f"{prof}us a layer by phase {phases} {tag}", flush=True)
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
    must launch 4 times a layer (q/k/v, o, gate/up, the silu-mul of down),
    counted by its wrappers, and the trace must show no eager silu kernel.
    The trace's own quantizer count is printed beside the wrappers' (a
    trace has dropped one launch of 112 on an H100)."""
    _zero_counts()
    keys = _profile(torch, prefill, f"{n}-row prefill", tag,
                    quiet=True)["launch_keys"]
    counts = _read_counts()
    nq = counts["quantize_rows"] + counts["quantize_silu_mul"]
    traced = sum(c for k, c in keys.items() if "w8a8::quantize" in k)
    ns = sum(c for k, c in keys.items() if "silu" in k.lower())
    print(f"profiled {n}-row prefill: {nq} quantizer launches ({nq / L:g} a "
          f"layer, {L} layers; the trace shows {traced}), {ns} eager silu "
          f"launches {tag}", flush=True)
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
    _count_split()
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


def decode_parity_phase(torch, dev, cfg, tag, new=DECODE_NEW):
    """Phase 16, bench.py's decode configuration: 1 tile, a 320-token prompt
    with 256 image tokens, 64 new tokens, quantize_for_serving(target="vlm",
    mode="int8"); the fused generator and the plain make_generate_fn on the
    same weights. Prints vlm_decode_tok_mismatches (bench.py's bound is 0),
    then holds the fused decoder to the plain one teacher-forced on the
    plain stream (DECODE_REL); a stack whose ln1 is ignored must break it.
    Where the two greedy streams first differ, the plain top-2 margin there
    (token 0: the plain prefill's logits; token t: teacher-forced step t - 1)
    must be within the bound: a near-tie, else the fused path is at fault.
    Times the fused generate (tok/s as bench.py counts it) and a step.
    `new`: the tokens to generate. -> tok/s, times, mismatches, the worst
    step's share of the bound."""
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.inference import fused_runner as fr
    from vlaser_tpu_torch.inference.kv_cache import KVCache
    from vlaser_tpu_torch.inference.sampling import make_generate_fn

    llm, L = cfg.llm, cfg.llm.num_layers
    model = quantize_for_serving(_chat_model(torch, dev, cfg, 14),
                                 target="vlm", mode="int8")
    N, NEW, img = DECODE_PROMPT, new, cfg.vision.image_size
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
    return dict(tok_s=1e3 * NEW / ms, generate_ms=ms, step_ms=step_ms,
                mismatches=mismatches, worst=worst)


# -- the continuous-batching engine: phases 20-22 ----------------------------
ENGINE_BUCKETS = (64, 128, 192, 256, 320)  # bench.py's _bench_engine
ENGINE_REPS = 1  # timed runs a path (after one warm-up run), median; cut
#                  from 3 to keep the whole script under 1,000 s
ENGINE_ORACLE_ROWS = 5  # requests the solo plain decode is run for (one of
#                         each prompt bucket, the 320-token one with its
#                         tile); cut from 16 for the same reason
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
    solo = reqs[:ENGINE_ORACLE_ROWS]
    want = {r.uid: oracle(r) for r in solo}
    print(f"engine: solo plain decodes of {len(solo)} of the 16 requests "
          f"done ({time.perf_counter() - t0:.0f} s into the phase) {tag}",
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
        bad, first, margin = _divergence(torch, np, model, solo, got, want)
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
              f"{1e3 * n_tok / ms:.1f} tok/s; {bad} of {len(solo)} rows "
              f"differ from the solo plain decode (bf16, informational)"
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

    t0 = time.perf_counter()
    model = quantize_for_serving(_chat_model(torch, dev, cfg, 1))
    engine = ContinuousBatchingEngine(model, prefill_buckets=ENGINE_BUCKETS,
                                      **ENGINE_KW)
    reqs = _engine_requests(np, cfg, Request)
    t1 = time.perf_counter()
    with torch.inference_mode():
        engine.run(reqs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        prof = _profile(torch, lambda: engine.run(reqs),
                        "engine run (16 requests)", tag)
    t3 = time.perf_counter()
    print(f"engine profile phase: build {t1 - t0:.1f} s, warm run "
          f"{t2 - t1:.1f} s, profiled run {prof['wall'] / 1e3:.1f} s, the "
          f"profiler's own work {t3 - t2 - prof['wall'] / 1e3:.1f} s {tag}",
          flush=True)
    report["engine"]["engine"]["profiled_busy_ms"] = prof["busy"]
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()


# -- the VLM's serving and evaluation entry points: phases 35-37 -------------
BEAM_TILES, BEAM_TEXT, BEAM_NEW = 13, 320, 64  # phase 35 at full width
BEAM_KS = (2, 4)
BEAM_BUCKET = 256  # VlaserChat's bucket
TINY_BEAM_NEW = 10  # the fp32 beam gate on tiny_vlm
SERVE_TEXT = ENGINE_BUCKETS  # phase 20's lengths: the messages' byte tokens
SERVE_MAX = (16, 32, 64)  # phase 20's max_new: the requests' max_tokens
SERVE_REQS, SERVE_STREAM_EVERY = 16, 4  # every 4th request streams
# the engine's slot budget: phase 20's 448 cannot hold a 320-token message
# behind the byte tokenizer's 237-token template plus 64 new tokens
SERVE_MAX_LEN = 640
SERVE_BURSTS = 1  # timed bursts, after one warm-up burst (2 until the
#                   data-generation phases needed the time)
SERVE_SEQUENTIAL = 4  # requests to the VlaserChat backend, one streaming
# 32 items (64 until the data-generation phases needed the time)
EVAL_ITEMS, EVAL_TEXT, EVAL_NEW, EVAL_BATCH = 32, (40, 300), 16, 8


class DecimalByteTokenizer:
    """The byte tokenizer of the port's CLIs (256 byte ids plus the 9
    InternVL tokens that ensure_special_tokens adds) for every prompt; its
    decode writes each id as its decimal, as bench.py's stub tokenizer does:
    a random 151,674-word model emits ids the byte tokenizer has no text for,
    and the server's SSE deltas, the gates on them and the token counts need
    every token to show in the text. EOS (the template's <|im_end|>) is not
    among its tokens: every completion runs to its budget."""

    def __init__(self):
        from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer
        from vlaser_tpu_torch.utils.tools import ensure_special_tokens

        self._tok = ByteTokenizer()
        ensure_special_tokens(self._tok)
        self.pad_token_id = self._tok.pad_token_id

    def __len__(self):
        return len(self._tok)

    def __call__(self, text, add_special_tokens=False, **kw):
        return self._tok(text)

    def convert_tokens_to_ids(self, tokens):
        return self._tok.convert_tokens_to_ids(tokens)

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _recording(torch, model, name, logs, fn):
    """Run fn() under inference_mode with model.prefill / decode_step
    recording, under logs[name], the logits each gives for the next token
    (the prompt's last row, then each step's row 0); -> fn's result."""
    rec = logs.setdefault(name, [])
    prefill, step = model.prefill, model.decode_step

    def rec_prefill(input_ids, pixel_values, seg_ids, cache, **kw):
        out = prefill(input_ids, pixel_values, seg_ids, cache, **kw)
        last = int((seg_ids[0] != 0).sum()) - 1
        rec.append(out[0][0, last].float().clone())
        return out

    def rec_step(token, cache, positions=None, seg_ids=None):
        out = step(token, cache, positions, seg_ids)
        rec.append(out[0][0, 0].float().clone())
        return out

    model.prefill, model.decode_step = rec_prefill, rec_step
    try:
        with torch.inference_mode():
            return fn()
    finally:
        del model.prefill, model.decode_step


def beam_greedy_gate(torch, model, ids, seg, tiles, eos, tag):
    """Phase 35's gate: make_beam_generate_fn with K = 1 against the plain
    make_generate_fn greedy decoder on the same prompt. Both run the same
    prefill and decode_step, so every logit row before the streams' first
    difference must be bit for bit equal; the tokens must be equal, unless
    they first differ where the greedy logits' top-2 margin is within the
    fp32 rounding of the beam's summed log-probabilities (a tie the two
    comparisons break apart)."""
    from vlaser_tpu_torch.inference.beam_search import make_beam_generate_fn
    from vlaser_tpu_torch.inference.sampling import make_generate_fn

    kw = dict(max_new_tokens=BEAM_NEW, eos_token_ids=eos,
              pad_token_id=model.cfg.pad_token_id)
    logs = {}
    g_tok, g_num = _recording(torch, model, "greedy", logs, lambda: (
        make_generate_fn(model, **kw)(ids, seg, tiles)))
    b_tok, b_num = _recording(torch, model, "beam", logs, lambda: (
        make_beam_generate_fn(model, num_beams=1, **kw)(ids, seg, tiles)))
    g, b = g_tok[0].tolist(), b_tok[0].tolist()
    first = next((i for i in range(BEAM_NEW) if g[i] != b[i]), None)
    upto = BEAM_NEW if first is None else first + 1
    same = [torch.equal(x, y) for x, y in zip(logs["greedy"][:upto],
                                              logs["beam"][:upto])]
    if not all(same):
        raise RuntimeError(f"beam K = 1: logits differ from greedy's at rows "
                           f"{[i for i, s in enumerate(same) if not s][:5]}")
    if first is None:
        if g_num.tolist() != b_num.tolist():
            raise RuntimeError(f"beam K = 1 lengths {b_num.tolist()} != "
                               f"greedy's {g_num.tolist()}")
        print(f"beam K = 1 vs greedy: {BEAM_NEW} tokens equal, the {upto} "
              f"logit rows bit for bit equal {tag}", flush=True)
        return
    lg = logs["greedy"][first]
    top = lg.topk(2).values
    margin = float(top[0] - top[1])
    score = sum(float(torch.log_softmax(logs["greedy"][i], -1)[g[i]])
                for i in range(first))
    bound = 4 * (abs(score) + 16) * 2.0 ** -23
    print(f"beam K = 1 vs greedy: equal through token {first}, logit rows "
          f"bit for bit equal through it; there the greedy top-2 margin is "
          f"{margin:.3g} against the rounding bound {bound:.3g} of the "
          f"summed log-probabilities {score:.2f} {tag}", flush=True)
    if margin > bound:
        raise RuntimeError(f"beam K = 1 differs from greedy at token {first} "
                           f"(margin {margin} > {bound})")


def beam_fp32_gate(torch, np, dev, tag):
    """Phase 35 at fp32: make_beam_generate_fn on tiny_vlm (phase 21's
    setup: fp32 compute and cache, seeded weights), K = 2 and 3, on the card
    against the port's own CPU run of the same weights and two text rows
    (the second right-padded): with an EOS the model never reaches (-1), and
    with one it emits mid-beam (the token at TINY_BEAM_NEW // 2 of the first
    row's unreachable-EOS beam, as test_golden_vs_reference.py picks it).
    Tokens and lengths must be equal."""
    from vlaser_tpu_torch.inference.beam_search import make_beam_generate_fn
    from vlaser_tpu_torch.models.vlm import InternVLChatModel

    card = _tiny_fp32_vlm(torch, dev, 35)
    host = InternVLChatModel(card.cfg, compute_dtype=torch.float32,
                             device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    host.requires_grad_(False)
    rng = np.random.default_rng(35)
    ids = rng.integers(5, 400, (2, 9))
    seg = np.ones((2, 9), np.int32)
    ids[1, 6:], seg[1, 6:] = 0, 0
    cases = []
    for K in (2, 3):
        def run(model, eos):
            gen = make_beam_generate_fn(
                model, max_new_tokens=TINY_BEAM_NEW, num_beams=K,
                eos_token_ids=[eos], pad_token_id=0,
                cache_dtype=torch.float32)
            d = model.device
            with torch.inference_mode():
                t, n = gen(torch.as_tensor(ids, device=d),
                           torch.as_tensor(seg, device=d), None)
            return t.cpu().tolist(), n.cpu().tolist()

        want = run(host, -1)
        for eos in (-1, want[0][0][TINY_BEAM_NEW // 2]):
            want = run(host, eos)
            got = run(card, eos)
            cases.append((K, eos, want[1], got == want))
    print(f"beam fp32 gate (tiny_vlm, card vs the host's run): (K, EOS, "
          f"lengths, equal) {cases} {tag}", flush=True)
    if not all(c[3] for c in cases):
        raise RuntimeError("beam search on the card differs from the host")
    if not any(min(c[2]) < TINY_BEAM_NEW for c in cases if c[1] != -1):
        raise RuntimeError("the mid-beam EOS case finished no hypothesis")
    del card, host


def beam_phase(torch, np, dev, model, tok, tag):
    """Phase 35: VlaserChat(num_beams=K) at full width (13 seeded tiles, a
    BEAM_TEXT-token message, BEAM_NEW new tokens, K in BEAM_KS), the K = 1
    gate, derived launch counts of one call of each K, the stage times and
    peak memory; then the fp32 gate. -> launches of the counted calls."""
    from vlaser_tpu_torch.image.tiling import normalize_uint8
    from vlaser_tpu_torch.inference import beam_search as bs
    from vlaser_tpu_torch.inference.chat import VlaserChat
    from vlaser_tpu_torch.inference.kv_cache import KVCache
    from vlaser_tpu_torch.tokenizer.conversation import build_chat_query

    t0 = time.perf_counter()
    cfg = model.cfg
    llm, vcfg = cfg.llm, cfg.vision
    L, Lv = llm.num_layers, vcfg.num_layers
    rng = np.random.default_rng(35)
    img = vcfg.image_size
    tiles = torch.from_numpy(normalize_uint8(rng.integers(
        0, 256, (BEAM_TILES, img, img, 3), dtype=np.uint8))).to(dev)
    question = _text(rng, BEAM_TEXT)
    chats = {K: VlaserChat(model, tok, max_new_tokens=BEAM_NEW, num_beams=K,
                           bucket=BEAM_BUCKET) for K in BEAM_KS}
    if any(c._fused_gen is not None for c in chats.values()):
        raise RuntimeError("a beam VlaserChat routed to the fused runner")
    chat = chats[BEAM_KS[0]]
    query = build_chat_query(cfg.template, "<image>\n" + question,
                             [BEAM_TILES], cfg.num_image_token)
    ids, seg = chat._encode([query])
    n, n_valid = ids.shape[1], int(seg.sum())
    beam_greedy_gate(torch, model, ids, seg, tiles, [chat.eos_token_id], tag)

    # derived from the code: the plain prefill runs the ViT layer by layer
    # (no fused stack): 4 w8a8 Dense a layer, each quantizing its own input,
    # its attention on flash at the 13-tile logits' size; the LLM prefill's
    # 7 w8a8 Dense a layer on 4 quantizations, its attention and its 2L + 1
    # norms on their kernels at the JAX dispatch's row thresholds. The
    # BEAM_NEW - 1 steps at K rows take none: weight-only Dense under 128
    # rows, reference attention and RMSNorm
    per_call = _add({"quantize_rows": 4 * Lv, "int8_gemm": 4 * Lv},
                    _prefill_want(llm, n, n + BEAM_NEW))
    if _uses_flash(BEAM_TILES, vcfg.seq_len, vcfg.num_heads):
        _add(per_call, {"flash_attention_fwd": Lv})
    launches, rows = {}, {}
    for K, c in chats.items():
        with torch.inference_mode():
            c.chat(question, tiles)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t1 = time.perf_counter()
            resp = c.chat(question, tiles)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
        got = {k: v for k, v in _read_counts().items() if v}
        _add(launches, got)
        rows[K] = dict(ms=ms, peak=torch.cuda.max_memory_allocated() / 2**30,
                       launches=got, resp=resp)
        if got != per_call:
            raise RuntimeError(f"beam K = {K} launches {got} != {per_call}")
        if len(resp.split()) != BEAM_NEW:  # no EOS among the byte tokens
            raise RuntimeError(f"beam K = {K} answered {len(resp.split())} "
                               f"tokens, not {BEAM_NEW}")
    # stage times: the prefill alone, the cache reorder at the largest K
    with torch.inference_mode():
        make = lambda b: KVCache.create(L, b, n + BEAM_NEW, llm.num_kv_heads,
                                        llm.head_dim, torch.bfloat16, dev)
        prefill_ms = _ms(torch, lambda: model.prefill(ids, tiles, seg,
                                                      make(1)), 2)
        K = BEAM_KS[-1]
        cache, spare = make(K), make(K)
        order = torch.arange(K, device=dev).flip(0)
        reorder_ms = _kernel_ms(torch, lambda: bs._reorder_cache(
            cache, order, spare), 10)
        nbytes = 2 * 2 * cache.k.numel() * cache.k.element_size()
        del cache, spare
    for K, r in rows.items():
        step = (r["ms"] - prefill_ms) / (BEAM_NEW - 1)
        print(f"beam search K = {K} (VlaserChat, {BEAM_TILES} tiles, prompt "
              f"{n_valid} tokens in a bucket of {n}, {BEAM_NEW} new): "
              f"{r['ms']:.1f} ms a call (host clock around synchronize), "
              f"{1e3 * BEAM_NEW / r['ms']:.1f} tok/s of the best beam, "
              f"~{step:.2f} ms a beam step ((call - prefill) / "
              f"{BEAM_NEW - 1}), peak {r['peak']:.2f} GiB; launches "
              f"{r['launches']} (derived {per_call}); answer "
              f"{r['resp'][:40]!r} {tag}", flush=True)
    print(f"beam stages: prefill {prefill_ms:.2f} ms ({n} rows, 13 tiles, "
          f"CUDA events); cache reorder at K = {K} {reorder_ms:.4f} ms "
          f"({nbytes / 1e9:.3f} GB read + written, bound "
          f"{nbytes / PEAK_BYTES * 1e3:.4f} ms) {tag}", flush=True)
    beam_fp32_gate(torch, np, dev, tag)
    print(f"phase 35 took {time.perf_counter() - t0:.1f} s {tag}", flush=True)
    return launches


def _prefill_want(llm, n, skv):
    """Launches of one batch-1 LLM prefill of n rows over a cache of skv
    slots: the w8a8 Dense at >= ACT_QUANT_MIN_ROWS rows, flash and RMSNorm
    at the JAX dispatch's thresholds (kernels/flash_attention.attention_fn,
    kernels/rmsnorm.rms_norm)."""
    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import rmsnorm
    from vlaser_tpu_torch.models.layers import ACT_QUANT_MIN_ROWS

    L, want = llm.num_layers, {}
    if n >= ACT_QUANT_MIN_ROWS:
        want.update(quantize_rows=3 * L, quantize_silu_mul=L,
                    int8_gemm=7 * L)
    if n >= fa.SQ_MIN or llm.num_heads * n * skv * 4 > fa.LOGITS_BYTES_MIN:
        want["flash_attention_fwd"] = L
    if n >= rmsnorm.MIN_ROWS and llm.hidden_size <= rmsnorm.MAX_HIDDEN:
        want["_rms_fwd"] = 2 * L + 1
    return want


def _post_chat(url, payload):
    """One /v1/chat/completions POST -> (status, body, seconds to the first
    SSE content delta or None, seconds to the end). A streamed body comes
    back as its list of deltas."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + "/v1/chat/completions", json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    first = None
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status = r.status
            if not payload.get("stream"):
                return status, json.loads(r.read()), None, \
                    time.perf_counter() - t0
            deltas = []
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                chunk = json.loads(line[len("data: "):])
                d = chunk["choices"][0]["delta"].get("content")
                if d:
                    if first is None:
                        first = time.perf_counter() - t0
                    deltas.append(d)
            return status, deltas, first, time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()[:300], None, time.perf_counter() - t0


def _burst(url, payloads):
    """POST every payload at once (one thread each, released together) ->
    (results in payload order, wall seconds)."""
    import threading

    out = [None] * len(payloads)
    gate = threading.Barrier(len(payloads) + 1)

    def fire(i):
        gate.wait()
        out[i] = _post_chat(url, payloads[i])

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    return out, time.perf_counter() - t0


def _serve_payloads(rng, n_text, max_tokens):
    """One message a request, of n_text[i] seeded bytes (byte tokens);
    every SERVE_STREAM_EVERY-th request streams."""
    return [{"messages": [{"role": "user", "content": _text(rng, t)}],
             "max_tokens": m, "stream": i % SERVE_STREAM_EVERY ==
             SERVE_STREAM_EVERY - 1}
            for i, (t, m) in enumerate(zip(n_text, max_tokens))]


def _served(chat):
    """Wrap chat.chat_many to keep each question's final text."""
    finals = {}
    many = chat.chat_many

    def recorded(items, on_token=None):
        texts = many(items, on_token=on_token)
        finals.update((it[0], t) for it, t in zip(items, texts))
        return texts

    chat.chat_many = recorded
    return finals


def _check_burst(results, payloads, finals, cap, what):
    """Every response 200; no completion longer than its max_tokens (every
    one runs to it: the byte tokenizer has no EOS), usage.max_new_tokens
    the request's; each stream's deltas concatenate to its final text.
    -> completions' tokens."""
    n_tok = 0
    for (status, body, _, _), p in zip(results, payloads):
        if status != 200:
            raise RuntimeError(f"{what}: HTTP {status}: {body}")
        want = min(p["max_tokens"], cap)
        final = finals[p["messages"][0]["content"]]
        if p["stream"]:
            text = "".join(body).strip()
            if text != final:
                raise RuntimeError(f"{what}: stream deltas {text[:60]!r} != "
                                   f"the final text {final[:60]!r}")
        else:
            text = body["choices"][0]["message"]["content"]
            if text != final or body["usage"]["max_new_tokens"] != want:
                raise RuntimeError(f"{what}: response {text[:40]!r} / usage "
                                   f"{body['usage']} for max_tokens {want}")
        if len(text.split()) != want:
            raise RuntimeError(f"{what}: {len(text.split())} tokens for "
                               f"max_tokens {want}")
        n_tok += want
    return n_tok


def serve_fp32_gate(torch, np, dev, tag):
    """Phase 36's gate: tiny_vlm at fp32 (compute and cache) behind
    ChatHTTPServer on EngineChat; 16 concurrent requests (4 streaming) must
    complete as EngineChat.chat_many does on the same items, token for
    token."""
    from vlaser_tpu_torch.serve.chat_server import ChatHTTPServer
    from vlaser_tpu_torch.serve.engine_chat import EngineChat

    tiny = _tiny_fp32_vlm(torch, dev, 36)
    tok = DecimalByteTokenizer()
    chat = EngineChat(tiny, tok, max_new_tokens=11, num_slots=4, max_len=320,
                      cache_dtype=torch.float32)
    rng = np.random.default_rng(36)
    payloads = _serve_payloads(
        rng, [int(rng.integers(8, 40)) for _ in range(SERVE_REQS)],
        [(4, 7, 11)[i % 3] for i in range(SERVE_REQS)])
    finals = _served(chat)
    srv = ChatHTTPServer(chat, host="127.0.0.1", port=0)
    srv.start_background()
    try:
        results, _ = _burst(f"http://127.0.0.1:{srv.port}", payloads)
        _check_burst(results, payloads, finals, 11, "fp32 server")
    finally:
        srv.shutdown()
    with torch.inference_mode():
        want = chat.chat_many([(p["messages"][0]["content"], None, None,
                                None, p["max_tokens"]) for p in payloads])
    got = ["".join(b).strip() if p["stream"] else
           b["choices"][0]["message"]["content"]
           for (_, b, _, _), p in zip(results, payloads)]
    bad = sum(g != w for g, w in zip(got, want))
    print(f"server fp32 gate (tiny_vlm, EngineChat, {SERVE_REQS} concurrent "
          f"requests, {SERVE_REQS // SERVE_STREAM_EVERY} streaming): {bad} "
          f"completions differ from chat_many's; {srv.batches_served} "
          f"batches {tag}", flush=True)
    if bad:
        raise RuntimeError(f"server fp32 gate: {bad} completions differ")
    del tiny, chat


def serve_phase(torch, np, dev, model, tok, tag, report):
    """Phase 36: serve_vlm's stages (--engine --host 127.0.0.1 --port 0, the
    CLI's defaults otherwise; max_len SERVE_MAX_LEN) and ChatHTTPServer at
    full width: a warm-up burst, then SERVE_BURSTS timed bursts of 16
    concurrent requests, launch counters around them; SERVE_SEQUENTIAL
    sequential requests to serve_vlm's VlaserChat backend; the fp32 gate.
    -> launches of the timed bursts and the sequential requests."""
    from vlaser_tpu_torch.scripts import serve_vlm
    from vlaser_tpu_torch.tokenizer.conversation import build_chat_query

    t0 = time.perf_counter()
    cfg = model.cfg
    overhead = len(tok(build_chat_query(cfg.template, "", [],
                                        cfg.num_image_token))["input_ids"])
    args = serve_vlm.build_parser().parse_args(
        ["--engine", "--host", "127.0.0.1", "--port", "0"])
    chat = serve_vlm.build_chat(args, model, tok, max_len=SERVE_MAX_LEN)
    finals = _served(chat)
    srv = serve_vlm.build_server(args, chat)
    srv.start_background()
    url = f"http://127.0.0.1:{srv.port}"
    rng = np.random.default_rng(36)
    n_text = [SERVE_TEXT[i % len(SERVE_TEXT)] for i in range(SERVE_REQS)]
    max_tok = [SERVE_MAX[i % len(SERVE_MAX)] for i in range(SERVE_REQS)]
    launches, runs = {}, []
    try:
        for b in range(SERVE_BURSTS + 1):
            payloads = _serve_payloads(rng, n_text, max_tok)
            before = srv.batches_served
            if b == 1:
                _zero_counts()
            results, wall = _burst(url, payloads)
            n_tok = _check_burst(results, payloads, finals,
                                 args.max_new_tokens, "server burst")
            batches = srv.batches_served - before
            if batches >= SERVE_REQS:
                raise RuntimeError(f"{batches} batches for {SERVE_REQS} "
                                   "requests: no cross-request batching")
            if b:
                runs.append((wall, n_tok, batches, results))
        got = {k: v for k, v in _read_counts().items() if v}
    finally:
        srv.shutdown()
    _add(launches, got)
    need = ("int8_gemm", "quantize_rows", "quantize_silu_mul")
    q = got.get("quantize_rows", 0)
    if not all(got.get(k) for k in need) or got["int8_gemm"] * 3 != 7 * q \
            or got["quantize_silu_mul"] * 3 != q:
        raise RuntimeError(f"server bursts' launches {got}: each admission "
                           "prefill layer takes 7 int8_gemm on 3 "
                           "quantize_rows and 1 quantize_silu_mul")
    engine_tok_s = report.get("engine", {}).get("engine", {}).get("tok_s")
    for i, (wall, n_tok, batches, results) in enumerate(runs):
        lat = sorted(r[3] for r in results)
        ttft = [r[2] for r in results if r[2] is not None]
        print(f"server burst {i + 1} (serve_vlm --engine, EngineChat 16 "
              f"slots, max_len {SERVE_MAX_LEN}; {SERVE_REQS} requests, "
              f"messages of {min(n_text)}-{max(n_text)} byte tokens behind "
              f"a {overhead}-token template, max_tokens {SERVE_MAX}, "
              f"{len(ttft)} streaming): {wall * 1e3:.1f} ms wall, "
              f"{SERVE_REQS / wall:.2f} requests/s, latency p50 "
              f"{statistics.median(lat) * 1e3:.1f} / p95 "
              f"{lat[int(0.95 * (len(lat) - 1))] * 1e3:.1f} ms, time to the "
              f"first SSE delta {[round(t * 1e3, 1) for t in ttft]} ms, "
              f"{n_tok} useful tokens -> {n_tok / wall:.1f} tok/s (phase "
              f"20's engine: "
              + (f"{engine_tok_s:.1f}" if engine_tok_s else "not run")
              + f" tok/s), {batches} batches {tag}", flush=True)
    print(f"server bursts' launches ({SERVE_BURSTS} bursts): {got} {tag}",
          flush=True)

    # the static backend: serve_vlm without --engine (VlaserChat, fused
    # runner on the card), sequential requests, one streaming (the shim)
    sargs = serve_vlm.build_parser().parse_args(
        ["--host", "127.0.0.1", "--port", "0"])
    static = serve_vlm.build_chat(sargs, model, tok)
    if static._fused_gen is None:
        raise RuntimeError("serve_vlm's VlaserChat did not take the fused "
                           "runner")
    srv = serve_vlm.build_server(sargs, static)
    srv.start_background()
    url = f"http://127.0.0.1:{srv.port}"
    texts = [_text(rng, 64 * (i + 1)) for i in range(SERVE_SEQUENTIAL - 1)]
    seq = [{"messages": [{"role": "user", "content": t}]} for t in texts]
    seq.append({"stream": True, **seq[0]})
    try:
        _post_chat(url, seq[0])  # warm-up
        _zero_counts()
        out = [_post_chat(url, p) for p in seq]
        got = {k: v for k, v in _read_counts().items() if v}
        _count_split()
    finally:
        srv.shutdown()
    _add(launches, got)
    if any(o[0] != 200 for o in out):
        raise RuntimeError(f"static server: {[o[:2] for o in out]}")
    shim = out[-1][1]
    if len(shim) != 1 or shim[0] != out[0][1]["choices"][0]["message"][
            "content"]:
        raise RuntimeError("the stream shim's one delta differs from the "
                           "same request's answer")
    # derived from the code: per request the fused runner's prefill of n
    # rows over an n + new cache (7 w8a8 Dense a layer on 4 quantizations at
    # >= ACT_QUANT_MIN_ROWS rows; attention and the 2L + 1 norms on their
    # kernels at the JAX dispatch's thresholds) and one fused stack a token
    # after the first
    new = sargs.max_new_tokens
    want = {"fused_int8_stack": SERVE_SEQUENTIAL * (new - 1)}
    for p in seq:
        n = static._encode([build_chat_query(
            cfg.template, p["messages"][0]["content"], [],
            cfg.num_image_token)])[0].shape[1]
        _add(want, _prefill_want(cfg.llm, n, n + new))
    if got != want:
        raise RuntimeError(f"static server launches {got}, want {want}")
    print(f"static server (serve_vlm, VlaserChat fused runner, "
          f"{new} new tokens): {SERVE_SEQUENTIAL} sequential requests "
          f"{[round(o[3] * 1e3, 1) for o in out]} ms, the last streamed "
          f"(one delta, equal to the first's answer); launches {got} "
          f"(derived {want}) {tag}",
          flush=True)
    del chat, static
    gc.collect()
    torch.cuda.empty_cache()
    serve_fp32_gate(torch, np, dev, tag)
    print(f"phase 36 took {time.perf_counter() - t0:.1f} s {tag}", flush=True)
    return launches


def _eval_items(np, root):
    """EVAL_ITEMS seeded text-only multiple-choice items: a question of
    EVAL_TEXT byte tokens, 4 choices, the answer letter. -> the path."""
    rng = np.random.default_rng(37)
    path = os.path.join(root, "mc.jsonl")
    with open(path, "w") as f:
        for _ in range(EVAL_ITEMS):
            n = int(rng.integers(EVAL_TEXT[0], EVAL_TEXT[1] + 1))
            f.write(json.dumps({
                "question": _text(rng, n).strip() + "?",
                "choices": [_text(rng, 12).strip() for _ in range(4)],
                "answer": "ABCD"[int(rng.integers(4))]}) + "\n")
    return path


def eval_phase(torch, np, dev, model, tok, tag, work):
    """Phase 37: eval_vlm's stages on the phases' seeded model (the HF
    checkpoint of phase 27 is written later in the run; its load is phase
    27's): the generic route (load_jsonl_benchmark -> evaluate_benchmark,
    --batch 8, --max_new_tokens EVAL_NEW) through VlaserChat with 1 and 2
    beams and --engine, and RUNNERS["scienceqa"] (run_mc_benchmark, the
    runner that takes text-only rows); each run's launches counted from 0.
    -> their launches."""
    import contextlib
    import io

    from vlaser_tpu_torch.scripts import eval_vlm

    t0 = time.perf_counter()
    path = _eval_items(np, work)
    base = ["--data", path, "--batch", str(EVAL_BATCH), "--max_new_tokens",
            str(EVAL_NEW)]
    variants = (("VlaserChat, 1 beam", ["--benchmark", "mcq"]),
                ("VlaserChat, 2 beams", ["--benchmark", "mcq", "--num_beams",
                                         "2"]),
                ("--engine", ["--benchmark", "mcq", "--engine"]),
                ("RUNNERS['scienceqa']", ["--benchmark", "scienceqa"]))
    keys = {"mcq": ["accuracy", "benchmark", "num_evaluated"],
            "scienceqa": ["accuracy", "benchmark", "num_evaluated"]}
    need = ("int8_gemm", "quantize_rows", "quantize_silu_mul")
    launches = {}
    for name, extra in variants:
        ap = eval_vlm.build_parser()
        args = ap.parse_args(base + extra)
        args.quantize = eval_vlm.quantize_mode(ap, args)
        chat = eval_vlm.build_chat(args, model, tok)
        _zero_counts()
        t1 = time.perf_counter()
        with torch.inference_mode():
            key, out = eval_vlm.run(args, chat)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        got = {k: v for k, v in _read_counts().items() if v}
        _add(launches, got)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            printed = eval_vlm.report(args, key, out)
        printed = {"benchmark": key, **printed}
        if sorted(printed) != keys[key] or out["num_evaluated"] != \
                EVAL_ITEMS or json.loads(buf.getvalue()) != printed:
            raise RuntimeError(f"eval_vlm {name}: results {printed}")
        lack = [k for k in need if not got.get(k)]
        if lack:
            raise RuntimeError(f"eval_vlm {name} never launched {lack}")
        print(f"eval_vlm {name}: {EVAL_ITEMS} items in {wall:.2f} s -> "
              f"{EVAL_ITEMS / wall:.1f} items/s; accuracy "
              f"{printed['accuracy']:.3f} (random weights: means nothing); "
              f"launches {got} {tag}", flush=True)
        del chat
    print(f"phase 37 took {time.perf_counter() - t0:.1f} s {tag}", flush=True)
    return launches


def vlm_entry_phases(torch, np, dev, cfg, tag, report):
    """Phases 35-37, then the data-generation phases 50-52, on one seeded
    Vlaser-2B (bf16 N(0, 0.02^2) through serve_vlm's config and quantize
    stages: w8a8) with the byte tokenizer. -> launches of their main
    paths."""
    from vlaser_tpu_torch.scripts import serve_vlm

    t0 = time.perf_counter()
    tok = DecimalByteTokenizer()
    args = serve_vlm.build_parser().parse_args([])
    cfg = serve_vlm.build_config(args, tok, cfg)
    model = serve_vlm.quantize(args, _chat_model(torch, dev, cfg, 14))
    torch.cuda.synchronize()
    print(f"entry-point model: Vlaser-2B ({cfg.llm.vocab_size} words, the "
          f"byte tokenizer's image tokens {cfg.img_context_token_id} / "
          f"{cfg.img_start_token_id} / {cfg.img_end_token_id}), w8a8, "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    launches = beam_phase(torch, np, dev, model, tok, tag)
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, serve_phase(torch, np, dev, model, tok, tag, report))
    work = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        _add(launches, eval_phase(torch, np, dev, model, tok, tag, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phases 35-37 took {time.perf_counter() - t0:.1f} s {tag}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, data_generation_phases(torch, np, dev, model, tok, tag))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- data generation: phases 50-52 (right after 37, on its model) -------------
QA_FRAMES, QA_NEW = 4, 64  # phase 50: generate_qa's default route
QA_FILTER_ITEMS = 4  # phase 50: parsed items the --filter stage scores
QA_ENGINE_FRAMES, QA_ENGINE_NEW = 8, 16  # phase 51: --engine --kind all
MPO_ITEMS, MPO_SAMPLES, ROLLOUT_NEW = 4, 4, 32  # phase 52: MPO rollouts
PRM_SOLUTIONS, PRM_MC, PRM_STEPS, PRM_NEW = 2, 2, 3, 16  # phase 52: VisualPRM


def _qa_frames(np, n, size, seed):
    """n seeded uint8 camera frames at the ViT's size, each with an
    instruction, as generate_qa's frame reader yields them."""
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (size, size, 3), dtype=np.uint8),
             "instruction": _text(rng, 40).strip()} for _ in range(n)]


def _qa_args(extra, root):
    from vlaser_tpu_torch.scripts import generate_qa

    return generate_qa.build_parser().parse_args(
        ["--episodes_dir", root, "--out", os.path.join(root, "qa.jsonl"),
         "--images_dir", os.path.join(root, "qa_images")] + extra)


def _no_empty(responses, what):
    empty = [i for i, r in enumerate(responses) if not r]
    if empty:
        raise RuntimeError(f"{what}: requests {empty} returned no token")


def _vit_prefills(engine):
    """Count the tiles of every engine prefill that carries an image (the
    ViT's input, an admission group's padding rows included) in
    engine.vit_tiles / vit_calls; -> a function that undoes it."""
    orig = engine._prefill
    engine.vit_tiles = engine.vit_calls = 0

    def counted(ids, seg, pixels, flags, true_lens):
        if pixels is not None:
            engine.vit_tiles += int(pixels.shape[0])
            engine.vit_calls += 1
        return orig(ids, seg, pixels, flags, true_lens)

    engine._prefill = counted
    return lambda: engine.__dict__.pop("_prefill")


def qa_default_phase(torch, np, dev, model, tok, tag, work):
    """Phase 50: generate_qa's stages on the default route (VlaserChat:
    the fused ViT stack and the fused decode stack at R 1) over QA_FRAMES
    seeded 448 px frames, --kind general, QA_NEW new tokens; then its
    --filter stage over the same backend: on the items written (random
    weights write no parseable QA) and on QA_FILTER_ITEMS parsed items of
    a file of their own (text-only scoring requests). Launches counted
    from 0 around each stage and held to the counts the code implies; ms a
    frame, the ViT / prefill / decode stages each timed alone.
    -> launches."""
    from vlaser_tpu_torch.data.qa_generation import (FILTER_PROMPT,
                                                     GENERAL_QA_PROMPT)
    from vlaser_tpu_torch.inference import fused_runner as fr
    from vlaser_tpu_torch.inference.kv_cache import KVCache
    from vlaser_tpu_torch.scripts import generate_qa
    from vlaser_tpu_torch.tokenizer.conversation import build_chat_query

    cfg = model.cfg
    llm, size, L = cfg.llm, cfg.vision.image_size, cfg.llm.num_layers
    args = _qa_args(["--kind", "general", "--filter"], work)
    chat = generate_qa.build_chat(args, model, tok, max_new_tokens=QA_NEW)
    if chat.route != "fused":
        raise RuntimeError(f"generate_qa's VlaserChat took {chat.route!r}")
    gen_fn = generate_qa.make_generate_fn(args, chat, cfg)
    if generate_qa.make_shared_image_fn(args, chat, cfg) is not None:
        raise RuntimeError("--kind general built a shared-image function")
    frames = _qa_frames(np, QA_FRAMES, size, 50)
    gen_fn(np.stack([frames[0]["image"]]), ["warm up"])  # warm-up
    torch.cuda.synchronize()

    def query(prompt, tiles):
        q = build_chat_query(cfg.template, ("<image>\n" if tiles else "")
                             + prompt, [1] if tiles else [],
                             cfg.num_image_token)
        return chat._encode([q])

    # derived from the code: a frame's chat is one fused act_quant ViT, the
    # fused runner's prefill of its bucket over a bucket + QA_NEW cache and
    # QA_NEW - 1 fused stack steps; a scoring request the same without ViT
    want = {}
    for f in frames:
        ids, _ = query(GENERAL_QA_PROMPT.format(
            instruction=f["instruction"]), True)
        n = ids.shape[1]
        _add(want, _add({"fused_vit_stack_w8a8": 1,
                         "fused_int8_stack": QA_NEW - 1},
                        _prefill_want(llm, n, n + QA_NEW)))
    seen = []

    def recording(images, prompts):
        out = gen_fn(images, prompts)
        seen.extend(out)
        return out

    _zero_counts()
    t1 = time.perf_counter()
    with torch.inference_mode():
        written = generate_qa.generate(args, recording, None, iter(frames))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    got = {k: v for k, v in _read_counts().items() if v}
    _count_split()
    _no_empty(seen, "generate_qa")
    if len(seen) != QA_FRAMES or got != want:
        raise RuntimeError(f"generate_qa: {len(seen)} responses, launches "
                           f"{got} (derived {want})")
    launches = dict(got)
    kept, total = generate_qa.filter_items(args, chat)
    # the --filter stage on parsed items: their own file, scored by the
    # same backend (text only)
    rng = np.random.default_rng(51)
    items = [{"id": i, "image": f"qa_{i:06d}.jpg", "width": size,
              "height": size, "conversations": [
                  {"from": "human", "value": "<image>\n" + _text(rng, 60)},
                  {"from": "gpt", "value": _text(rng, 160)}]}
             for i in range(QA_FILTER_ITEMS)]
    fargs = _qa_args(["--filter", "--out", os.path.join(work, "f.jsonl")],
                     work)
    with open(fargs.out, "w") as f:
        for it in items:
            f.write(json.dumps(it) + "\n")
    fwant = {}
    for it in items:
        ids, _ = query(FILTER_PROMPT.format(
            question=it["conversations"][0]["value"].replace("<image>\n", ""),
            answer=it["conversations"][1]["value"]), False)
        n = ids.shape[1]
        _add(fwant, _add({"fused_int8_stack": QA_NEW - 1},
                         _prefill_want(llm, n, n + QA_NEW)))
    _zero_counts()
    t1 = time.perf_counter()
    with torch.inference_mode():
        fkept, ftotal = generate_qa.filter_items(fargs, chat)
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t1
    fgot = {k: v for k, v in _read_counts().items() if v}
    _count_split()
    if ftotal != QA_FILTER_ITEMS or fgot != fwant:
        raise RuntimeError(f"--filter: {ftotal} items, launches {fgot} "
                           f"(derived {fwant})")
    _add(launches, fgot)

    # stage times, each alone (CUDA events around the call)
    f0 = frames[0]
    ids, seg = query(GENERAL_QA_PROMPT.format(
        instruction=f0["instruction"]), True)
    tiles = torch.from_numpy(generate_qa.frame_tiles(f0["image"],
                                                     size)).to(dev)
    n = ids.shape[1]
    with torch.inference_mode():
        vit_stack = fr.pack_vit_stack(model.vision_model)
        feats = fr.fused_visual_features(model, tiles, vit_stack)
        fresh = lambda: KVCache.create(L, 1, n + QA_NEW, llm.num_kv_heads,
                                       llm.head_dim, torch.bfloat16, dev)
        logits, _, cache = model.prefill(ids, None, seg, fresh(),
                                         visual_features=feats)
        token = logits[0, int(seg.sum()) - 1].argmax(-1)[None]
        del logits
        vit_ms = _ms(torch, lambda: fr.fused_visual_features(
            model, tiles, vit_stack), 5)
        prefill_ms = _ms(torch, lambda: model.prefill(
            ids, None, seg, fresh(), visual_features=feats), 3)
        step_ms = _ms(torch, lambda: fr.fused_decode_step(
            fr.pack_qwen2_stack(model.language_model),
            model.language_model.embed_tokens,
            fr.head_of(model.language_model), llm, token, cache,
            seg.sum(1)), 10)
    del cache, feats
    frame_ms = wall * 1e3 / QA_FRAMES
    print(f"generate_qa (VlaserChat, fused; --kind general, {QA_FRAMES} "
          f"frames of {size} px, prompts of {int(seg.sum())} tokens in a "
          f"bucket of {n}, {QA_NEW} new tokens): {wall:.2f} s, "
          f"{frame_ms:.1f} ms a frame, {QA_FRAMES * QA_NEW / wall:.1f} tok/s;"
          f" stages each alone (CUDA events): ViT {vit_ms:.3f} ms, prefill "
          f"{prefill_ms:.3f} ms, decode {step_ms:.3f} ms a token (sum "
          f"{vit_ms + prefill_ms + (QA_NEW - 1) * step_ms:.1f} ms a frame); "
          f"items written {written}, kept {kept}/{total} (random weights "
          f"write no parseable QA); launches {got} (derived) {tag}",
          flush=True)
    print(f"generate_qa --filter on {QA_FILTER_ITEMS} parsed items "
          f"(text-only scoring requests, {QA_NEW} new tokens): "
          f"{fwall * 1e3:.1f} ms, {fwall * 1e3 / ftotal:.1f} ms an item, "
          f"kept {fkept}/{ftotal}; launches {fgot} (derived) {tag}",
          flush=True)
    del chat
    return launches


def qa_engine_phase(torch, np, dev, model, tok, tag, work):
    """Phase 51: generate_qa --engine --kind all over QA_ENGINE_FRAMES
    seeded frames (3 kinds each), QA_ENGINE_NEW new tokens: once through
    the shared-image function (EngineChat.batch_chat_shared_image: one
    image prefill a frame, the kind-prompts against it), once through the
    plain batched generate function (batch_chat: one image prefill a
    request); the engine's image prefills counted (the ViT's tiles), each
    route's launches counted from 0. Fails when a request returns no token,
    a request is not completed, the shared route prefills more than one
    tile a frame, or a route never launches the w8a8 kernels (the plain
    route also flash: its admission groups' tiles). -> launches."""
    from vlaser_tpu_torch.data.qa_generation import PROMPTS
    from vlaser_tpu_torch.scripts import generate_qa

    cfg = model.cfg
    size = cfg.vision.image_size
    args = _qa_args(["--engine", "--kind", "all"], work)
    chat = generate_qa.build_chat(args, model, tok,
                                  max_new_tokens=QA_ENGINE_NEW)
    engine = chat.engine
    frames = _qa_frames(np, QA_ENGINE_FRAMES, size, 51)
    n_req = QA_ENGINE_FRAMES * len(PROMPTS)
    routes = {"shared image": generate_qa.make_shared_image_fn(args, chat,
                                                               cfg),
              "batched": None}
    if routes["shared image"] is None:
        raise RuntimeError("--engine --kind all built no shared-image "
                           "function")
    gen_fn = generate_qa.make_generate_fn(args, chat, cfg)
    # warm-up: one frame through each route
    routes["shared image"](["warm up", "warm up twice"], frames[0]["image"])
    gen_fn(np.stack([frames[0]["image"]] * 2), ["warm up", "again"])
    torch.cuda.synchronize()
    need = ("int8_gemm", "quantize_rows", "quantize_silu_mul")
    launches, answers = {}, {}
    for name, shared_fn in routes.items():
        seen, admitted = [], [0]

        def rec_gen(images, prompts):
            out = gen_fn(images, prompts)
            seen.extend(out)
            admitted[0] += engine.stats["admitted_rows"]
            return out

        def rec_shared(prompts, image):
            out = shared_fn(prompts, image)
            seen.extend(out)
            admitted[0] += engine.stats["admitted_rows"]
            return out

        undo = _vit_prefills(engine)
        _zero_counts()
        t1 = time.perf_counter()
        try:
            with torch.inference_mode():
                written = generate_qa.generate(
                    args, rec_gen, rec_shared if shared_fn else None,
                    iter(frames))
            torch.cuda.synchronize()
        finally:
            undo()
        wall = time.perf_counter() - t1
        got = {k: v for k, v in _read_counts().items() if v}
        _add(launches, got)
        answers[name] = list(seen)
        _no_empty(seen, f"generate_qa --engine ({name})")
        n_tok = sum(len(r.split()) for r in seen)
        lack = [k for k in need + (() if shared_fn else
                                   ("flash_attention_fwd",))
                if not got.get(k)]
        if len(seen) != n_req or admitted[0] != n_req or lack:
            raise RuntimeError(f"generate_qa --engine ({name}): "
                               f"{len(seen)} responses, {admitted[0]} "
                               f"admitted of {n_req}; never launched {lack}")
        if shared_fn and engine.vit_tiles > QA_ENGINE_FRAMES:
            raise RuntimeError(f"the shared-image route prefilled "
                               f"{engine.vit_tiles} tiles for "
                               f"{QA_ENGINE_FRAMES} frames")
        print(f"generate_qa --engine --kind all, {name} route "
              f"(EngineChat {engine.num_slots} slots; {QA_ENGINE_FRAMES} "
              f"frames x {len(PROMPTS)} kinds = {n_req} requests, "
              f"{QA_ENGINE_NEW} new tokens): {wall:.2f} s wall, "
              f"{QA_ENGINE_FRAMES / wall:.2f} frames/s, {n_tok} useful "
              f"tokens -> {n_tok / wall:.1f} tok/s; image prefills: "
              f"{engine.vit_tiles} tiles in {engine.vit_calls} prefill "
              f"calls; items written {written}; last run's schedule "
              f"{engine.stats}; launches {got} {tag}", flush=True)
    same = sum(a == b for a, b in zip(answers["shared image"],
                                      answers["batched"]))
    print(f"generate_qa --engine: {same}/{n_req} responses token-equal "
          f"between the two routes (bf16 near-ties may flip: "
          f"informational) {tag}", flush=True)
    del chat, engine
    return launches


class _Prefetched:
    """A pipeline's one-at-a-time callable, f(item, key) -> str, served
    from batched EngineChat.chat_many runs: the first call of a key runs
    `per_key` requests for it in one engine run, and each call pops one."""

    def __init__(self, chat, make_item, per_key):
        self.chat, self.make_item, self.per_key = chat, make_item, per_key
        self.store, self.requests = {}, 0

    def prefetch(self, pairs):
        """Run the requests of several (item, key) pairs in one batch."""
        pairs = [p for p in pairs if not self.store.get(repr(p[1]))]
        items = [self.make_item(it, k) for it, k in pairs
                 for _ in range(self.per_key)]
        out = self.chat.chat_many(items)
        _no_empty(out, "rollouts")
        self.requests += len(items)
        for j, (it, k) in enumerate(pairs):
            self.store[repr(k)] = out[j * self.per_key:(j + 1) * self.per_key]

    def __call__(self, item, key):
        if not self.store.get(repr(key)):
            self.prefetch([(item, key)])
        return self.store[repr(key)].pop()


def rollout_phase(torch, np, dev, model, tok, tag, work):
    """Phase 52: the MPO and VisualPRM data pipelines over EngineChat
    (generate_qa's --engine backend stage at temperature 0.7, top_p 0.9;
    each request seeded by its uid). MPO: sample_responses over MPO_ITEMS
    questions about seeded frames x MPO_SAMPLES samples (one engine run),
    build_items_based_on_correctness, build_pairs and write_pairs_jsonl,
    read back by PreferenceDataset; the first half of the items take their
    gold answer from their first sample (random weights answer nothing
    right otherwise), the rest one no sample gives. VisualPRM:
    build_process_supervision on 1 item x PRM_SOLUTIONS solutions,
    PRM_MC continuations a step prefix, max_steps PRM_STEPS, each prefix's
    continuations one engine run. Generations/s and the counts.
    -> launches."""
    from vlaser_tpu_torch.data import reasoning_pipeline as rp
    from vlaser_tpu_torch.data import visualprm_pipeline as prm
    from vlaser_tpu_torch.data.preference_dataset import (
        PreferenceDataset, PreferenceDatasetConfig)
    from vlaser_tpu_torch.scripts import generate_qa
    from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer
    from vlaser_tpu_torch.utils.tools import ensure_special_tokens

    cfg = model.cfg
    size = cfg.vision.image_size
    args = _qa_args(["--engine", "--temperature", "0.7", "--top_p", "0.9"],
                    work)
    chat = generate_qa.build_chat(args, model, tok,
                                  max_new_tokens=ROLLOUT_NEW)
    frames = _qa_frames(np, MPO_ITEMS, size, 52)
    tiles = [generate_qa.frame_tiles(f["image"], size) for f in frames]
    rng = np.random.default_rng(52)
    items = [{"question": f"{_text(rng, 80).strip()}?", "answer": "none",
              "frame": i} for i in range(MPO_ITEMS)]
    chat.chat_many([(items[0]["question"], tiles[0], None)])  # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t1 = time.perf_counter()
    rollouts = _Prefetched(chat, lambda it, k: (it["question"],
                                                tiles[it["frame"]], None),
                           1)
    with torch.inference_mode():
        rollouts.prefetch([(it, (it["frame"], k)) for it in items
                           for k in range(MPO_SAMPLES)])
        out = rp.sample_responses(
            items, lambda it, k: rollouts(it, (it["frame"], k)),
            num_samples=MPO_SAMPLES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    got = {k: v for k, v in _read_counts().items() if v}
    launches = dict(got)
    for r in out[: (MPO_ITEMS // 2) * MPO_SAMPLES: MPO_SAMPLES]:
        gold = rp.extract_final_answer(r["response"])
        for o in out:
            if o["frame"] == r["frame"]:
                o["answer"] = gold
    pos, neg, fmt = rp.build_items_based_on_correctness(out)
    pairs = rp.build_pairs(pos, neg)
    path = os.path.join(work, "pairs.jsonl")
    rp.write_pairs_jsonl(pairs, path)
    btok = ByteTokenizer()
    ensure_special_tokens(btok)
    ds = PreferenceDataset(PreferenceDatasetConfig(path), btok)
    if len(ds) != len(pairs) or not pairs or any(
            (ds[i]["chosen_labels"] == -100).all() for i in range(len(ds))):
        raise RuntimeError(f"MPO pairs: {len(pairs)} built, {len(ds)} read")
    distinct = len({o["response"] for o in out})
    print(f"MPO rollouts (EngineChat, temperature 0.7, top_p 0.9, "
          f"{ROLLOUT_NEW} new tokens): {MPO_ITEMS} items x {MPO_SAMPLES} "
          f"samples = {len(out)} generations in {wall:.2f} s -> "
          f"{len(out) / wall:.2f} generations/s ({distinct} distinct); "
          f"positive {sum(map(len, pos.values()))}, negative "
          f"{sum(map(len, neg.values()))}, no answer "
          f"{sum(map(len, fmt.values()))}; {len(pairs)} pairs written and "
          f"read back by PreferenceDataset; launches {got} {tag}",
          flush=True)

    # VisualPRM: 1 item, its solutions and step continuations batched
    item = {"question": items[0]["question"], "frame": 0,
            "answer": items[0]["answer"]}
    chat.max_new_tokens = PRM_NEW
    solutions = _Prefetched(chat, lambda it, k: (it["question"],
                                                 tiles[it["frame"]], None),
                            PRM_SOLUTIONS)
    conts = _Prefetched(chat, lambda it, prefix: (
        f"{it['question']}\n{prefix}", tiles[it["frame"]], None), PRM_MC)
    _zero_counts()
    t1 = time.perf_counter()
    with torch.inference_mode():
        rows = prm.build_process_supervision(
            [item], lambda it, k: solutions(it, ("solution",)), conts,
            num_return_sequences=PRM_SOLUTIONS, num_mc_sequences=PRM_MC,
            max_steps=PRM_STEPS)
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t1
    pgot = {k: v for k, v in _read_counts().items() if v}
    _add(launches, pgot)
    n_gen = solutions.requests + conts.requests
    convs = [prm.item_to_prm_conversation(r) for r in rows]
    convs += [prm.item_to_orm_conversation(r) for r in rows]
    prm.write_conversations_jsonl(convs, os.path.join(work, "prm.jsonl"))
    steps = [len(r["steps_with_score"]) for r in rows]
    if len(rows) != PRM_SOLUTIONS or not all(steps):
        raise RuntimeError(f"VisualPRM: {len(rows)} rows, steps {steps}")
    print(f"VisualPRM (EngineChat, {PRM_NEW} new tokens): 1 item x "
          f"{PRM_SOLUTIONS} solutions, {PRM_MC} continuations a step, "
          f"max_steps {PRM_STEPS}: steps {steps}, scores "
          f"{[[s['score'] for s in r['steps_with_score']] for r in rows]}; "
          f"{n_gen} generations in {pwall:.2f} s -> {n_gen / pwall:.2f} "
          f"generations/s; {len(convs)} PRM / ORM rows written; launches "
          f"{pgot} {tag}", flush=True)
    need = ("int8_gemm", "quantize_rows", "quantize_silu_mul")
    lack = [k for k in need if not got.get(k) or not pgot.get(k)]
    if lack:
        raise RuntimeError(f"rollouts never launched {lack}")
    del chat
    return launches


def data_generation_phases(torch, np, dev, model, tok, tag):
    """Phases 50-52 on phases 35-37's model and tokenizer. -> launches."""
    work = tempfile.mkdtemp(prefix="chip_smoke_qa_")
    launches = {}
    try:
        for n, fn in ((50, qa_default_phase), (51, qa_engine_phase),
                      (52, rollout_phase)):
            t = time.perf_counter()
            _add(launches, fn(torch, np, dev, model, tok, tag, work))
            gc.collect()
            torch.cuda.empty_cache()
            print(f"phase {n} took {time.perf_counter() - t:.1f} s {tag}",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# -- memory budget and monitoring: phase 53 (last of all) ---------------------
def budget_rows(config, ada_b=None):
    """Phase 53's one-device rows: (label, memory_budget function, its
    keywords, a VLAConfig for _vla_budget or None), for the train recipes
    the script runs and the larger families."""
    import dataclasses

    ada = dataclasses.replace(_cut_depth(config.vlaser_2b_vla(), ABLATION_LAYERS),
                              adaptive_mode="adaln_zero",
                              time_hidden_size=256, vision_in_expert=True)
    one = dict(dp=1, fsdp=1, tp=1)
    return [
        ("11 VLA b32, fp32 AdamW", "vla_train_budget",
         dict(one, per_device_batch=32), None),
        ("26 SFTTrainer, 2,048 tokens, frozen ViT", "vlm_sft_budget",
         dict(one, model_size="2b", seq_len=SFT_TOKENS,
              frozen_patterns=(r"vision_model/",)), None),
        ("47 adaLN-Zero + VIE", "vla_train_budget",
         dict(one, per_device_batch=ada_b or ADA_B), ada),
        ("8B-VLA", "vla_train_budget", dict(one, model_size="8b"), None),
        ("30B-A3B SFT", "vlm_sft_budget", dict(one, model_size="30b-a3b"),
         None),
        ("38B SFT", "vlm_sft_budget", dict(one, model_size="38b"), None),
        ("78B SFT", "vlm_sft_budget", dict(one, model_size="78b"), None),
    ]


def budget_phase(torch, dev, tag):
    """Phase 53: utils/memory_budget at the one-device mesh for the train
    recipes the script ran (11 and 32-34: the Vlaser-2B-VLA at B 32, whose
    budget counts fp32 AdamW moments; 26; 47) beside the peak each
    measured, and the 8B-VLA, 30B-A3B, 38B and 78B rows against the card's
    memory. Gate: the Vlaser-2B-VLA budget's params_gib equals the bytes
    of the port's fp32 PiZeroVLA built on the card. Then
    monitoring_probe (log_device_memory, profile_trace around one small
    call) in this process and in a fresh one, whose trace must hold the
    call's device kernel."""
    from vlaser_tpu_torch.core import config
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.utils import memory_budget as mb

    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    peaks = {"11": PEAKS.get("11"), "32-34": PEAKS.get("32-34"),
             "26": PEAKS.get("26"), "47": PEAKS.get("47")}
    ada_b = (peaks["47"] or (None, None, None))[1]
    rows = {}
    for label, fn, kw, vcfg in budget_rows(config, ada_b):
        t = time.perf_counter()
        r = (mb._vla_budget(vcfg, **kw) if vcfg is not None
             else getattr(mb, fn)(**kw))
        rows[label] = r
        phase = label.split()[0]
        measured = [f"phase {p} peak {peaks[p][0]:.2f} GiB at B "
                    f"{peaks[p][1]}, {peaks[p][2]:.2f} GiB of it left by "
                    f"earlier phases (budget - own peak "
                    f"{r['total_gib'] - peaks[p][0] + peaks[p][2]:+.2f} GiB)"
                    for p in ((phase, "32-34") if phase == "11" else (phase,))
                    if peaks.get(p)]
        fit = "fits" if r["total_gib"] <= total else "does not fit"
        print(f"memory budget {label} ({fn}, {kw}): {r['n_params']:,} "
              f"parameters; params {r['params_gib']:.2f}, grads "
              f"{r['grads_gib']:.2f}, moments {r['moments_gib']:.2f}, acts "
              f"{r['acts_gib']:.2f} -> total {r['total_gib']:.2f} GiB a "
              f"device ({fit} the card's {total:.2f} GiB; "
              f"{(time.perf_counter() - t) * 1e3:.0f} ms on the meta "
              f"device); " + ("; ".join(measured) or "no phase measures it")
              + f" {tag}", flush=True)
    # gate: the budget's parameter bytes are the model's on the card
    r = rows["11 VLA b32, fp32 AdamW"]
    before = torch.cuda.memory_allocated()
    model = PiZeroVLA(config.vlaser_2b_vla(), param_dtype=torch.float32,
                      compute_dtype=torch.bfloat16, device=dev)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    grew = torch.cuda.memory_allocated() - before
    print(f"memory budget gate: the fp32 Vlaser-2B-VLA on the card holds "
          f"{nbytes:,} bytes of parameters ({nbytes / 2**30:.6f} GiB; the "
          f"allocator grew {grew / 2**30:.6f} GiB), the budget's params_gib "
          f"{r['params_gib']:.6f} {tag}", flush=True)
    if nbytes / 2**30 != r["params_gib"]:
        raise RuntimeError(f"memory budget: params_gib {r['params_gib']} != "
                           f"{nbytes / 2**30} GiB on the card")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # monitoring: device memory, a timed call, a trace; in this process
    # (late in the run its session has recorded no device kernel, PERF.md)
    # and in a fresh one, which must record the call's kernel
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        here = monitoring_probe(os.path.join(trace_dir, "here"))
        out = subprocess.run(
            [sys.executable, "-c", "import json, chip_smoke; print(json.dumps("
             f"chip_smoke.monitoring_probe({os.path.join(trace_dir, 'new')!r}"
             ")))"], cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        if out.returncode:
            raise RuntimeError(f"monitoring probe: {out.stderr[-2000:]}")
        lines = out.stdout.strip().splitlines()
        print("\n".join(lines[:-1]), flush=True)  # its log lines
        fresh = json.loads(lines[-1])
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    for where, r in (("this process", here), ("a fresh process", fresh)):
        print(f"profile_trace in {where}: {r['files']} trace of "
              f"{r['bytes']:,} bytes, {r['events']} events, {r['kernels']} "
              f"device kernels {tag}", flush=True)
    if fresh["files"] != 1 or not fresh["kernels"]:
        raise RuntimeError("profile_trace in a fresh process wrote no "
                           "device kernel")


def monitoring_probe(trace_dir):
    """utils/monitoring on the card: log_device_memory, then profile_trace
    into trace_dir around one timed 1,024^2 matmul (log_execution_time).
    -> {"files", "bytes", "events", "kernels"} of the trace written."""
    import logging

    import torch

    from vlaser_tpu_torch.utils import monitoring

    log = logging.getLogger("vlaser_tpu_torch")
    handler = None if log.hasHandlers() else logging.StreamHandler(
        sys.stdout)
    if handler is not None:
        log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)
    try:
        monitoring.log_device_memory("phase 53")
        x = torch.randn(1024, 1024, device="cuda")

        @monitoring.log_execution_time()
        def small_call():
            y = x @ x
            torch.cuda.synchronize()
            return y

        with monitoring.profile_trace(trace_dir):
            small_call()
    finally:
        if handler is not None:
            log.removeHandler(handler)
        log.setLevel(level)
    files = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    return {"files": len(files),
            "bytes": sum(os.path.getsize(os.path.join(trace_dir, f))
                         for f in files),
            "events": len(events),
            "kernels": sum(e.get("cat") == "kernel" for e in events)}


# -- closed-loop evaluation: phases 38-39 (right after 37) ------------------
SIM_EPISODES, SIM_STEPS, SIM_ACT = 4, 24, 4  # episodes, env steps, act_steps
SIM_VARIANTS = 2
# a statistics JSON as a dataset's is laid out (bench.py's serving bounds)
SIM_STATS = {
    "action": {"p01": [-0.05] * 6 + [0.0], "p99": [0.05] * 6 + [1.0],
               "mean": [0.0] * 7, "std": [1.0] * 7},
    "proprio": {"p01": [-0.5] * 6 + [0.0], "p99": [0.5] * 6 + [1.0],
                "mean": [0.0] * 7, "std": [1.0] * 7}}
RT_REQUESTS, RT_BURST, RT_EPISODES = 32, 8, 4
RT_BATCH, RT_STEPS = 8, 4  # train_robotwin's --batch; auto-route steps
RT_FAIL_SEEDS = {5}  # seed % 7 of the one episode the scripted expert fails
# The RoboTwin models take random_init_'s draws (norms 1 + N(0, 0.1^2)),
# with the head's output layer scaled by this: the policy emits joint
# deltas, ~0.15 at most here instead of ~1.5. Measured on the CPU at full
# width (the kernels' plain twins): two correct bf16 routes through the
# 23 ViT and 28 LLM layers differ by ~5% of the actions (0.07 at |a| 1.5,
# 0.007 at 0.15), while the b1 gate's controls move them by 0.06-0.26 at
# 0.15; with N(0, 0.02^2) everywhere (bench.py's serving draws) the
# controls move them by <= 1.5e-3 and the gate would be blind.
RT_HEAD_SCALE = 0.1
RT_WORDS = ("beat", "the", "block", "with", "hammer", "place", "cup", "on",
            "mat", "lift", "pot", "handover", "mic", "stack", "bowls")


class MockSimplerEnv:
    """A gym-like stand-in for a SimplerEnv task (the JAX test's mock,
    tests/test_eval.py, at the policy's frame size): every episode's frames
    and end-effector poses come from its seed and not from the actions; an
    episode is truncated at `horizon` env steps and succeeds there when its
    seed is even."""

    class _Unwrapped:
        _seed = 0

        def seed(self, s):
            self._seed = s

        def get_language_instruction(self):
            return "pick coke can"

    def __init__(self, np, size, horizon):
        self.np, self.size, self.horizon = np, size, horizon
        self.unwrapped = self._Unwrapped()
        self.t, self.steps = 0, 0

    def reset(self, options=None):
        self.t = 0
        self.rng = self.np.random.default_rng(self.unwrapped._seed)
        return self._obs(), {}

    def _obs(self):
        np, rng = self.np, self.rng
        q = rng.standard_normal(4)
        eef = np.concatenate([rng.uniform(-0.3, 0.3, 3), q / np.linalg.norm(q),
                              rng.uniform(0, 1, 1)])
        return {"agent": {"eef_pos": eef},
                "frame": rng.integers(0, 256, (self.size, self.size, 3),
                                      dtype=np.uint8)}

    def step(self, action):
        if action.shape != (7,) or not self.np.isfinite(action).all():
            raise RuntimeError(f"bad env action {action}")
        self.t += 1
        self.steps += 1
        truncated = self.t >= self.horizon
        success = truncated and self.unwrapped._seed % 2 == 0
        return self._obs(), float(success), success, truncated, {
            "success": success}


class MockRoboTwinEnv:
    """The JAX test's RoboTwin mock (tests/test_eval.py) at the deploy
    policy's sizes: 224-px frames and 14 joints from the episode's seed,
    the scripted expert failing where seed % 7 is in `fail`, success after 3
    joint steps."""

    def __init__(self, np, size, fail):
        self.np, self.size, self.fail = np, size, set(fail)
        self.moved, self.calls = 0, 0

    def reset_with_seed(self, seed):
        self.seed, self.moved = seed, 0
        self.rng = self.np.random.default_rng(seed)

    def play_expert_once(self):
        return (self.seed % 7) not in self.fail

    def get_observation(self):
        self.calls += 1
        return {"image": self.rng.integers(0, 256, (self.size, self.size, 3),
                                           dtype=self.np.uint8),
                "qpos": self.rng.uniform(-1, 1, 14).astype(self.np.float32),
                "instruction": "beat the block with the hammer"}

    def step_qpos(self, q):
        if q.shape != (14,) or not self.np.isfinite(q).all():
            raise RuntimeError(f"bad joint target {q}")
        self.moved += 1

    def check_success(self):
        return self.moved >= 3


def robotwin_tokenizer(vocab_size, img_context_id):
    """The byte tokenizer of the port's CLIs inside Vlaser-2B's vocabulary:
    bytes keep ids 0-255, <IMG_CONTEXT> is the config's id, and the tokens
    train_robotwin's config stage adds take ids from `vocab_size` on, as
    they do in Vlaser-2B's own tokenizer (12 RoboTwin markers, then 512
    <state_i>: state_token_start 151,686 of 152,198 words)."""
    from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer
    from vlaser_tpu_torch.tokenizer.conversation import IMG_CONTEXT_TOKEN

    class Tok(ByteTokenizer):
        def __init__(self):
            super().__init__()
            self._specials[IMG_CONTEXT_TOKEN] = img_context_id
            self.added = 0

        def __len__(self):
            return vocab_size + self.added

        def add_tokens(self, tokens, special_tokens=True):
            n = 0
            for t in tokens:
                if t not in self._specials:
                    self._specials[t] = vocab_size + self.added
                    self.added += 1
                    n += 1
            return n

    return Tok()


def _rt_setup(torch, dev, vlm_cfg, seed):
    """The RoboTwin config, builder and a seeded model through
    train_robotwin's stages: vlaser_2b at 224 px, select_layer -2, the
    vocabulary grown as the JAX CLI grows it."""
    from vlaser_tpu_torch.scripts import train_robotwin

    args = train_robotwin.build_parser().parse_args(
        ["--batch", str(RT_BATCH), "--steps", str(RT_STEPS)])
    tok = robotwin_tokenizer(vlm_cfg.llm.vocab_size,
                             vlm_cfg.img_context_token_id)
    cfg, start = train_robotwin.build_config(args, tok, vlm_cfg)
    builder = train_robotwin.build_builder(cfg, tok, start)
    model = train_robotwin.build_model(args, cfg, dev, seed=seed)
    with torch.no_grad():  # joint-delta outputs: see RT_HEAD_SCALE
        model.action_head.fc2.kernel.mul_(RT_HEAD_SCALE)
        model.action_head.fc2.bias.mul_(RT_HEAD_SCALE)
    return args, tok, cfg, start, builder, model


def _rt_samples(np, n, size, chunk, seed):
    """In-memory samples with _make_synthetic_episodes' fields at `size`
    px (the card's machine has no h5py): uint8 frames, qpos and action
    chunks in [-1, 1], instructions of 2-9 words (text padding behind the
    short ones, the long ones cut at max_text_tokens)."""
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 255, (size, size, 3), np.uint8),
             "qpos": rng.uniform(-1, 1, 14).astype(np.float32),
             "actions": rng.uniform(-1, 1, (chunk, 14)).astype(np.float32),
             "instruction": " ".join(rng.choice(RT_WORDS,
                                                rng.integers(2, 10)))}
            for _ in range(n)]


def simpler_phase(torch, np, dev, cfg, tag, work):
    """Phase 38: eval_simpler's stages on a seeded Vlaser-2B-VLA (bf16
    N(0, 0.02^2)), --robot fractal: the plain server (--no-fused) and then
    the fused w8a8 server (the model quantized w8a8 before build_server,
    whose weight-only int8 of the JAX CLI then leaves it as it is) over the
    same SIM_EPISODES mock episodes, every
    control step's raw action chunk within PARITY_TOL of the other's; then
    run_variant_aggregation over SIM_VARIANTS variants with the Bridge
    adapter. -> launches of the fused runs, held to the policy calls x
    phase 6's per-step counts."""
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.eval.simpler_eval import (EvalConfig,
                                                    run_variant_aggregation)
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.scripts import eval_simpler

    t0 = time.perf_counter()
    stats = os.path.join(work, "dataset_statistics.json")
    with open(stats, "w") as f:
        json.dump(SIM_STATS, f)
    flags = ["--model_path", work, "--ckpt", os.path.join(work, "vla.pt"),
             "--stats", stats, "--episodes", str(SIM_EPISODES),
             "--act_steps", str(SIM_ACT)]
    parse = eval_simpler.build_parser().parse_args
    bf = torch.bfloat16
    model = PiZeroVLA(cfg, param_dtype=bf, compute_dtype=bf, device=dev)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(38)
    init_normal_(model, gen, std=0.02)
    proc = eval_simpler.build_processor(cfg, SmokeTokenizer(cfg.vlm))
    img = cfg.vlm.vision.image_size
    frame = lambda env, obs: obs["frame"]
    L = cfg.vlm.llm.num_layers
    per_call = {"fused_vit_stack_w8a8": 1,
                "fused_int8_stack": cfg.num_inference_steps,
                "quantize_rows": 3 * L, "quantize_silu_mul": L,
                "int8_gemm": 7 * L}
    runs = {}
    launches = {}
    for route in ("plain", "fused"):
        args = parse(flags + ["--robot", "fractal"]
                     + (["--no-fused"] if route == "plain" else []))
        adapter = eval_simpler.build_adapter(args, cfg)
        if route == "fused":  # w8a8, which build_server's int8 leaves as is
            quantize_for_serving(model, target="policy")
        server = eval_simpler.build_server(args, model, adapter, proc, dev)
        chunks, ms = [], []
        infer, step = server._infer, server.step

        def recording(*a, infer=infer, chunks=chunks):
            out = infer(*a)
            chunks.append(out[0].float())
            return out

        def timed(obs, image, step=step, ms=ms):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = step(obs, image)
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
            return out

        server._infer, server.step = recording, timed
        env = MockSimplerEnv(np, img, SIM_STEPS)
        torch.cuda.synchronize()
        _zero_counts()
        w0 = time.perf_counter()
        summary = eval_simpler.run(args, server, env=env, get_image=frame)
        wall = time.perf_counter() - w0
        agg = None
        if route == "fused":  # the sweep, on the Bridge adapter
            server.adapter = eval_simpler.build_adapter(
                parse(flags + ["--robot", "bridge"]), cfg)
            agg = run_variant_aggregation(
                EvalConfig(task=args.task, n_eval_episode=1,
                           act_steps=SIM_ACT),
                server, [{"lighting": i} for i in range(SIM_VARIANTS)],
                env_factory=lambda v: MockSimplerEnv(np, img, SIM_STEPS),
                get_image=frame)
        torch.cuda.synchronize()
        got = {k: v for k, v in _read_counts().items() if v}
        _count_split()
        calls = len(chunks)
        want = ({} if route == "plain" else
                {k: calls * v for k, v in per_call.items()})
        runs[route] = (summary, chunks)
        sweep = "" if agg is None else (
            f"; run_variant_aggregation (BridgeSimplerAdapter) over "
            f"{len(agg['per_variant'])} variants: success "
            f"{agg['variant_aggregation_success']}")
        print(f"eval_simpler {route} (--robot fractal, EDRSimplerAdapter): "
              f"{summary}; {calls} policy calls, control step "
              f"{statistics.median(ms):.2f} ms median ({min(ms):.2f}-"
              f"{max(ms):.2f}, CUDA events, host included), "
              f"{env.steps / wall:.1f} env steps/s over {env.steps} steps "
              f"({wall:.2f} s wall){sweep} {tag}", flush=True)
        _held(got, want, f"eval_simpler {route}")
        if route == "fused":
            launches = got
    (sp, cp), (sf, cf) = runs["plain"], runs["fused"]
    if sp != sf or sp["n_episodes"] != SIM_EPISODES:
        raise RuntimeError(f"eval_simpler: plain {sp} != fused {sf}")
    n = SIM_EPISODES * SIM_STEPS // SIM_ACT
    if len(cp) != n or len(cf) != n + SIM_VARIANTS * SIM_STEPS // SIM_ACT:
        raise RuntimeError(f"eval_simpler: {len(cp)} / {len(cf)} calls")
    errs = [float((a - b).abs().max()) for a, b in zip(cp, cf)]
    finite = all(bool(c.isfinite().all()) for c in cp + cf)
    print(f"eval_simpler parity: every control step's actions, fused (w8a8) "
          f"vs plain (bf16), max abs {max(errs):.3e} (bound {PARITY_TOL}), "
          f"all finite {finite}; phase 38 took "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    if not (finite and max(errs) <= PARITY_TOL):
        raise RuntimeError("eval_simpler: fused and plain actions disagree")
    del model, runs
    return launches


def _act_burst(url, jobs):
    """Concurrent act_request calls; -> [(action, seconds)] in order."""
    import threading

    from vlaser_tpu_torch.serve.deploy_server import act_request

    out, errs = [None] * len(jobs), []

    def run(i, img, text, qpos):
        try:
            t = time.perf_counter()
            a = act_request(url, img, text, qpos)
            out[i] = (a, time.perf_counter() - t)
        except Exception as e:  # raised below, after every thread ended
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, *j))
               for i, j in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise RuntimeError(f"/act burst failed: {errs[0]!r}")
    return out


def robotwin_deploy_phase(torch, np, dev, vlm_cfg, tag):
    """Phase 39: deploy_robotwin's stages at full width (a seeded model:
    no checkpoint in the repository) behind PolicyHTTPServer on 127.0.0.1:
    RT_REQUESTS sequential /act requests and a burst of RT_BURST, every
    action bit-equal to the in-process policy_fn on the same input; the
    control step's time; eval_policy over RT_EPISODES mock episodes with
    one expert failure. -> launches of the served path (none: at B 1 the
    JAX dispatch keeps attention and RMSNorm off the kernels)."""
    from vlaser_tpu_torch.eval.robotwin_eval import (RoboTwinEvalConfig,
                                                     eval_policy)
    from vlaser_tpu_torch.scripts import deploy_robotwin

    t0 = time.perf_counter()
    args, tok, cfg, start, builder, model = _rt_setup(torch, dev, vlm_cfg, 39)
    model.requires_grad_(False)
    dargs = deploy_robotwin.build_parser().parse_args(
        ["--host", "127.0.0.1", "--port", "0"])
    policy = deploy_robotwin.build_policy(model, builder, tok)
    policy_fn = deploy_robotwin.make_policy_fn(policy, cfg)
    srv = deploy_robotwin.build_server(dargs, policy_fn)
    img = cfg.vlm.vision.image_size
    spans = cfg.layout()
    torch.cuda.synchronize()
    print(f"robotwin deploy model: ParallelDecodingVLA, vlaser_2b at {img} px"
          f" (select_layer {cfg.vlm.select_layer}, {cfg.vlm.vision.seq_len} "
          f"ViT tokens), vocab {cfg.vlm.llm.vocab_size} (state_token_start "
          f"{start}), {spans['total'][1]} LLM tokens, fp32 params / bf16 "
          f"compute, {time.perf_counter() - t0:.1f} s {tag}", flush=True)
    rng = np.random.default_rng(39)
    jobs = [(rng.integers(0, 256, (img, img, 3), dtype=np.uint8),
             " ".join(rng.choice(RT_WORDS, rng.integers(2, 10))),
             rng.uniform(-1, 1, 14).astype(np.float32))
            for _ in range(RT_REQUESTS + RT_BURST)]
    srv.start_background()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        _act_burst(url, jobs[:1])  # a warm-up request
        torch.cuda.synchronize()
        _zero_counts()
        seq = []
        for job in jobs[:RT_REQUESTS]:
            seq.extend(_act_burst(url, [job]))
        b0 = time.perf_counter()
        burst = _act_burst(url, jobs[RT_REQUESTS:])
        burst_s = time.perf_counter() - b0
        torch.cuda.synchronize()
        got = {k: v for k, v in _read_counts().items() if v}
    finally:
        srv.shutdown()
    differ = sum(not np.array_equal(a, policy_fn(*job))
                 for (a, _), job in zip(seq + burst, jobs))
    rt = sorted(s * 1e3 for _, s in seq)
    pct = lambda q: rt[min(len(rt) - 1, int(q * len(rt)))]
    bad = [a.shape for a, _ in seq + burst
           if a.shape != (cfg.action_chunk, 14) or a.dtype != np.float32
           or not np.isfinite(a).all()]
    print(f"deploy_robotwin: {RT_REQUESTS} sequential /act (224-px uint8, "
          f"qpos, 2-9 words), round trip p50 {pct(0.5):.2f} / p95 "
          f"{pct(0.95):.2f} ms; a burst of {RT_BURST} in {burst_s * 1e3:.1f} "
          f"ms ({RT_BURST / burst_s:.1f} requests/s); every response 200, "
          f"{differ} of {len(jobs)} differ from the in-process policy_fn "
          f"(bit for bit) {tag}", flush=True)
    _held(got, {}, "deploy_robotwin /act")
    if bad or differ:
        raise RuntimeError(f"deploy_robotwin: {differ} actions differ, bad "
                           f"shapes {bad[:3]}")
    image, text, qpos = jobs[1]
    ms = []
    for _ in range(10):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        policy.get_actions(image, qpos, text)
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
    env = MockRoboTwinEnv(np, img, RT_FAIL_SEEDS)
    e0 = time.perf_counter()
    summary = eval_policy(RoboTwinEvalConfig(test_num=RT_EPISODES, step_lim=8,
                                             chunk_exec=8), env, policy)
    ep_s = time.perf_counter() - e0
    skipped = sum(bool(e.get("skipped")) for e in summary["episodes"])
    print(f"robotwin control step (RoboTwinPolicy.get_actions, B 1): "
          f"{statistics.median(ms):.2f} ms median of 10 ({min(ms):.2f}-"
          f"{max(ms):.2f}, CUDA events, host included); eval_policy over "
          f"{RT_EPISODES} mock episodes: evaluated {summary['evaluated']}, "
          f"skipped {skipped}, success rate {summary['success_rate']}, "
          f"{env.calls} forwards, {RT_EPISODES / ep_s:.2f} episodes/s; "
          f"phase 39 took {time.perf_counter() - t0:.1f} s {tag}", flush=True)
    if (summary["evaluated"] != RT_EPISODES - 1 or skipped != 1
            or summary["success_rate"] != 1.0):
        raise RuntimeError(f"eval_policy: {summary}")
    del model, policy, policy_fn
    return got


def closed_loop_phases(torch, np, dev, cfg_vla, cfg_vlm, tag):
    """Phases 38-39. -> launches of their main paths."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_sim_")
    try:
        launches = simpler_phase(torch, np, dev, cfg_vla, tag, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, robotwin_deploy_phase(torch, np, dev, cfg_vlm, tag))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phases 38-39 took {time.perf_counter() - t0:.1f} s {tag}",
          flush=True)
    return launches


# -- RoboTwin training: phase 40 (after 26) ---------------------------------
def _rt_want(cfg, B, grad=True):
    """A forced-route pass's launches: one flash forward per ViT layer run
    (select_layer -2 stops one early) and per LLM layer, the two norms of
    every LLM layer and the final norm (the ViT's are LayerNorms), and with
    a gradient one backward each (every norm's output reaches a slot, and
    the frozen ViT still takes gradients)."""
    v = cfg.vlm.vision
    n_vit = v.num_layers + cfg.vlm.select_layer + 1
    L = cfg.vlm.llm.num_layers
    vit_rms = n_vit * ((2 if v.qk_normalization else 0)
                       + (2 if v.norm_type != "layer_norm" else 0))
    fwd = {"flash_attention_fwd": n_vit + L, "_rms_fwd": 2 * L + 1 + vit_rms}
    if grad:
        fwd.update(flash_attention_bwd=n_vit + L, _rms_bwd=2 * L + 1 + vit_rms)
    return fwd


def _rt_grad_norm(torch, model):
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad.float())
         for p in model.parameters() if p.grad is not None])).item()


def robotwin_train_phase(torch, np, dev, vlm_cfg, tag, report, work):
    """Phase 40: train_robotwin's recipe at full width (batch RT_BATCH, fp32
    parameters with bf16 compute, AdamW, the ViT frozen) on in-memory
    samples through collate_robotwin: RT_STEPS steps on the auto route
    (the JAX dispatch: no kernel at these shapes), then from the same init
    one step with the flash and RMSNorm kernel routes forced, held to the
    auto route (step-1 loss LOSS_REL, grad_norm GNORM_REL, every gradient
    finite, the text padding rows' input gradients exactly 0) and to the
    derived launch counts, and a forced B 1 forward against the auto one
    (PARITY_TOL); the flash kernels at the two shapes against SDPA; the
    step split and peak memory; a 1-step checkpoint restored bit for bit.
    -> launches of the forced-route passes."""
    from vlaser_tpu_torch.scripts import train_robotwin
    from vlaser_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)

    t0 = time.perf_counter()
    args, tok, cfg, start, builder, model = _rt_setup(torch, dev, vlm_cfg, 40)
    img = cfg.vlm.vision.image_size
    samples = _rt_samples(np, RT_BATCH, img, cfg.action_chunk, 40)
    nb = next(train_robotwin.make_batches(samples, RT_BATCH, builder, tok))
    batch = train_robotwin.to_device(nb, dev)
    s, e = cfg.layout()["text"]
    pad = nb["text_mask"][:, s:e] == 0
    init = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    n_param = sum(p.numel() for p in model.parameters())
    print(f"robotwin train model: {n_param / 1e9:.3f} G parameters (fp32), "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device; batch "
          f"{RT_BATCH} x {nb['input_ids'].shape[1]} tokens, text padding "
          f"rows {int(pad.sum())} of {pad.size}; "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)

    # -- the auto route: train_robotwin's step, RT_STEPS steps ---------------
    step = train_robotwin.build_step(args, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    ms, losses, gnorms = _timed_steps(torch, step, batch, RT_STEPS)
    torch.cuda.synchronize()
    _held({k: v for k, v in _read_counts().items() if v}, {},
          "train_robotwin auto route")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train_robotwin, auto route: {RT_STEPS} steps, losses "
          f"{[round(v, 6) for v in losses]}, grad norms "
          f"{[round(v, 4) for v in gnorms]}, step ms "
          f"{[round(v, 2) for v in ms]} (CUDA events, host included), peak "
          f"{peak:.2f} GiB {tag}", flush=True)
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise RuntimeError("train_robotwin: a non-finite loss or norm")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    model.zero_grad(set_to_none=True)
    ev[0].record()
    loss = model.loss(batch["input_ids"], batch["pixel_values"],
                      batch["text_mask"], batch["actions"])
    ev[1].record()
    loss.backward()
    ev[2].record()
    step.optimizer.step()
    ev[3].record()
    ev[3].synchronize()
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    print(f"train_robotwin step split (CUDA events): forward {split[0]:.2f} "
          f"ms, backward {split[1]:.2f} ms (the frozen ViT's included), "
          f"AdamW {split[2]:.2f} ms {tag}", flush=True)
    del loss, step
    model.zero_grad(set_to_none=True)
    gc.collect()

    # -- the forced kernel routes, from the same init ------------------------
    grab = {}

    def keep(mod, a, out):
        out.retain_grad()
        grab["emb"] = out

    gate = {}
    launches = {}
    for impl in ("auto", "kernel"):
        with torch.no_grad():
            model.load_state_dict(init)
        model.set_impl(impl, impl)
        step = train_robotwin.build_step(args, model)
        hook = model.embed_tokens.register_forward_hook(keep)
        torch.cuda.synchronize()
        _zero_counts()
        m = step(batch)
        torch.cuda.synchronize()
        hook.remove()
        got = {k: v for k, v in _read_counts().items() if v}
        g = grab.pop("emb").grad
        finite = all(bool(p.grad.isfinite().all()) for p in model.parameters()
                     if p.grad is not None) and bool(g.isfinite().all())
        pad_max = float(g[:, s:e][torch.from_numpy(pad).to(dev)].abs().max())
        live_max = float(g[:, s:e][~torch.from_numpy(pad).to(dev)].abs().max())
        gate[impl] = (m["loss"].item(), m["grad_norm"].item())
        print(f"train_robotwin step 1, {impl} route: loss {gate[impl][0]:.6f}, "
              f"grad_norm {gate[impl][1]:.4f}, every gradient finite "
              f"{finite}, text padding rows' input gradient max "
              f"{pad_max} (live text rows {live_max:.3e}) {tag}", flush=True)
        _held(got, {} if impl == "auto" else _rt_want(cfg, RT_BATCH),
              f"train_robotwin {impl} route, one step")
        if not finite or pad_max != 0.0 or live_max == 0.0:
            raise RuntimeError(f"train_robotwin {impl} route: non-finite or "
                               "leaking padding gradients")
        if impl == "kernel":
            launches = got
            ck = os.path.join(work, "robotwin")
            w0 = time.perf_counter()
            save_checkpoint(ck, 1, model, step)
            save_s = time.perf_counter() - w0
            live = _train_state(torch, model, step, None)
        del step, m, g
        model.zero_grad(set_to_none=True)
        gc.collect()
    (la, na), (lk, nk) = gate["auto"], gate["kernel"]
    loss_rel, norm_rel = abs(lk - la) / abs(la), abs(nk - na) / na
    print(f"train_robotwin gate, kernel vs auto route: loss rel diff "
          f"{loss_rel:.3e} (bound {LOSS_REL}), grad_norm rel diff "
          f"{norm_rel:.3e} (bound {GNORM_REL}) {tag}", flush=True)
    if not (loss_rel <= LOSS_REL and norm_rel <= GNORM_REL):
        raise RuntimeError("train_robotwin: kernel route disagrees")

    # -- B 1, no gradient: forced against auto, on the most padded row -------
    row = int(pad.sum(1).argmax())
    b1 = {k: v[row:row + 1] for k, v in batch.items()}
    fwd = lambda mask: model(b1["input_ids"], b1["pixel_values"], mask)
    outs = {}
    for impl in ("auto", "kernel"):
        model.set_impl(impl, impl)
        torch.cuda.synchronize()
        _zero_counts()
        with torch.no_grad():
            outs[impl] = fwd(b1["text_mask"])
        torch.cuda.synchronize()
        got = {k: v for k, v in _read_counts().items() if v}
        _held(got, {} if impl == "auto" else _rt_want(cfg, 1, grad=False),
              f"robotwin B 1 forward, {impl} route")
        if impl == "kernel":
            _add(launches, got)
    dropped = b1["text_mask"].clone()
    dropped[:, s:e] = 0
    with torch.no_grad():  # controls on the kernel route: must break it
        ctl = {"padding attended": fwd(torch.ones_like(dropped)),
               "text dropped": fwd(dropped)}
    model.set_impl("auto")
    err = float((outs["kernel"] - outs["auto"]).abs().max())
    ctl = {k: float((v - outs["auto"]).abs().max()) for k, v in ctl.items()}
    print(f"robotwin B 1 actions (row {row}, {int(pad[row].sum())} padded "
          f"text rows), kernel vs auto route: max abs {err:.3e} (bound "
          f"{PARITY_TOL}), |a| max {float(outs['auto'].abs().max()):.3f}; "
          f"controls { {k: f'{v:.3e}' for k, v in ctl.items()} } {tag}",
          flush=True)
    if not (err <= PARITY_TOL and bool(outs["kernel"].isfinite().all())):
        raise RuntimeError("robotwin B 1: kernel route disagrees")
    if min(ctl.values()) <= PARITY_TOL:
        raise RuntimeError(f"robotwin B 1: a control passes the gate {ctl}")

    # -- the checkpoint of the forced step, restored into a fresh trainer ----
    del init
    gc.collect()
    torch.cuda.empty_cache()
    _, _, _, _, _, fresh = _rt_setup(torch, dev, vlm_cfg, 41)
    fstep = train_robotwin.build_step(args, fresh)
    w0 = time.perf_counter()
    restore_checkpoint(ck, fresh, fstep)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - w0
    bad = _state_diff(torch, live, _train_state(torch, fresh, fstep, None))
    gb = _dir_gb(ck)
    print(f"train_robotwin checkpoint (1 step): {gb:.2f} GB, save "
          f"{save_s:.1f} s, restore {load_s:.1f} s, entries differing from "
          f"the live trainer {len(bad)} {bad[:3]} {tag}", flush=True)
    if bad:
        raise RuntimeError("train_robotwin checkpoint does not restore")
    del fresh, fstep, live
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the kernels at this path's shapes, against SDPA under its mask ------
    g = torch.Generator(device=dev)
    g.manual_seed(40)
    vcfg, llm = cfg.vlm.vision, cfg.vlm.llm
    i32 = dict(dtype=torch.int32, device=dev)
    ones = torch.ones(RT_BATCH, vcfg.seq_len, **i32)
    seg = batch["text_mask"].to(torch.int32)
    for name, S, H, KVH, D, sg in (
            ("robotwin_vit", vcfg.seq_len, vcfg.num_heads, vcfg.num_heads,
             vcfg.head_dim, ones),
            ("robotwin_llm", seg.shape[1], llm.num_heads, llm.num_kv_heads,
             llm.head_dim, seg)):
        f, b = _flash_case(torch, dev, g, tag, name.replace("_", " "),
                           RT_BATCH, S, S, H, KVH, D, sg, None, sg, None)
        report["flash_attention_fwd"][name] = f
        report["flash_attention_bwd"][name] = b
    f, b = rms_train_case(torch, g, dev, RT_BATCH * seg.shape[1],
                          llm.hidden_size, llm.rms_norm_eps, " (robotwin)",
                          tag)
    report["_rms_fwd"]["robotwin"], report["_rms_bwd"]["robotwin"] = f, b
    del model, batch
    print(f"phase 40 took {time.perf_counter() - t0:.1f} s {tag}", flush=True)
    return launches


def robotwin_train_phases(torch, np, dev, cfg, tag, report):
    work = tempfile.mkdtemp(prefix="chip_smoke_rt_")  # checkpoint: ~23 GB
    try:
        return robotwin_train_phase(torch, np, dev, cfg, tag, report, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
    compute), remat, draws as random_init_, every LLM layer kernel, the
    embedding and the lm_head int8 (DEFAULT_PATTERNS) with the layer
    kernels flagged w8a8 (VLM_W8A8_ACT_PATTERNS), every weight frozen, LoRA
    r SFT_RANK, alpha SFT_ALPHA, bf16 on LLM_TARGETS. -> (model, factors)."""
    from vlaser_tpu_torch.core import quant
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.scripts.train_sft import random_init_
    from vlaser_tpu_torch.train.lora import LLM_TARGETS, init_qlora_collection

    bf = torch.bfloat16
    model = InternVLChatModel(cfg, param_dtype=bf, compute_dtype=bf,
                              device=dev, remat=True)
    gen = torch.Generator(dev).manual_seed(seed)
    random_init_(model, gen)
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
    """`iters` steps, each between CUDA events (host included; the host's
    clock in a CPU rehearsal without a card). -> (ms a step, losses, grad
    norms)."""
    times, losses, gnorms = [], [], []
    for _ in range(iters):
        if not torch.cuda.is_available():
            t = time.perf_counter()
            m = step(batch)
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(m["loss"].item())
            gnorms.append(m["grad_norm"].item())
            continue
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
    from vlaser_tpu_torch.scripts.train_sft import random_init_
    from vlaser_tpu_torch.train.losses import make_sft_loss
    from vlaser_tpu_torch.train.trainer import SFTTrainer, TrainConfig

    t0 = time.perf_counter()
    left = torch.cuda.memory_allocated()  # by earlier phases
    model = InternVLChatModel(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.bfloat16, device=dev,
                              remat=True)
    random_init_(model, torch.Generator(dev).manual_seed(26))
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
    PEAKS["26"] = (peak, 1, left / 2**30)
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


# -- the training entry points (phases 27-31) ---------------------------------
CLI_TOKENS = 2048  # --max_seq of the packed SFT and pretrain runs
CLI_STEPS = 4      # train_sft steps at full width
# the LLM layers of 27-31's Vlaser-2B (of 28; full width): their time is
# checkpoint and converter IO, which scales with depth, and the script
# outgrew its time limit's budget with phases 54-56 (8 layers), then with
# phase 57 (4), then with phase 58 (2) (phase 40 keeps its depth: its
# bf16 grad-norm gate, calibrated at 28 layers, parts by 1.3e-2 at 8)
CUT_LAYERS = 2
PRETRAIN_STEPS = 2  # the first takes warmup_cosine's lr 0
CLI_CONVS = 160    # conversations of the JSONL
CLI_TEXT = (64, 1500)  # their text bytes (byte tokenizer tokens)
MPO_STEPS, MPO_PAIR = 3, 2000  # MPO steps; the pair's padded tokens
CLI_WORDS = ("pick", "place", "the", "red", "green", "block", "cube", "on",
             "plate", "left", "of", "near", "robot", "arm", "moves", "then",
             "grasp", "open", "drawer", "towel", "stack", "yellow", "spoon")


def _text(rng, n):
    """n bytes of seeded lowercase words."""
    s = ""
    while len(s) < n:
        s += CLI_WORDS[int(rng.integers(len(CLI_WORDS)))] + " "
    return s[:n]


def _cli_data(np, root, seed):
    """Write the phases' JSONL files under root: CLI_CONVS text-only
    conversations of CLI_TEXT text bytes (a short system turn, 1-3 human /
    gpt turns, the answers 4x the questions), one preference pair padded to
    MPO_PAIR tokens, and a few short ones of each for the --tiny runs. ->
    their paths."""
    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(root, f"{k}.jsonl")
             for k in ("conv", "pair", "tiny_conv", "tiny_pair")}

    def conv(n):
        turns = int(rng.integers(1, 4))
        c = [{"from": "system", "value": "You are a helpful robot."}]
        for _ in range(turns):
            q = max(1, n // (5 * turns))
            c += [{"from": "human", "value": _text(rng, q)},
                  {"from": "gpt", "value": _text(rng, max(1, n // turns - q))}]
        return {"conversations": c}

    def pair(n):  # n tokens: the template with its default system prompt
        # and a 100-byte question take 348; the rejected answer 60 fewer
        return {"question": _text(rng, 100), "chosen": _text(rng, n - 348),
                "rejected": _text(rng, n - 408)}

    for key, items in (
            ("conv", [conv(int(rng.integers(CLI_TEXT[0], CLI_TEXT[1] + 1)))
                      for _ in range(CLI_CONVS)]),
            ("pair", [pair(MPO_PAIR)]),
            ("tiny_conv", [conv(int(rng.integers(8, 60))) for _ in range(6)]),
            ("tiny_pair", [pair(480) for _ in range(3)])):
        with open(paths[key], "w") as f:
            for it in items:
                f.write(json.dumps(it) + "\n")
    return paths


def _uses_flash(b, sq, heads):
    """kernels/flash_attention.attention_fn's "auto" rule on the card."""
    from vlaser_tpu_torch.kernels import flash_attention as fa

    return sq >= fa.SQ_MIN or b * heads * sq * sq * 4 > fa.LOGITS_BYTES_MIN


def _step_want(cfg, b, n, tiles, grad=True):
    """Launches of one forward (grad=False) or one remat forward + backward
    (every parameter takes a gradient, the frozen ones too) of the
    InternVLChatModel on [b, n] tokens and `tiles` tiles: each ViT and LLM
    layer's attention (and its recompute) by the dispatch rule, each
    RMSNorm (two a layer and the final one) at b * n rows."""
    from vlaser_tpu_torch.kernels import rmsnorm

    v, llm = cfg.vision, cfg.llm
    s = (v.image_size // v.patch_size) ** 2 + 1
    vit = v.num_layers if _uses_flash(tiles, s, v.num_heads) else 0
    lm = llm.num_layers if _uses_flash(b, n, llm.num_heads) else 0
    L = llm.num_layers
    rms = b * n >= rmsnorm.MIN_ROWS and llm.hidden_size <= rmsnorm.MAX_HIDDEN
    passes = 2 if grad else 1
    return {"flash_attention_fwd": passes * (vit + lm),
            "flash_attention_bwd": (vit + lm) if grad else 0,
            "_rms_fwd": (passes * 2 * L + 1) if rms else 0,
            "_rms_bwd": (2 * L + 1) if rms and grad else 0}


def _launches_held(counts, want, what):
    _held({k: v for k, v in counts.items() if v},
          {k: v for k, v in want.items() if v}, what)


def _train_state(torch, model, step_fn, data, host=False):
    """{key: value} of everything a checkpoint restores: every parameter,
    every AdamW state entry, the step counter and the data state (copied to
    the host with host=True)."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {f"param/{n}": p.detach() for n, p in model.named_parameters()}
    for p, st in step_fn.optimizer.state.items():
        for k, v in st.items():
            out[f"adam/{names[id(p)]}/{k}"] = v.detach()
    if host:
        out = {k: v.to("cpu", copy=True) for k, v in out.items()}
    out["step"], out["data"] = step_fn.count, json.loads(json.dumps(data))
    return out


def _state_diff(torch, a, b):
    """Keys whose values differ (a tensor bit for bit, on a's device)."""
    bad = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        x, y = a[k], b[k]
        if torch.is_tensor(x):
            same = x.dtype == y.dtype and torch.equal(x, y.to(x.device))
        else:
            same = x == y
        if not same:
            bad.append(k)
    return bad


def _dir_gb(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 1e9


@contextmanager
def _timing(mod, names, seconds):
    """Time every call of mod.<name> for each name into seconds[name]."""
    orig = {n: getattr(mod, n) for n in names}

    def timed(n):
        def call(*a, **kw):
            t = time.perf_counter()
            out = orig[n](*a, **kw)
            seconds[n] = seconds.get(n, 0.0) + time.perf_counter() - t
            return out
        return call

    for n in names:
        setattr(mod, n, timed(n))
    try:
        yield seconds
    finally:
        for n, f in orig.items():
            setattr(mod, n, f)


def convert_phase(torch, np, dev, cfg, hf_dir, tag):
    """Phase 27: a seeded Vlaser-2B (scripts/train_sft.random_init_, seed
    27) exported as real checkpoints are (utils/convert.to_jax_params ->
    hf_convert.export_internvl_chat, bf16, save_hf_checkpoint_dir in 2
    shards), then loaded by train_sft's weights stage (load_model
    --model_path: load_safetensors_dir -> convert_internvl_chat ->
    from_jax_variables -> load_state on the card): every parameter equal to
    its source rounded to bf16, bit for bit. Control: the fp32 source of
    mlp1.fc1.kernel must differ from what came back (the files hold bf16).
    -> (the loaded model, which phase 28 trains as train_sft's `main`
    would after the same load; its config)."""
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.scripts import train_sft as cli
    from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer
    from vlaser_tpu_torch.utils import convert
    from vlaser_tpu_torch.utils import hf_convert as hc

    t0 = time.perf_counter()
    model = cli.random_init_(InternVLChatModel(cfg, device=dev),
                             torch.Generator(dev).manual_seed(27))
    fp32_ctrl = model.mlp1.fc1.kernel.detach().clone()
    src = {n: p.detach().to(torch.bfloat16)
           for n, p in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    hf = hc.export_internvl_chat(convert.to_jax_params(src))
    hf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in hf.items()}
    t2 = time.perf_counter()
    hc.save_hf_checkpoint_dir(hf, hf_dir, num_shards=2)
    t3 = time.perf_counter()
    n_hf = len(hf)
    del hf
    args = argparse.Namespace(tiny=False, model_path=hf_dir)
    tok = ByteTokenizer()
    cfg, n_added, _, _ = cli.build_config(args, tok, cfg)
    with _timing(hc, ("load_safetensors_dir", "convert_internvl_chat"),
                 {}) as sec, _timing(convert, ("from_jax_variables",), sec):
        model = cli.load_model(args, cfg, n_added, len(tok), dev)
        torch.cuda.synchronize()
    t4 = time.perf_counter()
    back = model.state_dict()
    bad = sorted(set(src) ^ set(back))
    bad += [n for n in set(src) & set(back)
            if back[n].dtype != torch.float32
            or not torch.equal(back[n], src[n].float())]
    ctrl = torch.equal(back["mlp1.fc1.kernel"], fp32_ctrl)
    print(f"converter round trip: Vlaser-2B, {len(src)} port tensors -> "
          f"{n_hf} HF tensors, {_dir_gb(hf_dir):.3f} GB of bf16 "
          f"safetensors; init {t1 - t0:.1f} s, export {t2 - t1:.1f} s, "
          f"write {t3 - t2:.1f} s; train_sft's load_model {t4 - t3:.1f} s "
          f"(read {sec['load_safetensors_dir']:.1f}, convert "
          f"{sec['convert_internvl_chat']:.1f}, from_jax_variables "
          f"{sec['from_jax_variables']:.1f}, the rest to the card); "
          f"{len(bad)} tensors differ from their bf16 source; control "
          f"(fp32 source of mlp1.fc1.kernel equal to what came back): "
          f"{ctrl} {tag}", flush=True)
    if bad:
        raise RuntimeError(f"converter round trip differs: {bad[:4]}")
    if ctrl:
        raise RuntimeError("converter control: the bf16 file equals the "
                           "fp32 source")
    return model, cfg


def sft_cli_phase(torch, np, dev, cfg, model, hf_dir, data, work, tag):
    """Phase 28: train_sft's stages at full width (the LLM's depth cut to
    CUT_LAYERS by `main`) as `main` runs them: --model_path (phase 27's
    checkpoint, loaded there by the same load_model into `model`) --data (CLI_CONVS conversations) --packed
    --max_seq CLI_TOKENS --steps CLI_STEPS --checkpoint_dir (under `work`),
    with the byte tokenizer and vlaser_2b's 151,674-word config handed in.
    The packer's fill rate, tokens/s over real tokens, step ms, the time
    each step waited on the prefetch queue, peak memory, and the launch
    counts held to _step_want's. Then the final checkpoint, restored into
    a fresh model and trainer, must equal the live trainer (every parameter and AdamW
    entry, the step counter, the data state it saved) bit for bit; the same
    comparison against the state after step CLI_STEPS - 1 must fail. ->
    (launches, the trained model)."""
    from vlaser_tpu_torch.data.chat_dataset import PackedDataset
    from vlaser_tpu_torch.scripts import train_sft as cli
    from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer
    from vlaser_tpu_torch.train.trainer import _to_device
    from vlaser_tpu_torch.utils import checkpoint as ck

    ckdir = os.path.join(work, "sft_ckpt")
    args = cli.build_parser().parse_args([
        "--model_path", hf_dir, "--data", data["conv"], "--packed",
        "--max_seq", str(CLI_TOKENS), "--steps", str(CLI_STEPS),
        "--checkpoint_dir", ckdir])
    tok = ByteTokenizer()  # no tokenizer files, no transformers here
    cfg, n_added, start, end = cli.build_config(args, tok, cfg)
    dataset = cli.build_dataset(args, cfg, tok)
    batches, state_fn = cli.build_batches(args, cfg, dataset, start, end)
    trainer = cli.build_trainer(args, model)
    saves, waits, steps, taken, snap = [], [], [], [], {}
    save = ck.save_checkpoint

    def timed_save(directory, step, m, fn, data_state=None, **kw):
        free = shutil.disk_usage(work).free / 1e9
        s = time.perf_counter()
        path = save(directory, step, m, fn, data_state, **kw)
        saves.append((step, time.perf_counter() - s, _dir_gb(path), free,
                      data_state))
        return path

    def fed():
        for i in range(CLI_STEPS):
            if i:
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t)
            if i == CLI_STEPS - 1:  # the state after step CLI_STEPS - 1
                snap.update(_train_state(torch, model, trainer.step_fn,
                                         state_fn(), host=True))
            s = time.perf_counter()
            b = next(batches)
            waits.append(time.perf_counter() - s)
            taken.append(b)
            t = time.perf_counter()
            yield b
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)

    ck.save_checkpoint = timed_save
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    try:
        trainer.train(fed(), data_state_fn=state_fn)
    finally:
        ck.save_checkpoint = save
        batches.close()
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tiles = [len(b["pixel_values"]) for b in taken]
    real = [int((b["seg_ids"] > 0).sum()) for b in taken]
    ms = [1e3 * s for s in steps]
    print(f"train_sft: {CLI_STEPS} packed steps of {CLI_TOKENS} tokens, "
          f"{real} real ({sum(real) / (CLI_STEPS * CLI_TOKENS):.1%} fill), "
          f"{[int(b['seg_ids'].max()) for b in taken]} conversations, "
          f"{tiles} blank tiles; step ms {[round(v, 1) for v in ms]} (median "
          f"of steps 2-{CLI_STEPS} {statistics.median(ms[1:]):.1f} ms), "
          f"{sum(real[1:]) / sum(steps[1:]):.0f} tok/s over real tokens "
          f"(steps 2-{CLI_STEPS}; {sum(real) / sum(steps):.0f} with the "
          f"first); waited on "
          f"the prefetch queue {[round(1e3 * w, 2) for w in waits]} ms; "
          f"peak device memory {peak:.2f} GiB {tag}", flush=True)
    want = {}
    for t in tiles:
        _add(want, _step_want(cfg, 1, CLI_TOKENS, t))
    _launches_held(counts, want, "train_sft")
    (step, save_s, gb, free, saved_data), = saves
    print(f"train_sft checkpoint (step {step}): {gb:.3f} GB in {save_s:.1f} "
          f"s ({gb / save_s:.2f} GB/s), {free:.1f} GB free before it; data "
          f"state {saved_data} {tag}", flush=True)
    model.zero_grad(set_to_none=True)
    live = _train_state(torch, model, trainer.step_fn, saved_data)
    gc.collect()
    torch.cuda.empty_cache()
    model2 = cli.load_model(argparse.Namespace(tiny=False, model_path=None),
                            cfg, 0, 0, dev)  # overwritten by the restore
    trainer2 = cli.build_trainer(args, model2)
    s = time.perf_counter()
    data2 = ck.restore_checkpoint(ckdir, model2, trainer2.step_fn)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - s
    restored = _state_diff(torch, _train_state(torch, model2,
                                               trainer2.step_fn, data2), live)
    earlier = _state_diff(torch, _train_state(torch, model2,
                                              trainer2.step_fn, data2), snap)
    print(f"train_sft restore: {gb:.3f} GB in {restore_s:.1f} s "
          f"({gb / restore_s:.2f} GB/s); {len(live)} entries, "
          f"{len(restored)} differ from the live trainer; control (the state "
          f"after step {CLI_STEPS - 1}): {len(earlier)} differ {tag}",
          flush=True)
    if restored:
        raise RuntimeError(f"the restored checkpoint differs: {restored[:4]}")
    if not ("step" in earlier and any(k.startswith("param/") for k in earlier)
            and any(k.startswith("adam/") for k in earlier)):
        raise RuntimeError(f"restore control: the state one step earlier "
                           f"differs only in {earlier[:4]}")
    del model2, trainer2, live, snap
    shutil.rmtree(ckdir)
    gc.collect()
    torch.cuda.empty_cache()
    s = time.perf_counter()
    it = iter(PackedDataset(dataset, max_packed_tokens=CLI_TOKENS,
                            pad_token_id=cfg.pad_token_id, img_start_id=start,
                            img_end_id=end,
                            num_image_token=cfg.num_image_token,
                            image_size=cfg.vision.image_size))
    for _ in range(CLI_STEPS):
        next(it)
    pack_s = (time.perf_counter() - s) / CLI_STEPS
    lens = sorted(len(dataset[i]["input_ids"]) for i in range(len(dataset)))
    print(f"train_sft host: {len(dataset)} conversations of "
          f"{lens[0]}-{lens[-1]} tokens (median {lens[len(lens) // 2]}), "
          f"image ids {start} / {end} / {cfg.img_context_token_id}; "
          f"tokenizing and packing {1e3 * pack_s:.1f} ms a "
          f"pack on one thread (the prefetch thread's work), "
          f"{1e3 * pack_s / statistics.median(ms[1:]):.1%} of a step "
          f"{tag}", flush=True)
    b = _to_device(taken[-1], dev)
    _profile(torch, lambda: trainer.step_fn(b), "train_sft step", tag)
    return {k: v for k, v in counts.items() if v}, model


def pretrain_phase(torch, np, dev, cfg, model, data, tag):
    """Phase 29: pretrain --stage 1's recipe (its train_sft arguments:
    --freeze_llm, lr 1e-3) on phase 28's model, PRETRAIN_STEPS packed steps
    with derived launch counts (the frozen ViT and LLM still take
    gradients): every mlp1 parameter must change and every other stay bit
    for bit (no checkpoint is written here; phase 31 writes one). ->
    launches."""
    from vlaser_tpu_torch.scripts import pretrain
    from vlaser_tpu_torch.scripts import train_sft as cli
    from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer

    pargs = pretrain.build_parser().parse_args([
        "--data", data["conv"], "--stage", "1", "--packed", "--max_seq",
        str(CLI_TOKENS), "--steps", str(PRETRAIN_STEPS)])
    args = cli.build_parser().parse_args(pretrain.sft_argv(pargs))
    args.checkpoint_dir = None
    tok = ByteTokenizer()
    cfg, _, start, end = cli.build_config(args, tok, cfg)
    batches, _ = cli.build_batches(args, cfg, cli.build_dataset(
        args, cfg, tok), start, end)
    trainer = cli.build_trainer(args, model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    taken = []

    def fed():
        for _ in range(PRETRAIN_STEPS):
            taken.append(next(batches))
            yield taken[-1]

    _zero_counts()
    s = time.perf_counter()
    try:
        trainer.train(fed())
        torch.cuda.synchronize()
    finally:
        batches.close()
    wall = time.perf_counter() - s
    counts = _read_counts()
    moved = sorted(n for n, p in model.named_parameters()
                   if not torch.equal(p.detach(), before[n]))
    mlp1 = sorted(n for n in before if n.startswith("mlp1."))
    print(f"pretrain --stage 1: lr {args.lr}, {PRETRAIN_STEPS} steps in "
          f"{wall:.2f} s; changed: {moved} (mlp1 holds {len(mlp1)}) {tag}",
          flush=True)
    want = {}
    for b in taken:
        _add(want, _step_want(cfg, 1, CLI_TOKENS, len(b["pixel_values"])))
    _launches_held(counts, want, "pretrain --stage 1")
    if moved != mlp1:
        raise RuntimeError(f"pretrain --stage 1 changed {moved}, not mlp1")
    return {k: v for k, v in counts.items() if v}


def mpo_phase(torch, np, dev, cfg, data, tag):
    """Phase 30: train_mpo's stages at full width (random_init_, remat,
    MPOConfig(), lr 5e-6) on one pair padded to MPO_PAIR tokens: MPO_STEPS
    steps with derived launch counts (the reference forward, then the
    policy's with its recompute), the losses, reward accuracy, step ms and
    peak memory. The reference copy must be bit for bit the initial
    parameters, in their dtype, in storage of its own; control: a
    reference that aliases the live parameters must fail that check. ->
    launches."""
    from vlaser_tpu_torch.scripts import train_mpo
    from vlaser_tpu_torch.scripts import train_sft as cli
    from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer

    args = train_mpo.build_parser().parse_args([
        "--data", data["pair"], "--steps", str(MPO_STEPS), "--batch", "1"])
    tok = ByteTokenizer()
    cfg, n_added, _, _ = cli.build_config(args, tok, cfg)
    model = cli.load_model(args, cfg, n_added, len(tok), dev)
    trainer = train_mpo.build_trainer(args, model)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = next(train_mpo.batches(args, cfg, train_mpo.build_dataset(
        args, cfg, tok)))
    n = batch["chosen_input_ids"].shape[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    rows = []
    for _ in range(MPO_STEPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        m = trainer.train(iter([batch]), 1)
        e.record()
        e.synchronize()
        rows.append((s.elapsed_time(e), {k: round(v.item(), 5)
                                         for k, v in m.items()}))
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for ms, m in rows:
        print(f"MPO step: {ms:.1f} ms, {m}", flush=True)
    print(f"MPO: B 1 pair x {n} tokens ([2, {n}] a forward), "
          f"{MPO_STEPS} steps, median "
          f"{statistics.median(r[0] for r in rows):.1f} ms, peak device "
          f"memory {peak:.2f} GiB {tag}", flush=True)
    tiles = 2 * len(batch["pixel_values"])
    want = {}
    for _ in range(MPO_STEPS):
        _add(want, _step_want(cfg, 2, n, tiles, grad=False))
        _add(want, _step_want(cfg, 2, n, tiles))
    _launches_held(counts, want, "MPOTrainer")
    if not all(math.isfinite(v) for _, m in rows for v in m.values()):
        raise RuntimeError("MPO gave a non-finite metric")
    live = {p.untyped_storage().data_ptr() for p in model.parameters()}
    shared = [k for k, t in trainer.ref_params.items()
              if t.untyped_storage().data_ptr() in live]
    changed = [k for k, t in trainer.ref_params.items()
               if t.dtype != init[k].dtype or not torch.equal(t, init[k])]
    alias = dict(model.named_parameters())
    alias_changed = [k for k, t in alias.items()
                     if not torch.equal(t.detach(), init[k])]
    print(f"MPO reference: {len(trainer.ref_params)} tensors, {len(shared)} "
          f"share storage with the live parameters, {len(changed)} changed; "
          f"control (a reference aliasing the live parameters): "
          f"{len(alias_changed)} changed {tag}", flush=True)
    if shared or changed:
        raise RuntimeError(
            f"the MPO reference moved: {(shared + changed)[:4]}")
    if not alias_changed:
        raise RuntimeError("MPO control: the live parameters did not move")
    return {k: v for k, v in counts.items() if v}


def tiny_cli_phase(torch, dev, data, work, tag):
    """Phase 31: each CLI's main through argparse, --tiny, on the card (no
    --device; the model must land on `dev`'s type): short runs that must
    leave their checkpoints."""
    from vlaser_tpu_torch.scripts import pretrain, train_mpo, train_sft
    from vlaser_tpu_torch.utils.checkpoint import latest_step

    for name, mod, src, ck in (("train_sft", train_sft, "tiny_conv", True),
                               ("pretrain", pretrain, "tiny_conv", True),
                               ("train_mpo", train_mpo, "tiny_pair", False)):
        argv = ["--tiny", "--data", data[src], "--steps", "2", "--batch", "2"]
        ckdir = os.path.join(work, f"tiny_{name}")
        if ck:
            argv += ["--checkpoint_dir", ckdir]
        s = time.perf_counter()
        trainer = mod.main(argv)
        wall = time.perf_counter() - s
        left = latest_step(ckdir) if ck else None
        print(f"{name} --tiny on the card: {wall:.1f} s, device "
              f"{trainer.model.device}, step {trainer.step}, checkpoint "
              f"{left if ck else '(the MPO CLI takes no --checkpoint_dir)'} "
              f"{tag}", flush=True)
        if (trainer.model.device.type != dev.type or trainer.step != 2
                or (ck and left != 2)):
            raise RuntimeError(f"{name} --tiny did not train on the card or "
                               "left no checkpoint")


def cli_phases(torch, np, dev, cfg, tag, work):
    """Phases 27-31, the training entry points at Vlaser-2B width: ->
    launches of their main paths. `work`: a scratch directory for the
    JSONL files, the HF checkpoint and the train checkpoints."""
    t0 = time.perf_counter()
    data = _cli_data(np, work, 27)
    hf_dir = os.path.join(work, "hf")
    model, _ = convert_phase(torch, np, dev, cfg, hf_dir, tag)
    gc.collect()
    torch.cuda.empty_cache()
    launches, model = sft_cli_phase(torch, np, dev, cfg, model, hf_dir, data,
                                    work, tag)
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, pretrain_phase(torch, np, dev, cfg, model, data, tag))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, mpo_phase(torch, np, dev, cfg, data, tag))
    gc.collect()
    torch.cuda.empty_cache()
    tiny_cli_phase(torch, dev, data, work, tag)
    print(f"phases 27-31: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


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


# -- the dense families beyond Vlaser-2B: phases 41-43 ----------------------
DECODE8B_NEW = 32  # bench.py's _bench_decode_8b: 1 tile, 320 tokens, 32 new
QK_GAIN = 4.0  # phase 43's q/k kernels x4: the per-head norms undo it
# phase 43: kernel vs reference prefill logits, x max |logits|: two correct
# bf16 routes through 28 random layers part this far (0.140 on an H100 at
# the 13-tile prefill; the QLoRA gate's final hidden states 0.2,
# HIDDEN_REL), while dropping the q/k norms moves them by 1.3
PREFILL_REL = 0.25
VIT_INTERP_PX = 224  # phase 43: a 224 px frame into the 448 px ViT
INTERP_EMB_REL, INTERP_OUT_REL = 1e-2, 5e-2  # bf16 on the card vs fp32
ENGINE8_MSGS = ((64, None, 16), (128, None, 32), (192, None, 16),
                (96, 1, 32))  # phase 43's chat_many: text chars, tiles, new


def _chat_request(torch, np, dev, cfg, chat, tiles_n, seed):
    """Phase 14's 13-tile request on `chat`'s config: -> (question, tiles,
    ids, seg)."""
    from vlaser_tpu_torch.image.tiling import normalize_uint8
    from vlaser_tpu_torch.tokenizer.conversation import build_chat_query

    question = "What is shown in this image?"
    img = cfg.vision.image_size
    tiles = torch.from_numpy(normalize_uint8(np.random.default_rng(
        seed).integers(0, 256, (tiles_n, img, img, 3),
                       dtype=np.uint8))).to(dev)
    query = build_chat_query(cfg.template, "<image>\n" + question, [tiles_n],
                             cfg.num_image_token)
    ids, seg = chat._encode([query])
    return question, tiles, ids, seg


def _counted_calls(torch, fn, what, tag):
    """A warm-up call of fn, then STEPS calls with the launch counters zeroed
    just before and read just after: -> (counts, wall ms of each call, the
    last result)."""
    first = fn()
    torch.cuda.synchronize()
    _zero_counts()
    times = []
    for _ in range(STEPS):
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    got = {k: v for k, v in _read_counts().items() if v}
    _count_split()
    print(f"{what}: {STEPS} calls {[round(t, 1) for t in times]} ms (median "
          f"{statistics.median(times):.1f} ms, host clock around "
          f"synchronize); launches {got} {tag}", flush=True)
    return got, times, out, first


def vlaser8b_chat_phase(torch, np, dev, tag, extra):
    """Phase 41, Vlaser-8B chat (InternViT-300M + Qwen2.5-7B, 151,674 words,
    random_init_'s draws, quantize_for_serving defaults: vlm, w8a8): 3
    counted 13-tile VlaserChat.chat calls on the fused runner, launches held
    to the derived counts; stage times and peak memory; then the kernels at
    the 8B's shapes against their plain versions with controls
    (fused_int8_stack R 1 at 384 / 3,592 slots, the layer's quantizers with
    the 18,944-wide silu-mul, int8_gemm at 384 / 3,584 rows, the causal
    flash prefill at 28 / 4 heads); then bench.py's _bench_decode_8b
    (decode_parity_phase at its draws, int8: 1 tile, a 320-token prompt, 32
    new tokens, teacher-forced against the plain decoder). No profiler.
    -> launches of the 3 chat calls."""
    from vlaser_tpu_torch.core.config import vlaser_8b
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.inference import fused_runner as fr
    from vlaser_tpu_torch.inference.chat import VlaserChat
    from vlaser_tpu_torch.inference.kv_cache import KVCache
    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import rmsnorm

    t0 = time.perf_counter()
    cfg = vlaser_8b()
    llm, L = cfg.llm, cfg.llm.num_layers
    torch.cuda.reset_peak_memory_stats()
    model = quantize_for_serving(_chat_model(torch, dev, cfg, 41,
                                             visible_norms=True))
    torch.cuda.synchronize()
    n_param = sum(t.numel() for t in model.state_dict().values())
    print(f"Vlaser-8B chat model: quantize_for_serving defaults (vlm, w8a8), "
          f"{n_param / 1e9:.3f} G elements, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    chat = VlaserChat(model, ChatStubTokenizer(cfg.img_context_token_id),
                      max_new_tokens=CHAT_NEW)
    print(f"Vlaser-8B VlaserChat route: {chat.route} {tag}", flush=True)
    if chat.route != "fused":
        raise RuntimeError("the Vlaser-8B chat did not take the fused runner")
    question, tiles, ids, seg = _chat_request(torch, np, dev, cfg, chat,
                                              CHAT_TILES, 12)
    n, n_valid = ids.shape[1], int(seg.sum())
    E = n + CHAT_NEW
    # derived from the code, as phase 14's: the act_quant ViT stack; 7 w8a8
    # Dense a layer on 4 quantizations; flash at the prefill's rows; the
    # RMSNorm kernel only at hidden <= 2,048 (the JAX dispatch: not here)
    per_call = {"fused_vit_stack_w8a8": 1, "quantize_rows": 3 * L,
                "quantize_silu_mul": L, "int8_gemm": 7 * L,
                "fused_int8_stack": CHAT_NEW - 1}
    if n >= fa.SQ_MIN:
        per_call["flash_attention_fwd"] = L
    if n >= rmsnorm.MIN_ROWS and llm.hidden_size <= rmsnorm.MAX_HIDDEN:
        per_call["_rms_fwd"] = 2 * L + 1
    with torch.inference_mode():
        got, times, r, first = _counted_calls(
            torch, lambda: chat.chat(question, tiles),
            f"Vlaser-8B chat, {CHAT_TILES} tiles, prompt {n_valid} tokens in "
            f"a bucket of {n}, {CHAT_NEW} new tokens", tag)
    want = {k: STEPS * v for k, v in per_call.items()}
    print(f"Vlaser-8B chat launches derived {want}; response {r[:60]!r} "
          f"{tag}", flush=True)
    if got != want:
        raise RuntimeError(f"Vlaser-8B chat launches {got} != {want}")
    if not (isinstance(r, str) and r == first):
        raise RuntimeError("Vlaser-8B chat answered differently")
    with torch.inference_mode():
        vit_stack = fr.pack_vit_stack(model.vision_model)
        feats = fr.fused_visual_features(model, tiles, vit_stack)
        mk = lambda: KVCache.create(L, 1, E, llm.num_kv_heads, llm.head_dim,
                                    torch.bfloat16, dev)
        logits, _, cache = model.prefill(ids, None, seg, mk(),
                                         visual_features=feats)
        if not (bool(logits.isfinite().all())
                and logits.shape == (1, n, llm.vocab_size)):
            raise RuntimeError("Vlaser-8B prefill gave bad logits")
        stack = fr.pack_qwen2_stack(model.language_model)
        head = fr.head_of(model.language_model)
        token = logits[0, n_valid - 1].argmax(-1)[None]
        del logits
        vit_ms = _ms(torch, lambda: fr.fused_visual_features(
            model, tiles, vit_stack), 3)
        prefill_ms = _ms(torch, lambda: model.prefill(
            ids, None, seg, mk(), visual_features=feats), 3)
        step_ms = _ms(torch, lambda: fr.fused_decode_step(
            stack, model.language_model.embed_tokens, head, llm, token,
            cache, seg.sum(1)), 10)
        hidden = torch.randn(1, llm.hidden_size, device=dev).to(torch.bfloat16)
        head_ms = _kernel_ms(torch, lambda: fr._head_logits(head, hidden), 10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"Vlaser-8B chat stages, each timed alone (CUDA events): ViT "
          f"({CHAT_TILES} tiles, fused act_quant) {vit_ms:.3f} ms, prefill "
          f"({n} rows) {prefill_ms:.3f} ms, decode {step_ms:.3f} ms per token "
          f"({1e3 / step_ms:.1f} tok/s; int8 lm_head {head_ms:.3f} ms of it); "
          f"chat median {statistics.median(times):.1f} ms; peak device memory "
          f"{peak:.2f} GiB {tag}", flush=True)
    del cache, feats, stack

    # -- the kernels at the 8B's shapes, against their plain versions -------
    dec = decode_kernel_phase(torch, model, dev,
                              (DECODE_PROMPT + DECODE_NEW, E), tag,
                              modes=("int8",), profile=False)
    lay = model.language_model.model.layers
    rows = (DECODE_PROMPT + DECODE_NEW, n)
    gem = gemm_phase(torch, _gemm_sites(lay.self_attn, lay.mlp), rows, dev,
                     tag)
    flash = flash_prefill_phase(torch, dev, llm, n_valid, n, E, tag)
    for Ek, rep in dec["int8"].items():
        extra["fused_int8_stack"][f"vlaser8b_decode_e{Ek}"] = rep
    for Ek, rep in dec["attention"].items():
        extra["fused_int8_stack"][f"vlaser8b_attention_alone_e{Ek}"] = rep
    for m, (k1, k2, k3) in gem.items():
        extra["quantize_rows"][f"vlaser8b_{m}"] = k1
        extra["int8_gemm"][f"vlaser8b_{m}"] = k2
        extra["quantize_silu_mul"][f"vlaser8b_{m}"] = k3
    extra["flash_attention_fwd"]["vlaser8b_prefill"] = flash
    del chat, model, tiles
    gc.collect()
    torch.cuda.empty_cache()

    # -- bench.py's _bench_decode_8b: int8, 1 tile, 32 new tokens, bench.py's
    # draws (phase 16's, whose 'ln1 ignored' control needs them) ----------
    par = decode_parity_phase(torch, dev, cfg, tag, new=DECODE8B_NEW)
    print(f"vlm8b_decode_tok_per_sec {par['tok_s']:.1f} (fused generate, "
          f"{DECODE8B_NEW} tokens over a {DECODE_PROMPT}-token prompt; "
          f"vlm_decode_tok_mismatches {par['mismatches']}) {tag}", flush=True)
    extra["fused_int8_stack"]["vlaser8b_decode_parity"] = par
    return got


def vlaser8b_vla_phase(torch, np, dev, tag, extra):
    """Phase 42, the Vlaser-8B-VLA control step (vlaser_8b_vla: the 8B
    mixture and the 768-wide expert with 28 q / 4 kv heads, bench.py's
    N(0, 0.02^2) draws): PolicyServer(fused=True) at batch 1 on the int8
    tree (3 counted steps, fused vs plain <= PARITY_TOL), fused_int8_stack
    at R 5 / 4 on the 8B expert against its twin with controls; then the
    w8a8 tree: PolicyServer at batch 1 and make_batched_infer_action at
    batch 8 (3 counted calls each, launches held to the derived counts),
    bench.py's gates (fused vs plain 2e-2, w8a8 vs bf16 2.5e-2, fused-ViT
    K/V 0.2, batched vs plain 2e-2), ms a step and peak memory; last, one
    b1 step under torch.profiler (idle share). -> launches of the three
    main paths."""
    from vlaser_tpu_torch.core.config import vlaser_8b_vla
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.envs.adapters import BridgeSimplerAdapter
    from vlaser_tpu_torch.kernels.fused_vit import (fused_vit_stack,
                                                    pack_vit_stack)
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.policy.fused_infer import make_batched_infer_action
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.policy.processing import InternVLAProcessor
    from vlaser_tpu_torch.serve.policy_server import PolicyServer

    t0 = time.perf_counter()
    cfg = vlaser_8b_vla()
    bf = torch.bfloat16
    L, steps = cfg.vlm.llm.num_layers, cfg.num_inference_steps

    def build():
        model = PiZeroVLA(cfg, param_dtype=bf, compute_dtype=bf, device=dev)
        model.requires_grad_(False)
        return init_normal_(model, torch.Generator(device=dev).manual_seed(
            42), std=0.02)

    model = build()
    S, img = cfg.max_image_text_tokens, cfg.vlm.vision.image_size
    A = (cfg.num_action_tokens, cfg.action_dim)
    proc = InternVLAProcessor(SmokeTokenizer(cfg.vlm),
                              num_image_tokens=cfg.vlm.num_image_token,
                              max_seq_len=S, pad_token_id=cfg.vlm.pad_token_id)
    prompt = "put the carrot on the plate"
    p = proc([prompt], np.zeros((1, 1, img, img, 3), np.uint8))
    ids1 = torch.from_numpy(p["input_ids"]).to(dev)
    mask1 = torch.from_numpy(p["attention_mask"]).to(dev)
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
    stats = {"action": {"p01": [-0.05] * 6 + [0.0], "p99": [0.05] * 6 + [1.0],
                        "mean": [0.0] * 7, "std": [1.0] * 7},
             "proprio": {"p01": [-0.5] * 6 + [0.0], "p99": [0.5] * 6 + [1.0],
                         "mean": [0.0] * 7, "std": [1.0] * 7}}
    adapter = BridgeSimplerAdapter(dataset_statistics=stats,
                                   image_size=(img, img))
    rng = np.random.default_rng(42)
    frames = [rng.integers(0, 256, (img, img, 3), dtype=np.uint8)
              for _ in range(STEPS)]
    obs = {"agent": {"eef_pos": np.array([0.1, 0.0, 0.2, 1, 0, 0, 0, 0.5],
                                         np.float32)}}

    def serve(what, per_step):
        server = PolicyServer(model, None, adapter, proc, act_steps=4,
                              seed=0, fused=True, device=dev)
        server.reset(prompt)
        torch.cuda.synchronize()
        _zero_counts()
        chunks = [server.step(obs, f) for f in frames]
        torch.cuda.synchronize()
        got = {k: v for k, v in _read_counts().items() if v}
        _count_split()
        want = {k: STEPS * v for k, v in per_step.items()}
        print(f"Vlaser-8B-VLA {what} server: {STEPS} steps, actions finite "
              f"{all(bool(np.isfinite(c).all()) for c in chunks)}; launches "
              f"{got} (derived {want}) {tag}", flush=True)
        if not all(c.shape == (4, 7) and np.isfinite(c).all()
                   for c in chunks):
            raise RuntimeError(f"the {what} server returned bad actions")
        if got != want:
            raise RuntimeError(f"{what} server launches {got} != {want}")
        with torch.inference_mode():
            diff = (server._infer(*in1) - model.infer_action(*in1)).abs()
        d = diff.max().item()
        print(f"Vlaser-8B-VLA {what} parity: fused vs plain, batch 1: "
              f"max_abs_diff {d:.3e} (bound {PARITY_TOL}) {tag}", flush=True)
        if not d <= PARITY_TOL:
            raise RuntimeError(f"the {what} fused path disagrees")
        return server, got

    # -- weight-only int8 (POLICY_PATTERNS): the bf16 ViT stack --------------
    quantize_for_serving(model, target="policy", mode="int8")
    print(f"Vlaser-8B-VLA int8 model: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    server, launches = serve("int8", {"fused_vit_stack": 1,
                                      "fused_int8_stack": steps})
    with torch.inference_mode():
        int8_ms = _ms(torch, lambda: server._infer(*in1), 10)
        rnd = lambda *s: torch.randn(s, generator=g, device=dev)
        dec = denoise_stack_phase(torch, dev, model, rnd, tag, profile=False)
    extra["fused_int8_stack"]["vlaser8b_expert"] = dec
    del server, model
    gc.collect()
    torch.cuda.empty_cache()

    # -- w8a8 (the serving default): b1 and the batched path at batch 8 -----
    model = build()
    quantize_for_serving(model, target="policy")
    per_step = {"fused_vit_stack_w8a8": 1, "fused_int8_stack": steps,
                "quantize_rows": 3 * L, "quantize_silu_mul": L,
                "int8_gemm": 7 * L}
    server, got = serve("w8a8", per_step)
    _add(launches, got)
    batched = make_batched_infer_action(model)
    per_step8 = {"fused_vit_stack_w8a8": 1, "quantize_rows": 3 * L,
                 "quantize_silu_mul": L, "int8_gemm": 7 * L}
    if B8 * S >= 2048 and cfg.vlm.llm.hidden_size <= 2048:
        per_step8["_rms_fwd"] = 2 * L
    torch.cuda.synchronize()
    _zero_counts()
    with torch.inference_mode():
        outs8 = [batched(*in8) for _ in range(STEPS)]
    torch.cuda.synchronize()
    got = {k: v for k, v in _read_counts().items() if v}
    want = {k: STEPS * v for k, v in per_step8.items()}
    print(f"Vlaser-8B-VLA w8a8 batched path: {STEPS} calls at batch {B8}; "
          f"launches {got} (derived {want}) {tag}", flush=True)
    if not all(o.isfinite().all() and o.shape == (B8, cfg.horizon_steps,
                                                  cfg.action_dim)
               for o in outs8):
        raise RuntimeError("the 8B batched path returned bad actions")
    if got != want:
        raise RuntimeError(f"8B batched path launches {got} != {want}")
    _add(launches, got)
    with torch.inference_mode():
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
        a8_f, a8_p = batched(*in8), model.infer_action(*in8)
        torch.cuda.synchronize()
    gates = (("w8a8 vs the bf16 model (plain)",
              (a_plain - a_bf16).abs().max().item(), W8A8_VS_BF16_TOL),
             ("fused-ViT prefix K/V vs plain", max(
                 (kv_f[i].float() - kv_p[i].float()).abs().max().item()
                 for i in (0, 1)), VIT_KV_TOL),
             ("batched vs plain, batch 8", (a8_f - a8_p).abs().max().item(),
              PARITY_B8_TOL))
    for name, d, tol in gates:
        print(f"Vlaser-8B-VLA w8a8 parity: {name}: max_abs_diff {d:.3e} "
              f"(bound {tol}) {tag}", flush=True)
    if any(not d <= tol for _, d, tol in gates):
        raise RuntimeError("a Vlaser-8B-VLA parity gate failed")
    del kv_f, kv_p, a8_p
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        step_ms = _ms(torch, lambda: server._infer(*in1), 10)
        step8_ms = _ms(torch, lambda: batched(*in8), 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_a = cfg.horizon_steps
    print(f"Vlaser-8B-VLA control step (median, CUDA events): int8 batch 1 "
          f"{int8_ms:.3f} ms; w8a8 batch 1 {step_ms:.3f} ms "
          f"({1e3 * n_a / step_ms:.1f} actions/s), batch {B8} "
          f"{step8_ms:.3f} ms ({1e3 * B8 * n_a / step8_ms:.1f} actions/s); "
          f"peak device memory {peak:.2f} GiB {tag}", flush=True)
    with torch.inference_mode():
        _profile(torch, lambda: torch.ones(8, device=dev).add_(1), "warm-up",
                 tag, quiet=True)
        prof = _profile(torch, lambda: server._infer(*in1),
                        "Vlaser-8B-VLA w8a8 batch-1 step", tag)
    extra["fused_int8_stack"]["vlaser8b_vla"] = dict(
        int8_b1_ms=int8_ms, w8a8_b1_ms=step_ms, w8a8_b8_ms=step8_ms,
        peak_gib=peak, b1_idle=1 - prof["busy"] / prof["wall"])
    del server, batched, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


@contextmanager
def _reference_route(torch, model, qk_norm=True):
    """Within: the model's attention and RMSNorm on their eager references
    and the w8a8 quantizer and GEMM on their plain versions (every kernel
    off, on the same CUDA tensors); qk_norm=False also drops the LLM's
    per-head q/k norms (the control of phase 43's gate)."""
    import dataclasses

    from vlaser_tpu_torch.kernels import w8a8
    from vlaser_tpu_torch.models.layers import set_rms_impl

    lay = model.language_model.model.layers
    names = ("quantize_rows", "quantize_silu_mul", "int8_gemm")
    saved = {k: getattr(w8a8, k) for k in names}
    cfg = lay.cfg
    try:
        for k in names:
            setattr(w8a8, k, getattr(w8a8, k + "_plain"))
        model.set_attn_impl("reference")
        set_rms_impl(model, "reference")
        lay.cfg = dataclasses.replace(cfg, qk_norm=qk_norm and cfg.qk_norm)
        yield
    finally:
        for k, f in saved.items():
            setattr(w8a8, k, f)
        model.set_attn_impl("auto")
        set_rms_impl(model, "auto")
        lay.cfg = cfg


def vit_interp_check(torch, np, dev, vcfg, tag):
    """Phase 43 (part): one VIT_INTERP_PX frame through a 448 px-config
    InternViT-300M (random_init_'s draws, the position embedding N(0, 1) as
    the JAX init draws it; bf16 on the card), its 16 x 16 grid's position
    embeddings resized bicubically from the 32 x 32 they were trained at,
    against the same function on the CPU in fp32: the embeddings within
    INTERP_EMB_REL and the encoder's output within INTERP_OUT_REL of max
    |fp32|; control: the grid's embeddings cut to the first rows (no
    resize) must break the embeddings' bound."""
    import torch.nn.functional as F

    from vlaser_tpu_torch.image.tiling import normalize_uint8
    from vlaser_tpu_torch.models.internvit import InternVisionModel
    from vlaser_tpu_torch.scripts.train_sft import random_init_

    bf, f32 = torch.bfloat16, torch.float32
    holder = torch.nn.Module()  # random_init_ draws a model's vision_model
    holder.vision_model = vit = InternVisionModel(
        vcfg, param_dtype=bf, compute_dtype=bf, device=dev)
    vit.requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(43)
    random_init_(holder, gen)
    with torch.no_grad():
        pos = vit.embeddings.position_embedding
        pos.copy_(torch.randn(pos.shape, generator=gen, device=dev))
    cpu = InternVisionModel(vcfg, param_dtype=f32, compute_dtype=f32,
                            device="cpu")
    cpu.load_state_dict({k: v.float().cpu() for k, v in
                         vit.state_dict().items()})
    px = VIT_INTERP_PX
    x = torch.from_numpy(normalize_uint8(np.random.default_rng(43).integers(
        0, 256, (1, px, px, 3), dtype=np.uint8)))
    with torch.inference_mode():
        emb, out = vit.embed(x.to(dev)), vit(x.to(dev))
        emb_c, out_c = cpu.embed(x), cpu(x)
        n, e = emb_c.shape[1], cpu.embeddings
        patch = F.conv2d(x.permute(0, 3, 1, 2), e.patch_embedding.weight,
                         stride=vcfg.patch_size).flatten(2).transpose(1, 2)
        cut = emb_c.clone()  # the grid's first rows, not resized
        cut[:, 1:] = (patch + e.patch_embedding.bias
                      + e.position_embedding[:, 1:n])
    rel = lambda a, b: ((a.float().cpu() - b).abs().max()
                        / b.abs().max()).item()
    r_emb, r_out, r_cut = rel(emb, emb_c), rel(out, out_c), rel(cut, emb_c)
    print(f"ViT position-embedding interpolation: a {px} px frame into the "
          f"{vcfg.image_size} px InternViT-300M ({n} tokens), card (bf16) vs "
          f"CPU (fp32): embeddings {r_emb:.3e} (bound {INTERP_EMB_REL}), "
          f"encoder output {r_out:.3e} (bound {INTERP_OUT_REL}) x max |fp32|;"
          f" control 'grid cut, not resized' {r_cut:.3e} (must exceed the "
          f"embeddings' bound) {tag}", flush=True)
    if not (r_emb <= INTERP_EMB_REL and r_out <= INTERP_OUT_REL
            and r_cut > INTERP_EMB_REL and bool(out.isfinite().all())):
        raise RuntimeError("the interpolated ViT disagrees with the CPU")
    return dict(emb_rel=r_emb, out_rel=r_out, control_rel=r_cut)


def _qwen3_model(torch, dev, cfg, compute):
    """Phase 43's InternVL3.5-2B: bf16 weights from random_init_'s draws
    (seed 43) with the q/k kernels x QK_GAIN, computing in `compute`."""
    model = _chat_model(torch, dev, cfg, 43, visible_norms=True,
                        compute=compute)
    att = model.language_model.model.layers.self_attn
    with torch.no_grad():
        att.q_proj.kernel.mul_(QK_GAIN)
        att.k_proj.kernel.mul_(QK_GAIN)
    return model


def internvl35_phase(torch, np, dev, tag, extra):
    """Phase 43, InternVL3.5-2B (InternViT-300M + Qwen3-1.7B: per-head q/k
    RMSNorm, tied embeddings; random_init_'s draws with the q/k kernels x
    QK_GAIN, which only the norms undo; quantize_for_serving defaults: vlm,
    w8a8): the ViT's interpolated position embeddings (vit_interp_check);
    VlaserChat's route (the plain generator: the fused decode stack has no
    q/k norm; use_fused=True must raise); 3 counted 13-tile chat calls,
    each of flash, _rms_fwd, quantize_rows, quantize_silu_mul and
    int8_gemm launched and no fused stack; _rms_fwd at the q/k norm's rows
    (3,584 x 16 of 128) and the layer norms' (3,584 x 2,048) and the causal
    flash prefill at 16 / 8 heads against their plain versions with
    controls; the 13-tile prefill on the kernel route against every kernel
    off, layer 0's output (LAYER0_REL) and the logits (PREFILL_REL, x max
    |logits| over the valid rows; control: the q/k norms dropped must
    break both); then, on the same int8 weights computing in fp32 (fp32
    cache), EngineChat.chat_many over ENGINE8_MSGS equal to the plain
    generator's answers token for token. No profiler. -> launches of the
    chat calls and the engine's run."""
    from vlaser_tpu_torch.core.config import internvl3_5_2b
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.inference.chat import VlaserChat
    from vlaser_tpu_torch.inference.kv_cache import KVCache
    from vlaser_tpu_torch.serve.engine_chat import EngineChat

    t0 = time.perf_counter()
    cfg = internvl3_5_2b()
    llm, L = cfg.llm, cfg.llm.num_layers
    vit_interp_check(torch, np, dev, cfg.vision, tag)
    model = quantize_for_serving(_qwen3_model(torch, dev, cfg,
                                              torch.bfloat16))
    torch.cuda.synchronize()
    tok = ChatStubTokenizer(cfg.img_context_token_id)
    chat = VlaserChat(model, tok, max_new_tokens=CHAT_NEW)
    try:
        VlaserChat(model, tok, max_new_tokens=CHAT_NEW, use_fused=True)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    print(f"InternVL3.5-2B (Qwen3-1.7B, qk_norm) chat model: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, "
          f"{time.perf_counter() - t0:.1f} s; VlaserChat route "
          f"{chat.route}; use_fused=True refused: {refused!r} {tag}",
          flush=True)
    if chat.route != "plain" or refused is None:
        raise RuntimeError("a qk-norm chat took or offered the fused runner")
    question, tiles, ids, seg = _chat_request(torch, np, dev, cfg, chat,
                                              CHAT_TILES, 12)
    n, n_valid = ids.shape[1], int(seg.sum())
    with torch.inference_mode():
        got, times, r, first = _counted_calls(
            torch, lambda: chat.chat(question, tiles),
            f"InternVL3.5-2B chat (plain generator), {CHAT_TILES} tiles, "
            f"prompt {n_valid} tokens, {CHAT_NEW} new tokens", tag)
    need = ("flash_attention_fwd", "_rms_fwd", "quantize_rows",
            "quantize_silu_mul", "int8_gemm")
    if [k for k in need if not got.get(k)] or any(
            k.startswith("fused_") for k in got) or r != first:
        raise RuntimeError(f"InternVL3.5-2B chat launches {got}")
    launches = dict(got)

    # -- the kernels at the Qwen3 prefill's shapes ---------------------------
    g = torch.Generator(device=dev).manual_seed(43)
    extra["_rms_fwd"]["internvl35_qk_norm"] = rms_serving(
        torch, g, dev, n * llm.num_heads, llm.head_dim, llm.rms_norm_eps,
        "Qwen3 q_norm over 16 heads a row", tag)
    extra["_rms_fwd"]["internvl35_prefill"] = rms_serving(
        torch, g, dev, n, llm.hidden_size, llm.rms_norm_eps,
        "Qwen3-1.7B prefill", tag)
    extra["flash_attention_fwd"]["internvl35_prefill"] = flash_prefill_phase(
        torch, dev, llm, n_valid, n, n + CHAT_NEW, tag)

    # -- the prefill: kernel route vs every kernel off, at layer 0 (the
    # ViT's features and one LLM layer) and at the logits ------------------
    lay = model.language_model.model.layers

    def prefill():
        out = []
        hook = lay.register_forward_hook(
            lambda m, a, o: out.append(o) if not out else None)
        cache = KVCache.create(L, 1, n, llm.num_kv_heads, llm.head_dim,
                               torch.bfloat16, dev)
        try:
            with torch.inference_mode():
                logits = model.prefill(ids, tiles, seg, cache)[0]
        finally:
            hook.remove()
        return out[0][0, :n_valid].float(), logits[0, :n_valid]

    got_h, got_l = prefill()
    with _reference_route(torch, model):
        ref_h, ref_l = prefill()
    with _reference_route(torch, model, qk_norm=False):
        ctrl_h, ctrl_l = prefill()
    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()
    l2 = lambda a: ((a - ref_l).norm() / ref_l.norm()).item()
    err0, ctrl0 = rel(got_h, ref_h), rel(ctrl_h, ref_h)
    err, ctrl = rel(got_l, ref_l), rel(ctrl_l, ref_l)
    print(f"InternVL3.5-2B 13-tile prefill, kernel route vs every kernel "
          f"off: layer 0's output {err0:.3e} x its max (bound LAYER0_REL "
          f"{LAYER0_REL}; control 'q/k norms dropped' {ctrl0:.3e}); logits "
          f"[{n_valid}, {llm.vocab_size}] {err:.3e} x max |logits| (bound "
          f"{PREFILL_REL}; relative L2 {l2(got_l):.3e}); control {ctrl:.3e} "
          f"(must exceed the bound; relative L2 {l2(ctrl_l):.3e}) {tag}",
          flush=True)
    if not (err0 <= LAYER0_REL < ctrl0 and err <= PREFILL_REL < ctrl
            and bool(got_l.isfinite().all())):
        raise RuntimeError("the qk-norm prefill disagrees with its reference")
    del got_l, ref_l, ctrl_l, got_h, ref_h, ctrl_h

    del chat, model
    gc.collect()
    torch.cuda.empty_cache()

    # -- EngineChat against the plain generator, at fp32 compute and cache
    # (phase 21's setting: in bf16 the engine's batch-4 decode and the
    # plain generator's batch-1 decode round apart, and the streams part at
    # near-ties), on the same int8 weights --------------------------------
    model = quantize_for_serving(_qwen3_model(torch, dev, cfg, torch.float32))
    rng = np.random.default_rng(20)
    words = ("pick", "place", "the", "red", "block", "on", "cup", "left")
    items = []
    for chars, n_tiles, new in ENGINE8_MSGS:
        text = ""
        while len(text) < chars:
            text += words[rng.integers(len(words))] + " "
        items.append((text[:chars], tiles[:n_tiles] if n_tiles else None,
                      None, None, new))
    eng = EngineChat(model, tok, max_new_tokens=max(m[2] for m in
                                                    ENGINE8_MSGS),
                     num_slots=4, max_len=768, cache_dtype=torch.float32)
    _zero_counts()
    w0 = time.perf_counter()
    with torch.inference_mode():
        answers = eng.chat_many(items)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    _add(launches, {k: v for k, v in _read_counts().items() if v})
    apart = []
    for (text, px, _, _, new), a in zip(items, answers):
        plain = VlaserChat(model, tok, max_new_tokens=new,
                           cache_dtype=torch.float32)
        with torch.inference_mode():
            b = plain.chat(text, px)
        if a != b:  # the first token index where the streams part
            ta, tb = a.split(), b.split()
            apart.append((len(text), next(
                (i for i in range(min(len(ta), len(tb))) if ta[i] != tb[i]),
                min(len(ta), len(tb)))))
    print(f"InternVL3.5-2B EngineChat.chat_many (fp32 compute and cache): "
          f"{len(items)} items in {wall:.2f} s wall; "
          f"{len(items) - len(apart)} equal to the plain generator token for "
          f"token {tag}", flush=True)
    if apart:
        raise RuntimeError(f"EngineChat's greedy streams leave the plain "
                           f"generator's (item chars, token): {apart}")
    del eng, model, tiles
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- the native image loader and the Qwen3-MoE family: phases 44-45 --------
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "vlaser_tpu_torch", "native", "fixtures")
FIXTURE_NAMES = ("scene_4x3", "tall", "gray")
# phase 44: the native resize against its float64 numpy twin, in
# ImageNet-normalized units (the C++ builds its weights and sums in fp32:
# up to 8.4e-5 apart on the 4 x 3 upscale, 0.005 of a level); another
# libjpeg than the one that decoded the stored pixels may differ by an IDCT
# rounding step: a few levels at most
RESIZE_TOL, DECODE_TOL = 1e-3, 4.0
LOADER_JOBS = 64
MOE_REL = 3e-2  # phase 45: one MoE layer in bf16 vs the fp32 oracle, x max
MOE_NEW = 32  # phase 45: the second chat's new tokens, and the teacher force
# phase 45: the LLM layers (of 48; full width), cut with phase 58 for the
# script's time limit (a 30B build and its chats scale with depth)
MOE_LAYERS = 12
ENGINE_MOE_MSGS = ((48, 12), (96, 16), (64, 8), (128, 12))  # chars, new


def native_build_job():
    """The native libraries' build, run beside nvcc (main): the toolchain
    (g++, jpeglib.h, libjpeg), the image-ops library, and the JPEG loader
    where the toolchain has libjpeg. -> report."""
    from vlaser_tpu_torch.native import build as nb

    t0 = time.perf_counter()
    out = {"toolchain": nb.jpeg_toolchain(), "image_ops": nb.build()}
    tc = out["toolchain"]
    out["jpeg"] = bool(tc["jpeglib_h"] and tc["libjpeg"])
    if out["jpeg"]:
        out["dataloader"] = nb.build_dataloader()
    out["seconds"] = time.perf_counter() - t0
    return out


def _np_resize_matrix(np, n_in, n_out):
    """image_ops.cpp's bicubic (a = -0.5) weights for one axis as a dense
    float64 [n_out, n_in] matrix (taps clamped at the border, each output's
    taps normalized to sum 1)."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    radius = 2 * fs
    taps = int(math.ceil(radius)) * 2 + 1
    m = np.zeros((n_out, n_in))
    for o in range(n_out):
        center = (o + 0.5) * scale - 0.5
        s0 = int(math.floor(center - radius + 0.5))
        x = np.abs((s0 + np.arange(taps) - center) / fs)
        w = np.where(x < 1, (1.5 * x - 2.5) * x * x + 1,
                     np.where(x < 2, (((x - 5) * x + 8) * x - 4) * -0.5, 0.0))
        w = w / w.sum() if w.sum() != 0 else w
        np.add.at(m[o], np.clip(s0 + np.arange(taps), 0, n_in - 1), w)
    return m


def _np_chain(np, px, oh, ow, normalize=True):
    """resize_batch's twin in float64: uint8 [H, W, 3] -> [oh, ow, 3]."""
    from vlaser_tpu_torch.image.tiling import IMAGENET_MEAN, IMAGENET_STD

    my = _np_resize_matrix(np, px.shape[0], oh)
    mx = _np_resize_matrix(np, px.shape[1], ow)
    out = np.tensordot(my, px.astype(np.float64), (1, 0))  # [oh, W, 3]
    out = np.tensordot(mx, out, (1, 1)).transpose(1, 0, 2)  # [oh, ow, 3]
    if normalize:
        out = (out / 255.0 - IMAGENET_MEAN.astype(np.float64)) / (
            IMAGENET_STD.astype(np.float64))
    return out


def _tiles_from_pixels(np, px, size=448, max_num=12):
    """load_image_tiles_native's chain after the decode, on the image-ops
    library: the grid from the pixels' aspect, one resize to it with the
    crop (tile_image), then the thumbnail."""
    from vlaser_tpu_torch.image import native
    from vlaser_tpu_torch.image.tiling import (candidate_ratios,
                                               find_closest_aspect_ratio)

    h, w = px.shape[:2]
    gw, gh = find_closest_aspect_ratio(w / h, candidate_ratios(1, max_num),
                                       w, h, size)
    tiles = native.tile_image(px, (gw, gh), size)
    thumb = native.resize_batch(px[None], (size, size))
    return np.concatenate([tiles, thumb]), (gw, gh)


def native_loader_phase(torch, np, tag, built):
    """Phase 44, the native image loader on this machine: the toolchain and
    the build (`built`, from native_build_job); the image-ops half against
    its float64 numpy twin on each fixture's stored pixels (resize to the
    4:3 fixture's 4 x 3 grid and its thumbnail, normalize, the tile crop;
    control: the pixels flipped left to right); the 4:3 fixture's 13 tiles
    from its pixels, two runs bit-equal. Where libjpeg is present: each
    fixture JPEG decoded at its own size against its stored pixels
    (DECODE_TOL; control flipped), load_image_tiles_native's 13 tiles equal
    to the pixel chain's, bit-equal over two runs and at 1 and 4 loader
    threads; NativeImageLoader over LOADER_JOBS jobs (every id once);
    ConversationDataset(use_native_loader=True) over a JSONL that names the
    fixtures, with PIL never imported. Without libjpeg the JPEG half is not
    built and a line says so. Rates: images/s and ms a 13-tile image. ->
    (the 13 tiles [13, 448, 448, 3] float32, report)."""
    from vlaser_tpu_torch.image import native

    tc = built["toolchain"]
    print(f"native toolchain: {tc['gxx']}; jpeglib.h "
          f"{'present' if tc['jpeglib_h'] else 'absent'}, libjpeg "
          f"{'links' if tc['libjpeg'] else 'absent'}; built image_ops"
          f"{' and the JPEG loader' if built['jpeg'] else ''} in "
          f"{built['seconds']:.1f} s (beside nvcc) -> "
          f"{os.path.dirname(built['image_ops'])} {tag}", flush=True)
    if not built["jpeg"]:
        print("native loader: the JPEG half (dataloader.cpp) is NOT built on "
              "this machine: no jpeglib.h / libjpeg. Phase 44 holds the "
              "image-ops half (resize, normalize, tile) on the fixtures' "
              "stored pixels, which phase 45 chats from", flush=True)
    rep = {"jpeg": built["jpeg"], "build_s": built["seconds"]}
    worst = 0.0
    for name in FIXTURE_NAMES:
        px = np.load(os.path.join(FIXTURES, name + ".npy"))
        h, w = px.shape[:2]
        for oh, ow in ((448, 448), (3 * 448, 4 * 448), (h, w)):
            got = native.resize_batch(px[None], (oh, ow))[0]
            ref = _np_chain(np, px, oh, ow)
            err = float(np.abs(got - ref).max())
            ctrl = float(np.abs(native.resize_batch(
                np.ascontiguousarray(px[:, ::-1])[None], (oh, ow))[0]
                - ref).max())
            worst = max(worst, err)
            if not (err <= RESIZE_TOL < ctrl):
                raise RuntimeError(f"native resize {name} -> {oh}x{ow}: "
                                   f"{err:.3e} (control {ctrl:.3e})")
        norm = native.normalize_batch(px)
        nref = _np_chain(np, px, h, w)  # normalize at the identity resize
        if float(np.abs(norm - nref).max()) > RESIZE_TOL:
            raise RuntimeError(f"native normalize {name} disagrees")
    px = np.load(os.path.join(FIXTURES, "scene_4x3.npy"))
    tiles, grid = _tiles_from_pixels(np, px)
    big = _np_chain(np, px, grid[1] * 448, grid[0] * 448)
    crop = big.reshape(grid[1], 448, grid[0], 448, 3).transpose(
        0, 2, 1, 3, 4).reshape(-1, 448, 448, 3)
    t_err = float(np.abs(tiles[:-1] - crop).max())
    again, _ = _tiles_from_pixels(np, px)
    print(f"native image ops vs their float64 numpy twin on the 3 fixtures' "
          f"pixels (resize to 448 x 448, to the 4 x 3 grid and to their own "
          f"size; normalize): worst {worst:.3e} (bound {RESIZE_TOL}; control "
          f"'pixels flipped' breaks it at every shape); the 4:3 fixture's "
          f"{len(tiles)} tiles (grid {grid[0]} x {grid[1]} + thumbnail) "
          f"{t_err:.3e} from the twin's crop, two runs bit-equal "
          f"{np.array_equal(tiles, again)} {tag}", flush=True)
    if not (tiles.shape == (13, 448, 448, 3) and t_err <= RESIZE_TOL
            and np.array_equal(tiles, again)):
        raise RuntimeError("the native tile chain disagrees")
    rep["resize_err"] = worst

    def rate(fn, reps=5):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    ms_pixels = rate(lambda: _tiles_from_pixels(np, px))
    rep["tiles_from_pixels_ms"] = ms_pixels
    if built["jpeg"]:
        _jpeg_half(np, tiles, rep, tag)
    ms = rep.get("tiles_from_jpeg_ms", ms_pixels)
    print(f"native loader rate: {ms:.2f} ms a 13-tile image ("
          f"{1e3 / ms:.1f} images/s; "
          f"{'JPEG decode included' if built['jpeg'] else 'from decoded pixels, no JPEG decode on this machine'}"
          f"), host threads of the image-ops library {os.cpu_count()} "
          f"{tag}", flush=True)
    return tiles, rep


def _jpeg_half(np, tiles, rep, tag):
    """Phase 44's JPEG half (the machine has libjpeg)."""
    from vlaser_tpu_torch.data import native_loader as nl

    worst, ctrl = 0.0, float("inf")
    for name in FIXTURE_NAMES:
        path = os.path.join(FIXTURES, name + ".jpg")
        want = np.load(os.path.join(FIXTURES, name + ".npy"))
        if nl.probe_jpeg(path) != want.shape[:2]:
            raise RuntimeError(f"probe_jpeg {name}: {nl.probe_jpeg(path)}")
        got = nl.load_image_batch([path], want.shape[:2], normalize=False)[0]
        worst = max(worst, float(np.abs(got - want).max()))
        ctrl = min(ctrl, float(np.abs(got - want[:, ::-1]).max()))
    path = os.path.join(FIXTURES, "scene_4x3.jpg")
    runs = []
    for threads in (4, 4, 1):
        nl._close_shared()
        nl._shared = nl.NativeImageLoader(num_threads=threads)
        runs.append(nl.load_image_tiles_native(path, 448, 1, 12))
    nl._close_shared()
    same = all(np.array_equal(runs[0], r) for r in runs[1:])
    t_err = float(np.abs(runs[0] - tiles).max())
    print(f"native JPEG decode of the 3 fixtures at their own size vs the "
          f"stored pixels: worst {worst:.3f} levels (bound {DECODE_TOL}; "
          f"control 'flipped' {ctrl:.1f}); load_image_tiles_native on the "
          f"4:3 fixture: {runs[0].shape}, two runs and 1 vs 4 threads "
          f"bit-equal {same}, {t_err:.3e} from the pixel chain {tag}",
          flush=True)
    if not (worst <= DECODE_TOL < ctrl and same
            and runs[0].shape == (13, 448, 448, 3)
            and t_err <= DECODE_TOL / 255 / 0.224 * 2):
        raise RuntimeError("the native JPEG decode disagrees")
    loader = nl.NativeImageLoader(num_threads=4, capacity=8)
    paths = [os.path.join(FIXTURES, n + ".jpg") for n in FIXTURE_NAMES]
    t0 = time.perf_counter()
    for i in range(LOADER_JOBS):
        loader.submit(i, paths[i % 3], (448, 448))
    seen = []
    for _ in range(LOADER_JOBS):
        jid, arr = loader.get(timeout_ms=60_000)
        seen.append(jid)
    wall = time.perf_counter() - t0
    loader.close()
    if sorted(seen) != list(range(LOADER_JOBS)):
        raise RuntimeError(f"NativeImageLoader ids {sorted(seen)[:8]}...")
    work = tempfile.mkdtemp(prefix="chip_smoke_jsonl_")
    try:
        import json as _json

        from vlaser_tpu_torch.data.chat_dataset import (ChatDatasetConfig,
                                                        ConversationDataset)
        from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer
        from vlaser_tpu_torch.utils.tools import ensure_special_tokens

        jsonl = os.path.join(work, "d.jsonl")
        with open(jsonl, "w") as f:
            for p in paths:
                f.write(_json.dumps({"image": p, "conversations": [
                    {"from": "human", "value": "<image>\nwhat is this?"},
                    {"from": "gpt", "value": "a fixture"}]}) + "\n")
        tok = ByteTokenizer()
        ensure_special_tokens(tok)
        ds = ConversationDataset(ChatDatasetConfig(
            jsonl_path=jsonl, image_root="", num_image_token=256,
            image_size=448, max_dynamic_patch=12, use_native_loader=True),
            tok)
        shapes = [ds[i]["pixel_values"].shape[0] for i in range(len(ds))]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    pil = "PIL" in sys.modules
    print(f"NativeImageLoader: {LOADER_JOBS} jobs over 4 threads, every id "
          f"once, {LOADER_JOBS / wall:.1f} images/s at 448 x 448; "
          f"ConversationDataset(use_native_loader=True) over the 3 fixtures: "
          f"tiles {shapes}, PIL imported {pil} {tag}", flush=True)
    if pil or shapes[0] != 13:
        raise RuntimeError("the dataset's native route took PIL or "
                           "mis-tiled")
    rep["decode_err"] = worst
    rep["loader_images_s"] = LOADER_JOBS / wall
    nl._shared = None

    def one():
        nl.load_image_tiles_native(path, 448, 1, 12)

    one()
    t0 = time.perf_counter()
    for _ in range(5):
        one()
    rep["tiles_from_jpeg_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    nl._close_shared()


def _moe_oracle(torch, cfg, x, gate, wg, wu, wd):
    """One MoE layer in fp32, independent of models/moe.py's scatter: the
    router in fp32, the capacity applied by a per-expert count over the
    slots in token-major order on the host, then each expert's fp32 MLP over
    the tokens it keeps, added with their weights. -> (y [T, H] fp32,
    slots dropped)."""
    import torch.nn.functional as F

    xt = x.reshape(-1, x.shape[-1]).float()
    T, E, k = xt.shape[0], cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(xt @ gate.float(), -1)
    w, e = probs.topk(k, -1)
    if cfg.norm_topk_prob:
        w = w / w.sum(-1, keepdim=True)
    C = T if cfg.moe_capacity_factor is None else min(
        max(k, int(cfg.moe_capacity_factor * T * k / E)), T)
    flat = e.reshape(-1).cpu().numpy()
    count = [0] * E
    keep = []
    for s_, ex in enumerate(flat.tolist()):
        keep.append(count[ex] < C)
        count[ex] += 1
    keep_t = torch.tensor(keep, device=x.device)
    y = torch.zeros_like(xt)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    wf = w.reshape(-1)
    ef = e.reshape(-1)
    for ex in range(E):
        sel = ((ef == ex) & keep_t).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        xs = xt[tok[sel]]
        h = F.silu(xs @ wg[ex].float()) * (xs @ wu[ex].float())
        y.index_add_(0, tok[sel], (h @ wd[ex].float()) * wf[sel, None])
    return y, len(keep) - sum(keep)


def moe_layer_gate(torch, cfg, x, w, tag):
    """Phase 45's MoE layer gate at the prefill's T: moe_forward (bf16, on
    the card) against _moe_oracle (fp32), MOE_REL x max |oracle|; controls
    (renormalization dropped, capacity ignored, expert 0's weights swapped
    with expert 1's) must break it. -> report."""
    import dataclasses as dc

    from vlaser_tpu_torch.models import moe

    gate, wg, wu, wd = w
    y = moe.moe_forward(cfg, x, gate, wg, wu, wd, torch.bfloat16)[0]
    ref, dropped = _moe_oracle(torch, cfg, x, *w)
    ref_max = ref.abs().max().item()
    rel = lambda a: (a.reshape(ref.shape).float() - ref).abs().max().item() \
        / ref_max
    err = rel(y)
    swap = lambda t: torch.cat([t[1:2], t[0:1], t[2:]])
    ctrls = {
        "renormalization dropped": rel(moe.moe_forward(
            dc.replace(cfg, norm_topk_prob=False), x, *w,
            torch.bfloat16)[0]),
        "capacity ignored": rel(moe.moe_forward(
            dc.replace(cfg, moe_capacity_factor=None), x, *w,
            torch.bfloat16)[0]),
        "experts 0 and 1 swapped": rel(moe.moe_forward(
            cfg, x, gate, swap(wg), swap(wu), swap(wd), torch.bfloat16)[0])}
    T = x.shape[0] * x.shape[1]
    slots = T * cfg.num_experts_per_tok
    print(f"MoE layer 0 at the prefill's T = {T} (C = "
          f"{moe.capacity(cfg, T)} a expert of an expected "
          f"{slots / cfg.num_experts:.1f}): bf16 on the card vs the fp32 "
          f"slot-count oracle {err:.3e} x max |oracle| (bound {MOE_REL}); "
          f"slots dropped {dropped} of {slots} ({dropped / slots:.2%}); "
          f"controls (must exceed the bound): "
          f"{ {k: round(v, 4) for k, v in ctrls.items()} } {tag}", flush=True)
    if not (err <= MOE_REL and min(ctrls.values()) > MOE_REL and dropped > 0
            and bool(y.isfinite().all())):
        raise RuntimeError("the MoE layer disagrees with its oracle")
    return {"rel": err, "dropped": dropped, "slots": slots, "T": T,
            "controls": ctrls}


def _teacher_forced(torch, model, ids, seg, tiles, stream, new):
    """The cached decode (the model's prefill, then one decode_step a
    token of `stream`) against one full forward over the prompt and the
    stream: -> (worst step's max |a - b| / max |b|, steps whose greedy
    tokens differ with their top-2 margins and bounds, the first such
    step or None)."""
    from vlaser_tpu_torch.inference.kv_cache import KVCache

    llm = model.cfg.llm
    n_valid = int(seg.sum())
    with torch.inference_mode():
        full_ids = torch.cat([ids[:, :n_valid], stream[:, :new - 1]], 1)
        full = model(full_ids, tiles, None)[0][0, n_valid - 1:]
        cache = KVCache.create(llm.num_layers, 1, ids.shape[1] + new,
                               llm.num_kv_heads, llm.head_dim,
                               torch.bfloat16, ids.device)
        logits, _, cache = model.prefill(ids, tiles, seg, cache)
        rows = [logits[0, n_valid - 1]]
        del logits
        for t in range(new - 1):
            lg, _, cache = model.decode_step(
                stream[:, t:t + 1], cache,
                torch.tensor([[n_valid + t]], device=ids.device))
            rows.append(lg[0, 0])
        got = torch.stack(rows).float()
        full = full.float()
    worst, flips = 0.0, []
    for t in range(new):
        worst = max(worst, ((got[t] - full[t]).abs().max()
                            / full[t].abs().max()).item())
        if got[t].argmax() != full[t].argmax():
            flips.append((t,) + _margin(full[t]))
    return worst, flips


def moe_chat_phase(torch, np, dev, tag, extra, tiles_np):
    """Phase 45, InternVL3.5-30B-A3B (InternViT-300M + Qwen3-30B-A3B: 48
    layers, 32 / 4 heads x 128, 128 experts top-8 of 768, capacity factor
    1.25) at full width and MOE_LAYERS of its 48 layers (the script's
    time limit), built on the card in bf16 from
    random_init_'s draws with the q/k kernels x QK_GAIN (phase 43's),
    quantize_for_serving defaults (vlm, w8a8: the attention, embedding, head
    and ViT int8; the router and experts bf16, as in JAX). VlaserChat on
    phase 44's 13 tiles: the route (the plain generator), 3 counted chats
    of CHAT_NEW tokens (launches held to the derived counts: flash,
    _rms_fwd, quantize_rows and int8_gemm; no silu-mul and no fused stack),
    then MOE_NEW tokens; the
    stage split; decode tok/s beside its bounds (every expert read, the
    routed experts read); the MoE layer's ms at the prefill's T and at T 1;
    peak memory. Gates: moe_layer_gate at the prefill's T; the cached
    decode against the full forward over MOE_NEW teacher-forced tokens at
    capacity None (greedy tokens equal, or apart at a near-tie within
    DECODE_REL; logits within PREFILL_REL) and at 1.25 (the first
    divergence printed: the reference's rule); the kernels at the prefill's
    shapes (flash at 32 / 4 x 128, the 4 attention GEMMs and their
    quantizer, _rms_fwd at the layer and q/k norm rows) against their plain
    versions with controls; then, on the same int8 weights computing in
    fp32 at capacity None, EngineChat.chat_many over ENGINE_MOE_MSGS equal
    to the plain generator's streams. No profiler. -> launches of the
    chat calls and the engine's run."""
    import dataclasses as dc

    from vlaser_tpu_torch.core.config import internvl3_5_30b_a3b
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.inference.chat import VlaserChat
    from vlaser_tpu_torch.inference.kv_cache import KVCache
    from vlaser_tpu_torch.inference.sampling import make_generate_fn
    from vlaser_tpu_torch.models import moe
    from vlaser_tpu_torch.serve.engine_chat import EngineChat
    from vlaser_tpu_torch.tokenizer.conversation import build_chat_query

    gc.collect()
    torch.cuda.empty_cache()
    print(f"before the 30B build: {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
          f"reserved {tag}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = _cut_depth(internvl3_5_30b_a3b(), MOE_LAYERS)
    llm, L = cfg.llm, cfg.llm.num_layers
    model = quantize_for_serving(_qwen3_model(torch, dev, cfg,
                                              torch.bfloat16))
    torch.cuda.synchronize()
    n_param = sum(t.numel() for t in model.state_dict().values())
    mlp = model.language_model.model.layers.mlp
    tok = ChatStubTokenizer(cfg.img_context_token_id)
    chat = VlaserChat(model, tok, max_new_tokens=CHAT_NEW)
    try:
        VlaserChat(model, tok, max_new_tokens=CHAT_NEW, use_fused=True)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    print(f"InternVL3.5-30B-A3B chat model ({L} of 48 LLM layers, "
          f"MOE_LAYERS: the script's time limit): "
          f"{n_param / 1e9:.3f} G elements, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, built "
          f"and quantized in {time.perf_counter() - t0:.1f} s; experts "
          f"{mlp.experts_gate_proj.dtype}; VlaserChat route {chat.route}; "
          f"use_fused=True refused: {refused is not None} {tag}", flush=True)
    if chat.route != "plain" or refused is None:
        raise RuntimeError("the MoE chat took or offered the fused runner")
    tiles = torch.from_numpy(tiles_np).to(dev)
    question = "What is shown in this image?"
    query = build_chat_query(cfg.template, "<image>\n" + question,
                             [len(tiles_np)], cfg.num_image_token)
    ids, seg = chat._encode([query])
    n, n_valid = ids.shape[1], int(seg.sum())
    with torch.inference_mode():
        got, times, r, first = _counted_calls(
            torch, lambda: chat.chat(question, tiles),
            f"InternVL3.5-30B-A3B chat (plain generator), {len(tiles_np)} "
            f"tiles of a fixture JPEG's pixels, prompt {n_valid} tokens in a "
            f"bucket of {n}, {CHAT_NEW} new tokens", tag)
    # derived from the code: the ViT's layer loop (13 x 1,025 rows) takes
    # flash and 4 w8a8 Dense a layer, each quantizing its own input; an LLM
    # layer at the prefill's rows takes flash, q/k/v on one quantization and
    # o on another, and _rms_fwd for its 2 norms and the q/k norms (>= 2,048
    # rows), plus the final norm; the MoE layer and the 1-row decode steps
    # launch none (no silu-mul, no fused stack)
    Lv = cfg.vision.num_layers
    want = {k: STEPS * v for k, v in (
        ("flash_attention_fwd", Lv + L), ("quantize_rows", 4 * Lv + 2 * L),
        ("int8_gemm", 4 * Lv + 4 * L), ("_rms_fwd", 4 * L + 1))}
    print(f"InternVL3.5-30B-A3B chat launches derived {want} {tag}",
          flush=True)
    if got != want or r != first:
        raise RuntimeError(f"InternVL3.5-30B-A3B chat launches {got}")
    launches = dict(got)
    long_chat = VlaserChat(model, tok, max_new_tokens=MOE_NEW)
    with torch.inference_mode():
        long_ms = _ms(torch, lambda: long_chat.chat(question, tiles), 1)
        vit_ms = _ms(torch, lambda: model.extract_feature(tiles), 3)
        prefill_ms = _ms(torch, lambda: model.prefill(ids, tiles, seg, (
            KVCache.create(L, 1, n + CHAT_NEW, llm.num_kv_heads,
                           llm.head_dim, torch.bfloat16, dev))), 3)
    chat_ms = statistics.median(times)
    tok_ms = (long_ms - chat_ms) / (MOE_NEW - CHAT_NEW)

    # -- the MoE layer at the prefill's T and at T 1, and its gate ----------
    seen = []
    hook = mlp.register_forward_hook(
        lambda m, a, o: seen.append(a[0]) if a[1] == 0 and not seen else None)
    gen = make_generate_fn(model, max_new_tokens=MOE_NEW,
                           eos_token_ids=[llm.vocab_size], pad_token_id=0)
    try:
        with torch.inference_mode():
            stream, _ = gen(ids, seg, tiles)
    finally:
        hook.remove()
    x = seen[0]
    w = tuple(t[0] for t in (mlp.gate, mlp.experts_gate_proj,
                             mlp.experts_up_proj, mlp.experts_down_proj))
    with torch.inference_mode():
        gate_rep = moe_layer_gate(torch, llm, x, w, tag)
        layer_ms = _kernel_ms(torch, lambda: moe.moe_forward(
            llm, x, *w, torch.bfloat16), 5)
        x1 = x[:, :1].contiguous()
        layer1_ms = _kernel_ms(torch, lambda: moe.moe_forward(
            llm, x1, *w, torch.bfloat16), 20)
    del x, seen
    expert_b = 3 * llm.hidden_size * llm.moe_intermediate_size * 2
    all_b = L * llm.num_experts * expert_b
    active_b = L * llm.num_experts_per_tok * expert_b
    fixed_b = (L * (2 * llm.hidden_size * (llm.q_dim + llm.kv_dim)
                    + llm.hidden_size * llm.num_experts * 2)
               + llm.hidden_size * llm.vocab_size)  # int8 attention + head
    b_all = (all_b + fixed_b) / PEAK_BYTES * 1e3
    b_act = (active_b + fixed_b) / PEAK_BYTES * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"InternVL3.5-30B-A3B chat: {chat_ms:.1f} ms (median of "
          f"{STEPS}, {CHAT_NEW} tokens), {long_ms:.1f} ms with {MOE_NEW}; "
          f"stages, each timed alone: ViT (13 tiles, the layer loop, w8a8) "
          f"{vit_ms:.1f} ms, prefill with the ViT ({n} rows) "
          f"{prefill_ms:.1f} ms; decode {tok_ms:.2f} ms a token (the two "
          f"chats' difference over {MOE_NEW - CHAT_NEW} tokens) ({1e3 / tok_ms:.1f} tok/s) against the bounds "
          f"{b_all:.2f} ms with every expert read ({(all_b + fixed_b) / 1e9:.1f}"
          f" GB a token, as the dispatch runs all {llm.num_experts}) and "
          f"{b_act:.2f} ms with the {llm.num_experts_per_tok} routed ones "
          f"({(active_b + fixed_b) / 1e9:.2f} GB); one MoE layer {layer_ms:.3f}"
          f" ms at T = {gate_rep['T']}, {layer1_ms:.3f} ms at T = 1 "
          f"(bound {all_b / L / PEAK_BYTES * 1e3:.3f} ms: its "
          f"{all_b / L / 1e9:.2f} GB of experts); peak device memory "
          f"{peak:.2f} GiB {tag}", flush=True)

    # -- the cached decode against the full forward, at None and at 1.25 ---
    res = {}
    for cap in (None, llm.moe_capacity_factor):
        mlp.cfg = dc.replace(llm, moe_capacity_factor=cap)
        res[cap] = _teacher_forced(torch, model, ids, seg, tiles, stream,
                                   MOE_NEW)
    mlp.cfg = llm
    worst, flips = res[None]
    near = all(m <= b for _, m, b in flips)
    w125, f125 = res[llm.moe_capacity_factor]
    print(f"cached decode vs one full forward, teacher-forced over "
          f"{MOE_NEW} tokens: capacity None: worst step {worst:.3e} x max "
          f"|logits| (bound PREFILL_REL {PREFILL_REL}), greedy tokens apart "
          f"at {len(flips)} steps {[t for t, _, _ in flips]}, each a "
          f"near-tie within DECODE_REL: {near}; capacity 1.25 (the named "
          f"config, the reference's rule): worst step {w125:.3e}, first "
          f"divergence of the greedy tokens at step "
          f"{f125[0][0] if f125 else None} (of {len(f125)}) {tag}",
          flush=True)
    if not (worst <= PREFILL_REL and near):
        raise RuntimeError("the MoE cached decode leaves the full forward")

    # -- the kernels at the prefill's shapes --------------------------------
    lay = model.language_model.model.layers
    att = lay.self_attn
    sites = (("q_proj", att.q_proj), ("k_proj", att.k_proj),
             ("v_proj", att.v_proj), ("o_proj", att.o_proj))
    (k1, k2, _), = gemm_phase(torch, sites, (n,), dev, tag,
                              silu_mul=False).values()
    extra["quantize_rows"]["internvl35_30b_prefill"] = k1
    extra["int8_gemm"]["internvl35_30b_prefill"] = k2
    g = torch.Generator(device=dev).manual_seed(45)
    extra["_rms_fwd"]["internvl35_30b_qk_norm"] = rms_serving(
        torch, g, dev, n * llm.num_heads, llm.head_dim, llm.rms_norm_eps,
        "Qwen3-30B-A3B q_norm over 32 heads a row", tag)
    extra["_rms_fwd"]["internvl35_30b_prefill"] = rms_serving(
        torch, g, dev, n, llm.hidden_size, llm.rms_norm_eps,
        "Qwen3-30B-A3B prefill", tag)
    extra["flash_attention_fwd"]["internvl35_30b_prefill"] = \
        flash_prefill_phase(torch, dev, llm, n_valid, n, n + CHAT_NEW, tag)
    del chat, long_chat, gen, model, stream, lay, att, sites, mlp, w, x1
    gc.collect()
    torch.cuda.empty_cache()

    # -- EngineChat against the plain generator at fp32 compute and cache
    # (phase 43's setting), capacity None, on the same int8 weights --------
    cfg0 = dc.replace(cfg, llm=dc.replace(llm, moe_capacity_factor=None))
    model = quantize_for_serving(_qwen3_model(torch, dev, cfg0,
                                              torch.float32))
    rng = np.random.default_rng(45)
    words = ("pick", "place", "the", "red", "block", "on", "cup", "left")
    items = []
    for chars, new in ENGINE_MOE_MSGS:
        text = ""
        while len(text) < chars:
            text += words[rng.integers(len(words))] + " "
        items.append((text[:chars], None, None, None, new))
    eng = EngineChat(model, tok, max_new_tokens=max(m[1] for m in
                                                    ENGINE_MOE_MSGS),
                     num_slots=4, max_len=512, cache_dtype=torch.float32)
    _zero_counts()
    w0 = time.perf_counter()
    with torch.inference_mode():
        answers = eng.chat_many(items)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    _add(launches, {k: v for k, v in _read_counts().items() if v})
    apart = []
    for (text, _, _, _, new), a in zip(items, answers):
        plain = VlaserChat(model, tok, max_new_tokens=new,
                           cache_dtype=torch.float32)
        with torch.inference_mode():
            b = plain.chat(text, None)
        if a != b:
            apart.append((len(text), a[:40], b[:40]))
    print(f"InternVL3.5-30B-A3B EngineChat.chat_many (fp32 compute and cache,"
          f" capacity None): {len(items)} items in {wall:.2f} s wall; "
          f"{len(items) - len(apart)} equal to the plain generator token for "
          f"token {tag}", flush=True)
    if apart:
        raise RuntimeError(f"EngineChat's greedy streams leave the plain "
                           f"generator's: {apart}")
    del eng, model, tiles
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- the VLA's text head, adaLN-Zero with vision-in-expert, InternViT-6B and
# the graft entry: phases 46-49 ---------------------------------------------
TEXT_NEW = 32  # phase 46: infer_text's new tokens
TEXT_TAIL = 3  # phase 46: row r's prompt holds 44 - 3 r text tokens
# phase 46: the kernel route vs the dispatch route, x max |logits|: on the
# bf16 tree the two part by 2.0-3.0% (an H100 80GB HBM3 at 700 W); on the
# w8a8 tree the int8 activations after them take it to 7.8-9.9%
TEXT_ROUTE_REL = {"bf16": 0.1, "w8a8": PREFILL_REL}
# phase 46: the w8a8 tree's cached logits (weight-only decode rows) vs
# forward_vlm's (w8a8 rows), x max |forward_vlm logits|: they part by
# 6.7-7.2% (an H100 80GB HBM3 at 700 W), the cached route with causality
# dropped by 23%
W8A8_STREAM_REL = 0.12
ADA_B = 32  # phase 47: the train batch (cut on out-of-memory, printed)
# phases 46-47: the LLM layers of both mixtures (of 28; full width). The
# script outgrew its time limit's budget with phase 58 (1,177.2 s of
# 1,200 on an H100 80GB HBM3 whose host built the kernels in 145.7 s);
# their gates were calibrated at 28 layers, where bf16 noise through
# more random layers parts correct routes further
ABLATION_LAYERS = 8
VIT6B_TILES = 13
BETA_DRAWS = 100_000
KS_CRIT = 1.95  # Kolmogorov-Smirnov: sqrt(n) D below this at the 0.1% level


def _auto_flash(b, sq, skv, h):
    """kernels/flash_attention.attention_fn's "auto" rule on the card."""
    from vlaser_tpu_torch.kernels import flash_attention as fa

    return sq >= fa.SQ_MIN or b * h * sq * skv * 4 > fa.LOGITS_BYTES_MIN


def _w8a8_want(rows_layers):
    """Launches of the w8a8 route over (rows, ViT layers, mixture layers)
    call sites: a ViT layer's 4 Dense quantize their own rows (4
    quantize_rows, 4 int8_gemm); a mixture layer shares q/k/v's and
    gate/up's rows and quantizes silu(g) * u in one kernel (3 quantize_rows,
    1 quantize_silu_mul, 7 int8_gemm); only sites of at least
    ACT_QUANT_MIN_ROWS rows."""
    from vlaser_tpu_torch.models.layers import ACT_QUANT_MIN_ROWS

    want = {"quantize_rows": 0, "quantize_silu_mul": 0, "int8_gemm": 0}
    for rows, vit, mix in rows_layers:
        if rows >= ACT_QUANT_MIN_ROWS:
            want["quantize_rows"] += 4 * vit + 3 * mix
            want["quantize_silu_mul"] += mix
            want["int8_gemm"] += 4 * vit + 7 * mix
    return want


def _text_batch(torch, dev, cfg, B, seed):
    """B right-padded prompts of cfg.max_image_text_tokens slots: the
    num_image_token image slots first, then row r's 44 - TEXT_TAIL r text
    tokens (the JAX entry's layout: 300 of 384 slots valid in row 0); one
    tile a row. -> (ids, pixels, mask)."""
    S, n_img = cfg.max_image_text_tokens, cfg.vlm.num_image_token
    img = cfg.vlm.vision.image_size
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ids = torch.full((B, S), cfg.vlm.pad_token_id, dtype=torch.long,
                     device=dev)
    ids[:, :n_img] = cfg.vlm.img_context_token_id
    mask = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for r in range(B):
        n = n_img + 44 - TEXT_TAIL * r
        ids[r, n_img:n] = torch.randint(100, 1100, (n - n_img,), generator=g,
                                        device=dev)
        mask[r, :n] = 1
    return ids, torch.rand((B, img, img, 3), generator=g, device=dev), mask


def _cached_text_logits(torch, model, ids, px, mask, stream):
    """infer_text's computation teacher-forced on `stream` [B, NEW]: the
    prefill's logits, then text_step's on stream[:, i] for i < NEW - 1.
    -> [B, NEW, vocab] fp32."""
    new = stream.shape[1]
    with torch.inference_mode():
        logits, state = model.text_prefill(ids, px, mask, new)
        rows = [logits]
        for i in range(new - 1):
            rows.append(model.text_step(stream[:, i], i, state))
        return torch.stack(rows, 1)


def _forced_stream(torch, model, ids, px, mask, stream):
    """forward_vlm over each row's valid prompt tokens followed by `stream`
    (right-padded to one length): -> the logits [B, NEW, vocab] fp32 at the
    positions that predict the stream's tokens."""
    b, new = stream.shape
    n = mask.sum(1)
    full = torch.full((b, ids.shape[1] + new), 0, dtype=ids.dtype,
                      device=ids.device)
    fmask = torch.zeros_like(full, dtype=torch.int32)
    for r in range(b):
        k = int(n[r])
        full[r, :k], full[r, k:k + new] = ids[r, :k], stream[r]
        fmask[r, :k + new] = 1
    with torch.inference_mode():
        logits = model.forward_vlm(full, px, fmask)
    idx = (n[:, None] - 1 + torch.arange(new, device=ids.device)[None])
    return logits[torch.arange(b, device=ids.device)[:, None], idx]


@contextmanager
def _joint_attention(torch, **over):
    """Within: the joint stack's attention built with `over` forced (a
    control: causal=False, or segments all ones)."""
    from vlaser_tpu_torch.policy import joint

    orig = joint.attention_fn

    def forced(*a, **kw):
        if over.get("segments") == "ones":
            kw["q_segment_ids"] = None
            kw["kv_segment_ids"] = None
        if "causal" in over:
            kw["causal"] = over["causal"]
        return orig(*a, **kw)

    joint.attention_fn = forced
    try:
        yield
    finally:
        joint.attention_fn = orig


def _stream_gate(torch, what, stream, forced, tag):
    """The cached greedy stream against the argmax of the teacher-forced
    logits: a token may differ only where the forced top-2 margin is within
    DECODE_REL x max |logits| (a near-tie). -> tokens compared."""
    checked, bad = 0, []
    for r in range(stream.shape[0]):
        for i in range(stream.shape[1]):
            row = forced[r, i]
            margin, bound = _margin(row)
            if margin > bound:
                checked += 1
            if int(row.argmax()) != int(stream[r, i]) and margin > bound:
                bad.append((r, i, margin, bound))
    print(f"{what}: cached greedy stream vs teacher-forced forward_vlm "
          f"argmax: {checked} of {stream.numel()} tokens outside a near-tie, "
          f"{len(bad)} of them differ {tag}", flush=True)
    if bad:
        raise RuntimeError(f"{what}: the cached stream differs from "
                           f"forward_vlm outside a near-tie: {bad[:4]}")
    return checked


def _w8a8_stream_gate(torch, model, what, ids, px, mask, stream, forced,
                      tag, controls):
    """The w8a8 tree's cached greedy stream. Its decode rows (B a step)
    take the Dense's weight-only route and forward_vlm's rows the int8-
    activation one (two quantizations, as in JAX), so the oracle is
    bounded, not argmax-equal: the logits of the stream's own computation
    teacher-forced on it (_cached_text_logits) must give the stream as
    their argmax (near-ties within DECODE_REL aside) and lie within
    W8A8_STREAM_REL x max |forced| of forward_vlm's (`forced`); a token may
    leave forward_vlm's argmax only where forward_vlm's top-2 margin is
    within twice that token's largest logit difference. Controls (causal
    dropped, padding segments ignored, in the cached computation) must
    break the bound. -> the largest difference over the bound."""
    cached = _cached_text_logits(torch, model, ids, px, mask, stream)
    bound = W8A8_STREAM_REL * forced.abs().max().item()
    diff = (cached - forced).abs().amax(-1)  # [B, NEW]
    err = diff.max().item()
    wiring, apart, checked = [], [], 0
    for r in range(stream.shape[0]):
        for i in range(stream.shape[1]):
            c, f, tok = cached[r, i], forced[r, i], int(stream[r, i])
            margin, tie = _margin(c)
            if int(c.argmax()) != tok and margin > tie:
                wiring.append((r, i))
            top2 = f.float().topk(2).values
            m_f, d = (top2[0] - top2[1]).item(), diff[r, i].item()
            if m_f > 2 * d:
                checked += 1
                if int(f.argmax()) != tok:
                    apart.append((r, i, m_f, d))
    print(f"{what}: the cached stream is its teacher-forced logits' argmax "
          f"at all but {len(wiring)} tokens outside a near-tie; those logits "
          f"vs forward_vlm's: max_abs_err {err:.4g} (bound {bound:.4g}, "
          f"{W8A8_STREAM_REL} x max |logits|); {checked} of {stream.numel()} "
          f"tokens' forward_vlm margin beyond twice their difference, "
          f"{len(apart)} of them leave forward_vlm's argmax {tag}",
          flush=True)
    if wiring or apart or not (err <= bound and cached.isfinite().all()):
        raise RuntimeError(f"{what}: the w8a8 cached stream leaves its "
                           f"oracles: {wiring[:4]} {apart[:4]} {err:.4g}")
    if controls:
        for name, over in (("causal dropped", dict(causal=False)),
                           ("padding segments ignored",
                            dict(segments="ones"))):
            with _joint_attention(torch, **over):
                c = _cached_text_logits(torch, model, ids, px, mask, stream)
            ratio = (c - forced).abs().max().item() / bound
            print(f"  control '{name}': {ratio:.2f} x the bound (must "
                  f"exceed 1)", flush=True)
            if not ratio > 1:
                raise RuntimeError(f"{what}: the bound cannot see '{name}'")
    return err / bound


def _route_gate(torch, model, what, ids, px, mask, stream, tag, rel,
                controls=True):
    """The forced kernel route (flash fwd in the ViT, at the prefill and at
    every one-row decode step, scalar q_offset) against the dispatch route
    (the eager reference at these sizes, as in JAX) on the teacher-forced
    cached logits and on forward_vlm's valid rows: max |kernel - dispatch|
    within rel x max |dispatch| (two bf16 routes through the ViT and 28
    random layers part by a few % of max, more where int8 activations
    follow them: the flash kernel itself is held tightly at these shapes by
    _flash_case); controls (causal dropped, padding segments ignored) must
    break one of the two bounds."""
    def run():
        with torch.inference_mode():
            return (_cached_text_logits(torch, model, ids, px, mask, stream),
                    model.forward_vlm(ids, px, mask)[mask.bool()])

    ref = run()
    model.set_attn_impl("kernel")
    try:
        got = run()
        ctrl = {}
        if controls:
            for name, over in (("causal dropped", dict(causal=False)),
                               ("padding segments ignored",
                                dict(segments="ones"))):
                with _joint_attention(torch, **over):
                    ctrl[name] = run()
    finally:
        model.set_attn_impl("auto")
    bounds = [rel * r.abs().max().item() for r in ref]
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    print(f"{what}: kernel route vs dispatch: cached logits max_abs_err "
          f"{errs[0]:.4g} (bound {bounds[0]:.4g}), forward_vlm "
          f"{errs[1]:.4g} (bound {bounds[1]:.4g}) {tag}", flush=True)
    if not (all(e <= b for e, b in zip(errs, bounds))
            and all(g.isfinite().all() for g in got)):
        raise RuntimeError(f"{what}: the kernel route disagrees")
    for name, c in ctrl.items():
        ratio = max((x - r).abs().max().item() / b
                    for x, r, b in zip(c, ref, bounds))
        print(f"  control '{name}': {ratio:.2f} x the bound (must exceed "
              f"1)", flush=True)
        if not ratio > 1:
            raise RuntimeError(f"{what}: the bound cannot see '{name}'")
    return max(e / b for e, b in zip(errs, bounds))


def vla_text_phase(torch, np, dev, tag, extra):
    """Phase 46, the VLA's text head at full width: Vlaser-2B-VLA with
    use_lm_head (ABLATION_LAYERS of its 28 layers x 1,536, a 151,930-row
    head), random_init_'s
    draws; forward_vlm and infer_text (TEXT_NEW greedy tokens, no EOS) at
    batch 1 and 8 over right-padded 384-slot prompts (256 image slots),
    first on the bf16 tree, then on quantize_for_serving(target="policy")'s
    w8a8 tree (the head stays bf16). Gates: the cached stream against
    teacher-forced forward_vlm (near-ties only on the bf16 tree; on the
    w8a8 tree _w8a8_stream_gate, controls at batch 8), the forced kernel
    route against the dispatch route on each (TEXT_ROUTE_REL; controls on
    the bf16 tree at batch 8); the w8a8 tree's ViT GEMMs and quantizer
    against the plain versions at both batches' rows (gemm_phase). The main path: infer_text on the w8a8 tree under the forced kernel
    route, counted from 0 and held to the derived counts. Flash at the
    prefill and decode shapes against the plain version (_flash_case).
    -> launches of the main path."""
    import dataclasses

    from vlaser_tpu_torch.core.config import vlaser_2b_vla
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.scripts.train_sft import random_init_

    from vlaser_tpu_torch.kernels import rmsnorm

    t0 = time.perf_counter()
    cfg = dataclasses.replace(_cut_depth(vlaser_2b_vla(), ABLATION_LAYERS),
                              use_lm_head=True)
    llm, S = cfg.vlm.llm, cfg.max_image_text_tokens
    L, n_vit = llm.num_layers, cfg.vlm.vision.num_layers
    s_vit = cfg.vlm.vision.seq_len
    bf = torch.bfloat16
    model = PiZeroVLA(cfg, param_dtype=bf, compute_dtype=bf, device=dev)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(46)
    random_init_(model, gen)
    print(f"VLA text head model: Vlaser-2B-VLA at {L} of 28 layers "
          f"(ABLATION_LAYERS: the script's time limit) + lm_head "
          f"{tuple(model.lm_head.kernel.shape)}, bf16, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    batches = {B: _text_batch(torch, dev, cfg, B, 46 + B) for B in (1, B8)}
    launches, rep = {}, {}
    for tree in ("bf16", "w8a8"):
        if tree == "w8a8":
            quantize_for_serving(model, target="policy")
            # the quantized ViT's 4 Dense at the B 1 and B 8 tiles' rows
            # (phase 47's two towers run the B 1 shapes)
            enc = model.vision_model.encoder
            vit_sites = (("qkv", enc.attn.qkv), ("proj", enc.attn.proj),
                         ("fc1", enc.mlp.fc1), ("fc2", enc.mlp.fc2))
            for rows, (k1, k2, _) in gemm_phase(
                    torch, vit_sites, (s_vit, B8 * s_vit), dev, tag,
                    silu_mul=False,
                    quant_sites=[n for n, _ in vit_sites]).items():
                extra["quantize_rows"][f"vla_text_vit_{rows}"] = k1
                extra["int8_gemm"][f"vla_text_vit_{rows}"] = k2
        for B, (ids, px, mask) in batches.items():
            what = f"VLA text {tree} B={B}"
            with torch.inference_mode():
                stream = model.infer_text(ids, px, mask, TEXT_NEW,
                                          eos_token_id=-1)
            forced = _forced_stream(torch, model, ids, px, mask, stream)
            if tree == "bf16":
                _stream_gate(torch, what, stream, forced, tag)
            else:
                rep[f"w8a8_b{B}_stream_err_over_bound"] = _w8a8_stream_gate(
                    torch, model, what, ids, px, mask, stream, forced, tag,
                    controls=(B == B8))
            del forced
            ratio = _route_gate(torch, model, what, ids, px, mask, stream,
                                tag, TEXT_ROUTE_REL[tree],
                                controls=(tree == "bf16" and B == B8))
            rep[f"{tree}_b{B}_route_err_over_bound"] = ratio
            if tree != "w8a8":
                continue
            # the main path: the forced kernel route, counted from 0
            model.set_attn_impl("kernel")
            try:
                run = lambda: model.infer_text(ids, px, mask, TEXT_NEW,
                                               eos_token_id=-1)
                got, times, out, _ = _counted_calls(
                    torch, run, f"{what} infer_text (kernel route)", tag)
                if not torch.equal(out, stream):
                    print(f"  {what}: the kernel route's stream differs "
                          f"from the dispatch route's at "
                          f"{int((out != stream).sum())} tokens "
                          f"(held by the route gate above)", flush=True)
                # the forced route: every attention is flash (the ViT's,
                # the prefill's and each decode step's); the prefill's rows
                # take w8a8 and RMSNorm by their thresholds, the decode
                # rows (B) neither
                want = {"flash_attention_fwd": n_vit + L * TEXT_NEW,
                        **_w8a8_want([(B * s_vit, n_vit, 0),
                                      (B * S, 0, L)])}
                vc = cfg.vlm.vision
                want["_rms_fwd"] = (
                    (2 * L + 1) * (B * S >= rmsnorm.MIN_ROWS)
                    + 2 * n_vit * (vc.qk_normalization  # not the 300M's
                                   and B * s_vit >= rmsnorm.MIN_ROWS
                                   and vc.hidden_size <= rmsnorm.MAX_HIDDEN))
                want = {k: STEPS * v for k, v in want.items() if v}
                print(f"  derived {want}", flush=True)
                if got != want:
                    raise RuntimeError(f"{what} launches {got} != {want}")
                _add(launches, got)
                torch.cuda.reset_peak_memory_stats()
                with torch.inference_mode():
                    pre_ms = _ms(torch, lambda: model.infer_text(
                        ids, px, mask, 1, eos_token_id=-1), 3)
                    # warm from the counted calls: one timed call
                    all_ms = _ms(torch, run, 1, warmup=0)
                peak = torch.cuda.max_memory_allocated() / 2**30
            finally:
                model.set_attn_impl("auto")
            tok_ms = (all_ms - pre_ms) / (TEXT_NEW - 1)
            rep[f"w8a8_b{B}"] = dict(prefill_ms=pre_ms, token_ms=tok_ms,
                                     tok_s=1e3 * B * TEXT_NEW / all_ms,
                                     peak_gib=peak)
            print(f"{what} (kernel route, CUDA events): prefill + first "
                  f"token {pre_ms:.2f} ms, {tok_ms:.3f} ms a token, "
                  f"infer_text {all_ms:.1f} ms -> "
                  f"{1e3 * B * TEXT_NEW / all_ms:.1f} tok/s ({B} x "
                  f"{TEXT_NEW}); peak device memory {peak:.2f} GiB {tag}",
                  flush=True)
        if tree == "bf16":
            ids, px, mask = batches[B8]
            with torch.inference_mode():
                run = lambda: model.infer_text(ids, px, mask, TEXT_NEW,
                                               eos_token_id=-1)
                pre_ms = _ms(torch, lambda: model.infer_text(
                    ids, px, mask, 1, eos_token_id=-1), 3)
                all_ms = _ms(torch, run, 3)
            rep["bf16_b8"] = dict(prefill_ms=pre_ms,
                                  token_ms=(all_ms - pre_ms) / (TEXT_NEW - 1),
                                  tok_s=1e3 * B8 * TEXT_NEW / all_ms)
            print(f"VLA text bf16 B={B8} (dispatch route, CUDA events): "
                  f"prefill + first token {pre_ms:.2f} ms, "
                  f"{rep['bf16_b8']['token_ms']:.3f} ms a token, "
                  f"{rep['bf16_b8']['tok_s']:.1f} tok/s {tag}", flush=True)
    del model, batches
    gc.collect()
    torch.cuda.empty_cache()
    # flash at the text head's shapes: the batch-8 prefill (causal over the
    # 416-slot buffer, the padded tails and the decode slots masked) and
    # one decode row at slot S + NEW / 2 (a group of 6 q heads a kv head
    # packed into one tile)
    g = torch.Generator(device=dev)
    g.manual_seed(46)
    i32 = dict(dtype=torch.int32, device=dev)
    total = S + TEXT_NEW
    _, _, mask8 = _text_batch(torch, dev, cfg, B8, 46 + B8)
    off = S + TEXT_NEW // 2
    kv_pre = torch.cat([mask8, torch.zeros(B8, TEXT_NEW, **i32)], 1)
    kv_dec = kv_pre.clone()
    kv_dec[:, S:] = 1  # every decode slot live: causality alone hides
    # the slots past the query's (its controls: causal, q_offset dropped)
    H, KVH, D = llm.num_heads, llm.num_kv_heads, llm.head_dim
    # the prefill's query rows all live here: its pad rows (segment 0 on
    # the path) then attend the pad keys that causality lets them see, so
    # that the 'padding keys unmasked' control has something to break
    for name, sq, q_seg, kv, o in (
            ("text prefill", S, torch.ones(B8, S, **i32), kv_pre, 0),
            ("text decode", 1, torch.ones(B8, 1, **i32), kv_dec, off)):
        t_fwd, _ = _flash_case(torch, dev, g, tag, name, B8, sq, total, H,
                               KVH, D, q_seg, None, kv, None, causal=True,
                               off=o)
        extra["flash_attention_fwd"][name.replace(" ", "_")] = t_fwd
    extra["flash_attention_fwd"]["vla_text"] = rep
    return launches


@contextmanager
def _suffix_without_cond(model):
    """Within: the joint stack's cached suffix runs without its adaLN
    condition (a control: plain norms, no gates)."""
    orig = model.joint.forward

    def forward(mode, *args):
        return orig(mode, *(args[:9] if mode == "suffix" else args))

    model.joint.forward = forward
    try:
        yield
    finally:
        del model.joint.forward


@contextmanager
def _actions_unshifted(model):
    """Within: the action rows' rope positions ignore the expert image rows
    ahead of them (a control)."""
    orig, n = model._positions, model._n_expert_img

    def positions(b, device):
        vlm, pro, act = orig(b, device)
        return vlm, pro, act - n

    model._positions = positions
    try:
        yield
    finally:
        del model._positions


def ada_vie_phase(torch, np, dev, tag, extra):
    """Phase 47, adaLN-Zero with vision-in-expert at full width:
    Vlaser-2B-VLA (ABLATION_LAYERS of its 28 layers in both mixtures)
    with adaptive_mode "adaln_zero", time_hidden_size 256 and
    the second vision tower, fp32 parameters, bf16 compute, remat,
    random_init_'s draws. Batch-1 infer_action against infer_action_naive
    (<= PARITY_TOL; controls: the suffix's adaLN condition dropped, the
    action positions unshifted); one loss + backward whose gradients on the VLM-side
    tower and its mlp1 must be exactly 0 (None counts as 0) and on the
    expert tower nonzero; 2 VLATrainer steps at batch ADA_B (halved on
    out-of-memory, the cut printed), counted and held to the derived
    counts; then quantize_for_serving(target="policy") (w8a8: the adaLN-Zero
    gates' raw kernels int8, which the JAX package cannot serve) and a
    counted batch-1 infer_action against infer_action_naive on that tree,
    the expert's GEMMs at its prefix rows against the plain versions.
    Flash at the joint shape and RMSNorm at the expert's rows against the
    plain versions. -> launches of the counted runs."""
    import dataclasses

    from vlaser_tpu_torch.core.config import vlaser_2b_vla
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.scripts.train_sft import random_init_
    from vlaser_tpu_torch.train.trainer import VLATrainConfig, VLATrainer

    from vlaser_tpu_torch.kernels import rmsnorm

    t0 = time.perf_counter()
    cfg = dataclasses.replace(_cut_depth(vlaser_2b_vla(), ABLATION_LAYERS),
                              adaptive_mode="adaln_zero",
                              time_hidden_size=256, vision_in_expert=True)
    L, n_vit = cfg.vlm.llm.num_layers, cfg.vlm.vision.num_layers
    n_img = cfg.vlm.num_image_token
    vc, llm, S_it = cfg.vlm.vision, cfg.vlm.llm, cfg.max_image_text_tokens
    H, n_a = llm.num_heads, cfg.num_action_tokens
    n_p = n_img + cfg.num_proprio_tokens
    left = torch.cuda.memory_allocated()  # by earlier phases
    model = PiZeroVLA(cfg, param_dtype=torch.float32,
                      compute_dtype=torch.bfloat16, device=dev, remat=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(47)
    random_init_(model, gen)
    n_param = sum(p.numel() for p in model.parameters())
    print(f"adaLN-Zero + vision-in-expert model ({L} of 28 LLM layers, "
          f"ABLATION_LAYERS: the script's time limit): {n_param / 1e9:.3f} G "
          f"parameters (fp32), {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB on device, {time.perf_counter() - t0:.1f} s {tag}",
          flush=True)
    b1 = _train_batch(torch, np, dev, cfg, 1)
    noise = torch.randn((1, cfg.num_action_tokens, cfg.action_dim),
                        generator=gen, device=dev)
    in1 = [b1[k] for k in ("input_ids", "pixel_values", "text_mask",
                           "proprios")] + [noise]

    def cached_vs_naive(what):
        with torch.inference_mode():
            a = model.infer_action(*in1)
            n = model.infer_action_naive(*in1)
        d, top = (a - n).abs().max().item(), n.abs().max().item()
        print(f"adaLN-Zero + VIE {what}: infer_action vs infer_action_naive, "
              f"batch 1: max_abs_diff {d:.3e} (bound {PARITY_TOL}: "
              f"{PARITY_TOL / top:.2e} x max |actions| {top:.4f}), finite "
              f"{bool(a.isfinite().all())} {tag}", flush=True)
        if not (d <= PARITY_TOL and a.isfinite().all()
                and a.shape == (1, cfg.horizon_steps, cfg.action_dim)):
            raise RuntimeError(f"adaLN-Zero + VIE {what}: cached vs naive")
        # controls, in the cached route only: each must break the bound
        for name, fault in (("adaLN cond dropped in the suffix",
                             _suffix_without_cond),
                            ("action positions not shifted past the "
                             "expert image", _actions_unshifted)):
            with fault(model), torch.inference_mode():
                c = model.infer_action(*in1)
            ratio = (c - n).abs().max().item() / PARITY_TOL
            print(f"  control '{name}': {ratio:.2f} x the bound (must "
                  f"exceed 1)", flush=True)
            if not ratio > 1:
                raise RuntimeError(f"adaLN-Zero + VIE {what}: the bound "
                                   f"cannot see '{name}'")
        return a

    a_float = cached_vs_naive("float tree")

    # -- training: the gradient check, then the counted trainer steps -------
    B = ADA_B
    while True:
        try:
            batch = _train_batch(torch, np, dev, cfg, B)
            trainer = VLATrainer(model, VLATrainConfig(), generator=gen)
            t = torch.rand((B,), generator=gen, device=dev) * 0.999
            x0 = torch.randn((B, cfg.num_action_tokens, cfg.action_dim),
                             generator=gen, device=dev)
            model.zero_grad(set_to_none=True)
            loss = model(*[batch[k] for k in (
                "input_ids", "pixel_values", "text_mask", "proprios",
                "actions")], t, x0)
            loss.backward()
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            trainer = batch = loss = None
            model.zero_grad(set_to_none=True)
            gc.collect()
            torch.cuda.empty_cache()
            if B == 1:
                raise
            print(f"adaLN-Zero + VIE train: batch {B} exceeds the card; "
                  f"halved (a cut of ADA_B {ADA_B})", flush=True)
            B //= 2
    zero = lambda mod: all(p.grad is None or not p.grad.any()
                           for p in mod.parameters())
    vlm_zero = zero(model.vision_model) and zero(model.mlp1)
    tower = [p.grad for p in model.vision_model_expert.parameters()]
    tower_ok = all(g_ is not None and g_.isfinite().all() for g_ in tower) \
        and any(g_.any() for g_ in tower)
    print(f"adaLN-Zero + VIE gradients (batch {B}, loss {loss.item():.5f}): "
          f"the VLM-side tower and mlp1 exactly 0: {vlm_zero}; the expert "
          f"tower finite and nonzero: {tower_ok} {tag}", flush=True)
    if not (vlm_zero and tower_ok and math.isfinite(loss.item())):
        raise RuntimeError("adaLN-Zero + VIE: the gradient check failed")
    del loss, tower
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    times, losses = [], []
    for _ in range(2):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        m = trainer.train_steps(iter([batch]), 1)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
        losses.append(m["loss"].item())
    torch.cuda.synchronize()
    got = {k: v for k, v in _read_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    PEAKS["47"] = (peak, B, left / 2**30)
    # derived from the code, a step: the VLM-side ViT runs its flash forward
    # once (its features are detached: no backward reaches it, so remat
    # never recomputes it); the expert tower and every joint layer run one
    # forward, one remat recompute and one backward. RMSNorm: each joint
    # layer's 2 VLM norms (B x 384 rows) and 2 expert norms (B x 261 rows;
    # the plain norm runs on every row, adaLN's is eager) forward twice,
    # plus vlm_norm and expert_norm; backward on all but the VLM's last
    # post-attention norm and vlm_norm, which never reach the loss
    S_e = n_p + n_a
    vit = n_vit * _auto_flash(B, vc.seq_len, vc.seq_len, vc.num_heads)
    jnt = L * _auto_flash(B, S_it + S_e, S_it + S_e, H)
    vlm_rms = B * S_it >= rmsnorm.MIN_ROWS
    exp_rms = B * S_e >= rmsnorm.MIN_ROWS
    # a ViT with q/k norms (not the 300M) runs 2 a layer in its 3 forward
    # passes and in the expert tower's backward
    vit_rms = 2 * n_vit * (vc.qk_normalization and B * vc.seq_len
                           >= rmsnorm.MIN_ROWS
                           and vc.hidden_size <= rmsnorm.MAX_HIDDEN)
    want = {"flash_attention_fwd": 2 * (vit + 2 * (vit + jnt)),
            "flash_attention_bwd": 2 * (vit + jnt),
            "_rms_fwd": 2 * ((vlm_rms + exp_rms) * (4 * L + 1)
                             + 3 * vit_rms),
            "_rms_bwd": 2 * (vlm_rms * (2 * L - 1) + exp_rms * (2 * L + 1)
                             + vit_rms)}
    want = {k: v for k, v in want.items() if v}
    print(f"adaLN-Zero + VIE train: 2 VLATrainer steps at batch {B}, losses "
          f"{[round(v, 5) for v in losses]}, step ms "
          f"{[round(v, 1) for v in times]} (CUDA events), peak device "
          f"memory {peak:.2f} GiB; launches {got} (derived {want}) {tag}",
          flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError("adaLN-Zero + VIE train: non-finite loss")
    if got != want:
        raise RuntimeError(f"adaLN-Zero + VIE train launches {got} != {want}")
    launches = dict(got)
    extra["flash_attention_bwd"]["adaln_zero_vie_train"] = dict(
        batch=B, step_ms=statistics.median(times), peak_gib=peak)
    del trainer, batch, m
    gc.collect()
    torch.cuda.empty_cache()

    # -- the w8a8 serving tree: the int8 adaLN-Zero gates --------------------
    model.requires_grad_(False)
    quantize_for_serving(model, target="policy")
    ex = model.joint.layers.expert
    if "kernel_q" not in ex.post_adaptive_scale._buffers:
        raise RuntimeError("the adaLN-Zero gate kernel was not quantized")
    # the expert's 7 GEMMs and its quantizers at the prefix's expert rows
    # ([expert image | proprio], batch 1), against the plain versions (the
    # ViT towers' shapes are phase 46's at batch 1)
    (k1, k2, k3), = gemm_phase(torch, _gemm_sites(ex, ex.mlp), (n_p,), dev,
                               tag).values()
    extra["quantize_rows"][f"ada_vie_expert_{n_p}"] = k1
    extra["int8_gemm"][f"ada_vie_expert_{n_p}"] = k2
    extra["quantize_silu_mul"][f"ada_vie_expert_{n_p}"] = k3
    a_q = cached_vs_naive("w8a8 tree")
    print(f"adaLN-Zero + VIE w8a8 vs the float tree (the trained weights "
          f"moved by 2 steps: informational): max_abs_diff "
          f"{(a_q - a_float).abs().max().item():.3e} {tag}", flush=True)
    with torch.inference_mode():
        got, times, out, _ = _counted_calls(
            torch, lambda: model.infer_action(*in1),
            "adaLN-Zero + VIE w8a8 infer_action, batch 1", tag)
    # batch 1: both towers' ViT layers (1 x seq rows each), the prefix's
    # VLM rows and expert rows ([expert image | proprio]) take w8a8 by the
    # row threshold, the denoise's 4 action rows stay weight-only; flash
    # and RMSNorm by their thresholds (none at these sizes on the card)
    want = _w8a8_want([(vc.seq_len, 2 * n_vit, 0), (S_it, 0, L),
                       (n_p, 0, L)])
    steps = cfg.num_inference_steps
    want["flash_attention_fwd"] = (
        2 * n_vit * _auto_flash(1, vc.seq_len, vc.seq_len, vc.num_heads)
        + L * _auto_flash(1, S_it + n_p, S_it + n_p, H)
        + steps * L * _auto_flash(1, n_a, S_it + n_p + n_a, H))
    want["_rms_fwd"] = L * 2 * ((S_it >= rmsnorm.MIN_ROWS)
                                + (n_p >= rmsnorm.MIN_ROWS))
    want = {k: STEPS * v for k, v in want.items() if v}
    print(f"  derived {want}", flush=True)
    if got != want or not out.isfinite().all():
        raise RuntimeError(f"adaLN-Zero + VIE w8a8 launches {got} != {want}")
    _add(launches, got)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # -- the kernels at this path's shapes -----------------------------------
    g = torch.Generator(device=dev)
    g.manual_seed(47)
    i32 = dict(dtype=torch.int32, device=dev)
    llm, S_it = cfg.vlm.llm, cfg.max_image_text_tokens
    S_j = S_it + S_e
    seg = torch.ones(ADA_B, S_j, **i32)
    seg[:, S_it - 60:S_it] = 0  # a padded prompt tail
    lev = torch.zeros(ADA_B, S_j, **i32)
    lev[:, S_it:S_it + n_img + 1] = 1
    lev[:, S_it + n_img + 1:] = 2
    t_fwd, t_bwd = _flash_case(torch, dev, g, tag, "adaLN-Zero VIE joint",
                               ADA_B, S_j, S_j, llm.num_heads,
                               llm.num_kv_heads, llm.head_dim, seg, lev,
                               seg, lev)
    extra["flash_attention_fwd"]["adaln_zero_vie_joint"] = t_fwd
    extra["flash_attention_bwd"]["adaln_zero_vie_joint"] = t_bwd
    f_rep, b_rep = rms_train_case(torch, g, dev, ADA_B * S_e,
                                  cfg.expert.hidden_size,
                                  cfg.expert.rms_norm_eps, " expert", tag)
    extra["_rms_fwd"]["adaln_zero_vie_expert"] = f_rep
    extra["_rms_bwd"]["adaln_zero_vie_expert"] = b_rep
    return launches


def _vit6b_flop(vcfg, tokens):
    """Matmul flop of the InternViT layer loop over `tokens` rows of one
    tile's sequence (QKV, projection, MLP, q.k and p.v)."""
    C, I, S = vcfg.hidden_size, vcfg.intermediate_size, vcfg.seq_len
    return vcfg.num_layers * tokens * (2 * C * (3 * C + C + 2 * I)
                                       + 4 * S * C)


def internvit6b_phase(torch, np, dev, tag, extra):
    """Phase 48, InternViT-6B (45 layers x 3,200, 25 heads x 128, RMSNorm
    blocks, bias-free QKV, flattened q/k norms; bf16, N(0, 0.02^2) draws,
    norms 1 + N(0, 0.1^2), layer scales ~0.5 (attention) and ~0.1 (MLP))
    through its layer loop:
    VIT6B_TILES noise tiles under the dispatch route (flash: 13 x 1,025
    rows pass JAX's logits threshold), counted; the flash route against the
    eager reference at batch 1 and 13 on the final hidden states
    (PREFILL_REL of what the stack changes), controls (attention scale
    dropped, attention dropped) must break it; timed, with the achieved
    matmul TFLOP/s against the bf16 peak; flash at the 6B shape against the
    plain version (_flash_case). -> launches of the counted runs."""
    from vlaser_tpu_torch.core.config import internvit_6b
    from vlaser_tpu_torch.kernels import rmsnorm
    from vlaser_tpu_torch.models import internvit
    from vlaser_tpu_torch.models.layers import RMSNorm, init_normal_

    t0 = time.perf_counter()
    vcfg = internvit_6b()
    bf = torch.bfloat16
    model = internvit.InternVisionModel(vcfg, param_dtype=bf,
                                        compute_dtype=bf, device=dev)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(48)
    init_normal_(model, gen, std=0.02)
    rnd = lambda t: torch.randn(t.shape, generator=gen, device=dev)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, RMSNorm):
                m.weight.copy_(1 + 0.1 * rnd(m.weight))
        # the attention branch's layer scale 0.5, the MLP's 0.1: attention
        # then carries the stack, so that its controls show
        enc = model.encoder
        for p, scale in ((enc.ls1, 0.5), (enc.ls2, 0.1)):
            p.copy_(scale * (1 + 0.1 * rnd(p)))
    n_param = sum(p.numel() for p in model.parameters())
    img = vcfg.image_size
    px = torch.randn((VIT6B_TILES, img, img, 3), generator=gen, device=dev)
    print(f"InternViT-6B: {n_param / 1e9:.3f} G parameters (bf16), "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device, "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    launches = {}
    with torch.inference_mode():
        got, times, out13, _ = _counted_calls(
            torch, lambda: model(px), f"InternViT-6B {VIT6B_TILES} tiles "
            "(dispatch route)", tag)
        # flash by the dispatch rule; RMSNorm (norm1, norm2 and the q/k
        # norms a layer) only up to the kernel's width, which 3,200 is past
        n = VIT6B_TILES * vcfg.seq_len
        want = {"flash_attention_fwd": STEPS * vcfg.num_layers * _auto_flash(
                    VIT6B_TILES, vcfg.seq_len, vcfg.seq_len, vcfg.num_heads),
                "_rms_fwd": STEPS * 4 * vcfg.num_layers * (
                    n >= rmsnorm.MIN_ROWS
                    and vcfg.hidden_size <= rmsnorm.MAX_HIDDEN)}
        want = {k: v for k, v in want.items() if v}
        if got != want or not out13.isfinite().all():
            raise RuntimeError(f"InternViT-6B launches {got} != {want}")
        _add(launches, got)
        torch.cuda.reset_peak_memory_stats()
        ms = _ms(torch, lambda: model(px), 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        flop = _vit6b_flop(vcfg, VIT6B_TILES * vcfg.seq_len)
        tflops = flop / ms / 1e9
        print(f"InternViT-6B {VIT6B_TILES} tiles: {ms:.1f} ms (CUDA events), "
              f"{flop / 1e12:.1f} TFLOP of matmul -> {tflops:.1f} TFLOP/s "
              f"({100 * tflops * 1e12 / PEAK_BF16:.1f}% of the bf16 peak; "
              f"bound {1e3 * flop / PEAK_BF16:.1f} ms); peak device memory "
              f"{peak:.2f} GiB {tag}", flush=True)
        rep = dict(ms=ms, tflops=tflops, bound_ms=1e3 * flop / PEAK_BF16,
                   peak_gib=peak)
        for B in (1, VIT6B_TILES):
            x = px[:B]
            x_in = model.embed(x)
            model.encoder.attn_impl = "reference"
            ref = model(x)
            model.encoder.attn_impl = "kernel"
            try:
                kern = model(x)
                orig = internvit.attention
                ctrl = {}
                for name, fn in (
                        ("attention scale dropped",
                         lambda q, k, v, **kw: orig(q, k, v, **kw,
                                                    scale=1.0)),
                        ("attention dropped",
                         lambda q, k, v, **kw: torch.zeros_like(q))):
                    internvit.attention = fn
                    try:
                        ctrl[name] = model(x)
                    finally:
                        internvit.attention = orig
            finally:
                model.encoder.attn_impl = "auto"
            # two bf16 routes through 45 random layers: PREFILL_REL of
            # what the stack changes (the kernel alone: _flash_case below)
            _gate(f"InternViT-6B flash route vs reference, B={B}", kern, ref,
                  x_in, ctrl, bound=PREFILL_REL * (
                      ref.float() - x_in.float()).abs().max().item())
            del ref, kern, ctrl
    del model, out13
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev)
    g.manual_seed(48)
    i32 = dict(dtype=torch.int32, device=dev)
    ones = torch.ones(VIT6B_TILES, vcfg.seq_len, **i32)
    t_fwd, t_bwd = _flash_case(torch, dev, g, tag, "InternViT-6B",
                               VIT6B_TILES, vcfg.seq_len, vcfg.seq_len,
                               vcfg.num_heads, vcfg.num_heads, vcfg.head_dim,
                               ones, None, ones, None)
    t_fwd["layer_loop"] = rep
    extra["flash_attention_fwd"]["internvit6b"] = t_fwd
    extra["flash_attention_bwd"]["internvit6b"] = t_bwd
    return launches


def entry_beta_phase(torch, np, dev, tag):
    """Phase 49: graft_entry.entry() once on the card (Vlaser-2B-VLA in
    bf16 with zero parameters, the JAX entry's example batch: actions
    [1, 4, 7], finite), then BETA_DRAWS flow times t ~ t_max (1 - z),
    z ~ Beta(2, 3), drawn on the card's generator: the Kolmogorov-Smirnov
    distance of z from Beta(2, 3)'s CDF 6 z^2 - 8 z^3 + 3 z^4, sqrt(n) D
    below KS_CRIT."""
    from vlaser_tpu_torch.graft_entry import entry
    from vlaser_tpu_torch.policy.flow import sample_fm_time

    t0 = time.perf_counter()
    fn, args = entry()
    with torch.inference_mode():
        out = fn(*args)
        ms = _ms(torch, lambda: fn(*args), 3)
    print(f"graft entry twin: actions {tuple(out.shape)} {out.dtype} on "
          f"{out.device}, finite {bool(out.isfinite().all())}, "
          f"{ms:.1f} ms a call (CUDA events), built and run in "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    if not (tuple(out.shape) == (1, 4, 7) and out.isfinite().all()
            and out.device.type == "cuda"):
        raise RuntimeError("the graft entry's twin returned bad actions")
    del fn, args, out
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev)
    g.manual_seed(49)
    t = sample_fm_time(g, BETA_DRAWS, "beta", 2.0, 3.0, t_max=1.0,
                       device=dev)
    if t.device.type != "cuda":
        raise RuntimeError("the Beta draws left the card")
    z = np.sort(1.0 - t.double().cpu().numpy())
    cdf = 6 * z ** 2 - 8 * z ** 3 + 3 * z ** 4
    n = len(z)
    d = max((np.arange(1, n + 1) / n - cdf).max(),
            (cdf - np.arange(n) / n).max())
    print(f"Beta(2, 3) flow times: {n} draws on the card, mean "
          f"{z.mean():.5f} (exact 0.4), Kolmogorov-Smirnov D {d:.5f}, "
          f"sqrt(n) D {d * n ** 0.5:.3f} (bound {KS_CRIT}) {tag}", flush=True)
    if not d * n ** 0.5 < KS_CRIT:
        raise RuntimeError("the Beta(2, 3) draws fail the KS test")


def text_ablation_phases(torch, np, dev, tag, extra):
    """Phases 46-49. -> launches of their main paths."""
    launches = vla_text_phase(torch, np, dev, tag, extra)
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, ada_vie_phase(torch, np, dev, tag, extra))
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, internvit6b_phase(torch, np, dev, tag, extra))
    gc.collect()
    torch.cuda.empty_cache()
    entry_beta_phase(torch, np, dev, tag)
    return launches


# -- the parallel layouts (phases 54-56) --------------------------------------
RING_TOKENS = 16384  # phase 24's long SFT pack
RING_RANKS = 4       # virtual context ranks
RING_SMALL = 2048    # the eager chunk twin's size
RING_SEGMENTS = (3000, 4500, 1500, 5000, 2320)  # packed, then 64 padding


def _ring_seg(torch, dev, n, lengths):
    """[1, n] segment ids: `lengths` packed from 0, segment 0 after."""
    seg = torch.zeros((1, n), dtype=torch.int32, device=dev)
    at = 0
    for i, m in enumerate(lengths):
        seg[:, at:at + m] = i + 1
        at += m
    return seg


def _ring_run(torch, ra, q, k, v, do, seg, n, layout, ranks=None):
    """virtual_ring in `layout` on the logical sequence; -> {key: the
    ranks' results put back in sequence order} (dk / dv of each rank's own
    chunk), or the raw result when `ranks` is given."""
    idx = None
    if layout == "zigzag":
        fwd, inv = ra.zigzag_indices(n, q.shape[1])
        idx = (torch.as_tensor(fwd, device=q.device),
               torch.as_tensor(inv, device=q.device))
    perm = lambda t: t if idx is None else t.index_select(1, idx[0])
    res = ra.virtual_ring(perm(q), perm(k), perm(v), n,
                          dout=None if do is None else perm(do),
                          q_segment_ids=perm(seg), causal=True,
                          layout=layout, ranks=ranks)
    if ranks is not None:
        return res
    back = lambda t, dim=1: t if idx is None else t.index_select(dim, idx[1])
    out = {"out": back(torch.cat([res["out"][r] for r in range(n)], 1)),
           "lse": back(torch.cat([res["lse"][r] for r in range(n)], 2), 2)}
    if do is not None:
        for key in ("dq", "dk", "dv"):
            out[key] = back(torch.cat([res[key][r] for r in range(n)], 1))
    return out


def _ring_pairs(ra, n, chunk, layout):
    """Allowed (q, kv) blocks of each virtual rank: its flash calls."""
    return [sum(len(ra._pairs(r, src, n, chunk, layout, True))
                for src in range(n)) for r in range(n)]


def _rank_work(torch, seg, n, layout, ra):
    """Allowed (query, key) pairs of each virtual rank's rows under the
    packed causal mask (the flop its chunk steps need)."""
    s = seg[0]
    pos = torch.arange(s.numel(), device=s.device)
    start = torch.zeros_like(pos)
    change = torch.nonzero(s[1:] != s[:-1])[:, 0] + 1
    start[change] = change
    start = torch.cummax(start, 0).values
    rows = torch.where(s != 0, pos - start + 1, 0)
    chunk = s.numel() // n
    return [int(rows[ra._positions(r, n, chunk, layout, s.device)].sum())
            for r in range(n)]


def ring_phase(torch, np, dev, tag, extra):
    """Phase 54: ring attention's chunk route at full width, 4 virtual
    context ranks in one process (kernels/ring_attention.virtual_ring:
    each rank runs exactly the flash calls of its 4 ring steps, forward
    and backward, the chunks handed over without communication):
    Qwen2.5-1.5B attention (12 / 2 heads x 128), bf16, RING_TOKENS causal
    tokens in packed segments, both layouts. Held against one flash call
    over the whole sequence (out, lse, dq, dk, dv within FLASH_REL x max,
    lse within LSE_ABS), with a control (every block pair's q_offset set
    to 0) that must break the bound; at RING_SMALL tokens the kernel route
    is held to the eager fp32 chunk twin. Each rank's device ms, the
    slowest against the one call, and the launches (counted from 0 around
    the two layouts' runs, held to the block pairs); the library yardstick
    is one scaled_dot_product_attention of the slowest rank's rows against
    the whole K/V. -> those launches."""
    import torch.nn.functional as F

    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import ring_attention as ra

    H, KVH, D, n = 12, 2, 128, RING_RANKS
    g = torch.Generator(device=dev)
    g.manual_seed(54)

    # the eager twin at the small size
    q, k, v, do = _flash_inputs(torch, g, dev, 1, RING_SMALL, RING_SMALL, H,
                                KVH, D)
    seg = _ring_seg(torch, dev, RING_SMALL, (700, 900, 384))
    keys = ("out", "lse", "dq", "dk", "dv")
    for layout in ("contiguous", "zigzag"):
        got = _ring_run(torch, ra, q, k, v, do, seg, n, layout)
        route = ra._kernel_route
        ra._kernel_route = lambda q: False
        try:
            twin = _ring_run(torch, ra, q, k, v, do, seg, n, layout)
        finally:
            ra._kernel_route = route
        bounds = {kk: FLASH_REL * twin[kk].float().abs().max().item()
                  for kk in ("out", "dq", "dk", "dv")}
        bounds["lse"] = LSE_ABS
        valid = (seg != 0)[0]  # fully masked rows: lse -1e30 either way
        twin["lse"], got["lse"] = twin["lse"][..., valid], got["lse"][
            ..., valid]
        _check(f"ring {layout} chunk route vs eager twin S={RING_SMALL} "
               f"H={H}/{KVH} D={D} x{n}", got, twin, bounds, {})
    del q, k, v, do, got, twin

    S = RING_TOKENS
    q, k, v, do = _flash_inputs(torch, g, dev, 1, S, S, H, KVH, D)
    seg = _ring_seg(torch, dev, S, RING_SEGMENTS)
    meta = fa.pack_meta(seg)
    one_fwd = lambda: fa.flash_attention_fwd(q, k, v, meta, meta, 0, True)
    out, lse = one_fwd()
    grads = fa.flash_attention_bwd(q, k, v, meta, meta, 0, out, lse, do,
                                   True)
    ref = dict(zip(keys, (out, lse, *grads)))
    bounds = {kk: FLASH_REL * ref[kk].float().abs().max().item()
              for kk in ("out", "dq", "dk", "dv")}
    bounds["lse"] = LSE_ABS
    valid = (seg != 0)[0]
    ref["lse"] = ref["lse"][..., valid]
    _zero_counts()
    runs = {}
    for layout in ("contiguous", "zigzag"):
        runs[layout] = _ring_run(torch, ra, q, k, v, do, seg, n, layout)
    torch.cuda.synchronize()
    launches = {kk: v_ for kk, v_ in _read_counts().items() if v_}
    calls = {lay: _ring_pairs(ra, n, S // n, lay)
             for lay in ("contiguous", "zigzag")}
    want = {"flash_attention_fwd": sum(map(sum, calls.values())),
            "flash_attention_bwd": sum(map(sum, calls.values()))}
    print(f"ring launches {launches} (derived from the block pairs "
          f"{calls}: {want}) {tag}", flush=True)
    if launches != want:
        raise RuntimeError(f"ring launches {launches} != {want}")
    pairs = ra._pairs
    ra._pairs = lambda *a: [(qs, ks, 0) for qs, ks, _ in pairs(*a)]
    try:
        wrong = _ring_run(torch, ra, q, k, v, None, seg, n, "contiguous")
    finally:
        ra._pairs = pairs
    errs = {}
    for layout, got in runs.items():
        got["lse"] = got["lse"][..., valid]
        errs[layout] = _check(
            f"ring {layout} S={S} H={H}/{KVH} D={D} x{n} vs one flash call",
            got, ref, bounds,
            {"q_offset 0": {"out": wrong["out"]}} if layout == "contiguous"
            else {})
    del runs, wrong, ref
    gc.collect()

    one_ms = _kernel_ms(torch, one_fwd, 5)
    one_both = _kernel_ms(torch, lambda: fa.flash_attention_bwd(
        q, k, v, meta, meta, 0, out, lse, do, True), 5) + one_ms
    io = (q.numel() + 2 * k.numel()) * 2
    for layout in ("contiguous", "zigzag"):
        work = _rank_work(torch, seg, n, layout, ra)
        f_ms = [_kernel_ms(torch, lambda r=r: _ring_run(
            torch, ra, q, k, v, None, seg, n, layout, ranks=[r]), 3)
            for r in range(n)]
        b_ms = [_kernel_ms(torch, lambda r=r: _ring_run(
            torch, ra, q, k, v, do, seg, n, layout, ranks=[r]), 3) - f
            for r, f in enumerate(f_ms)]
        slow = max(range(n), key=lambda r: f_ms[r] + b_ms[r])
        # the yardstick: one scaled_dot_product_attention of the slowest
        # rank's query rows against the whole K/V under the ring's mask at
        # their global positions (K/V repeated over each group's q heads),
        # forward, then autograd.grad for the backward
        pos = ra._positions(slow, n, S // n, layout, dev)
        mask = ra._chunk_mask(meta[:, pos], meta, pos,
                              torch.arange(S, device=dev), True)[:, None]
        rep_kv = lambda t: t.repeat_interleave(H // KVH, dim=2)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q[:, pos], rep_kv(k), rep_kv(v)))
        dot = do[:, pos].transpose(1, 2).contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        lib_f = _kernel_ms(torch, sdpa, 5)
        o_lib = sdpa()
        lib_b = _kernel_ms(torch, lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), dot, retain_graph=True), 5)
        del o_lib, qt, kt, vt, dot, mask
        route = ra._kernel_route
        ra._kernel_route = lambda q: False
        try:
            plain_f = _ms(torch, lambda: _ring_run(
                torch, ra, q, k, v, None, seg, n, layout, ranks=[slow]), 1)
            plain_b = _ms(torch, lambda: _ring_run(
                torch, ra, q, k, v, do, seg, n, layout, ranks=[slow]),
                1) - plain_f
        finally:
            ra._kernel_route = route
        # the slowest rank's work: its rows' allowed pairs, q / out / lse
        # of its rows and every k / v chunk once
        rows_b = (q.numel() // n) * 2 * 2 + (lse.numel() // n) * 4
        for nm, ms, plain, flop, nbytes in (
                ("fwd", f_ms, plain_f, 4 * D * H * work[slow],
                 io // n + 2 * k.numel() * 2 * (n - 1) // n + rows_b),
                ("bwd", b_ms, plain_b, 10 * D * H * work[slow],
                 2 * (io // n + 2 * k.numel() * 2 * (n - 1) // n + rows_b))):
            rep = {"max_abs_err": max(errs[layout][kk] for kk in (
                       ("out",) if nm == "fwd" else ("dq", "dk", "dv"))),
                   "ms": ms[slow], "rank_ms": [round(x, 4) for x in ms],
                   "plain_ms": plain,
                   "library_ms": lib_f if nm == "fwd" else lib_b,
                   "one_call_ms": one_ms if nm == "fwd" else one_both - one_ms,
                   "launches": sum(calls[layout]),
                   "calls_by_rank": calls[layout]}
            rep["bound_ms"], rep["bound_by"] = _bound(flop, nbytes,
                                                      PEAK_BF16)
            extra[f"flash_attention_{nm}"][f"ring{S // 1024}k_{layout}"] = rep
        both = [f + b for f, b in zip(f_ms, b_ms)]
        print(f"ring {layout} S={S} x{n} virtual ranks: device ms a rank "
              f"(fwd + bwd chunk steps) {[round(x, 3) for x in both]}, "
              f"allowed pairs a rank {work}, flash calls a rank "
              f"{calls[layout]}; slowest rank {max(both):.3f} ms against "
              f"one whole-sequence flash call {one_both:.3f} ms "
              f"({max(both) / one_both:.2f}x; an even split is "
              f"{1 / n:.2f}x); eager twin on the slowest rank "
              f"{plain_f + plain_b:.3f} ms; sdpa of the slowest rank's rows "
              f"fwd {lib_f:.3f} ms, bwd {lib_b:.3f} ms {tag}", flush=True)
    del q, k, v, do, out, lse, grads
    return launches


def _shard_run(torch, step, batch, what, steps):
    """`steps` calls of step(batch) (a trainer's loop on one batch), the
    launch counters zeroed just before and read just after: -> (ms a step,
    losses, grad norms, launches, peak GiB; 0 in a CPU rehearsal)."""
    card = torch.cuda.is_available()
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    times, losses, gnorms = _timed_steps(torch, step, batch, steps)
    counts = {k: v for k, v in _read_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30 if card else 0.0
    print(f"sharded {what}: losses {losses}, grad norms {gnorms}, step ms "
          f"{[round(t, 3) for t in times]}, peak {peak:.2f} GiB, launches "
          f"{counts}", flush=True)
    return times, losses, gnorms, counts, peak


SHARD_STEPS = 2
SHARD_REL = 1e-5  # loss / grad norm: sharded at world size 1 vs one device


def sharded_trainer_phase(torch, np, dev, tag):
    """Phase 55: the trainers over a mesh at world size 1 on the card: a
    one-rank NCCL group, SFTTrainer over (data 1, fsdp 1, tensor 1) and
    over (data 1, fsdp 1, context 1, tensor 1) with a context-parallel
    LLM config, and VLATrainer over (data 1, fsdp 1, tensor 1): phase 26's
    full-parameter Vlaser-2B SFT step (SFT_TOKENS packed tokens) and phase
    11's Vlaser-2B-VLA batch-32 step, SHARD_STEPS steps from the same
    weights, losses and grad norms held to the same trainer without a
    mesh within SHARD_REL, launches held to the derived counts; ms a step
    beside the unsharded step's, peak memory. The group is destroyed
    before the next phase. -> the sharded runs' launches."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core.config import vlaser_2b, vlaser_2b_vla
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.scripts.train_sft import random_init_
    from vlaser_tpu_torch.train.trainer import (SFTTrainer, TrainConfig,
                                                VLATrainConfig, VLATrainer)

    work = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group("nccl", init_method=f"file://{work}/pg", rank=0,
                            world_size=1)
    launches = {}
    try:
        mesh = mesh_lib.make_mesh(fsdp=1)
        cmesh = init_device_mesh("cuda", (1, 1, 1, 1), mesh_dim_names=(
            mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS, mesh_lib.CONTEXT_AXIS,
            mesh_lib.TENSOR_AXIS))
        print(f"phase 55 meshes: {mesh_lib.mesh_shape(mesh)}, "
              f"{mesh_lib.mesh_shape(cmesh)} (NCCL, world size 1)",
              flush=True)
        cfg = vlaser_2b()
        ccfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, context_parallel_axis=mesh_lib.CONTEXT_AXIS))
        lengths = (SFT_TOKENS * 3 // 8, SFT_TOKENS * 5 // 16, SFT_TOKENS // 4)
        batch = _packed_batch(np, cfg, SFT_TOKENS, 26, lengths)
        L = cfg.llm.num_layers
        sft_want = {"flash_attention_fwd": SHARD_STEPS * 2 * L,
                    "flash_attention_bwd": SHARD_STEPS * L,
                    "_rms_fwd": SHARD_STEPS * (4 * L + 1),
                    "_rms_bwd": SHARD_STEPS * (2 * L + 1)}
        vcfg = vlaser_2b_vla()
        vbatch = _train_batch(torch, np, dev, vcfg, 32)
        n_vit, VL = vcfg.vlm.vision.num_layers, vcfg.vlm.llm.num_layers
        vla_want = {"flash_attention_fwd": SHARD_STEPS * 2 * (n_vit + VL),
                    "flash_attention_bwd": SHARD_STEPS * (n_vit + VL),
                    "_rms_fwd": SHARD_STEPS * (2 * 2 * VL + 1),
                    "_rms_bwd": SHARD_STEPS * (2 * VL - 1)}

        def sft(conf, m):  # phase 26's trainer and weights
            model = InternVLChatModel(conf, param_dtype=torch.float32,
                                      compute_dtype=torch.bfloat16,
                                      device=dev, remat=True)
            random_init_(model, torch.Generator(dev).manual_seed(26))
            trainer = SFTTrainer(model, TrainConfig(), mesh=m)
            return lambda b: trainer.train(iter([b]))

        def vla(conf, m):  # phase 11's trainer, weights and generator
            model = PiZeroVLA(conf, param_dtype=torch.float32,
                              compute_dtype=torch.bfloat16, device=dev,
                              remat=True)
            gen = torch.Generator(device=dev)
            gen.manual_seed(5)
            random_init_(model, gen)
            trainer = VLATrainer(model, VLATrainConfig(), generator=gen,
                                 mesh=m)
            return lambda b: trainer.train_steps(iter([b]), 1)

        def run(make, conf, b, m, what):
            out = _shard_run(torch, make(conf, m), b, what, SHARD_STEPS)
            gc.collect()
            torch.cuda.empty_cache()
            return out

        plains = {}
        for what, make, conf, m, want in (
                ("SFT", sft, cfg, mesh, sft_want),
                ("SFT context", sft, ccfg, cmesh, sft_want),
                ("VLA", vla, vcfg, mesh, vla_want)):
            b = vbatch if what == "VLA" else batch
            family = what.split()[0]  # the context run's plain twin: SFT's
            if family not in plains:
                plains[family] = run(make, conf, b, None,
                                     f"{family} one device")
            plain = plains[family]
            shard = run(make, conf, b, m,
                        f"{what} mesh {mesh_lib.mesh_shape(m)}")
            _held(shard[3], want, f"sharded {what}")
            _add(launches, shard[3])
            rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(
                shard[1] + shard[2], plain[1] + plain[2]))
            # the first step of a process's first run holds its warm-up:
            # the last steps are compared
            print(f"sharded {what}: loss / grad norm rel diff to one device "
                  f"{rel:.3e} (bound {SHARD_REL}); last step "
                  f"{shard[0][-1]:.3f} ms sharded, {plain[0][-1]:.3f} ms one "
                  f"device; peak {shard[4]:.2f} / {plain[4]:.2f} GiB {tag}",
                  flush=True)
            if not rel <= SHARD_REL:
                raise RuntimeError(f"sharded {what} step disagrees with "
                                   "its one-device step")
        del vbatch
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    return launches


def dryrun_phase(tag):
    """Phase 56, a CPU check: graft_entry.dryrun_multichip(8), the
    repository's multi-device gate mirrored on 8 gloo ranks of the host's
    CPU (spawned processes, the card untouched): all nine lines (VLA, SFT,
    TP-serve, TP-engine, CP, PP, PPxFSDP-train, CPxFSDP-train, EP), finite
    (VLA and SFT on the JAX gate's mesh, data 2 x fsdp 2 x tensor 2; PP at
    stage 2). Its failure fails the run."""
    from vlaser_tpu_torch.graft_entry import ORDER, dryrun_multichip

    print("phase 56 (a CPU check on the host: 8 gloo ranks)", flush=True)
    lines = dryrun_multichip(8)
    for key in ORDER:
        if not any(f"dryrun_multichip(8) {key}:" in ln for ln in lines):
            raise RuntimeError(f"dryrun_multichip(8): no {key} line")
    gate = "mesh={'data': 2, 'fsdp': 2, 'tensor': 2}"
    if (len(lines) != len(ORDER)
            or any("nan" in ln or "inf" in ln for ln in lines)
            or not all(gate in ln for ln in lines
                       if ln.split()[1] in ("VLA:", "SFT:"))
            or not any("PP: 2-stage pipeline" in ln for ln in lines)):
        raise RuntimeError(f"dryrun_multichip(8) printed {lines}")
    print(f"dryrun_multichip(8): all {len(lines)} sections ran (CPU) {tag}",
          flush=True)


# -- phase 57: the tensor axis on one card (two processes over gloo) -----------
TP_ACT_TOL = 2e-2  # max |d action|: the fused-vs-plain gate's level
TP_NEW = 16        # new tokens a request of the engine runs
TP_TILES = 13      # the image request's tiles
TP_TEXT = (40, 72, 120)  # the text requests' prompt lengths
TP_NOTE = "two processes time-share one card over gloo: not a speed figure"
TP_STATS = {"action": {"p01": [-0.05] * 6 + [0.0], "p99": [0.05] * 6 + [1.0],
                       "mean": [0.0] * 7, "std": [1.0] * 7},
            "proprio": {"p01": [-0.5] * 6 + [0.0], "p99": [0.5] * 6 + [1.0],
                        "mean": [0.0] * 7, "std": [1.0] * 7}}


def _drop_reduce(tpl, dense):
    """A control: `dense`'s row-parallel split without its all-reduce
    (each rank keeps its partial sums). -> the split to restore."""
    class NoReduce(tpl.TensorSplit):
        def reduce(self, y):
            return y

    t = dense.tp
    dense.tp = NoReduce(t.kind, t.size, t.rank, t.group, t.gather, t.lo,
                        t.hi)
    return t


@contextmanager
def _row_codes(layers, w8a8, local_absmax=False):
    """Within the block, record the first row-parallel quantization of
    plain rows (a rank's input columns, its codes and scales, its split);
    with local_absmax every row-parallel quantization takes the rank's own
    absmax instead of the all-reduced one (a control)."""
    orig = layers.row_quantize
    seen = []

    def rq(x2, tp, g=None):
        if local_absmax:
            out = (w8a8.quantize_rows(x2) if g is None
                   else w8a8.quantize_silu_mul(x2, g))
        else:
            out = orig(x2, tp, g)
        if not seen and g is None:
            seen.append((x2.clone(), out[0].clone(), out[1].clone(), tp))
        return out

    layers.row_quantize = rq
    try:
        yield seen
    finally:
        layers.row_quantize = orig


def _codes_equal(torch, w8a8, seen):
    """The recorded codes against the one-device codes of the whole rows
    (every rank's columns gathered; each rank calls it). -> (codes and
    scales equal, rows, columns of the whole row)."""
    x2, q, am, tp = seen[0]
    full = tp.gather_out(x2)
    wq, wam = w8a8.quantize_rows(full)
    c = x2.shape[1]
    cols = wq[:, tp.rank * c:(tp.rank + 1) * c]
    return (bool(torch.equal(q, cols) and torch.equal(am, wam)),
            x2.shape[0], full.shape[1])


def _tp_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _tp_vla(torch, np, dev, mesh, cfg, mode, compute):
    """(a) Vlaser-2B-VLA's control step on a serving tree of `mode`
    ("int8" weight-only or "w8a8", core.quant.quantize_for_serving) with
    bf16 weights computed in `compute`, drawn by
    scripts/train_sft.random_init_ (norms 1 + N(0, 0.1^2); at bench.py's
    N(0, 0.02^2) norms the actions barely follow the weights, and no
    control could break the bound): the one-process plain PolicyServer,
    then PolicyServer(mesh=, fused=True) on the same weights (cut in
    place: the plain infer_action over the mesh's tensor axis). The
    actions compared are infer_action's chunks (the env actions after the
    adapter's clip and binarize). "int8" (the gate's tree, in fp32 as the
    JAX oracle's test): the control with the expert's o_proj all-reduce
    dropped. "w8a8" (the serving default): a row-parallel input's codes
    against one device's, and the control that quantizes with the rank's
    own absmax; its actions part from one process by code flips (any
    rounding difference flips some int8 codes: ~1e-2 at visible norms,
    printed, not gated). -> results."""
    from vlaser_tpu_torch.core import tensor_parallel as tpl
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.envs.adapters import BridgeSimplerAdapter
    from vlaser_tpu_torch.kernels import w8a8
    from vlaser_tpu_torch.models import layers
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.policy.processing import InternVLAProcessor
    from vlaser_tpu_torch.scripts.train_sft import random_init_
    from vlaser_tpu_torch.serve.policy_server import PolicyServer

    model = PiZeroVLA(cfg, param_dtype=torch.bfloat16, compute_dtype=compute,
                      device=dev)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.no_grad():
        random_init_(model, gen)
    quantize_for_serving(model, target="policy", mode=mode)
    img = cfg.vlm.vision.image_size
    proc = InternVLAProcessor(SmokeTokenizer(cfg.vlm),
                              num_image_tokens=cfg.vlm.num_image_token,
                              max_seq_len=cfg.max_image_text_tokens,
                              pad_token_id=cfg.vlm.pad_token_id)
    frame = np.random.default_rng(8).integers(0, 256, (img, img, 3),
                                              dtype=np.uint8)
    obs = {"agent": {"eef_pos": np.array([0.1, 0.0, 0.2, 1, 0, 0, 0, 0.5],
                                         np.float32)}}

    def server(**kw):
        return PolicyServer(model, None, BridgeSimplerAdapter(
            dataset_statistics=TP_STATS, image_size=(img, img)), proc,
            act_steps=4, seed=0, device=dev, **kw)

    def step(srv):
        """-> (the raw action chunk infer_action returned, the step's
        wall ms); the env actions are kept in out["env"]."""
        raw, infer = [], srv._infer
        srv._infer = lambda *a: raw.append(infer(*a)) or raw[-1]
        srv.generator.manual_seed(0)  # the same noise every step
        srv.reset("put the carrot on the plate")
        _tp_sync(torch, dev)
        t = time.perf_counter()
        out.setdefault("env", []).append(srv.step(obs, frame))
        _tp_sync(torch, dev)
        srv._infer = infer
        return raw[0].float().cpu().numpy(), (time.perf_counter() - t) * 1e3

    out = {}
    plain = server()
    step(plain)
    out["want"], out["plain_ms"] = step(plain)
    tps = server(fused=True, mesh=mesh)
    out["path"] = tps.serving_path
    _zero_counts()  # no warm-up: each step takes seconds over gloo
    with _row_codes(layers, w8a8) as seen:
        out["got"], out["ms"] = step(tps)
    out["counts"] = {k: v for k, v in _read_counts().items() if v}
    if mode == "int8":
        o_proj = model.joint.layers.expert.o_proj  # the action stream's
        saved = _drop_reduce(tpl, o_proj)
        out["dropped"], _ = step(tps)
        o_proj.tp = saved
        return out
    out["codes_equal"], out["rows"], out["cols"] = _codes_equal(
        torch, w8a8, seen)
    with _row_codes(layers, w8a8, local_absmax=True) as seen:
        out["local"], _ = step(tps)
    out["codes_local"], _, _ = _codes_equal(torch, w8a8, seen)
    return out


def _tp_requests(np, cfg, tiles, text, new):
    """One `tiles`-tile request (its image tokens between two short runs
    of text) and text requests of the lengths `text`, `new` new tokens
    each, from default_rng(57)."""
    from vlaser_tpu_torch.serve.engine import Request

    rng = np.random.default_rng(57)
    img = cfg.vision.image_size
    ids = np.concatenate([
        rng.integers(100, 1100, (8,)),
        np.full((tiles * cfg.num_image_token,), cfg.img_context_token_id),
        rng.integers(100, 1100, (8,))]).astype(np.int64)
    px = (rng.random((tiles, img, img, 3), dtype=np.float32) - 0.5) * 2
    reqs = [Request(uid=0, input_ids=ids, pixel_values=px,
                    max_new_tokens=new)]
    for i, n in enumerate(text):
        reqs.append(Request(uid=1 + i, input_ids=rng.integers(
            100, 1100, (n,)).astype(np.int64), max_new_tokens=new))
    return reqs


def _tp_engine(torch, np, dev, mesh, cfg, tiles, new, w8a8_bf16):
    """(b) Vlaser-2B through the engine: fp32 (reference attention; the
    flash kernel takes bf16) or, with w8a8_bf16, the chat serving default
    (bf16, quantize_for_serving: w8a8 prefill, flash and the RMSNorm
    kernel at the image request's rows). The one-process engine, then the
    engine on the mesh (cut in place), then (fp32) the control. ->
    results."""
    import dataclasses

    from vlaser_tpu_torch.core import tensor_parallel as tpl
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.serve.engine import ContinuousBatchingEngine

    dt = torch.bfloat16 if w8a8_bf16 else torch.float32
    model = InternVLChatModel(cfg, param_dtype=dt, compute_dtype=dt,
                              device=dev)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    init_normal_(model, gen, std=0.02)
    if w8a8_bf16:
        quantize_for_serving(model)
    else:
        model.set_attn_impl("reference")
    reqs = _tp_requests(np, cfg, tiles, TP_TEXT if dev.type == "cuda"
                        else (9, 14, 20), new)
    n_max = max(len(r.input_ids) for r in reqs) + new
    max_len = -(-n_max // 128) * 128
    kw = dict(num_slots=4, max_len=max_len, eos_token_ids=[2],
              pad_token_id=cfg.pad_token_id, prefill_buckets=(128, max_len),
              cache_dtype=dt)

    def run(eng):
        _tp_sync(torch, dev)
        t = time.perf_counter()
        done = {c.uid: c.token_ids for c in eng.run(reqs)}
        _tp_sync(torch, dev)
        return done, (time.perf_counter() - t) * 1e3

    out = {"tokens": sum(r.max_new_tokens for r in reqs), "new": new,
           "prompt": [len(r.input_ids) for r in reqs]}
    # warm-ups for the timings over NCCL; over gloo (phase 57) the walls
    # are not speed figures and each run on the mesh takes seconds
    nccl = torch.distributed.get_backend() == "nccl"
    one = ContinuousBatchingEngine(model, **kw)
    if nccl:
        run(one)
    out["want"], out["plain_ms"] = run(one)
    del one
    eng = ContinuousBatchingEngine(model, mesh=mesh, **kw)
    if nccl:
        run(eng)
    _zero_counts()
    out["got"], out["ms"] = run(eng)
    out["counts"] = {k: v for k, v in _read_counts().items() if v}
    out["kv_heads"] = eng.cache.k.shape[3]
    if not w8a8_bf16:  # the control: 2 new tokens (the first differ)
        o_proj = model.language_model.model.layers.self_attn.o_proj
        saved = _drop_reduce(tpl, o_proj)
        reqs = [dataclasses.replace(r, max_new_tokens=2) for r in reqs]
        out["dropped"], _ = run(eng)
        o_proj.tp = saved
        out["want2"] = {u: t[:2] for u, t in out["want"].items()}
    return out


def _tp_rank(rank, n, work, rehearse=None, layers=None):
    """One of the n processes of phase 57 (tensor n over a gloo group on
    CUDA tensors; both on card 0): (a) _tp_vla on the int8 tree in fp32
    and on the w8a8 tree in bf16, (b) _tp_engine in fp32,
    then in the w8a8 bf16 chat default. Writes their results to
    work/tp.<rank>. `rehearse`: (VLA config, VLM config, tiles, new
    tokens) to run the same code on CPU processes at a small size."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core.config import vlaser_2b, vlaser_2b_vla

    vla_cfg, vlm_cfg, tiles, new = rehearse or (
        _cut_depth(vlaser_2b_vla(), layers), _cut_depth(vlaser_2b(), layers),
        TP_TILES, TP_NEW)
    if rehearse is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    else:
        torch.set_num_threads(2)
        dev = torch.device("cpu")
    dist.init_process_group("gloo", init_method=f"file://{work}/tp_pg",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=300))
    res = {}
    try:
        mesh = mesh_lib.make_mesh(dp=1, fsdp=1, tp=n)
        for key, mode, dt in (("vla", "int8", torch.float32),
                              ("vla_w8a8", "w8a8", torch.bfloat16)):
            res[key] = _tp_vla(torch, np, dev, mesh, vla_cfg, mode, dt)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        for key, bf in (("engine", False), ("engine_w8a8", True)):
            t = time.perf_counter()
            res[key] = _tp_engine(torch, np, dev, mesh, vlm_cfg, tiles, new,
                                  bf)
            res[key]["wall_s"] = time.perf_counter() - t
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(work, f"tp.{rank}"))


def tp_absmax_phase(torch, dev, tag, extra, rows_list=(384, 3584)):
    """The quantizers' absmax input at the tp-2 shapes of Vlaser-2B's
    row-parallel inputs (o_proj 768 columns, down_proj's silu-mul 4,480),
    at the VLA prefix's and the image prefill's rows: the kernel against
    its plain twin given the same absmax (bit for bit), timed beside the
    twin and its bound (the input read, the absmax read, q and am
    written). Filed under extra[...]["absmax_tp2_r<rows>"]."""
    from vlaser_tpu_torch.kernels import w8a8

    g = torch.Generator(device=dev)
    g.manual_seed(57)
    bf = torch.bfloat16
    for rows in rows_list:
        x = torch.randn(rows, 768, generator=g, device=dev).to(bf)
        amax = (x.float().abs().amax(-1, keepdim=True)
                * (1 + torch.rand(rows, 1, generator=g, device=dev)))
        gg, uu = _silu_mul_inputs(torch, g, rows, 4480, dev)
        am2 = (w8a8.quantize_silu_mul_plain(gg, uu)[1]
               * (1 + torch.rand(rows, 1, generator=g, device=dev)))
        for name, fn, twin, args, nbytes in (
                ("quantize_rows", w8a8.quantize_rows,
                 w8a8.quantize_rows_plain, (x,), rows * (768 * 3 + 8)),
                ("quantize_silu_mul", w8a8.quantize_silu_mul,
                 w8a8.quantize_silu_mul_plain, (gg, uu),
                 rows * (4480 * 5 + 8))):
            am_in = amax if name == "quantize_rows" else am2
            q, am = fn(*args, amax=am_in)
            torch.cuda.synchronize()
            pq, pam = twin(*args, amax=am_in)
            bad = int((q != pq).sum()) + int((am != pam).sum())
            ctrl = int((fn(*args)[0] != q).sum())  # its own absmax
            ms = _cold_ms(torch, lambda *a: fn(*a[:-1], amax=a[-1]),
                          (*args, am_in), 20)
            plain_ms = _kernel_ms(torch, lambda: twin(*args, amax=am_in), 5)
            bound, by = _bound_s(0, nbytes)
            print(f"{name} with an absmax input {rows}x"
                  f"{args[0].shape[1]} (tp 2): codes / scales differing "
                  f"from the twin {bad}; the row's own absmax changes "
                  f"{ctrl} codes (must be > 0); {ms:.4f} ms (plain "
                  f"{plain_ms:.4f}, bound {bound:.4f}) {tag}", flush=True)
            if bad or ctrl == 0:
                raise RuntimeError(f"{name} with an absmax input disagrees "
                                   "with its twin")
            extra[name][f"absmax_tp2_r{rows}"] = dict(
                max_abs_err=float(bad), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def tp_serve_phase(torch, np, dev, tag, extra, rehearse=None, layers=None):
    """Phase 57: the tensor axis for serving on the one card. NCCL refuses
    two ranks on one card, so two processes share it over a gloo group on
    CUDA tensors (every collective of core/tensor_parallel moves real
    data). (a) Vlaser-2B-VLA's control step through PolicyServer(mesh=,
    fused=True) (the plain route, as JAX on a mesh) against the
    one-process plain step from the same weights: on the int8 weight-only
    tree in fp32, max |d action| <= TP_ACT_TOL (control: the expert's
    o_proj all-reduce dropped breaks it); on the w8a8 tree in bf16, a
    row-parallel input's int8 codes equal the one-device codes of its
    whole rows (control: the rank's own absmax breaks it), the actions'
    difference printed (see _tp_vla). (b) Vlaser-2B in fp32 through
    ContinuousBatchingEngine(mesh=):
    one TP_TILES-tile request and 3 text requests, TP_NEW tokens each,
    token-identical to the one-process engine; control: o_proj's
    all-reduce dropped. Then the same requests at the chat serving
    default (bf16 w8a8: the quantizers with the all-reduced absmax, flash
    and the RMSNorm kernel on the rank's 6 / 1 heads), held to finite
    tokens and equal ranks; its agreement with one process is printed.
    Every rank's completions must be equal. `layers`: the LLM layers of
    both models (full width; None: all 28). -> rank 0's launches of the
    runs on the mesh."""
    import torch.multiprocessing as mp

    if rehearse is None:
        tp_absmax_phase(torch, dev, tag, extra)
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        t0 = time.perf_counter()
        mp.spawn(_tp_rank, args=(2, work, rehearse, layers), nprocs=2)
        res = [torch.load(os.path.join(work, f"tp.{r}"), weights_only=False)
               for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t0
    a = [r["vla"] for r in res]
    w = [r["vla_w8a8"] for r in res]
    dmax = lambda rows, k: max(float(np.abs(x[k] - x["want"]).max())
                               for x in rows)
    d_act, d_drop = dmax(a, "got"), dmax(a, "dropped")
    d_w8a8, d_local = dmax(w, "got"), dmax(w, "local")
    print(f"phase 57 (a) Vlaser-2B-VLA step over tensor 2 (serving_path "
          f"{a[0]['path']!r}), the int8 weight-only tree in fp32: max "
          f"|d action| (infer_action's chunk) vs one process {d_act:.3e} "
          f"(bound {TP_ACT_TOL}); control, the expert's o_proj all-reduce "
          f"dropped: {d_drop:.3e} (must be > bound); wall {a[0]['ms']:.1f} "
          f"ms vs {a[0]['plain_ms']:.1f} ms one process ({TP_NOTE}) {tag}",
          flush=True)
    print(f"phase 57 (a) the w8a8 tree in bf16 (the serving default): int8 "
          f"codes of a row-parallel input ({w[0]['rows']} rows x "
          f"{w[0]['cols']} columns, {w[0]['cols'] // 2} a rank) equal one "
          f"device's: {[x['codes_equal'] for x in w]}; control, the rank's "
          f"own absmax: codes equal {[x['codes_local'] for x in w]} (one "
          f"must be False); |d action| vs one process {d_w8a8:.3e} (code "
          f"flips; not gated), with the own absmax {d_local:.3e}; launches "
          f"(rank 0, one step) {w[0]['counts']}; wall {w[0]['ms']:.1f} / "
          f"{w[1]['ms']:.1f} ms vs {w[0]['plain_ms']:.1f} ms one process "
          f"({TP_NOTE}) {tag}", flush=True)
    if not (a[0]["path"] == w[0]["path"] == "plain" and d_act <= TP_ACT_TOL
            and d_drop > TP_ACT_TOL and all(x["codes_equal"] for x in w)
            and not all(x["codes_local"] for x in w)
            and all(np.isfinite(x["got"]).all() for x in a + w)):
        raise RuntimeError("phase 57 (a): the tensor-parallel control step "
                           "fails its gates or a control")
    if not (np.array_equal(a[0]["got"], a[1]["got"])
            and np.array_equal(w[0]["got"], w[1]["got"])):
        raise RuntimeError("phase 57 (a): the ranks' actions differ")
    b = [r["engine"] for r in res]
    bad = [u for u in b[0]["want"] if b[0]["got"].get(u) != b[0]["want"][u]]
    dropped = sum(b[0]["dropped"][u] != b[0]["want2"][u]
                  for u in b[0]["want2"])
    print(f"phase 57 (b) Vlaser-2B fp32 engine over tensor 2 (prompts "
          f"{b[0]['prompt']}, {b[0]['new']} new tokens each; KV heads a rank "
          f"{b[0]['kv_heads']}): requests differing from one process {bad} "
          f"(must be none); ranks equal {b[0]['got'] == b[1]['got']}; "
          f"control (o_proj's all-reduce dropped; 2 new tokens): {dropped} "
          f"of {len(b[0]['want'])} differ (must be > 0); launches (rank 0) "
          f"{b[0]['counts']}; wall {b[0]['ms']:.1f} ms, "
          f"{b[0]['tokens'] / b[0]['ms'] * 1e3:.1f} tok/s vs "
          f"{b[0]['plain_ms']:.1f} ms one process ({TP_NOTE}) {tag}",
          flush=True)
    if bad or dropped == 0 or b[0]["got"] != b[1]["got"]:
        raise RuntimeError("phase 57 (b): the tensor-parallel engine fails "
                           "its gate or its control")
    c = [r["engine_w8a8"] for r in res]
    agree = [sum(1 for x, y in zip(c[0]["got"][u], c[0]["want"][u]) if x == y)
             for u in sorted(c[0]["want"])]
    print(f"phase 57 (b) Vlaser-2B w8a8 bf16 engine over tensor 2: tokens "
          f"agreeing with one process, by request {agree} of {c[0]['new']} "
          f"(bf16: partial sums over ranks round otherwise; no gate); ranks "
          f"equal {c[0]['got'] == c[1]['got']}; launches (rank 0) "
          f"{c[0]['counts']}; wall {c[0]['ms']:.1f} ms vs "
          f"{c[0]['plain_ms']:.1f} ms one process ({TP_NOTE}); phase "
          f"{seconds:.1f} s {tag}", flush=True)
    if c[0]["got"] != c[1]["got"] or not all(
            len(t) > 0 for t in c[0]["got"].values()):
        raise RuntimeError("phase 57 (b): the w8a8 engine's ranks disagree")
    want = ("flash_attention_fwd", "_rms_fwd", "quantize_rows",
            "quantize_silu_mul", "int8_gemm")
    if rehearse is None and not all(c[0]["counts"].get(k) for k in want):
        raise RuntimeError(f"phase 57: a kernel of the w8a8 engine's path "
                           f"never launched: {c[0]['counts']}")
    return _add(_add(_add(dict(a[0]["counts"]), w[0]["counts"]),
                     b[0]["counts"]), c[0]["counts"])


# -- the tensor axis for training (phase 58) ----------------------------------
TP_TRAIN_STEPS = 2
TP_TRAIN_ROWS = 2  # packed rows of SFT_TOKENS a step (every rank feeds both)
# phases 57-58 in the whole script: the LLM layers of their models (of 28;
# full width), for its time limit (1,177.2 and 1,248.5 s of 1,200 with
# both at full depth on H100 80GB HBM3 hosts that built the kernels in
# 145.7 and 170.1 s); --tp-serve / --tp-train run all 28
TP_LAYERS = 8


def _tp_train_batch(np, cfg, tokens, rows=TP_TRAIN_ROWS):
    """`rows` packed rows (_packed_batch, phase 26's segments rotated a
    row)."""
    lengths = (tokens * 3 // 8, tokens * 5 // 16, tokens // 4)
    parts = [_packed_batch(np, cfg, tokens, 26 + i,
                           lengths[i % 3:] + lengths[:i % 3])
             for i in range(rows)]
    return {k: np.concatenate([r[k] for r in parts]) for k in parts[0]}


def _tp_train_model(torch, dev, cfg):
    """Phase 26's full-parameter SFT model: fp32 parameters, bf16 compute,
    remat, scripts/train_sft.random_init_ from seed 26."""
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.scripts.train_sft import random_init_

    model = InternVLChatModel(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.bfloat16, device=dev,
                              remat=True)
    random_init_(model, torch.Generator(dev).manual_seed(26))
    return model


def _tp_train_grad(torch, model, sharded, loss_fn, batch):
    """The loss and grad norm one step of the trainer would report on
    `batch` (its loss function, the state's sums and norms), with no
    update: a control's numbers. -> (loss, grad norm)."""
    params = list(model.parameters())
    model.zero_grad(set_to_none=True)
    loss = loss_fn(batch)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    loss = loss.detach().float().reshape(1)
    sharded.reduce(params, [loss])
    norm = sharded.grad_norms([params])[0]
    model.zero_grad(set_to_none=True)
    return float(loss[0]), float(norm)


def _tp_train_rank(rank, n, work, rehearse=None, layers=None):
    """One of the n processes of phase 58 (tensor n over a gloo group on
    CUDA tensors, both on card 0): phase 26's SFT model cut over tensor n
    by SFTTrainer(TrainConfig(mesh_tp=n)); two controls (no update):
    down_proj's all-reduce dropped, the vocab-parallel CE's sum of exp
    not all-reduced; then TP_TRAIN_STEPS steps with the launch counters
    zeroed just before and read just after. Writes its results to
    work/tp_train.<rank>. `rehearse`: (VLM config, tokens) to run the
    same code on CPU processes at a small size."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from vlaser_tpu_torch.core import tensor_parallel as tpl
    from vlaser_tpu_torch.core.config import vlaser_2b
    from vlaser_tpu_torch.train import losses
    from vlaser_tpu_torch.train.trainer import SFTTrainer, TrainConfig

    cfg, tokens = rehearse or (_cut_depth(vlaser_2b(), layers), SFT_TOKENS)
    if rehearse is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    else:
        torch.set_num_threads(2)
        dev = torch.device("cpu")
    dist.init_process_group("gloo", init_method=f"file://{work}/tp_pg",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=600))
    res, tag = {}, f"(rank {rank})"
    try:
        batch = _tp_train_batch(np, cfg, tokens)
        t0 = time.perf_counter()
        model = _tp_train_model(torch, dev, cfg)
        trainer = SFTTrainer(model, TrainConfig(mesh_tp=n))
        _tp_sync(torch, dev)
        res["build_s"] = time.perf_counter() - t0
        sharded = trainer.sharded
        loss_fn = losses.make_sft_loss(model, mesh=trainer.mesh)
        tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        down = model.language_model.model.layers.mlp.down_proj
        kept = _drop_reduce(tpl, down)
        try:
            res["drop_down"] = _tp_train_grad(torch, model, sharded,
                                              loss_fn, tb)
        finally:
            down.tp = kept
        kept = losses._sum_exp_over_vocab
        losses._sum_exp_over_vocab = lambda x, tp: x
        try:
            res["drop_sum_exp"] = _tp_train_grad(torch, model, sharded,
                                                 loss_fn, tb)
        finally:
            losses._sum_exp_over_vocab = kept
        del tb
        res["run"] = _shard_run(torch, lambda b: trainer.train(iter([b])),
                                batch, f"SFT tensor {n} {tag}",
                                TP_TRAIN_STEPS)
        res["held_gib"] = sharded.bytes_per_rank() / 2**30
        res["layers"] = cfg.llm.num_layers
        res["heads"] = (model.language_model.model.layers.self_attn.heads,
                        model.language_model.model.layers.self_attn.kv_heads)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(work, f"tp_train.{rank}"))


def _tp_flash_phase(torch, np, dev, cfg, tag, extra):
    """flash_attention_fwd / _bwd at a tensor-2 rank's heads of the SFT
    step (Vlaser-2B's 12 / 2 -> 6 / 1 x 128: the backward walks a GQA
    group of 6), on TP_TRAIN_ROWS packed causal rows of SFT_TOKENS,
    against the plain versions with phase 9's controls, timed beside
    SDPA. Filed under "sft_tp2"."""
    llm = cfg.llm
    H, KVH = llm.num_heads // 2, max(llm.num_kv_heads // 2, 1)
    g = torch.Generator(device=dev)
    g.manual_seed(58)
    seg = torch.as_tensor(_tp_train_batch(np, cfg, SFT_TOKENS)["seg_ids"],
                          dtype=torch.int32, device=dev)
    f, b = _flash_case(torch, dev, g, tag, f"sft tp2 {H}/{KVH}",
                       TP_TRAIN_ROWS, SFT_TOKENS, SFT_TOKENS, H, KVH,
                       llm.head_dim, seg, None, seg, None, causal=True)
    extra["flash_attention_fwd"]["sft_tp2"] = f
    extra["flash_attention_bwd"]["sft_tp2"] = b


def tp_train_phase(torch, np, dev, tag, extra, rehearse=None, layers=None):
    """Phase 58: the tensor axis for training on the one card. The flash
    kernels at a rank's 6 / 1 heads first (_tp_flash_phase). Then phase
    26's full-parameter Vlaser-2B SFT step on TP_TRAIN_ROWS packed rows
    of SFT_TOKENS: SFTTrainer without a mesh in this process,
    TP_TRAIN_STEPS steps, freed; then the same weights and batch through
    SFTTrainer(TrainConfig(mesh_tp=2)) in two processes that share the
    card over a gloo group on CUDA tensors (NCCL refuses two ranks on one
    card; _tp_train_rank). Gate: each step's loss and grad norm within
    MULTI_REL of the one-process step's, on both ranks; each control
    (down_proj's all-reduce dropped; the vocab-parallel CE's sum of exp
    not all-reduced) must break it on step 1's numbers. Launches (rank
    0, the steps only) held to phase 26's per-step counts. Ms a step (a
    gloo wall: not a speed figure) and each rank's peak memory beside
    utils/memory_budget.vlm_sft_budget(1, 1, 2). `layers`: the LLM layers
    of both runs (full width; None: all 28). -> rank 0's launches."""
    import torch.multiprocessing as mp

    from vlaser_tpu_torch.core.config import vlaser_2b
    from vlaser_tpu_torch.train.trainer import SFTTrainer, TrainConfig
    from vlaser_tpu_torch.utils import memory_budget as mb

    cfg, tokens = rehearse or (_cut_depth(vlaser_2b(), layers), SFT_TOKENS)
    if rehearse is None:
        _tp_flash_phase(torch, np, dev, cfg, tag, extra)
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch = _tp_train_batch(np, cfg, tokens)
    model = _tp_train_model(torch, dev, cfg)
    trainer = SFTTrainer(model, TrainConfig())
    plain = _shard_run(torch, lambda b: trainer.train(iter([b])), batch,
                       "SFT one process", TP_TRAIN_STEPS)
    del model, trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_tpt_")
    try:
        t1 = time.perf_counter()
        mp.spawn(_tp_train_rank, args=(2, work, rehearse, layers), nprocs=2)
        spawn_s = time.perf_counter() - t1
        res = [torch.load(os.path.join(work, f"tp_train.{r}"),
                          weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rel = lambda got, want: max(abs(a - b) / abs(b)
                                for a, b in zip(got, want))
    want = plain[1] + plain[2]
    d_run = max(rel(r["run"][1] + r["run"][2], want) for r in res)
    first = (plain[1][0], plain[2][0])
    d_down = max(rel(r["drop_down"], first) for r in res)
    d_exp = max(rel(r["drop_sum_exp"], first) for r in res)
    run = res[0]["run"]
    budget = mb.vlm_sft_budget(1, 1, 2, per_device_batch=TP_TRAIN_ROWS,
                               seq_len=tokens, model_size="2b",
                               frozen_patterns=(r"vision_model/",))
    L = res[0]["layers"]
    depth = ("the full depth" if layers is None else
             f"TP_LAYERS of 28: the script's time limit; --tp-train runs "
             f"all 28, and the budget is the full model's")
    print(f"phase 58 Vlaser-2B SFT over tensor 2 ({L} LLM layers, {depth}; "
          f"heads a rank {res[0]['heads']}; {TP_TRAIN_ROWS} x "
          f"{tokens} packed tokens): losses {run[1]}, grad norms {run[2]} "
          f"vs one process {plain[1]}, {plain[2]}: max rel diff "
          f"{d_run:.3e} over both ranks (bound {MULTI_REL}); controls on "
          f"step 1: down_proj's all-reduce dropped {d_down:.3e}, the CE's "
          f"sum of exp not all-reduced {d_exp:.3e} (each must be > bound)"
          f" {tag}", flush=True)
    print(f"phase 58 step ms {[round(t, 1) for t in run[0]]} over tensor 2 "
          f"vs {[round(t, 1) for t in plain[0]]} one process ({TP_NOTE}); "
          f"peak GiB a rank {[round(r['run'][4], 2) for r in res]} vs "
          f"{plain[4]:.2f} one process; parameters a rank "
          f"{[round(r['held_gib'], 2) for r in res]} GiB; "
          f"memory_budget.vlm_sft_budget(1, 1, 2): params "
          f"{budget['params_gib']:.2f}, grads {budget['grads_gib']:.2f}, "
          f"moments {budget['moments_gib']:.2f}, acts "
          f"{budget['acts_gib']:.2f}, total {budget['total_gib']:.2f} GiB; "
          f"model built in {res[0]['build_s']:.1f} s a rank; processes "
          f"{spawn_s:.1f} s, phase {time.perf_counter() - t0:.1f} s {tag}",
          flush=True)
    if not (d_run <= MULTI_REL < min(d_down, d_exp)):
        raise RuntimeError("phase 58: the tensor-parallel SFT step fails "
                           "its gate or a control")
    if not all(math.isfinite(v) for r in res for v in r["run"][1]
               + r["run"][2]):
        raise RuntimeError("phase 58: a non-finite loss or grad norm")
    counts = res[0]["run"][3]
    if rehearse is None:
        _held(counts, {"flash_attention_fwd": TP_TRAIN_STEPS * 2 * L,
                       "flash_attention_bwd": TP_TRAIN_STEPS * L,
                       "_rms_fwd": TP_TRAIN_STEPS * (4 * L + 1),
                       "_rms_bwd": TP_TRAIN_STEPS * (2 * L + 1)},
              "phase 58 SFT over tensor 2 (rank 0)")
    return dict(counts)


# -- phase 59: the stage axis for training ------------------------------------
PP_STEPS = 2
PP_ROWS = 4  # packed rows of SFT_TOKENS a step (every stage feeds all four)
PP_MICRO = 4  # microbatches: one row each
PP_STAGES = 2
# phase 59 in the whole script: the LLM layers (of 28; full width), for its
# time limit, as TP_LAYERS; --pp-train runs all 28
PP_LAYERS = 8
PP_LR = 1e-5


@contextmanager
def pp_backward_dropped(pipeline):
    """A control: inside the block every cotangent the pipeline's backward
    sends to the stage before is zeros (the transfers still run), so every
    stage but the last gets zero layer gradients."""
    sched, link = pipeline._Schedule, pipeline._Link
    backward, send = sched.backward, link.send
    inside = []

    def zero_backward(ctx, g):
        inside.append(True)
        try:
            return backward(ctx, g)
        finally:
            inside.pop()

    def zero_send(self, t, dst):
        return send(self, t * 0 if inside else t, dst)

    sched.backward, link.send = staticmethod(zero_backward), zero_send
    try:
        yield
    finally:
        sched.backward, link.send = staticmethod(backward), send


@contextmanager
def pp_consts_misrouted(pipeline):
    """A control: inside the block pipeline_llm_forward gives every
    microbatch microbatch 0's segment ids (the constants misrouted)."""
    forward = pipeline.pipeline_llm_forward

    def misrouted(cfg, layers, x, cos, sin, seg_ids, **kw):
        m = kw["n_microbatches"]
        seg_ids = seg_ids[:seg_ids.shape[0] // m].repeat(
            m, *([1] * (seg_ids.dim() - 1)))
        return forward(cfg, layers, x, cos, sin, seg_ids, **kw)

    pipeline.pipeline_llm_forward = misrouted
    try:
        yield
    finally:
        pipeline.pipeline_llm_forward = forward


def _pp_batch(np, cfg, tokens, rows=PP_ROWS):
    """`rows` packed rows of `tokens` (_tp_train_batch at Vlaser-2B): the
    LM's ids, labels (-100 on the prompts and the pad tail) and segment
    ids, the ids folded into the LLM config `cfg`'s vocabulary (a
    rehearsal's is smaller)."""
    from vlaser_tpu_torch.core.config import vlaser_2b

    b = _tp_train_batch(np, vlaser_2b(), tokens, rows)
    ids, labels = b["input_ids"], b["labels"]
    return {"input_ids": ids % cfg.vocab_size,
            "labels": np.where(labels >= 0, labels % cfg.vocab_size, labels),
            "seg_ids": b["seg_ids"]}


def _pp_model(torch, dev, cfg):
    """Qwen2ForCausalLM at `cfg` (fp32 parameters, bf16 compute), drawn
    from seed 59 as scripts/train_sft.random_init_ draws the LLM:
    N(0, 0.02^2), norm weights 1 + N(0, 0.1^2)."""
    from vlaser_tpu_torch.models.layers import RMSNorm, init_normal_
    from vlaser_tpu_torch.models.qwen2 import Qwen2ForCausalLM

    model = Qwen2ForCausalLM(cfg, param_dtype=torch.float32,
                             compute_dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(dev).manual_seed(59)
    init_normal_(model, gen, std=0.02)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, RMSNorm):
                m.weight.copy_(1 + 0.1 * torch.randn(
                    m.weight.shape, generator=gen, device=dev))
    return model


def _pp_step(torch, model, mesh, m, rules=True):
    """make_train_step over the pipeline loss (remat, flash and RMSNorm on
    their auto routes): AdamW at PP_LR, decay 0.01, clip 1.0; the state
    sharded by stageify_rules over `mesh` (None: one process, one
    stage). -> (step(a numpy batch), the ShardedState or None, the loss
    function)."""
    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.train.pipeline import make_pipeline_lm_loss
    from vlaser_tpu_torch.train.train_step import (ParamGroup,
                                                   make_train_step,
                                                   shard_train_state)

    sharded = None
    if mesh is not None:
        r = mesh_lib.default_param_rules()
        sharded = shard_train_state(model, mesh, mesh_lib.stageify_rules(r)
                                    if rules else r)
    loss_fn = make_pipeline_lm_loss(model, n_microbatches=m, mesh=mesh)
    groups = {"all": ParamGroup(list(model.parameters()),
                                lambda i: PP_LR, 0.01, 1.0)}
    step = make_train_step(loss_fn, groups, sharded=sharded)
    dev = next(model.parameters()).device
    return (lambda b: step({k: torch.as_tensor(v).to(dev)
                            for k, v in b.items()}), sharded, loss_fn)


def _pp_grad(torch, model, sharded, loss_fn, batch):
    """One step's loss and grad norm on `batch` (the step's sums and
    norms) and layer 0's q_proj gradient (None on a stage without layer
    0), with no update: at random weights the loss and its norm barely see
    where a token attends, layer 0's attention gradient does. -> (loss,
    grad norm, the gradient on the host)."""
    from vlaser_tpu_torch.train.train_step import grad_norm

    params = list(model.parameters())
    model.zero_grad(set_to_none=True)
    loss = loss_fn({k: torch.as_tensor(v).to(params[0].device)
                    for k, v in batch.items()})
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    loss = loss.detach().float().reshape(1)
    if sharded is not None:
        sharded.reduce(params, [loss])
        norm = sharded.grad_norms([params])[0]
    else:
        norm = grad_norm(params)
    q = model.model.layers.self_attn.q_proj
    first = q._staged is None or q._staged["kernel"] == 0
    g0 = q.kernel.grad[0].float().cpu() if first else None
    model.zero_grad(set_to_none=True)
    return float(loss[0]), float(norm), g0


def _pp_apart(got, want):
    """The largest relative gap of (loss, grad norm, layer 0's gradient:
    its L2 distance over want's L2 norm; skipped where got has none)."""
    d = max(abs(a - b) / abs(b) for a, b in zip(got[:2], want[:2]))
    if got[2] is not None:
        d = max(d, float((got[2] - want[2]).norm() / want[2].norm()))
    return d


def _pp_want(L, stages, rank, m, steps):
    """Launches of `steps` pipeline steps on stage `rank`: each of its
    L / stages layers runs every microbatch once forward and once again
    in its remat recompute (flash fwd 2, RMSNorm fwd 4: two norms a layer)
    and once backward (flash bwd 1, RMSNorm bwd 2); the last stage adds
    the final norm's forward and backward over the whole batch."""
    lm = L // stages * m
    last = int(rank == stages - 1)
    return {"flash_attention_fwd": steps * 2 * lm,
            "flash_attention_bwd": steps * lm,
            "_rms_fwd": steps * (4 * lm + last),
            "_rms_bwd": steps * (2 * lm + last)}


def _pp_train_rank(rank, n, work, rehearse=None, layers=None):
    """One of the n processes of phase 59 (stage n over a gloo group on
    CUDA tensors, both on card 0): phase 59's LLM at stage n, its state
    sharded by stageify_rules; two controls (no update): the backward's
    transfers zeroed, every microbatch given microbatch 0's segment ids;
    then PP_STEPS steps with the launch counters zeroed just before and
    read just after, the time blocked in receives beside them. Writes its
    results to work/pp_train.<rank>. `rehearse`: (LLM config, tokens) to
    run the same code on CPU processes at a small size."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core.config import vlaser_2b
    from vlaser_tpu_torch.train import pipeline

    cfg, tokens = rehearse or (_cut_depth(vlaser_2b(), layers).llm,
                               SFT_TOKENS)
    if rehearse is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    else:
        torch.set_num_threads(2)
        dev = torch.device("cpu")
    dist.init_process_group("gloo", init_method=f"file://{work}/pp_pg",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=600))
    res, tag = {}, f"(rank {rank})"
    try:
        batch = _pp_batch(np, cfg, tokens)
        t0 = time.perf_counter()
        model = _pp_model(torch, dev, cfg)
        mesh = mesh_lib.make_mesh(dp=1, pp=n)
        step, sharded, loss_fn = _pp_step(torch, model, mesh, PP_MICRO)
        _tp_sync(torch, dev)
        res["build_s"] = time.perf_counter() - t0
        res["host"] = pipeline.stage_link(mesh).host
        res["grad"] = _pp_grad(torch, model, sharded, loss_fn, batch)
        with pp_backward_dropped(pipeline):
            res["drop_backward"] = _pp_grad(torch, model, sharded, loss_fn,
                                            batch)
        with pp_consts_misrouted(pipeline):
            res["misrouted"] = _pp_grad(torch, model, sharded, loss_fn,
                                        batch)
        pipeline.reset_waits()
        res["run"] = _shard_run(torch, step, batch,
                                f"LM stage {n} {tag}", PP_STEPS)
        res["recv_s"] = pipeline.WAITS["recv_s"]
        res["recvs"] = pipeline.WAITS["recvs"]
        res["held_gib"] = sharded.bytes_per_rank() / 2**30
        res["layers"] = cfg.num_layers
        res["held_layers"] = (
            model.model.layers.self_attn.q_proj.kernel.shape[0])
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(work, f"pp_train.{rank}"))


def pp_train_phase(torch, np, dev, tag, extra, rehearse=None, layers=None):
    """Phase 59: the stage axis for training on the one card. Vlaser-2B's
    LLM (Qwen2.5-1.5B at full width: hidden 1,536, 12 / 2 heads x 128, I
    8,960, an untied 151,674-word head; fp32 parameters, bf16 compute,
    remat, AdamW) on PP_ROWS packed rows of SFT_TOKENS: the plain stack in
    this process (the pipeline loss at one stage and one microbatch: the
    same CE), PP_STEPS steps, freed; then the same weights and batch at
    stage PP_STAGES, PP_MICRO microbatches, in two processes that share
    the card over a gloo group on CUDA tensors (NCCL refuses two ranks on
    one card; _pp_train_rank). Gate: each step's loss and grad norm within
    MULTI_REL of the one-process step's, on both ranks, and so is a first
    step with no update read with layer 0's q_proj gradient (_pp_grad);
    each control (the backward's transfers zeroed; every microbatch given
    microbatch 0's segment ids) must break that step's gate. Launches of
    each rank (the steps only) held to _pp_want. Ms a step (a gloo wall:
    not a speed figure), each rank's time blocked in receives beside
    GPipe's bubble, and each rank's peak memory beside one process's. `layers`: the LLM
    layers of both runs (full width; None: all 28). -> rank 0's
    launches."""
    import torch.multiprocessing as mp

    from vlaser_tpu_torch.core.config import vlaser_2b

    cfg, tokens = rehearse or (_cut_depth(vlaser_2b(), layers).llm,
                               SFT_TOKENS)
    t0 = time.perf_counter()
    batch = _pp_batch(np, cfg, tokens)
    model = _pp_model(torch, dev, cfg)
    step, _, loss_fn = _pp_step(torch, model, None, 1)
    grad = _pp_grad(torch, model, None, loss_fn, batch)
    plain = _shard_run(torch, step, batch, "LM one process", PP_STEPS)
    del model, step, loss_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_ppt_")
    try:
        t1 = time.perf_counter()
        mp.spawn(_pp_train_rank, args=(PP_STAGES, work, rehearse, layers),
                 nprocs=PP_STAGES)
        spawn_s = time.perf_counter() - t1
        res = [torch.load(os.path.join(work, f"pp_train.{r}"),
                          weights_only=False) for r in range(PP_STAGES)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rel = lambda got, want: max(abs(a - b) / abs(b)
                                for a, b in zip(got, want))
    want = plain[1] + plain[2]
    d_run = max(rel(r["run"][1] + r["run"][2], want) for r in res)
    d_grad = max(_pp_apart(r["grad"], grad) for r in res)
    d_drop = max(_pp_apart(r["drop_backward"], grad) for r in res)
    d_mis = max(_pp_apart(r["misrouted"], grad) for r in res)
    run = res[0]["run"]
    L = res[0]["layers"]
    n, m = PP_STAGES, PP_MICRO
    bubble = (n - 1) / (m + n - 1)
    depth = ("the full depth" if layers is None else
             f"PP_LAYERS of 28: the script's time limit; --pp-train runs "
             f"all 28")
    print(f"phase 59 Vlaser-2B's LLM over stage {n} ({L} layers, {depth}; "
          f"{res[0]['held_layers']} a stage; {PP_ROWS} x {tokens} packed "
          f"tokens, {m} microbatches): losses {run[1]}, grad norms {run[2]} "
          f"vs one process {plain[1]}, {plain[2]}: max rel diff "
          f"{d_run:.3e} over both ranks; step 1 with no update (loss, "
          f"grad norm and layer 0's q_proj gradient, its relative L2 "
          f"distance) {d_grad:.3e} (bound {MULTI_REL} for both); controls "
          f"on that step: the backward's transfers zeroed {d_drop:.3e}, "
          f"every microbatch given microbatch 0's segment ids {d_mis:.3e} "
          f"(each must be > bound) {tag}", flush=True)
    staged = ("gloo: CUDA tensors staged through host memory"
              if res[0]["host"] else "device transfers")
    ms = [[round(t, 1) for t in r["run"][0]] for r in res]
    print(f"phase 59 step ms {ms} over stage {n} vs "
          f"{[round(t, 1) for t in plain[0]]} one process ({TP_NOTE}; "
          f"{staged}); time blocked in receives a rank "
          f"{[round(r['recv_s'] * 1e3, 1) for r in res]} ms over "
          f"{PP_STEPS} steps ({res[0]['recvs']} receives a rank), "
          f"{[round(r['recv_s'] * 1e3 / sum(r['run'][0]), 3) for r in res]}"
          f" of the steps' wall vs GPipe's bubble (n-1)/(M+n-1) = "
          f"{bubble:.3f}; peak GiB a rank "
          f"{[round(r['run'][4], 2) for r in res]} vs {plain[4]:.2f} one "
          f"process; parameters a rank "
          f"{[round(r['held_gib'], 2) for r in res]} GiB; model built in "
          f"{res[0]['build_s']:.1f} s a rank; processes {spawn_s:.1f} s, "
          f"phase {time.perf_counter() - t0:.1f} s {tag}", flush=True)
    if not (max(d_run, d_grad) <= MULTI_REL < min(d_drop, d_mis)):
        raise RuntimeError("phase 59: the pipelined LM step fails its gate "
                           "or a control")
    if not all(math.isfinite(v) for r in res for v in r["run"][1]
               + r["run"][2]):
        raise RuntimeError("phase 59: a non-finite loss or grad norm")
    if rehearse is None:
        for r, out in enumerate(res):
            _held(out["run"][3], _pp_want(L, n, r, m, PP_STEPS),
                  f"phase 59 LM over stage {n} (rank {r})")
    return dict(res[0]["run"][3])


# -- the layouts across cards (--multichip N) ----------------------------------
MULTI_STEPS = 2
MULTI_REL = 1e-2  # loss / grad norm: fsdp 2 x cp 2 over NCCL vs one card


def _multichip_rank(rank, n, work, rehearse=None):
    """One rank of `--multichip n`, on card `rank`, in an NCCL group of n:
    (1) phase 26's full-parameter Vlaser-2B SFT step on two packed rows of
    SFT_TOKENS, MULTI_STEPS steps, over (data n / 4, fsdp 2, context 2)
    with the context-parallel LLM (the P2P ring on the flash kernels, the
    gathers and reduce-scatters of the ZeRO-3 state), rank 0 first running
    the same steps on one card alone; (f) the same step over (data n / 4,
    fsdp 2, tensor 2); (2) the Vlaser-8B-VLA step (phase 11's trainer,
    one row a rank) over fsdp n, which no one card holds.
    Writes {"plain", "sft", "sft_tp", "vla8b": _shard_run's results} to
    work/res.<rank>. `rehearse`: (SFT config, VLA config, tokens) to run
    the same code on a gloo group of CPU processes at a small size."""
    import dataclasses
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core.config import vlaser_2b, vlaser_8b_vla
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.scripts.train_sft import random_init_
    from vlaser_tpu_torch.train.trainer import (SFTTrainer, TrainConfig,
                                                VLATrainConfig, VLATrainer)

    cfg, vcfg, tokens = (rehearse[:3] if rehearse
                         else (vlaser_2b(), vlaser_8b_vla(), SFT_TOKENS))
    if rehearse is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        dist.init_process_group("nccl", init_method=f"file://{work}/pg",
                                rank=rank, world_size=n, device_id=dev,
                                timeout=datetime.timedelta(seconds=240))
    else:
        dev = torch.device("cpu")
        dist.init_process_group("gloo", init_method=f"file://{work}/pg",
                                rank=rank, world_size=n)
    res, tag = {}, f"(rank {rank})"
    try:
        ccfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, context_parallel_axis=mesh_lib.CONTEXT_AXIS))
        lengths = (tokens * 3 // 8, tokens * 5 // 16, tokens // 4)
        rows = [_packed_batch(np, cfg, tokens, 26 + i, lengths[i % 3:]
                              + lengths[:i % 3]) for i in range(n // 2)]
        batch = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}

        def sft(conf, m, b, what):
            model = InternVLChatModel(conf, param_dtype=torch.float32,
                                      compute_dtype=torch.bfloat16,
                                      device=dev, remat=True)
            random_init_(model, torch.Generator(dev).manual_seed(26))
            trainer = SFTTrainer(model, TrainConfig(), mesh=m)
            out = _shard_run(torch, lambda b_: trainer.train(iter([b_])), b,
                             f"{what} {tag}", MULTI_STEPS)
            del model, trainer
            gc.collect()
            torch.cuda.empty_cache()
            return out

        if rank == 0:
            res["plain"] = sft(cfg, None, batch,
                               f"SFT one card, {n // 2} rows")
        dist.barrier()
        mesh = mesh_lib.make_mesh(fsdp=2, cp=2)
        index, count = mesh_lib.batch_shard(mesh)
        local = {k: v[index:index + 1] for k, v in batch.items()}
        res["sft"] = sft(ccfg, mesh, local,
                         f"SFT mesh {mesh_lib.mesh_shape(mesh)}")
        dist.barrier()
        # (f) the same step over (data n / 4, fsdp 2, tensor 2): the
        # tensor axis's collectives over NCCL
        mesh = mesh_lib.make_mesh(dp=-1, fsdp=2, tp=2)
        index, count = mesh_lib.batch_shard(mesh)
        local = {k: v[index:index + 1] for k, v in batch.items()}
        res["sft_tp"] = sft(cfg, mesh, local,
                            f"SFT mesh {mesh_lib.mesh_shape(mesh)}")
        dist.barrier()

        mesh = mesh_lib.make_mesh(fsdp=n)
        model = PiZeroVLA(vcfg, param_dtype=torch.float32,
                          compute_dtype=torch.bfloat16, device=dev,
                          remat=True)
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        random_init_(model, gen)
        trainer = VLATrainer(model, VLATrainConfig(), generator=gen,
                             mesh=mesh)
        index, count = mesh_lib.batch_shard(mesh)
        vbatch = _train_batch(torch, np, dev, vcfg, count)
        vbatch = {k: v[index:index + 1] for k, v in vbatch.items()}
        res["vla8b"] = _shard_run(
            torch, lambda b_: trainer.train_steps(iter([b_]), 1), vbatch,
            f"Vlaser-8B-VLA mesh {mesh_lib.mesh_shape(mesh)} {tag}",
            MULTI_STEPS)
        res["vla8b_rank_bytes"] = trainer.sharded.bytes_per_rank()
        del model, trainer
        gc.collect()
        if rehearse is None:
            torch.cuda.empty_cache()
        dist.barrier()
        _multichip_tp(torch, np, dev, rank, n, res,
                      rehearse[3] if rehearse else None)
        dist.barrier()
        _multichip_pp(torch, np, dev, rank, n, res,
                      rehearse[4] if rehearse else None)
    finally:
        dist.destroy_process_group()
    import torch as _t

    _t.save(res, os.path.join(work, f"res.{rank}"))


MULTI_TP_STEPS = 3  # timed control steps a layout


def _tp_vla_steps(torch, np, dev, mesh, cfg, fused_ms, compute,
                  mode="w8a8"):
    """(c) on one layout: Vlaser-2B-VLA's serving tree of `mode` (the
    int8 weight-only gate tree, or w8a8) from seed 0 (random_init_, as
    phase 57) computing in `compute`, the one-card plain step and
    (fused_ms, bf16 only) the fused one-card step, then the model cut over
    `mesh` (PolicyServer(mesh=)). -> (max |d action| of infer_action's
    chunk, ms a step on the mesh, one-card plain ms, fused ms or None)."""
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.envs.adapters import BridgeSimplerAdapter
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.policy.processing import InternVLAProcessor
    from vlaser_tpu_torch.scripts.train_sft import random_init_
    from vlaser_tpu_torch.serve.policy_server import PolicyServer

    model = PiZeroVLA(cfg, param_dtype=torch.bfloat16, compute_dtype=compute,
                      device=dev)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.no_grad():
        random_init_(model, gen)
    quantize_for_serving(model, target="policy", mode=mode)
    img = cfg.vlm.vision.image_size
    proc = InternVLAProcessor(SmokeTokenizer(cfg.vlm),
                              num_image_tokens=cfg.vlm.num_image_token,
                              max_seq_len=cfg.max_image_text_tokens,
                              pad_token_id=cfg.vlm.pad_token_id)
    frame = np.random.default_rng(8).integers(0, 256, (img, img, 3),
                                              dtype=np.uint8)
    obs = {"agent": {"eef_pos": np.array([0.1, 0.0, 0.2, 1, 0, 0, 0, 0.5],
                                         np.float32)}}

    def timed(srv):
        raw, infer = [], srv._infer
        srv._infer = lambda *a: raw.append(infer(*a)) or raw[-1]
        times = []
        for _ in range(MULTI_TP_STEPS + 1):  # the first: a warm-up
            srv.generator.manual_seed(0)
            srv.reset("put the carrot on the plate")
            _tp_sync(torch, dev)
            t = time.perf_counter()
            srv.step(obs, frame)
            _tp_sync(torch, dev)
            times.append((time.perf_counter() - t) * 1e3)
        srv._infer = infer
        return raw[-1].float().cpu().numpy(), statistics.median(times[1:])

    mk = lambda **kw: PolicyServer(model, None, BridgeSimplerAdapter(
        dataset_statistics=TP_STATS, image_size=(img, img)), proc,
        act_steps=4, seed=0, device=dev, **kw)
    want, plain_ms = timed(mk())
    f_ms = timed(mk(fused=True))[1] if fused_ms else None
    got, ms = timed(mk(fused=True, mesh=mesh))
    return float(np.abs(got - want).max()), ms, plain_ms, f_ms


def _random_shards_(torch, model, rank, cut, std=0.02):
    """Fill a materialized model's floating leaves from a generator seeded
    by (leaf, rank) for the leaves `cut` over the tensor axis and by the
    leaf alone for the rest (replicated: equal on every rank): N(0, std^2),
    norm weights 1."""
    import zlib

    gen = torch.Generator(device=next(model.parameters()).device)
    with torch.no_grad():
        for name, t in itertools.chain(model.named_parameters(),
                                       model.named_buffers()):
            if not t.is_floating_point():
                continue
            parent, leaf = name.split(".")[-2:]
            if "norm" in parent:
                t.fill_(1.0 if leaf == "weight" else 0.0)
                continue
            gen.manual_seed(zlib.crc32(name.encode())
                            + (rank << 32 if name in cut else 0))
            t.normal_(0.0, std, generator=gen)


def _chat_78b(torch, np, dev, rank, mesh, tiles, new, rehearse_cfg=None):
    """(e) InternVL3-78B in bf16 over tensor 4: each rank's shards built
    on `meta`, cut (core/tensor_parallel.shard_model), materialized and
    drawn (_random_shards_); one tiles-tile chat request through the
    engine: ms to the first token (a 1-token run), ms a token (the
    difference to a `new`-token run), the rank's peak GiB."""
    import dataclasses

    from vlaser_tpu_torch.core import tensor_parallel as tpl
    from vlaser_tpu_torch.core.config import internvl3_78b
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.serve.engine import ContinuousBatchingEngine

    cfg = rehearse_cfg or internvl3_78b()
    bf = torch.bfloat16
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = InternVLChatModel(cfg, param_dtype=bf, compute_dtype=bf,
                              device="meta")
    model.requires_grad_(False)
    group, size, idx = tpl.tensor_group(mesh)
    tpl.shard_model(model, size, idx, group)
    model = model.to_empty(device=dev)
    _random_shards_(torch, model, idx, set(model._tensor_plan.leaves))
    _tp_sync(torch, dev)
    build_s = time.perf_counter() - t0
    held = sum(t.numel() * t.element_size() for t in model.parameters())
    reqs = _tp_requests(np, cfg, tiles, (), new)
    n = len(reqs[0].input_ids) + new
    max_len = -(-n // 128) * 128
    eng = ContinuousBatchingEngine(model, num_slots=1, max_len=max_len,
                                   eos_token_ids=[2],
                                   pad_token_id=cfg.pad_token_id,
                                   prefill_buckets=(max_len,),
                                   cache_dtype=bf, mesh=mesh)

    def run(k):
        r = dataclasses.replace(reqs[0], max_new_tokens=k)
        _tp_sync(torch, dev)
        t = time.perf_counter()
        done = eng.run([r])
        _tp_sync(torch, dev)
        return done[0].token_ids, (time.perf_counter() - t) * 1e3

    run(2)  # warm-up
    _, first_ms = run(1)
    toks, all_ms = run(new)
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else 0.0)
    return {"first_ms": first_ms, "token_ms": (all_ms - first_ms) / (new - 1),
            "tokens": toks, "peak_gib": peak, "held_gib": held / 2**30,
            "build_s": build_s, "prompt": len(reqs[0].input_ids)}


def _multichip_tp(torch, np, dev, rank, n, res, rehearse=None):
    """The tensor axis over n NCCL cards: (c) the VLA control step at
    tensor 2 (data n / 2) and tensor n against one card, (d) the engine at
    tensor n on Vlaser-2B (fp32 token identity, then the w8a8 bf16 chat
    default's tok/s), (e) InternVL3-78B chat at tensor n."""
    import torch.distributed as dist

    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core.config import vlaser_2b, vlaser_2b_vla

    vla_cfg, vlm_cfg, tiles, new, big = (
        rehearse if rehearse else (vlaser_2b_vla(), vlaser_2b(), TP_TILES,
                                   TP_NEW, None))
    for tp in (2, n):
        mesh = mesh_lib.make_mesh(dp=-1, fsdp=1, tp=tp)
        # the gate on the int8 weight-only tree in fp32 (as phase 57: the
        # w8a8 quantizer turns any rounding difference into flipped
        # codes); the w8a8 serving default in bf16, printed
        for key, dt, mode in (("", torch.bfloat16, "w8a8"),
                              ("_fp32", torch.float32, "int8")):
            res[f"vla_tp{tp}{key}"] = _tp_vla_steps(
                torch, np, dev, mesh, vla_cfg, (tp == 2 and not key), dt,
                mode)
            gc.collect()
            torch.cuda.empty_cache() if dev.type == "cuda" else None
            dist.barrier()
    mesh = mesh_lib.make_mesh(dp=1, fsdp=1, tp=n)
    for key, bf in (("engine_fp32", False), ("engine_w8a8", True)):
        res[key] = _tp_engine(torch, np, dev, mesh, vlm_cfg, tiles, new, bf)
        gc.collect()
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        dist.barrier()
    res["chat_78b"] = _chat_78b(torch, np, dev, rank, mesh, tiles, new, big)


PP_BIG_LAYERS = 8  # (h): of InternVL3-38B's 64 LLM layers, 2 a stage
PP_BIG_STAGES = 4


def _multichip_pp(torch, np, dev, rank, n, res, rehearse=None):
    """The stage axis over n cards: (g) phase 59's step (Vlaser-2B's LLM
    at full depth, PP_ROWS packed rows of SFT_TOKENS) over (data n / 4,
    fsdp 2, stage 2), one row a microbatch, against the plain stack on
    one card (rank 0 alone first); (h) InternVL3-38B's LLM (Qwen2.5-32B at
    full width) at PP_BIG_LAYERS layers over (data n / 4, stage 4),
    PP_ROWS rows a data rank, at 2 microbatches against 4 (no one card
    holds the step's fp32 state). Receives drain the stream before and
    after each wait (pipeline.SYNC_WAITS), so their time is the device's
    wait. `rehearse`: (the LLM config of (g), that of (h), tokens)."""
    import dataclasses

    import torch.distributed as dist

    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core.config import internvl3_38b, vlaser_2b
    from vlaser_tpu_torch.train import pipeline

    gcfg, hcfg, tokens = rehearse or (
        vlaser_2b().llm, dataclasses.replace(internvl3_38b().llm,
                                             num_layers=PP_BIG_LAYERS),
        SFT_TOKENS)
    pipeline.SYNC_WAITS = dev.type == "cuda"
    tag = f"(rank {rank})"

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()

    def run(cfg, mesh, batch, m, key, what):
        index, count = mesh_lib.batch_shard(mesh)
        b = batch["input_ids"].shape[0] // count
        local = {k: v[index * b:(index + 1) * b] for k, v in batch.items()}
        model = _pp_model(torch, dev, cfg)
        step, sharded, _ = _pp_step(torch, model, mesh, m)
        waits = []

        def waited(b_):  # each step's time blocked in receives
            pipeline.reset_waits()
            out = step(b_)
            waits.append(pipeline.WAITS["recv_s"])
            return out

        res[key] = _shard_run(torch, waited, local, f"{what} mesh "
                              f"{mesh_lib.mesh_shape(mesh)} M {m} {tag}",
                              MULTI_STEPS)
        res[f"{key}_recv_s"] = waits
        res[f"{key}_held"] = sharded.bytes_per_rank()

    batch = _pp_batch(np, gcfg, tokens)
    if rank == 0:
        step = _pp_step(torch, _pp_model(torch, dev, gcfg), None, 1)[0]
        res["pp_plain"] = _shard_run(torch, step, batch, "(g) LM one card",
                                     MULTI_STEPS)
        del step
    free()
    mesh = mesh_lib.make_mesh(dp=-1, fsdp=2, pp=2)
    run(gcfg, mesh, batch, PP_ROWS // mesh_lib.batch_shard(mesh)[1],
        "pp_g", "(g) LM")
    free()
    mesh = mesh_lib.make_mesh(dp=-1, pp=PP_BIG_STAGES)
    batch = _pp_batch(np, hcfg, tokens,
                      PP_ROWS * mesh_lib.batch_shard(mesh)[1])
    for m in (2, 4):
        run(hcfg, mesh, batch, m, f"pp_h{m}", "(h) 38B LM")
        free()
    pipeline.SYNC_WAITS = False


def _multichip_pp_rank(rank, n, work, rehearse=None):
    """One rank of `--multichip n --stage-only`: _multichip_pp alone,
    results to work/res.<rank>."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    if rehearse is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        dist.init_process_group("nccl", init_method=f"file://{work}/pg",
                                rank=rank, world_size=n, device_id=dev,
                                timeout=datetime.timedelta(seconds=240))
    else:
        dev = torch.device("cpu")
        dist.init_process_group("gloo", init_method=f"file://{work}/pg",
                                rank=rank, world_size=n)
    res = {}
    try:
        _multichip_pp(torch, np, dev, rank, n, res, rehearse)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(work, f"res.{rank}"))


def _multichip_pp_report(res, n, tag):
    """Print (g) and (h) of `--multichip n` (see _multichip_pp), then raise
    if a gate failed."""
    import torch

    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core.config import vlaser_2b
    from vlaser_tpu_torch.models.qwen2 import Qwen2ForCausalLM
    from vlaser_tpu_torch.utils import memory_budget as mb

    rel = lambda got, want: max(abs(a - b) / abs(b)
                                for a, b in zip(got, want))
    plain, g = res[0]["pp_plain"], res[0]["pp_g"]
    d_g = max(rel(r["pp_g"][1] + r["pp_g"][2], plain[1] + plain[2])
              for r in res)
    dp = max(n // 4, 1)
    budget = mb.vlm_sft_budget(dp, 2, 1, pp=2, n_microbatches=2,
                               per_device_batch=PP_ROWS // (2 * dp),
                               seq_len=SFT_TOKENS, model_size="2b")
    rules = mesh_lib.stageify_rules(mesh_lib.default_param_rules())
    llm = mb.param_leaves(Qwen2ForCausalLM(vlaser_2b().llm,
                                           device=torch.device("meta")))
    llm_gib = 4 * mb.sharded_bytes_per_device(
        llm, mb._abstract_mesh(dp, 2, 1, 2), rules) / 2**30
    # the last step's: the first sets up NCCL's communicators
    wait = lambda key: [round(r[f"{key}_recv_s"][-1] * 1e3, 1) for r in res]
    ms = lambda key: [round(r[key][0][-1], 1) for r in res]
    print(f"multichip (g) Vlaser-2B's LLM (28 layers) over fsdp 2 x stage 2 "
          f"on {n} NCCL cards, {PP_ROWS} x {SFT_TOKENS} packed tokens, a "
          f"row a microbatch: losses {g[1]}, grad norms {g[2]} vs one card "
          f"{plain[1]}, {plain[2]}: max rel diff {d_g:.3e} over the ranks "
          f"(bound {MULTI_REL}); the last step's ms a rank {ms('pp_g')} "
          f"vs {plain[0][-1]:.1f} one card, its time blocked in receives "
          f"a rank {wait('pp_g')} ms (bubble 1/3 at M 2); "
          f"peak GiB a rank {[round(r['pp_g'][4], 2) for r in res]} vs "
          f"{plain[4]:.2f} one card; parameters + grads + moments a rank "
          f"{[round(4 * r['pp_g_held'] / 2**30, 2) for r in res]} GiB vs "
          f"{llm_gib:.2f} the LLM's under stageify_rules "
          f"(memory_budget.vlm_sft_budget({dp}, 2, 1, pp=2), the VLM: "
          f"params {budget['params_gib']:.2f}, grads "
          f"{budget['grads_gib']:.2f}, moments {budget['moments_gib']:.2f}"
          f", total {budget['total_gib']:.2f}) {tag}", flush=True)
    h2, h4 = res[-1]["pp_h2"], res[-1]["pp_h4"]
    d_h = max(rel(r["pp_h2"][1] + r["pp_h2"][2],
                  r["pp_h4"][1] + r["pp_h4"][2]) for r in res)
    print(f"multichip (h) InternVL3-38B's LLM (Qwen2.5-32B, "
          f"{PP_BIG_LAYERS} of 64 layers) over stage {PP_BIG_STAGES} on {n} "
          f"NCCL cards, {PP_ROWS} x {SFT_TOKENS} packed tokens a data "
          f"rank: M 2 losses {h2[1]}, grad norms {h2[2]} vs M 4 {h4[1]}, "
          f"{h4[2]}: max rel diff {d_h:.3e} (bound {MULTI_REL}); the last "
          f"step's ms a rank M 2 {ms('pp_h2')}, M 4 {ms('pp_h4')}, its time "
          f"blocked in receives a rank M 2 {wait('pp_h2')}, M 4 "
          f"{wait('pp_h4')} ms (bubble 3/5, 3/7); "
          f"peak GiB a rank M 2 {[round(r['pp_h2'][4], 2) for r in res]}, "
          f"M 4 {[round(r['pp_h4'][4], 2) for r in res]}; parameters + "
          f"grads + moments a rank "
          f"{[round(4 * r['pp_h4_held'] / 2**30, 2) for r in res]} GiB "
          f"{tag}", flush=True)
    bad = [k for k, d in (("(g)", d_g), ("(h)", d_h))
           if not d <= MULTI_REL]
    if not all(math.isfinite(v) for r in res for key in ("pp_g", "pp_h2",
                                                           "pp_h4")
               for v in r[key][1] + r[key][2]):
        bad.append("a non-finite loss or grad norm")
    if bad:
        raise RuntimeError(f"multichip: stage-axis gates failed: {bad}")


def multichip(n, tag, stage_only=False):
    """`--multichip n`: the data / fsdp / context layouts over n cards, one
    NCCL rank a card (_multichip_rank), (f) the SFT step over fsdp 2 x
    tensor 2 (the only run of the tensor axis's training collectives over
    NCCL), then the tensor axis for serving (_multichip_tp), then the
    stage axis, (g) and (h) (_multichip_pp; alone with stage_only). The
    sharded SFT step's losses and grad norms are held to the one-card step
    within MULTI_REL; the 8B-VLA step's losses must be finite; each rank's
    peak memory is printed beside utils/memory_budget's per-device
    total."""
    import torch
    import torch.multiprocessing as mp

    if torch.cuda.device_count() < n or n % 4:
        raise SystemExit(f"--multichip {n}: needs a multiple of 4 cards, "
                         f"{torch.cuda.device_count()} visible")
    work = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    try:
        t0 = time.perf_counter()
        mp.spawn(_multichip_pp_rank if stage_only else _multichip_rank,
                 args=(n, work), nprocs=n)
        res = [torch.load(os.path.join(work, f"res.{r}")) for r in range(n)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if not stage_only:
        _multichip_report(res, n, time.perf_counter() - t0, tag)
    _multichip_pp_report(res, n, tag)
    print(f"multichip: {time.perf_counter() - t0:.1f} s in all {tag}",
          flush=True)


def _multichip_tp_report(res, n, tag):
    """Print (c)-(e) of `--multichip n` (see _multichip_tp), then raise if
    a gate failed."""
    bad_gates = []
    for tp in (2, n):
        rows = [r[f"vla_tp{tp}"] for r in res]
        d = max(x[0] for x in rows)
        f32 = [r[f"vla_tp{tp}_fp32"] for r in res]
        d32 = max(x[0] for x in f32)
        fused = rows[0][3]
        print(f"multichip (c) Vlaser-2B-VLA control step at tensor {tp}"
              f" (data {n // tp}): max |d action| vs one card, the int8 "
              f"weight-only tree in fp32 {d32:.3e} (bound {TP_ACT_TOL}), "
              f"the w8a8 tree in bf16 (the serving default, no gate) "
              f"{d:.3e}; bf16 ms a step "
              f"{[round(x[1], 2) for x in rows]} vs {rows[0][2]:.2f} one card "
              f"plain" + (f", {fused:.2f} one card fused" if fused else "")
              + f"; fp32 {f32[0][1]:.2f} vs {f32[0][2]:.2f} ms {tag}",
              flush=True)
        if not d32 <= TP_ACT_TOL:
            bad_gates.append(f"(c) at tensor {tp}")
    e = [r["engine_fp32"] for r in res]
    bad = [u for u in e[0]["want"] if e[0]["got"].get(u) != e[0]["want"][u]]
    dropped = sum(e[0]["dropped"][u] != e[0]["want2"][u]
                  for u in e[0]["want2"])
    same = all(x["got"] == e[0]["got"] for x in e)
    w = [r["engine_w8a8"] for r in res]
    print(f"multichip (d) Vlaser-2B fp32 engine at tensor {n} (prompts "
          f"{e[0]['prompt']}, {e[0]['new']} new tokens each, KV heads a rank "
          f"{e[0]['kv_heads']}): requests differing from one card {bad} "
          f"(must be none), ranks equal {same}, control {dropped} differ; "
          f"{e[0]['ms']:.1f} ms, {e[0]['tokens'] / e[0]['ms'] * 1e3:.1f} "
          f"useful tok/s vs {e[0]['plain_ms']:.1f} ms one card; w8a8 bf16 "
          f"(the chat default): {w[0]['ms']:.1f} ms, "
          f"{w[0]['tokens'] / w[0]['ms'] * 1e3:.1f} tok/s vs "
          f"{w[0]['plain_ms']:.1f} ms one card, ranks equal "
          f"{all(x['got'] == w[0]['got'] for x in w)}, launches (rank 0) "
          f"{w[0]['counts']} {tag}", flush=True)
    if bad or not same or dropped == 0:
        bad_gates.append("(d)")
    c = [r["chat_78b"] for r in res]
    print(f"multichip (e) InternVL3-78B bf16 chat at tensor {n}: "
          f"{c[0]['prompt']}-token prompt ({TP_TILES} tiles), "
          f"{len(c[0]['tokens'])} new tokens; first token "
          f"{c[0]['first_ms']:.1f} ms, {c[0]['token_ms']:.2f} ms a token; "
          f"weights a rank {[round(x['held_gib'], 2) for x in c]} GiB, peak "
          f"{[round(x['peak_gib'], 2) for x in c]} GiB; built in "
          f"{c[0]['build_s']:.1f} s; ranks equal "
          f"{all(x['tokens'] == c[0]['tokens'] for x in c)} {tag}",
          flush=True)
    if not all(x["tokens"] == c[0]["tokens"] for x in c):
        bad_gates.append("(e)")
    if bad_gates:
        raise RuntimeError(f"multichip: gates failed: {bad_gates}")


def _multichip_report(res, n, seconds, tag):
    """Print and hold `--multichip n`'s results (see multichip)."""
    from vlaser_tpu_torch.utils import memory_budget as mb

    plain = res[0]["plain"]
    sft = res[0]["sft"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(sft[1] + sft[2],
                                                   plain[1] + plain[2]))
    peaks = [r["sft"][4] for r in res]
    print(f"multichip SFT fsdp 2 x cp 2 over {n} cards: losses {sft[1]}, "
          f"grad norms {sft[2]} vs one card {plain[1]}, {plain[2]}: rel "
          f"diff {rel:.3e} (bound {MULTI_REL}); last step {sft[0][-1]:.3f} "
          f"ms vs {plain[0][-1]:.3f} ms one card; peak GiB a rank "
          f"{[round(p, 2) for p in peaks]} vs {plain[4]:.2f} one card "
          f"{tag}", flush=True)
    budget = mb.vla_train_budget(1, n, 1, per_device_batch=1,
                                 model_size="8b")
    vla = [r["vla8b"] for r in res]
    print(f"multichip Vlaser-8B-VLA fsdp {n}: losses {vla[0][1]}, grad "
          f"norms {vla[0][2]}, step ms {[round(t, 3) for t in vla[0][0]]}, "
          f"peak GiB a rank {[round(v[4], 2) for v in vla]}, parameter "
          f"shard {res[0]['vla8b_rank_bytes'] / 2**30:.2f} GiB a rank; "
          f"memory_budget at fsdp {n}: params {budget['params_gib']:.2f}, "
          f"grads {budget['grads_gib']:.2f}, moments "
          f"{budget['moments_gib']:.2f}, acts {budget['acts_gib']:.2f}, "
          f"total {budget['total_gib']:.2f} GiB ({seconds:.1f} s in all) "
          f"{tag}", flush=True)
    ft = res[0]["sft_tp"]
    rel_tp = max(abs(a - b) / abs(b) for a, b in zip(ft[1] + ft[2],
                                                      plain[1] + plain[2]))
    budget_tp = mb.vlm_sft_budget(max(n // 4, 1), 2, 2, per_device_batch=1,
                                  seq_len=SFT_TOKENS, model_size="2b",
                                  frozen_patterns=(r"vision_model/",))
    print(f"multichip (f) SFT fsdp 2 x tensor 2 over {n} NCCL cards: losses "
          f"{ft[1]}, grad norms {ft[2]} vs one card: rel diff "
          f"{rel_tp:.3e} (bound {MULTI_REL}); last step {ft[0][-1]:.3f} ms; "
          f"peak GiB a rank {[round(r['sft_tp'][4], 2) for r in res]} vs "
          f"memory_budget.vlm_sft_budget total "
          f"{budget_tp['total_gib']:.2f} GiB (params "
          f"{budget_tp['params_gib']:.2f}, moments "
          f"{budget_tp['moments_gib']:.2f}) {tag}", flush=True)
    _multichip_tp_report(res, n, tag)
    if not rel <= MULTI_REL:
        raise RuntimeError("the sharded SFT step over NCCL disagrees with "
                           "its one-card step")
    if not rel_tp <= MULTI_REL:
        raise RuntimeError("(f): the SFT step over fsdp 2 x tensor 2 "
                           "disagrees with its one-card step")
    if not all(math.isfinite(x) for v in vla for x in v[1] + v[2]):
        raise RuntimeError("the 8B-VLA step over fsdp gave a non-finite "
                           "loss or grad norm")


def layout_phases(torch, np, dev, tag, extra):
    """Phases 54-56, the data / fsdp / context layouts: -> launches of
    their main paths (the ring's chunk steps, the sharded trainers)."""
    launches = ring_phase(torch, np, dev, tag, extra)
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, sharded_trainer_phase(torch, np, dev, tag))
    dryrun_phase(tag)
    return launches


KERNEL_GROUPS = (("flash attention", ("fa::",)), ("RMSNorm", ("rms::",)),
                 ("w8a8 quantizer + int8 GEMM", ("w8a8::",)),
                 ("fused ViT", ("vit::",)), ("int8 stack", ("dec::",)),
                 ("GEMM", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
                 ("AdamW", ("adam",)))


def _profile_step(torch, trainer, batch, tag):
    _profile(torch, lambda: trainer.train_steps(iter([batch]), 1),
             "train step", tag)


def _profile(torch, fn, label, tag, quiet=False):
    """One call of fn under torch.profiler, device activity only (host ops
    would only slow the call and the trace's post-processing): device time
    by kernel group and the share of the call's wall time with no kernel
    running. -> {"busy":
    device ms, "groups": ms by group, "kernels": ms by kernel name (its
    name before any template or argument list), "launches": kernels
    launched (copies and fills not counted), "launch_keys": launches by
    the profiler's full kernel name}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    return {"busy": busy, "wall": wall_ms, "groups": groups,
            "kernels": by_name, "launches": launches, "launch_keys": keys}


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
    ap.add_argument("--layouts", action="store_true",
                    help="only build the kernels and run phases 54-56 (the "
                         "parallel layouts), then exit")
    ap.add_argument("--tp-serve", action="store_true",
                    help="only build the kernels and run phase 57 (the "
                         "tensor axis for serving: two processes on the "
                         "card), then exit")
    ap.add_argument("--tp-train", action="store_true",
                    help="only build the kernels and run phase 58 (the "
                         "tensor axis for training: two processes on the "
                         "card), then exit")
    ap.add_argument("--pp-train", action="store_true",
                    help="only build the kernels and run phase 59 (the "
                         "stage axis for training: two processes on the "
                         "card, all 28 layers), then exit")
    ap.add_argument("--multichip", type=int, metavar="N",
                    help="only build the kernels and run the layouts, the "
                         "tensor axis and the stage axis over N cards (a "
                         "multiple of 4), one NCCL rank a card, then exit")
    ap.add_argument("--stage-only", action="store_true",
                    help="with --multichip: only the stage axis's "
                         "sections (g) and (h)")
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

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ beside nvcc
        native = pool.submit(native_build_job)
        _build.library()
        native = native.result()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.last_build_seconds:.1f} s, g++ {native['seconds']:.1f} s"
          f") -> {_build.BUILD_DIR}", flush=True)

    if args.engine_wall:
        engine_wall(torch, np, dev, vlaser_2b(), args.profile_first, tag)
        return 0
    if args.multichip:
        multichip(args.multichip, tag, args.stage_only)
        return 0
    if args.pp_train:
        launches = pp_train_phase(torch, np, dev, tag, {})
        print(json.dumps({"launches": launches}), flush=True)
        return 0
    if args.tp_serve:
        extra = {"quantize_rows": {}, "quantize_silu_mul": {}}
        launches = tp_serve_phase(torch, np, dev, tag, extra)
        print(json.dumps({"launches": launches, "absmax": extra}), flush=True)
        return 0
    if args.tp_train:
        extra = {"flash_attention_fwd": {}, "flash_attention_bwd": {}}
        launches = tp_train_phase(torch, np, dev, tag, extra)
        print(json.dumps({"launches": launches, "flash": extra}), flush=True)
        return 0
    if args.layouts:
        extra = {"flash_attention_fwd": {}, "flash_attention_bwd": {}}
        launches = layout_phases(torch, np, dev, tag, extra)
        print(json.dumps({"launches": launches, "ring": extra}), flush=True)
        return 0
    _build_report(_build)
    report = {}
    # the kernels at the 8B and Qwen3 shapes, filed beside each kernel's
    # other entries at the end (phases 41-43 run before the phases that
    # make those entries)
    extra = {k: {} for k in ("fused_int8_stack", "quantize_rows",
                             "quantize_silu_mul", "int8_gemm",
                             "flash_attention_fwd", "flash_attention_bwd",
                             "_rms_fwd", "_rms_bwd")}

    def phase(label, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase wall: {label} {time.perf_counter() - t:.1f} s {tag}",
              flush=True)
        return out

    # first: its wall times are host-bound, and a profiler session leaves
    # later launches in the process slower (PERF.md)
    launches = phase("20-22 engine", engine_phases, torch, np, dev,
                     vlaser_2b(), tag, report)
    # the entry points' phases serve over HTTP, and the data-generation
    # phases 50-52 on their model drive the chat backends: host-bound too
    _add(launches, phase("35-37, 50-52 entry points, data generation",
                         vlm_entry_phases, torch, np, dev, vlaser_2b(), tag,
                         report))
    # the closed-loop harnesses: host-bound as well
    _add(launches, phase("38-39 closed loop", closed_loop_phases, torch, np,
                         dev, vlaser_2b_vla(), vlaser_2b(), tag))
    # the dense families beyond Vlaser-2B; their chat and engine timings
    # are host-bound, and 42 profiles one step last
    _add(launches, phase("41 Vlaser-8B chat", vlaser8b_chat_phase, torch, np,
                         dev, tag, extra))
    _add(launches, phase("43 InternVL3.5-2B", internvl35_phase, torch, np,
                         dev, tag, extra))
    # the native loader's 13 tiles, then the 30B MoE chat on them
    tiles, _ = phase("44 native loader", native_loader_phase, torch, np, tag,
                     native)
    _add(launches, phase("45 InternVL3.5-30B-A3B", moe_chat_phase, torch, np,
                         dev, tag, extra, tiles))
    _add(launches, phase("42 Vlaser-8B-VLA", vlaser8b_vla_phase, torch, np,
                         dev, tag, extra))
    # the profiler's first trace in a process can miss its first kernels
    _profile(torch, lambda: torch.ones(8, device=dev).add_(1), "warm-up", tag,
             quiet=True)
    phase("stack launches", stack_launch_phase, torch, dev, vlaser_2b().llm,
          tag)
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
    _add(launches, phase("1-3 int8 serving", serving_phases, torch, np, dev,
                         cfg, tag, report))
    _add(launches, phase("4-8 w8a8 serving", w8a8_phases, torch, np, dev,
                         cfg, tag, report))
    phase("9 flash", flash_phase, torch, dev, cfg, tag, report)
    phase("10 RMSNorm", rms_phase, torch, dev, cfg, tag, report)
    _add(launches, phase("11 train", train_phase, torch, np, dev, cfg, tag,
                         report))
    work = tempfile.mkdtemp(prefix="chip_smoke_")  # checkpoint: ~15 GB
    try:
        _add(launches, phase("32-34 VLA 8-bit", vla8bit_phases, torch, np,
                             dev, cfg, tag, report, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _add(launches, phase("12-16 chat", chat_phases, torch, np, dev,
                         vlaser_2b(), tag, report))
    _add(launches, phase("17-19 PaliGemma", pali_phases, torch, np, dev,
                         pizero_paligemma(), tag, report))
    _add(launches, phase("23-26 SFT", sft_phases, torch, np, dev,
                         vlaser_2b(), tag, report))
    _add(launches, phase("40 RoboTwin train", robotwin_train_phases, torch,
                         np, dev, vlaser_2b(), tag, report))
    cut = _cut_depth(vlaser_2b(), CUT_LAYERS)
    work = tempfile.mkdtemp(prefix="chip_smoke_")  # checkpoints: ~15 GB
    try:
        _add(launches, phase("27-31 CLIs", cli_phases, torch, np, dev, cut,
                             tag, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the VLA's text head and ablations, InternViT-6B, the graft entry:
    # after every phase that profiles the cooperative decoder stack (run
    # before the warm-up session, they left its launches out of the next
    # profiles)
    _add(launches, phase("46-49 text head, adaLN-Zero, 6B ViT",
                         text_ablation_phases, torch, np, dev, tag, extra))
    # the data / fsdp / context layouts: the ring's chunk route, the
    # trainers over a one-rank NCCL group (destroyed after), and the
    # 8-rank gloo mirror of the multi-device gate on the host
    _add(launches, phase("54-56 parallel layouts", layout_phases, torch, np,
                         dev, tag, extra))
    # the tensor axis for serving: two processes share the card over gloo
    _add(launches, phase("57 tensor-parallel serving", tp_serve_phase,
                         torch, np, dev, tag, extra, None, TP_LAYERS))
    # the tensor axis for training: two processes share the card again
    _add(launches, phase("58 tensor-parallel training", tp_train_phase,
                         torch, np, dev, tag, extra, None, TP_LAYERS))
    # the stage axis for training: two processes share the card again
    _add(launches, phase("59 pipeline training", pp_train_phase, torch, np,
                         dev, tag, extra, None, PP_LAYERS))
    phase("engine profile", engine_profile_phase, torch, np, dev,
          vlaser_2b(), tag, report)
    # reads the train phases' peaks; its profiler sessions come last
    phase("53 memory budget", budget_phase, torch, dev, tag)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "vlaser_tpu")]
    if bad:
        raise RuntimeError(f"the port imported {bad[:4]}")

    for name, r in report.pop("engine_kernels").items():
        report[name]["engine"] = r
    for name, shapes in extra.items():
        report[name].update(shapes)
    split = {f"r{r}": n for r, n in sorted(MAIN_SPLIT.items())}
    report["fused_int8_stack"]["launches_by_rows"] = split
    print(f"fused_int8_stack launches on the main paths by rows: {split} "
          f"(of {launches.get('fused_int8_stack', 0)}) {tag}", flush=True)
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
            ("_rms_bwd", "rmsnorm.cu", "kernels/rmsnorm.py:89"),
            ("adamw8bit", "adam8bit.cu", "train/optim8bit.py:142")):
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
