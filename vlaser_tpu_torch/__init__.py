"""vlaser_tpu_torch: the PyTorch + CUDA port of vlaser_tpu for NVIDIA Hopper.

Slices ported so far: the Vlaser-2B-VLA control step under the
weight-only int8 serving mode (fused InternViT encoder, VLM prefix, and the
10-step Euler denoise through the fused int8 expert stack), the
flow-matching train step (flash attention and RMSNorm kernels, forward and
backward), and the w8a8 serving default at batch 1 and batch 8 (the fused
ViT's act_quant mode and the int8 tensor-core GEMM of `w8a8_dot`), the
Vlaser-2B chat path, the PaliGemma VLA, continuous-batching serving, the
SFT train step and the training CLIs (`scripts/`: SFT, pretrain, MPO).
Entry points build on the CUDA card unless given `device="cpu"` (the CLIs:
`--device cpu`). The framework-free modules it needs (configs, processor,
env adapter, tiling, tokenizer, datasets, checkpoint converters) are copies
kept in this package: nothing here imports jax or `vlaser_tpu`.
"""

__version__ = "0.1.0"
