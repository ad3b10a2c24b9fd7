"""vlaser_tpu_torch: the PyTorch + CUDA port of vlaser_tpu for NVIDIA Hopper.

Slices ported so far: the Vlaser-2B-VLA batch-1 control step under the
weight-only int8 serving mode (fused InternViT encoder, VLM prefix, and the
10-step Euler denoise through the fused int8 expert stack), and the
flow-matching train step (flash attention and RMSNorm kernels, forward and
backward). The framework-free modules it needs (configs, processor, env
adapter, frame normalization) are copies kept in this package: nothing
here imports jax or `vlaser_tpu`.
"""

__version__ = "0.1.0"
