"""vlaser_tpu_torch: the PyTorch + CUDA port of vlaser_tpu for NVIDIA Hopper.

The first slice is the Vlaser-2B-VLA batch-1 control step under the
weight-only int8 serving mode: fused InternViT encoder, VLM prefix, and the
10-step Euler denoise through the fused int8 expert stack. Framework-free
modules (configs, processor, adapters, tiling, tokenizer) are imported from
`vlaser_tpu` itself; nothing here imports jax.
"""

__version__ = "0.1.0"
