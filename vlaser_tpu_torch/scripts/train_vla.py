"""VLA flow-matching training entry point of the port (scripts/train_vla.py's
recipe): the RLDS bridge / fractal mixture ->
InternVLAProcessor inputs -> VLATrainer (two optimizer groups, beta
flow-time sampling, fp32 parameters with bf16 compute and remat).

    python -m vlaser_tpu_torch.scripts.train_vla --model_path Vlaser-2B/ \\
        --rlds_dir /data/oxe --datasets bridge_dataset \\
        fractal20220817_data --batch 32 --steps 20000 [--adam8bit]

The flags are the JAX CLI's, plus --device (the card unless it says
"cpu"; without a card it raises); --fsdp above 1 trains over the
processes' ranks (torchrun or slurm, as train_sft): ZeRO-3 state over
fsdp, each rank fed its shard of the RLDS batches (its batch coordinate,
core/mesh.batch_shard); with --adam8bit it raises NotImplementedError (a
shard would split the 8-bit blocks). `main` runs the JAX
`main`'s stages, each a function here: the tokenizer and the config, the
model and the processor, the RLDS batches and the trainer. The JAX CLI
initializes its parameters with `model.init`; the port's model takes a
seeded random init (scripts/train_sft.random_init_). The RLDS stream
needs `tensorflow` and `tensorflow_datasets` (imported by data/rlds.py's
functions only), the tokenizer `transformers`.
"""

from __future__ import annotations

import argparse
import logging
from typing import Callable, Dict, Iterator

import numpy as np
import torch

from .train_sft import build_mesh, resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--rlds_dir", required=True)
    ap.add_argument("--datasets", nargs="+", default=["bridge_dataset"])
    ap.add_argument("--weights", nargs="+", type=float, default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--horizon", type=int, default=4)
    ap.add_argument("--image_size", type=int, default=448)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--adam8bit", action="store_true",
                    help="8-bit optimizer state (bnb AdamW8bit parity)")
    ap.add_argument("--strong_aug", action="store_true",
                    help="use_strong_data_aug augmentation variant")
    ap.add_argument("--shuffle_buffer", type=int, default=200_000)
    ap.add_argument("--checkpoint_dir", default="checkpoints/vla")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def load_tokenizer(args):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(args.model_path, use_fast=False,
                                         trust_remote_code=True)


def build_config(args, tokenizer):
    """Vlaser-2B-VLA with the vocab sized to the tokenizer."""
    from ..core.config import vlaser_2b_vla

    return vlaser_2b_vla(vocab_size=len(tokenizer))


def build_model(args, cfg, device, seed: int = 0):
    """PiZeroVLA (fp32 parameters, bf16 compute, remat) with a seeded
    random init on `device`."""
    from ..policy.pizero import PiZeroVLA
    from .train_sft import random_init_

    model = PiZeroVLA(cfg, param_dtype=torch.float32,
                      compute_dtype=torch.bfloat16, device=device,
                      remat=True)
    return random_init_(model, torch.Generator(device).manual_seed(seed))


def build_processor(cfg, tokenizer):
    from ..policy.processing import InternVLAProcessor

    return InternVLAProcessor(tokenizer,
                              num_image_tokens=cfg.vlm.num_image_token,
                              max_seq_len=cfg.max_image_text_tokens)


def build_dataset(args, cfg):
    """The interleaved tf.data mixture of --datasets (normalized actions
    with the gripper left raw, windows of cfg.cond_steps frames and
    --horizon actions, resized and augmented frames), batched to --batch."""
    from ..data.rlds import (AUGMENT_KWARGS_PRIMARY,
                             AUGMENT_KWARGS_PRIMARY_STRONG,
                             OXE_STANDARDIZATION_TRANSFORMS,
                             RLDSDatasetConfig, apply_frame_transforms,
                             apply_trajectory_transforms,
                             make_dataset_from_rlds, make_interleaved_dataset)

    frames = []
    for name in args.datasets:
        d_cfg = RLDSDatasetConfig(
            name=name, data_dir=args.rlds_dir,
            standardize_fn=OXE_STANDARDIZATION_TRANSFORMS[name],
            norm_mask=[True] * 6 + [False],
            statistics_path=f"stats/{name}.json")
        traj, _ = make_dataset_from_rlds(d_cfg, train=True)
        f = apply_trajectory_transforms(
            traj, window_size=cfg.cond_steps, action_horizon=args.horizon,
            subsample_length=100, skip_unlabeled=True)
        aug = (AUGMENT_KWARGS_PRIMARY_STRONG if args.strong_aug
               else AUGMENT_KWARGS_PRIMARY)
        frames.append(apply_frame_transforms(
            f, resize=(args.image_size, args.image_size), train=True,
            image_augment_kwargs=aug))
    return make_interleaved_dataset(frames, args.weights,
                                    batch_size=args.batch,
                                    shuffle_buffer_size=args.shuffle_buffer)


def make_batches(mixed, processor, cfg) -> Callable[[], Iterator[Dict]]:
    """-> batches(): a fresh pass over the mixture, numpy batches of the
    latest frame, the instruction's processed prompt, the last proprio and
    the first num_action_tokens actions."""
    from ..data.rlds import RLDSInterleavedIterator

    def batches():
        for raw in RLDSInterleavedIterator(mixed):
            imgs = raw["observation"]["image_primary"][:, -1]
            texts = [t.decode() for t in raw["language_instruction"]]
            proc = processor(texts, imgs[:, None])
            yield {
                "input_ids": proc["input_ids"],
                "pixel_values": proc["pixel_values"],
                "text_mask": proc["attention_mask"],
                "proprios": np.asarray(raw["observation"]["proprio"][
                    :, -1:][..., :cfg.proprio_dim]),
                "actions": np.asarray(raw["action"][
                    :, :cfg.num_action_tokens]),
            }

    return batches


def build_trainer(args, model, mesh=None, **overrides):
    """VLATrainer with lr_action = lr_vlm = --lr, the 8-bit optimizer under
    --adam8bit and --checkpoint_dir, over `mesh`; `overrides`: other
    VLATrainConfig fields."""
    from ..train.trainer import VLATrainConfig, VLATrainer

    return VLATrainer(model, VLATrainConfig(
        lr_action=args.lr, lr_vlm=args.lr, mesh_fsdp=args.fsdp,
        optimizer_8bit=args.adam8bit, checkpoint_dir=args.checkpoint_dir,
        **overrides), mesh=mesh)


def main(argv=None):
    """Parse argv (sys.argv when None), train, and return the trainer."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    mesh = build_mesh(args)
    tokenizer = load_tokenizer(args)
    cfg = build_config(args, tokenizer)
    model = build_model(args, cfg, device)
    processor = build_processor(cfg, tokenizer)
    dataset = build_dataset(args, cfg)
    if mesh is not None:
        from ..core.distributed import shard_for_process
        from ..core.mesh import batch_shard

        index, count = batch_shard(mesh)
        dataset = shard_for_process(dataset, num_shards=count, index=index)
    batches = make_batches(dataset, processor, cfg)
    trainer = build_trainer(args, model, mesh=mesh)
    trainer.train_steps(batches(), args.steps)
    return trainer


if __name__ == "__main__":
    main()
