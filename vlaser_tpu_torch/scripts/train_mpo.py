"""MPO (Mixed Preference Optimization) training entry of the port, as
scripts/train_mpo.py: preference-pair JSONL ({image?, question, chosen,
rejected}) -> DPO sigmoid + BCO-pair + SFT losses against a frozen copy of
the initial parameters, on one CUDA device.

    python -m vlaser_tpu_torch.scripts.train_mpo --model_path Vlaser-2B/ \\
        --data pairs.jsonl --image_root images/ --steps 2000 --batch 4
    python -m vlaser_tpu_torch.scripts.train_mpo --tiny --data pairs.jsonl \\
        --steps 2 --device cpu

The flags are the JAX CLI's, plus --device (the card unless it says
"cpu"; without a card it raises); --fsdp above 1 trains over the
processes' ranks (torchrun or slurm, as train_sft): ZeRO-3 state over
fsdp, each rank fed its block of the global batch of --batch pairs a
rank. The tokenizer, config and weights stages are train_sft's; remat is
on unless --tiny, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import logging

from .train_sft import (build_config, build_mesh, load_model,
                        load_tokenizer, resolve_device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--data", required=True, help="preference-pair jsonl")
    ap.add_argument("--image_root", default="")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-6)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--max_seq", type=int, default=4096)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def build_dataset(args, cfg, tokenizer):
    from ..data.preference_dataset import (PreferenceDataset,
                                           PreferenceDatasetConfig)

    return PreferenceDataset(PreferenceDatasetConfig(
        jsonl_path=args.data, image_root=args.image_root,
        num_image_token=cfg.num_image_token, image_size=cfg.vision.image_size,
        max_seq_length=args.max_seq), tokenizer)


def batches(args, cfg, dataset, mesh=None):
    """Consecutive pairs of --batch, cycling over the dataset; over a mesh
    the global batch is --batch pairs a rank and each rank collates its
    block of them (its batch coordinate, core/mesh.batch_shard)."""
    from ..core.mesh import batch_shard
    from ..data.preference_dataset import preference_collate

    index, count = batch_shard(mesh) if mesh is not None else (0, 1)
    i = 0
    while True:
        start = i + index * args.batch
        chunk = [dataset[(start + j) % len(dataset)]
                 for j in range(args.batch)]
        i += args.batch * count
        yield preference_collate(chunk, cfg.pad_token_id)


def build_trainer(args, model, mesh=None):
    from ..train.mpo import MPOConfig, MPOTrainer
    from ..train.trainer import TrainConfig

    return MPOTrainer(model, MPOConfig(beta=args.beta), TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        mesh_fsdp=args.fsdp), mesh=mesh)


def main(argv=None):
    """Parse argv (sys.argv when None), train, and return the trainer."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    if not (args.tiny or args.model_path):
        raise SystemExit("need --model_path (or --tiny)")
    device = resolve_device(args.device)
    mesh = build_mesh(args)
    tokenizer = load_tokenizer(args)
    cfg, n_added, _, _ = build_config(args, tokenizer)
    model = load_model(args, cfg, n_added, len(tokenizer), device,
                       remat=not args.tiny)
    trainer = build_trainer(args, model, mesh)
    trainer.train(batches(args, cfg, build_dataset(args, cfg, tokenizer),
                          mesh), args.steps)
    return trainer


if __name__ == "__main__":
    main()
