"""InternVL-style pretrain entry of the port (stage 1 / 1.5), as
scripts/pretrain.py: the SFT machinery with other freeze masks and
learning rates over caption / conversation JSONL data,
  stage 1   -- train the mlp1 projector only (ViT and LLM frozen), high lr
  stage 1.5 -- train the projector and the LLM (ViT frozen), lower lr
(stage 2 is the SFT recipe: vlaser_tpu_torch.scripts.train_sft). It
delegates to the port's train_sft.main, so data, packing and checkpoints
behave the same.

    python -m vlaser_tpu_torch.scripts.pretrain --model_path InternVL-init/ \\
        --meta pretrain.json --stage 1 --steps 40000 --batch 32 [--packed]
    python -m vlaser_tpu_torch.scripts.pretrain --tiny --data captions.jsonl \\
        --stage 1 --steps 2 --device cpu
"""

from __future__ import annotations

import argparse
from typing import List

from . import train_sft

STAGE_DEFAULTS = {
    # lr per stage (shell/internvl3.0 pretrain recipes: projector-only warms
    # at a higher lr than full-LLM pretraining)
    "1": dict(lr=1e-3, freeze_vision=True, freeze_llm=True),
    "1.5": dict(lr=2e-5, freeze_vision=True, freeze_llm=False),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--data", default=None)
    ap.add_argument("--meta", default=None)
    ap.add_argument("--image_root", default="")
    ap.add_argument("--stage", choices=["1", "1.5"], default="1")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=None,
                    help="override the stage default lr")
    ap.add_argument("--max_seq", type=int, default=4096)
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--checkpoint_dir", default="checkpoints/pretrain")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def sft_argv(args) -> List[str]:
    """The train_sft arguments of the stage's recipe."""
    stage = STAGE_DEFAULTS[args.stage]
    argv = [
        "--steps", str(args.steps), "--batch", str(args.batch),
        "--lr", str(args.lr if args.lr is not None else stage["lr"]),
        "--max_seq", str(args.max_seq), "--fsdp", str(args.fsdp),
        "--checkpoint_dir", args.checkpoint_dir,
    ]
    if args.model_path:
        argv += ["--model_path", args.model_path]
    if args.tiny:
        argv += ["--tiny"]
    for flag in ("data", "meta", "image_root"):
        if getattr(args, flag):
            argv += [f"--{flag}", getattr(args, flag)]
    if args.packed:
        argv += ["--packed"]
    if stage["freeze_llm"]:
        argv += ["--freeze_llm"]
    if args.device:
        argv += ["--device", args.device]
    return argv


def main(argv=None):
    """Parse argv (sys.argv when None) and run train_sft.main with the
    stage's recipe; -> its trainer."""
    return train_sft.main(sft_argv(build_parser().parse_args(argv)))


if __name__ == "__main__":
    main()
