"""RoboTwin parallel-decoding VLA training entry point of the port
(scripts/train_robotwin.py's recipe): HDF5 episodes ->
the SequenceBuilder's static layout -> the ParallelDecodingVLA L1 loss,
fp32 parameters with bf16 compute, AdamW under warmup_cosine(lr, steps,
0.03), the ViT frozen (the reference's no-grad extract_feature).

    python -m vlaser_tpu_torch.scripts.train_robotwin \\
        --model_path InternVL3-2B/ --data_root robotwin_episodes/ \\
        --steps 20000 --batch 64
    python -m vlaser_tpu_torch.scripts.train_robotwin --tiny --steps 2 \\
        --device cpu      # offline: tiny random model, synthetic episodes

The flags are the JAX CLI's, plus --device (the card unless it says
"cpu"; without a card it raises); --fsdp above 1 trains over the
processes' ranks (torchrun or slurm, as train_sft): ZeRO-3 state over
fsdp, a global batch of --batch samples a rank, each rank taking its
block of consecutive samples. `main` runs the JAX
`main`'s stages, each a function here: the tokenizer, the config (the 12
RoboTwin markers, <IMG_CONTEXT> and the <state_i> tokens added as the JAX
CLI adds them), the model (a seeded random init under --tiny, else the
--model_path VLM grafted into a freshly initialized model), the data (any
sequence of samples: an HDF5VLADataset, or samples made in memory), the
train step and the loop. The frozen ViT still takes gradients, so
`grad_norm` is the JAX step's. Steps 1, every 10th and the last are
logged; a checkpoint (utils/checkpoint.py) is written every 500 steps
under --checkpoint_dir. `h5py` and PIL are imported by the dataset's
functions only, `transformers` only for a --model_path tokenizer.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from ..core.distributed import initialize
from .train_sft import build_mesh, resolve_device

# RoboTwin special tokens added at train time (train_mine_new.py:226-266)
ROBOTWIN_TOKENS = [
    "<soi>", "<eoi>", "<sot>", "<eot>",
    "<left_arm_soa>", "<left_arm_eoa>", "<right_arm_soa>", "<right_arm_eoa>",
    "<left_arm_sost>", "<left_arm_eost>", "<right_arm_sost>", "<right_arm_eost>",
]
TINY_STATE_TOKENS, STATE_TOKENS = 32, 512  # <state_i> tokens (tiny, real)
LOG_EVERY, SAVE_EVERY = 10, 500

logger = logging.getLogger("vlaser_tpu_torch.train")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def check_args(args) -> None:
    if not (args.tiny or (args.model_path and args.data_root)):
        raise SystemExit("need --model_path and --data_root (or --tiny)")


def load_tokenizer(args):
    """The byte tokenizer under --tiny, else the checkpoint's."""
    if args.tiny:
        from ..tokenizer.byte_tokenizer import ByteTokenizer

        return ByteTokenizer()
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(args.model_path, use_fast=False,
                                         trust_remote_code=True)


def build_config(args, tokenizer, vlm=None):
    """Add the RoboTwin markers and <IMG_CONTEXT> (a tokenizer that has it
    keeps its id), then the <state_i> tokens (32 under --tiny, else 512),
    and size the config's vocab to the tokenizer. vlm None: tiny_vlm under
    --tiny, else vlaser_2b; without --tiny the ViT runs at 224 px with
    select_layer -2 (RoboTwin's model/load.py), a vlm handed in too, which
    keeps its widths. -> (cfg, state_token_start)."""
    from ..core.config import tiny_vlm, vlaser_2b
    from ..policy.parallel_decoding import ParallelDecodingConfig
    from ..tokenizer.conversation import IMG_CONTEXT_TOKEN

    n_state = TINY_STATE_TOKENS if args.tiny else STATE_TOKENS
    tokenizer.add_tokens(ROBOTWIN_TOKENS + [IMG_CONTEXT_TOKEN],
                         special_tokens=True)
    state_start = len(tokenizer)
    tokenizer.add_tokens([f"<state_{i}>" for i in range(n_state)],
                         special_tokens=True)
    img_ctx = tokenizer.convert_tokens_to_ids(IMG_CONTEXT_TOKEN)
    if vlm is None:
        vlm = tiny_vlm() if args.tiny else vlaser_2b()
    if not args.tiny:
        vlm = dataclasses.replace(
            vlm, vision=dataclasses.replace(vlm.vision, image_size=224),
            select_layer=-2)
    vlm = dataclasses.replace(
        vlm, llm=dataclasses.replace(vlm.llm, vocab_size=len(tokenizer)),
        img_context_token_id=img_ctx)
    if args.tiny:
        cfg = ParallelDecodingConfig(
            vlm=vlm, action_chunk=4, action_dim=14, state_dim=14,
            state_vocab_size=n_state, max_text_tokens=16, head_hidden=32)
    else:
        cfg = ParallelDecodingConfig(
            vlm=vlm, action_chunk=getattr(args, "chunk", 8), action_dim=14,
            state_dim=14, state_vocab_size=n_state)
    return cfg, state_start


def build_builder(cfg, tokenizer, state_start: int):
    """The SequenceBuilder over the tokenizer's marker ids (bos 1, eos 2,
    pad 0, as the JAX CLI sets them)."""
    from ..policy.parallel_decoding import SequenceBuilder
    from ..tokenizer.conversation import IMG_CONTEXT_TOKEN

    tok_ids = {"bos": 1, "eos": 2,
               "img_context": tokenizer.convert_tokens_to_ids(
                   IMG_CONTEXT_TOKEN)}
    for t in ROBOTWIN_TOKENS:
        tok_ids[t.strip("<>")] = tokenizer.convert_tokens_to_ids(t)
    return SequenceBuilder(cfg, tok_ids, state_token_start=state_start,
                           pad_token_id=0)


def graft_vlm(model, raw: Dict) -> None:
    """Put an InternVL chat tree (utils/hf_convert.convert_internvl_chat's
    `vision_model`, `mlp1`, `language_model/{model,embed_tokens}`, numpy)
    into the parallel-decoding model, as the JAX CLI grafts it; the action
    head keeps its init. A ViT trained at another grid (a 448-px
    checkpoint into the 224-px model) raises ValueError naming both grids,
    as the JAX CLI grafts no other grid either: the position embedding is
    not resized here (ops.bicubic_resize_2d resizes it at run time only
    for an input of another grid, models/internvit.py)."""
    from ..models.layers import load_state
    from ..utils.convert import from_jax_variables

    pe = np.asarray(raw["vision_model"]["embeddings"]["position_embedding"])
    vcfg = model.cfg.vlm.vision
    want = vcfg.num_patches_per_side
    have = int(round((pe.shape[1] - 1) ** 0.5))
    if pe.shape[1] != vcfg.seq_len:
        raise ValueError(
            f"the checkpoint's ViT position embedding is a {have} x {have} "
            f"grid ({pe.shape[1]} rows), the model's {vcfg.image_size} px "
            f"config a {want} x {want} grid ({vcfg.seq_len} rows); the graft "
            "takes the model's grid only, as the JAX CLI's does")
    tree = {"vision_model": raw["vision_model"], "mlp1": raw["mlp1"],
            "language_model": raw["language_model"]["model"],
            "embed_tokens": raw["language_model"]["embed_tokens"]}
    state = from_jax_variables({"params": tree})
    head = {k: v for k, v in model.state_dict().items()
            if k.startswith("action_head.")}
    load_state(model, {**state, **head})


def build_model(args, cfg, device, seed: int = 0):
    """ParallelDecodingVLA (fp32 parameters, bf16 compute; "reference"
    attention under --tiny, else "auto", as the JAX CLI sets it) with a
    seeded random init on `device`; without --tiny the --model_path VLM is
    grafted over it."""
    from ..policy.parallel_decoding import ParallelDecodingVLA
    from .train_sft import random_init_

    model = ParallelDecodingVLA(
        cfg, param_dtype=torch.float32, compute_dtype=torch.bfloat16,
        device=device, attn_impl="reference" if args.tiny else "auto")
    random_init_(model, torch.Generator(device).manual_seed(seed))
    if not args.tiny and args.model_path:
        from ..utils.hf_convert import (convert_internvl_chat,
                                        load_safetensors_dir)
        from ..utils.tools import resize_token_embeddings

        raw = convert_internvl_chat(load_safetensors_dir(args.model_path),
                                    cfg.vlm.vision.num_layers,
                                    cfg.vlm.llm.num_layers)
        graft_vlm(model, resize_token_embeddings(raw, cfg.vlm.llm.vocab_size))
    return model


def make_synthetic_episodes(root: str, n: int = 2, t: int = 10) -> None:
    """The JAX CLI's --tiny episodes (default_rng(0)): n HDF5 files of t
    32-px frames, qpos and actions in [-1, 1]."""
    import h5py

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        with h5py.File(os.path.join(root, f"ep{i}.hdf5"), "w") as h:
            h.create_dataset(
                "observations/head_camera",
                data=rng.integers(0, 255, (t, 32, 32, 3), np.uint8))
            h.create_dataset("qpos", data=rng.uniform(-1, 1, (t, 14)))
            h.create_dataset(
                "action",
                data=rng.uniform(-1, 1, (t, 14)).astype(np.float32))
            h.attrs["instruction"] = f"move the block {i}"


def build_dataset(args, cfg):
    """HDF5VLADataset over --data_root (under --tiny a temporary directory
    with synthetic episodes when it holds none)."""
    from ..data.hdf5_dataset import HDF5DatasetConfig, HDF5VLADataset

    root = args.data_root
    if args.tiny:
        root = root or tempfile.mkdtemp(prefix="robotwin_tiny_")
        if not any(f.endswith(".hdf5") for f in os.listdir(root)):
            make_synthetic_episodes(root)
    return HDF5VLADataset(HDF5DatasetConfig(
        data_root=root, chunk_size=cfg.action_chunk,
        image_size=cfg.vlm.vision.image_size))


def normalize(images: np.ndarray) -> np.ndarray:
    """uint8 -> ImageNet-normalized float32 (the CLIs' normalizer)."""
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (images.astype(np.float32) / 255.0 - mean) / std


def make_batches(samples: Sequence[Dict], batch: int, builder, tokenizer,
                 index: int = 0, count: int = 1
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless numpy batches of `batch` samples taken in order, wrapping
    around (the JAX CLI's loop), through collate_robotwin. index / count:
    this rank's block of each global batch of count x batch samples."""
    from ..data.hdf5_dataset import collate_robotwin

    i = 0
    while True:
        start = i + index * batch
        chunk = [samples[(start + j) % len(samples)] for j in range(batch)]
        i += batch * count
        yield collate_robotwin(chunk, builder, tokenizer, normalize)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def build_step(args, model):
    """The train step: make_optimizer's AdamW (clip 1.0, decay 0.01) under
    warmup_cosine(--lr, --steps, 0.03), `vision_model/` frozen, the L1
    loss; with --fsdp above 1 over the mesh of the ranks
    (train_sft.build_mesh; `step.sharded.mesh`), ZeRO-3 shards and each
    rank's share of the global batch's mean loss."""
    from ..train.optim import make_optimizer, warmup_cosine
    from ..train.train_step import make_train_step, shard_train_state

    mesh = build_mesh(args)
    groups, frozen = make_optimizer(
        model, warmup_cosine(args.lr, args.steps, 0.03),
        frozen_patterns=(r"vision_model/",))
    sharded = shard_train_state(model, mesh) if mesh is not None else None
    ranks = mesh.size() if mesh is not None else 1

    def loss_fn(batch):
        loss = model.loss(batch["input_ids"], batch["pixel_values"],
                          batch["text_mask"], batch["actions"])
        return loss / ranks if ranks > 1 else loss

    return make_train_step(loss_fn, groups, frozen=frozen, sharded=sharded)


def train(args, model, step, batches, device) -> List[Dict[str, float]]:
    """--steps steps; -> the logged steps' {"step", "loss", "grad_norm"}."""
    from ..utils.checkpoint import save_checkpoint

    logged = []
    for i, batch in enumerate(batches):
        if i >= args.steps:
            break
        metrics = step(to_device(batch, device))
        s = i + 1
        if s == 1 or s % LOG_EVERY == 0 or s == args.steps:
            row = {"step": s, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"])}
            logged.append(row)
            logger.info("robotwin step %d l1_loss %.4f gnorm %.3f", s,
                        row["loss"], row["grad_norm"])
        if args.checkpoint_dir and s % SAVE_EVERY == 0:
            save_checkpoint(args.checkpoint_dir, s, model, step)
    return logged


def main(argv=None):
    """Parse argv (sys.argv when None), train; -> the logged metrics."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    check_args(args)
    device = resolve_device(args.device)
    initialize()  # before the model: under NCCL it picks the rank's card
    tokenizer = load_tokenizer(args)
    cfg, state_start = build_config(args, tokenizer)
    builder = build_builder(cfg, tokenizer, state_start)
    model = build_model(args, cfg, device)
    dataset = build_dataset(args, cfg)
    step = build_step(args, model)
    index, count = (0, 1)
    if step.sharded is not None:
        from ..core.mesh import batch_shard

        index, count = batch_shard(step.sharded.mesh)
    return train(args, model, step,
                 make_batches(dataset, args.batch, builder, tokenizer, index,
                              count), device)


if __name__ == "__main__":
    main()
