"""VLM SFT entry point of the port (scripts/train_sft.py's recipe on one
CUDA device): the ViT frozen, lr 2e-5 cosine, fp32 parameters with bf16
compute and remat, packed or length-grouped padded batches, checkpoints
with the data stream's state.

    python -m vlaser_tpu_torch.scripts.train_sft --model_path Vlaser-2B/ \\
        --data train.jsonl --image_root images/ --steps 5000 [--packed]
    python -m vlaser_tpu_torch.scripts.train_sft --model_path Vlaser-2B/ \\
        --meta meta.json --packed   # a multi-dataset metafile
    python -m vlaser_tpu_torch.scripts.train_sft --tiny --data train.jsonl \\
        --steps 2 --device cpu      # offline: tiny random model, bytes

    torchrun --nproc_per_node 8 -m vlaser_tpu_torch.scripts.train_sft \
        --model_path Vlaser-2B/ --data train.jsonl --packed --fsdp 2 --cp 2
    torchrun --nproc_per_node 8 -m vlaser_tpu_torch.scripts.train_sft \
        --model_path Vlaser-2B/ --data train.jsonl --packed --fsdp 2 --tp 2

The flags are the JAX CLI's, plus --device (the card unless it says
"cpu"; without a card it raises). --fsdp, --tp and --cp above 1 train
over a (data, fsdp[, context], tensor) mesh of the processes' ranks
(core/distributed.initialize reads the torchrun or slurm variables; one
card a process): the model cut over tensor (core/tensor_parallel, a
vocab-parallel CE), ZeRO-3 state over fsdp, the LLM ring-sharded over
context (its config then sets context_parallel_axis; a packed batch of
--max_seq tokens, which 2 x --cp must divide, is cut along the sequence
by the model, each context rank keeping its slice), each rank fed its
block of the batches (packs sharded by the rank's batch coordinate,
core/mesh.batch_shard; a tensor group's ranks take the same packs).
`main` runs the JAX `main`'s stages, each a function here: the tokenizer,
the config (the InternVL special tokens; the vocab sized to the tokenizer
unless a config is handed in), the model and its weights (an HF
checkpoint directory through utils/hf_convert and utils/convert, or a
seeded random init under --tiny or without --model_path), the batches and
the trainer. `transformers` is imported only to load a --model_path
tokenizer.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import Callable, Iterator, Optional, Tuple

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", default=None, help="HF checkpoint dir")
    ap.add_argument("--tiny", action="store_true",
                    help="offline smoke mode: tiny random-init model + byte "
                         "tokenizer (no checkpoint needed)")
    ap.add_argument("--data", default=None, help="conversation jsonl")
    ap.add_argument("--meta", default=None,
                    help="multi-dataset metafile json (overrides --data)")
    ap.add_argument("--image_root", default="")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--max_seq", type=int, default=8192)
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--cp", type=int, default=1)
    ap.add_argument("--freeze_vision", action="store_true", default=True)
    ap.add_argument("--freeze_llm", action="store_true",
                    help="projector-only training (pretrain stage 1)")
    ap.add_argument("--checkpoint_dir", default="checkpoints/sft")
    ap.add_argument("--profile_dir", default=None,
                    help="a torch.profiler trace over steps 5-7")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def resolve_device(name: Optional[str]) -> torch.device:
    """The card unless `name` asks for another device; no card raises."""
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu to run "
                               "on the CPU")
        name = "cuda"
    return torch.device(name)


def build_mesh(args):
    """Start the process group from the environment (a no-op for one
    process) and -> the mesh of --fsdp / --tp / --cp (make_mesh(fsdp, tp,
    cp), as the JAX CLI builds it), or None when all are 1. A CLI without
    --tp or --cp (train_mpo, train_vla) builds its mesh here too."""
    from ..core.distributed import initialize
    from ..train.trainer import build_mesh as trainer_mesh

    initialize()
    return trainer_mesh(None, getattr(args, "fsdp", 1),
                        getattr(args, "tp", 1), getattr(args, "cp", 1))


def load_tokenizer(args):
    """The byte tokenizer under --tiny, else the checkpoint's."""
    if args.tiny:
        from ..tokenizer.byte_tokenizer import ByteTokenizer

        return ByteTokenizer()
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(args.model_path, use_fast=False,
                                         trust_remote_code=True)


def build_config(args, tokenizer, cfg=None) -> Tuple[object, int, int, int]:
    """Add the 9 InternVL tokens (finetune.py:865-876) and set the config's
    image-token and pad ids from the tokenizer. cfg None: tiny_vlm under
    --tiny, else vlaser_2b, with the vocab sized to the tokenizer, as the
    JAX CLI sizes it; a cfg handed in keeps its vocab. -> (cfg, tokens
    added, <img> id, </img> id)."""
    from ..core.config import tiny_vlm, vlaser_2b
    from ..utils.tools import ensure_special_tokens

    n_added, img_ctx_id, img_start_id, img_end_id = ensure_special_tokens(
        tokenizer)
    if cfg is None:
        if args.tiny:
            cfg = tiny_vlm()
            cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
                cfg.llm, vocab_size=len(tokenizer)))
        else:
            cfg = vlaser_2b(vocab_size=len(tokenizer))
    cfg = dataclasses.replace(
        cfg, img_context_token_id=img_ctx_id, img_start_token_id=img_start_id,
        img_end_token_id=img_end_id,
        pad_token_id=tokenizer.pad_token_id or cfg.pad_token_id)
    if getattr(args, "cp", 1) > 1:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, context_parallel_axis="context"))
    return cfg, n_added, img_start_id, img_end_id


@torch.no_grad()
def random_init_(model, gen: torch.Generator):
    """N(0, 0.02^2) draws from `gen` (on the model's device), then norm
    weights 1 + N(0, 0.1^2) and ViT layer scales ~0.1 (at N(0, 0.02^2)
    norms every branch would vanish)."""
    from ..models.layers import LayerNorm, RMSNorm, init_normal_

    init_normal_(model, gen, std=0.02)
    rnd = lambda t: torch.randn(t.shape, generator=gen, device=t.device)
    for m in model.modules():
        if isinstance(m, (LayerNorm, RMSNorm)):
            m.weight.copy_(1 + 0.1 * rnd(m.weight))
    enc = model.vision_model.encoder
    for p in (enc.ls1, enc.ls2):
        p.copy_(0.1 * (1 + 0.1 * rnd(p)))
    return model


def load_model(args, cfg, n_added: int, vocab: int, device,
               remat: bool = True):
    """The port's InternVLChatModel (fp32 parameters, bf16 compute) with the
    weights of --model_path (load_safetensors_dir -> convert_internvl_chat
    -> resize_token_embeddings when tokens were added -> from_jax_variables)
    or, under --tiny or without one, random_init_."""
    from ..models.layers import load_state
    from ..models.vlm import InternVLChatModel

    model = InternVLChatModel(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.bfloat16, device=device,
                              remat=remat)
    if args.tiny or not args.model_path:
        return random_init_(model, torch.Generator(device).manual_seed(0))
    from ..utils.convert import from_jax_variables
    from ..utils.hf_convert import convert_internvl_chat, load_safetensors_dir
    from ..utils.tools import resize_token_embeddings

    raw = convert_internvl_chat(load_safetensors_dir(args.model_path),
                                cfg.vision.num_layers, cfg.llm.num_layers)
    if n_added:
        raw = resize_token_embeddings(raw, vocab)
    return load_state(model, from_jax_variables({"params": raw}))


def build_dataset(args, cfg, tokenizer):
    """ConversationDataset (or the metafile's ConcatDataset). Packed mode
    keeps samples up to 4x the pack size: the packer splits them at
    non-image boundaries instead of truncating."""
    from ..data.chat_dataset import (ChatDatasetConfig, ConversationDataset,
                                     build_datasets)

    ds_cfg = ChatDatasetConfig(
        jsonl_path=args.data or "", image_root=args.image_root,
        num_image_token=cfg.num_image_token, image_size=cfg.vision.image_size,
        max_seq_length=args.max_seq * (4 if args.packed else 1))
    if args.meta:
        return build_datasets(args.meta, tokenizer, ds_cfg)
    return ConversationDataset(ds_cfg, tokenizer)


def build_batches(args, cfg, dataset, img_start_id: int, img_end_id: int,
                  mesh=None) -> Tuple[Iterator, Optional[Callable]]:
    """-> (batches, data_state_fn). Packed: PackedDataset behind a
    PrefetchIterator, its cursor the data state. Padded: length-grouped
    order (train_sampler_patch.py:54-125) cycled through map_prefetch's
    item threads, no data state. Over a mesh each rank takes the shard of
    its batch coordinate (context ranks share it), and with --cp the
    sequence length is a multiple of 2 x --cp."""
    from ..core.distributed import shard_for_process
    from ..core.mesh import batch_shard
    from ..data.chat_dataset import PackedDataset, pad_collate
    from ..data.prefetch import PrefetchIterator, map_prefetch

    index, count = batch_shard(mesh) if mesh is not None else (0, 1)
    cp = getattr(args, "cp", 1)
    if args.packed:
        if cp > 1:
            # the model cuts the pack along the sequence: max_seq must
            # divide 2 * cp (zigzag headroom)
            assert args.max_seq % (2 * cp) == 0, (
                f"--packed with --cp {cp} needs max_seq divisible by "
                f"{2 * cp}, got {args.max_seq}")
        packed = PackedDataset(dataset, max_packed_tokens=args.max_seq,
                               pad_token_id=cfg.pad_token_id,
                               img_start_id=img_start_id,
                               img_end_id=img_end_id,
                               num_image_token=cfg.num_image_token,
                               image_size=cfg.vision.image_size)
        packed = shard_for_process(packed, num_shards=count, index=index)
        return PrefetchIterator(iter(packed), buffer_size=4), packed.state_dict
    from ..data.chat_dataset import (estimate_lengths, length_grouped_indices,
                                     tokenized_lengths)

    # reference-exact tokenized lengths (internvl_chat_finetune.py:361-382)
    # when the dataset exposes a tokenizer; chars / 4 otherwise
    try:
        lengths = tokenized_lengths(dataset)
    except Exception:
        lengths = estimate_lengths(dataset)
    if lengths:
        order = length_grouped_indices(lengths, args.batch)
    else:  # ConcatDataset: sequential order
        order = list(range(len(dataset)))
    order = order[index::count]

    def cycle():
        while True:
            yield from order

    batches = map_prefetch(
        dataset, cycle(),
        collate=lambda xs: pad_collate(
            xs, cfg.pad_token_id, pad_multiple=2 * cp if cp > 1 else None),
        batch_size=args.batch, num_threads=4)
    return batches, None


def build_trainer(args, model, mesh=None):
    from ..train.trainer import SFTTrainer, TrainConfig

    return SFTTrainer(model, TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        freeze_vision=args.freeze_vision, freeze_llm=args.freeze_llm,
        mesh_fsdp=getattr(args, "fsdp", 1), mesh_tp=getattr(args, "tp", 1),
        mesh_cp=getattr(args, "cp", 1),
        checkpoint_dir=args.checkpoint_dir, profile_dir=args.profile_dir),
        mesh=mesh)


def main(argv=None):
    """Parse argv (sys.argv when None), train, and return the trainer."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    if not (args.data or args.meta):
        raise SystemExit("need --data or --meta")
    if not (args.tiny or args.model_path):
        raise SystemExit("need --model_path (or --tiny)")
    device = resolve_device(args.device)
    mesh = build_mesh(args)  # before the model: NCCL picks the rank's card
    tokenizer = load_tokenizer(args)
    cfg, n_added, img_start_id, img_end_id = build_config(args, tokenizer)
    model = load_model(args, cfg, n_added, len(tokenizer), device)
    dataset = build_dataset(args, cfg, tokenizer)
    batches, data_state_fn = build_batches(args, cfg, dataset, img_start_id,
                                           img_end_id, mesh)
    trainer = build_trainer(args, model, mesh=mesh)
    try:
        trainer.train(batches, data_state_fn=data_state_fn)
    finally:
        batches.close()
    return trainer


if __name__ == "__main__":
    main()
