"""QA data generation of the port driven by its own chat model
(scripts/generate_qa.py's recipe on one CUDA device; the
data-pipeline/slurm/data_generator.sh role, minus vLLM).

    python -m vlaser_tpu_torch.scripts.generate_qa --model_path Vlaser-2B/ \\
        --episodes_dir eps/ --kind general --out qa.jsonl [--filter]
    python -m vlaser_tpu_torch.scripts.generate_qa --tiny --device cpu \\
        --episodes_dir frames/ --kind all --engine --out qa.jsonl

The flags are the JAX CLI's, plus --device (the card unless it says "cpu";
without a card it raises) and --tiny (serve_vlm's offline mode: tiny_vlm
with seeded weights and the byte tokenizer). `main` runs the JAX `main`'s
stages, each a function here: the tokenizer, the config, the model and its
weights and `quantize_for_serving` (serve_vlm's stages), the chat backend
(VlaserChat, or EngineChat under --engine / --offline), the generate
functions, the frames, `QAGenerator.generate` and the --filter stage.

A frame already at the ViT's input size is one tile, `normalize_uint8` of
it (what `load_image_tiles(max_num=1, dynamic=False)` gives at that size);
any other frame goes through `load_image_tiles`, which needs PIL. `h5py`
is imported only to read `.hdf5` episodes, PIL only to read `.jpg` /
`.png` frames, to tile them or to save a parsed item's JPEG.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from . import serve_vlm
from .train_sft import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", default=None, help="HF checkpoint dir")
    ap.add_argument("--tiny", action="store_true",
                    help="offline smoke mode: tiny random-init model + byte "
                         "tokenizer (no checkpoint needed)")
    ap.add_argument("--episodes_dir", required=True,
                    help="dir of .hdf5 episodes or image files")
    ap.add_argument("--kind",
                    choices=["general", "grounding", "spatial", "all"],
                    default="general",
                    help="'all' generates every QA kind per frame; with "
                         "--engine the frame's image block prefills once "
                         "and all kind-prompts share it (engine prefix "
                         "caching)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--images_dir", default="qa_images")
    ap.add_argument("--max_frames", type=int, default=1000)
    ap.add_argument("--filter", action="store_true")
    ap.add_argument("--threshold", type=float, default=6.0)
    ap.add_argument("--engine", action="store_true",
                    help="batch generation through the continuous-batching "
                         "engine (serve/engine.py)")
    ap.add_argument("--offline", action="store_true",
                    help="like --engine but through the offline schedule "
                         "(serve/offline.py), greedy only")
    ap.add_argument("--num_slots", type=int, default=16)
    ap.add_argument("--spec_draft", type=int, default=0,
                    help="speculative decode through the engine (prompt-"
                         "lookup drafts; greedy token-identical, --engine "
                         "only)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for QA generation "
                         "(engine mode: per-request sampling params)")
    ap.add_argument("--top_p", type=float, default=1.0)
    ap.add_argument("--quantize", choices=("none", "int8", "w8a8"),
                    default="w8a8",
                    help="serving quantization (core/quant."
                         "quantize_for_serving)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def build_chat(args, model, tokenizer, max_new_tokens: int = 512):
    """EngineChat under --engine / --offline (backend, sampling and
    speculative drafts from the flags), else VlaserChat; the JAX CLI's
    asserts on greedy-only routes."""
    if args.engine or args.offline:
        from ..serve.engine_chat import EngineChat

        assert not (args.offline and args.temperature > 0.0), (
            "--offline is greedy-only; sampled generation uses --engine"
        )
        return EngineChat(model, tokenizer, max_new_tokens=max_new_tokens,
                          num_slots=args.num_slots,
                          temperature=args.temperature, top_p=args.top_p,
                          backend="offline" if args.offline else "engine",
                          speculative_draft_len=args.spec_draft)
    assert args.temperature == 0.0, (
        "sampled QA generation runs through --engine (per-request "
        "sampling params)"
    )
    from ..inference.chat import VlaserChat

    return VlaserChat(model, tokenizer, max_new_tokens=max_new_tokens)


def frame_tiles(image: np.ndarray, image_size: int) -> np.ndarray:
    """One uint8 [H, W, 3] frame -> [1, S, S, 3] normalized tiles, as
    `load_image_tiles(max_num=1, use_thumbnail=False, dynamic=False)`
    tiles it."""
    if image.shape[:2] == (image_size, image_size):
        from ..image.tiling import normalize_uint8

        return normalize_uint8(np.asarray(image, np.uint8))[None]
    from PIL import Image

    from ..image.tiling import load_image_tiles

    return load_image_tiles(Image.fromarray(image), image_size, max_num=1,
                            use_thumbnail=False, dynamic=False)


def make_generate_fn(args, chat, cfg):
    """generate_fn(images [B, H, W, 3] uint8, prompts [B]) -> responses:
    one engine run over the whole batch under --engine / --offline
    (requests decode in flight, short answers free their slots early),
    else one chat call a prompt."""
    size = cfg.vision.image_size

    def generate_fn(images, prompts):
        tile_list = [frame_tiles(img, size) for img in images]
        if args.engine or args.offline:
            pixels = np.concatenate(tile_list, axis=0)
            return chat.batch_chat(list(prompts), pixels,
                                   [t.shape[0] for t in tile_list])
        return [chat.chat(p, t) for p, t in zip(prompts, tile_list)]

    return generate_fn


def make_shared_image_fn(args, chat, cfg):
    """shared_image_fn(prompts [K], image) -> responses: the frame's image
    block prefills once and the K kind-prompts share it; None unless
    --engine with --kind all."""
    if not (args.engine and args.kind == "all"):
        return None
    size = cfg.vision.image_size

    def shared_image_fn(prompts, image):
        return chat.batch_chat_shared_image(list(prompts),
                                            frame_tiles(image, size))

    return shared_image_fn


def frames(args):
    """Every 10th `observations/head_camera` frame of each `.hdf5` under
    --episodes_dir (with its decoded `instruction`), or else its `.jpg` /
    `.png` images; at most --max_frames."""
    n = 0
    hdf5s = sorted(glob.glob(os.path.join(args.episodes_dir, "**/*.hdf5"),
                             recursive=True))
    if hdf5s:
        import h5py

        for f in hdf5s:
            with h5py.File(f, "r") as h:
                instr = h.attrs.get("instruction", "complete the task")
                if isinstance(instr, bytes):
                    instr = instr.decode()
                imgs = h["observations/head_camera"]
                for t in range(0, imgs.shape[0], 10):
                    if n >= args.max_frames:
                        return
                    yield {"image": np.asarray(imgs[t]),
                           "instruction": str(instr)}
                    n += 1
    else:
        from PIL import Image

        for f in sorted(glob.glob(os.path.join(args.episodes_dir, "*.jpg"))
                        + glob.glob(os.path.join(args.episodes_dir,
                                                 "*.png"))):
            if n >= args.max_frames:
                return
            yield {"image": np.asarray(Image.open(f).convert("RGB")),
                   "instruction": "complete the task"}
            n += 1


def generate(args, generate_fn, shared_image_fn, frame_iter) -> int:
    """QAGenerator.generate over the frames into --out; -> items written."""
    from ..data.qa_generation import QAGenConfig, QAGenerator

    gen = QAGenerator(generate_fn, QAGenConfig(kind=args.kind,
                                               images_dir=args.images_dir),
                      shared_image_fn=shared_image_fn)
    return gen.generate(frame_iter, args.out)


def filter_items(args, chat):
    """The --filter stage: every item of --out scored by the chat model
    (text only), the ones at --threshold or above written back.
    -> (kept, total)."""
    from ..data.qa_generation import quality_filter

    with open(args.out) as f:
        items = [json.loads(l) for l in f]
    kept = quality_filter(
        items,
        score_fn=lambda prompts: [chat.chat(p, None) for p in prompts],
        threshold=args.threshold,
    )
    with open(args.out, "w") as f:
        for it in kept:
            f.write(json.dumps(it) + "\n")
    return len(kept), len(items)


def main(argv=None):
    """Parse argv (sys.argv when None), generate --out and filter it under
    --filter."""
    args = build_parser().parse_args(argv)
    if not (args.tiny or args.model_path):
        raise SystemExit("need --model_path (or --tiny)")
    device = resolve_device(args.device)
    tokenizer = serve_vlm.load_tokenizer(args)
    cfg = serve_vlm.build_config(args, tokenizer)
    model = serve_vlm.quantize(args, serve_vlm.load_model(args, cfg, device))
    chat = build_chat(args, model, tokenizer)
    n = generate(args, make_generate_fn(args, chat, cfg),
                 make_shared_image_fn(args, chat, cfg), frames(args))
    print(f"wrote {n} items to {args.out}")
    if args.filter:
        kept, total = filter_items(args, chat)
        print(f"kept {kept}/{total} after filtering")


if __name__ == "__main__":
    main()
