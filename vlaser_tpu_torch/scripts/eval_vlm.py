"""VLM benchmark evaluation of the port (scripts/eval_vlm.py's recipe on
one CUDA device: the embodied-reasoning sweep and the general benchmarks).

    python -m vlaser_tpu_torch.scripts.eval_vlm --model_path Vlaser-2B/ \\
        --benchmark erqa --data erqa.jsonl --image_root images/
    python -m vlaser_tpu_torch.scripts.eval_vlm --model_path Vlaser-2B/ \\
        --benchmark mmbench --data mmbench_dev.tsv [--engine]
    python -m vlaser_tpu_torch.scripts.eval_vlm --tiny --device cpu \\
        --benchmark mcq --data items.jsonl   # offline: tiny random model

Routes, as in JAX: the embodied benchmarks (EMBODIED) through
eval/embodied_benchmarks.run_benchmark; mmbench and pope through their
loaders; mmmu, scienceqa, seed, mmvp, mme, mvbench, refcoco, caption,
mathvista and vqa[:dataset] through eval/protocol_runners.RUNNERS; any
other name as a generic multiple-choice JSONL file. The flags are the JAX
CLI's, plus --device (the card unless it says "cpu"; without a card it
raises) and --tiny (tiny_vlm with seeded weights and the byte tokenizer).
--tp above 1 raises NotImplementedError. `main` runs the JAX `main`'s
stages, each a function here; the model stages are serve_vlm's.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from . import serve_vlm
from .train_sft import resolve_device

EMBODIED = ("erqa", "egoplan2", "refspatial", "mmsi", "vsi", "vsi_bench",
            "pixmo", "paco_lavis", "where2place", "pointarena")
RUNNER_KEYS = ("mmmu", "scienceqa", "seed", "mmvp", "mme", "mvbench",
               "refcoco", "caption", "mathvista")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", default=None, help="HF checkpoint dir")
    ap.add_argument("--tiny", action="store_true",
                    help="offline smoke mode: tiny random-init model + byte "
                         "tokenizer (no checkpoint needed)")
    ap.add_argument("--benchmark", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--image_root", default="")
    ap.add_argument("--max_tiles", type=int, default=None,
                    help="dynamic-tiling cap; default = each protocol's "
                         "reference value (12 generic, 6 refcoco, 1 video)")
    ap.add_argument("--max_new_tokens", type=int, default=100)
    ap.add_argument("--num_beams", type=int, default=1,
                    help="beam search width (HF generation_config surface)")
    ap.add_argument("--repetition_penalty", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--quantize", choices=("none", "int8", "w8a8"),
                    default=None,
                    help="serving quantization (core/quant.py): 'w8a8' "
                         "(default), 'int8' (weight-only) or 'none' (bf16)")
    ap.add_argument("--int8", action="store_true",
                    help="deprecated alias for --quantize int8 "
                         "(conflicts with an explicit --quantize)")
    ap.add_argument("--engine", action="store_true",
                    help="serve through the continuous-batching engine "
                         "(serve/engine.py): mixed-length prompts decode "
                         "in flight instead of padding to the longest row")
    ap.add_argument("--num_slots", type=int, default=16,
                    help="engine decode slots (--engine only)")
    ap.add_argument("--engine_max_len", type=int, default=4096,
                    help="engine KV length budget per slot (--engine only)")
    ap.add_argument("--offline", action="store_true",
                    help="like --engine but through the offline schedule "
                         "(serve/offline.py), greedy only")
    ap.add_argument("--spec_draft", type=int, default=0,
                    help="speculative decode through the engine: prompt-"
                         "lookup drafts of this length verify per slot "
                         "(--engine only; greedy token-identical)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree for --engine serving")
    ap.add_argument("--out", default=None, help="results json path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def quantize_mode(ap, args) -> str:
    """--int8 is a deprecated alias; it must not silently override an
    explicitly chosen --quantize. Default w8a8."""
    if args.int8 and args.quantize is not None:
        ap.error("--int8 conflicts with an explicit --quantize "
                 f"{args.quantize!r}; drop the deprecated --int8")
    return "int8" if args.int8 else (args.quantize or "w8a8")


def build_chat(args, model, tokenizer):
    """EngineChat under --engine / --offline (greedy, no beams or penalty),
    else VlaserChat with --num_beams and --repetition_penalty."""
    if args.engine or args.offline:
        from ..serve.engine_chat import EngineChat

        if args.num_beams != 1 or args.repetition_penalty != 1.0:
            raise ValueError(
                "--engine decodes greedy/sampled per slot; beams and "
                "repetition penalty run through the static batch_chat path")
        return EngineChat(model, tokenizer,
                          max_new_tokens=args.max_new_tokens,
                          num_slots=args.num_slots,
                          max_len=args.engine_max_len,
                          backend="offline" if args.offline else "engine",
                          speculative_draft_len=args.spec_draft)
    from ..inference.chat import VlaserChat

    return VlaserChat(model, tokenizer, max_new_tokens=args.max_new_tokens,
                      num_beams=args.num_beams,
                      repetition_penalty=args.repetition_penalty)


def run(args, chat):
    """-> (benchmark key, results dict) of the route the benchmark name
    picks."""
    key = args.benchmark.lower().replace("-", "_")
    if key in EMBODIED:
        from ..eval.embodied_benchmarks import run_benchmark

        return key, run_benchmark(key, chat, args.data, args.image_root,
                                  max_tiles=args.max_tiles or 12)
    if key == "mmbench":
        from ..eval.vlm_benchmarks import evaluate_benchmark, load_mmbench_tsv

        return key, evaluate_benchmark(
            chat, load_mmbench_tsv(args.data), mode="multiple_choice",
            batch_size=args.batch, max_tiles=args.max_tiles or 12)
    if key == "pope":
        from ..eval.vlm_benchmarks import evaluate_pope, load_pope

        return key, evaluate_pope(
            chat, load_pope(args.data, args.image_root),
            batch_size=args.batch, max_tiles=args.max_tiles or 12)
    if key in RUNNER_KEYS or key.startswith("vqa"):
        from ..eval.protocol_runners import RUNNERS

        kw = dict(batch_size=args.batch)
        if args.max_tiles is not None:
            kw["max_tiles"] = args.max_tiles
        if key.startswith("vqa"):
            # 'vqa:<dataset>' routes the metric via METRIC_BY_DATASET
            ds = key.split(":", 1)[1] if ":" in key else None
            return key, RUNNERS["vqa"](chat, args.data, args.image_root,
                                       dataset=ds, **kw)
        return key, RUNNERS[key](chat, args.data, args.image_root, **kw)
    from ..eval.vlm_benchmarks import evaluate_benchmark, load_jsonl_benchmark

    return key, evaluate_benchmark(
        chat, load_jsonl_benchmark(args.data, args.image_root),
        mode="multiple_choice", batch_size=args.batch,
        max_tiles=args.max_tiles or 12)


def report(args, key, out) -> dict:
    """Print the results without the responses; write them all to --out."""
    printable = {k: v for k, v in out.items() if k != "responses"}
    print(json.dumps({"benchmark": key, **printable}, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"benchmark": key, **out}, f, indent=2, default=str)
    return printable


def main(argv=None):
    """Parse argv (sys.argv when None), evaluate, print; -> the results
    dict (responses included)."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = build_parser()
    args = ap.parse_args(argv)
    if not (args.tiny or args.model_path):
        raise SystemExit("need --model_path (or --tiny)")
    args.quantize = quantize_mode(ap, args)
    serve_vlm.check_single_device(args)
    device = resolve_device(args.device)
    tokenizer = serve_vlm.load_tokenizer(args)
    cfg = serve_vlm.build_config(args, tokenizer)
    model = serve_vlm.quantize(args, serve_vlm.load_model(args, cfg,
                                                          device))
    key, out = run(args, build_chat(args, model, tokenizer))
    report(args, key, out)
    return out


if __name__ == "__main__":
    main()
