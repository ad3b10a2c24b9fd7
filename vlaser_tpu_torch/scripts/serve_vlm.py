"""OpenAI-compatible VLM chat server of the port (scripts/serve_vlm.py's
recipe on one CUDA device; the vLLM API-server role).

    python -m vlaser_tpu_torch.scripts.serve_vlm --model_path Vlaser-2B/ \\
        --port 8000 [--engine] [--quantize w8a8] [--max_new_tokens 256]
    python -m vlaser_tpu_torch.scripts.serve_vlm --tiny --device cpu \\
        --port 8000     # offline: tiny random model, byte tokenizer
    torchrun --nproc-per-node 2 -m vlaser_tpu_torch.scripts.serve_vlm \\
        --model_path Vlaser-2B/ --engine --tp 2   # tensor-parallel

Then point an OpenAI client at http://host:port/v1 (chat completions with
text and data: / file: image URLs). The flags are the JAX CLI's, plus
--device (the card unless it says "cpu"; without a card it raises) and
--tiny (train_sft's offline mode: tiny_vlm with seeded weights and the
byte tokenizer). --tp N (with --engine, as in JAX) serves over a (data 1,
fsdp 1, tensor N) mesh: run under `torchrun --nproc-per-node N`, one rank
a card (gloo ranks under --device cpu); every rank builds the model and
the engine lays it out (core/tensor_parallel), rank 0 serves HTTP and
hands each batch of requests to the others (serve/chat_server.
RankBroadcastChat), and only rank 0 answers. `main` runs the JAX `main`'s
stages, each a function here:
the tokenizer, the config (vlaser_2b with the vocab sized to the
tokenizer), the model and its weights (utils/hf_convert -> utils/convert),
`quantize_for_serving`, the chat backend (EngineChat under --engine, else
VlaserChat), the server.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from .train_sft import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", default=None, help="HF checkpoint dir")
    ap.add_argument("--tiny", action="store_true",
                    help="offline smoke mode: tiny random-init model + byte "
                         "tokenizer (no checkpoint needed)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max_new_tokens", type=int, default=256)
    ap.add_argument("--max_tiles", type=int, default=12)
    ap.add_argument("--engine", action="store_true",
                    help="serve through the continuous-batching engine "
                         "(serve/engine_chat.EngineChat) instead of the "
                         "static VlaserChat path")
    ap.add_argument("--num_slots", type=int, default=16)
    ap.add_argument("--quantize", choices=("none", "int8", "w8a8"),
                    default="w8a8")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (--engine only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def tensor_mesh(args):
    """--tp: None at 1, else a (1, 1, tp) mesh over the process group,
    which must hold exactly tp ranks (torchrun --nproc-per-node tp); -tp
    needs --engine, as the JAX CLI asserts."""
    if args.tp == 1:
        return None
    if not args.engine:
        raise ValueError("--tp requires --engine")
    import torch.distributed as dist

    from ..core import distributed, mesh

    n = (dist.get_world_size() if dist.is_initialized()
         else int(os.environ.get("WORLD_SIZE", "1")))
    if n != args.tp:
        raise RuntimeError(
            f"--tp {args.tp} needs a process group of {args.tp} ranks (run "
            f"under torchrun --nproc-per-node {args.tp}); this one has {n}")
    cpu = str(args.device or "").startswith("cpu")
    distributed.initialize(backend="gloo" if cpu else None)
    return mesh.make_mesh(dp=1, fsdp=1, tp=args.tp)


def load_tokenizer(args):
    """The byte tokenizer (with the InternVL special tokens) under --tiny,
    else the checkpoint's."""
    if args.tiny:
        from ..tokenizer.byte_tokenizer import ByteTokenizer
        from ..utils.tools import ensure_special_tokens

        tok = ByteTokenizer()
        ensure_special_tokens(tok)
        return tok
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(args.model_path, use_fast=False,
                                         trust_remote_code=True)


def build_config(args, tokenizer, cfg=None):
    """vlaser_2b with the vocab sized to the tokenizer, as the JAX CLI
    sizes it. Under --tiny, tiny_vlm so sized, and a cfg handed in keeps
    its vocab: both take their image-token ids from the tokenizer (the
    byte tokenizer's added tokens)."""
    from ..core.config import tiny_vlm, vlaser_2b

    if cfg is None:
        if not args.tiny:
            return vlaser_2b(vocab_size=len(tokenizer))
        cfg = tiny_vlm()
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, vocab_size=len(tokenizer)))
    ids = tokenizer.convert_tokens_to_ids(["<IMG_CONTEXT>", "<img>",
                                           "</img>"])
    return dataclasses.replace(cfg, img_context_token_id=ids[0],
                               img_start_token_id=ids[1],
                               img_end_token_id=ids[2])


def load_model(args, cfg, device):
    """The port's InternVLChatModel in bf16 (parameters and compute, as the
    JAX CLI builds it) with the weights of --model_path
    (load_safetensors_dir -> convert_internvl_chat -> from_jax_variables),
    or seeded random weights under --tiny."""
    from ..models.layers import load_state
    from ..models.vlm import InternVLChatModel

    bf = torch.bfloat16
    model = InternVLChatModel(cfg, param_dtype=bf, compute_dtype=bf,
                              device=device)
    model.requires_grad_(False)
    if args.tiny:
        from .train_sft import random_init_

        return random_init_(model, torch.Generator(device).manual_seed(0))
    from ..utils.convert import from_jax_variables
    from ..utils.hf_convert import convert_internvl_chat, load_safetensors_dir

    raw = convert_internvl_chat(load_safetensors_dir(args.model_path),
                                cfg.vision.num_layers, cfg.llm.num_layers)
    return load_state(model, from_jax_variables({"params": raw}))


def quantize(args, model):
    """core.quant.quantize_for_serving(target="vlm", mode=--quantize) in
    place; "none" keeps bf16."""
    if args.quantize != "none":
        from ..core.quant import quantize_for_serving

        quantize_for_serving(model, target="vlm", mode=args.quantize)
    return model


def build_chat(args, model, tokenizer, mesh=None, **engine_kw):
    """EngineChat under --engine (on `mesh` under --tp; engine_kw: further
    EngineChat keywords, such as a caller's max_len), else VlaserChat."""
    if args.engine:
        from ..serve.engine_chat import EngineChat

        return EngineChat(model, tokenizer,
                          max_new_tokens=args.max_new_tokens,
                          num_slots=args.num_slots, mesh=mesh, **engine_kw)
    from ..inference.chat import VlaserChat

    return VlaserChat(model, tokenizer, max_new_tokens=args.max_new_tokens)


def build_server(args, chat):
    from ..serve.chat_server import ChatHTTPServer

    name = "vlaser-tpu"
    if args.model_path:
        name = os.path.basename(args.model_path.rstrip("/")) or name
    return ChatHTTPServer(chat, host=args.host, port=args.port,
                          model_name=name, max_tiles=args.max_tiles)


def main(argv=None):
    """Parse argv (sys.argv when None), build the server and serve until
    interrupted (under --tp: rank 0 serves, the other ranks follow it)."""
    args = build_parser().parse_args(argv)
    if not (args.tiny or args.model_path):
        raise SystemExit("need --model_path (or --tiny)")
    mesh = tensor_mesh(args)
    device = resolve_device(args.device)
    tokenizer = load_tokenizer(args)
    cfg = build_config(args, tokenizer)
    model = quantize(args, load_model(args, cfg, device))
    chat = build_chat(args, model, tokenizer, mesh)
    if mesh is not None:
        import torch.distributed as dist

        from ..serve.chat_server import RankBroadcastChat, follow_rank0

        if dist.get_rank() != 0:
            follow_rank0(chat)
            return
        chat = RankBroadcastChat(chat)
    srv = build_server(args, chat)
    print(f"serving on http://{args.host}:{srv.port}/v1 "
          f"(backend={'engine' if args.engine else 'static'}, "
          f"quantize={args.quantize}, device={device}, tp={args.tp})",
          flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.shutdown()
        if mesh is not None:
            chat.stop()


if __name__ == "__main__":
    main()
