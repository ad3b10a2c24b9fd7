"""Serve the RoboTwin parallel-decoding policy over HTTP (the port of
scripts/deploy_robotwin.py, on one CUDA device).

POST /act with {"image": <json-numpy uint8 HxWx3>, "instruction": str,
"qpos": [14]} returns {"action": <chunk x 14 joint deltas>}; the client
helper is vlaser_tpu_torch.serve.deploy_server.act_request.

    python -m vlaser_tpu_torch.scripts.deploy_robotwin \\
        --model_path InternVL3-2B/ --ckpt checkpoints/robotwin --port 8000
    python -m vlaser_tpu_torch.scripts.deploy_robotwin --tiny --port 8000 \\
        --device cpu      # offline: tiny random-init policy

The flags are the JAX CLI's, plus --device (the card unless it says
"cpu"; without a card it raises). --ckpt is a checkpoint directory of the
port's train_robotwin (utils/checkpoint.py; its latest step's weights).
`main` runs the JAX `main`'s stages, each a function here: the tokenizer
and the config (train_robotwin's), the model, the policy
(eval/robotwin_eval.RoboTwinPolicy), its `policy_fn` and the server; it
prints `READY port=N` once the server listens. `policy_fn` resizes an
image of another size with PIL (imported only then).
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from .train_robotwin import (build_builder, build_config, load_tokenizer,
                             normalize)
from .train_sft import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory of train_robotwin")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def build_model(args, cfg, device, seed: int = 0):
    """ParallelDecodingVLA (fp32 parameters, bf16 compute; "reference"
    attention under --tiny, else "auto") with a seeded random init under
    --tiny, else the --ckpt weights."""
    from ..policy.parallel_decoding import ParallelDecodingVLA
    from .train_sft import random_init_

    model = ParallelDecodingVLA(
        cfg, param_dtype=torch.float32, compute_dtype=torch.bfloat16,
        device=device, attn_impl="reference" if args.tiny else "auto")
    model.requires_grad_(False)
    if args.tiny:
        return random_init_(model, torch.Generator(device).manual_seed(seed))
    if not args.ckpt:
        raise SystemExit("need --ckpt (a train_robotwin checkpoint) for "
                         "real serving")
    from ..utils.checkpoint import restore_params

    restore_params(args.ckpt, model)
    return model


def build_policy(model, builder, tokenizer):
    from ..eval.robotwin_eval import RoboTwinPolicy

    return RoboTwinPolicy(model, None, builder, tokenizer, normalize)


def make_policy_fn(policy, cfg):
    """policy_fn(image, instruction, qpos) -> [chunk, 14] float32: an image
    of another size is resized to the ViT's (bicubic, PIL); no qpos means
    zeros."""
    img = cfg.vlm.vision.image_size

    def policy_fn(image, instruction, qpos):
        if image.shape[0] != img:
            from PIL import Image as PILImage

            image = np.asarray(
                PILImage.fromarray(image.astype(np.uint8)).resize(
                    (img, img), PILImage.BICUBIC))
        qpos = (np.zeros((cfg.state_dim,), np.float32)
                if qpos is None else np.asarray(qpos, np.float32))
        return policy.get_actions(image, qpos, instruction)

    return policy_fn


def build_server(args, policy_fn):
    from ..serve.deploy_server import PolicyHTTPServer

    return PolicyHTTPServer(policy_fn, host=args.host, port=args.port)


def main(argv=None):
    """Parse argv (sys.argv when None) and serve until interrupted."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    tokenizer = load_tokenizer(args)
    cfg, state_start = build_config(args, tokenizer)
    builder = build_builder(cfg, tokenizer, state_start)
    model = build_model(args, cfg, device)
    policy_fn = make_policy_fn(build_policy(model, builder, tokenizer), cfg)
    srv = build_server(args, policy_fn)
    logging.getLogger("vlaser_tpu_torch.serve").info(
        "serving on %s:%d (POST /act)", args.host, srv.port)
    print(f"READY port={srv.port}", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.shutdown()


if __name__ == "__main__":
    main()
