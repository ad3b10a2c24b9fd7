"""Closed-loop SimplerEnv evaluation of the Vlaser-2B-VLA policy (the port of
scripts/eval_simpler.py, on one CUDA device).

    python -m vlaser_tpu_torch.scripts.eval_simpler --model_path Vlaser-2B/ \\
        --ckpt vla.pt --task widowx_carrot_on_plate \\
        --stats config/bridge_statistics.json --episodes 240 \\
        [--robot fractal] [--variant_aggregation | --visual_matching]

The flags are the JAX CLI's, plus --device (the card unless it says
"cpu"; without a card it raises). `main` runs the JAX `main`'s stages,
each a function here: the tokenizer and the config, the model (PiZeroVLA
in bf16; a torch `.pt` through utils/tools.convert_pizero_torch_checkpoint),
the adapter (Bridge or EDR, from --stats), the processor, the server and
the run. --fused (the default) quantizes as the JAX CLI does, weight-only
int8 over POLICY_PATTERNS (quantize_for_serving(mode="int8",
target="policy"): the joint mixtures' kernels and the token embedding), and
serves through the fused PolicyServer path (the Hopper ViT and
decoder-stack kernels, the ViT in bf16); --no-fused takes the plain
`infer_action` of the unquantized model. A caller that wants the w8a8
policy quantizes the model itself before build_server, which leaves an
already-quantized model as it is. SimplerEnv, SAPIEN and
gymnasium are imported only where an environment is built
(eval/simpler_eval.py), the tokenizer's `transformers` only in
`load_tokenizer`.
"""

from __future__ import annotations

import argparse

import torch

from .train_sft import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--ckpt", required=True, help="torch .pt checkpoint")
    ap.add_argument("--task", default="widowx_carrot_on_plate")
    ap.add_argument("--stats", required=True, help="dataset statistics json")
    ap.add_argument("--episodes", type=int, default=240)
    ap.add_argument("--act_steps", type=int, default=4)
    ap.add_argument("--robot", choices=["bridge", "fractal"], default="bridge")
    ap.add_argument("--variant_aggregation", action="store_true")
    ap.add_argument("--visual_matching", action="store_true")
    ap.add_argument("--video_dir", default=None)
    ap.add_argument("--results", default=None)
    ap.add_argument("--fused", action="store_true", default=True,
                    help="int8-quantize the policy (weight-only, the JAX "
                         "CLI's POLICY_PATTERNS) and serve through the fused "
                         "ViT / denoise kernels (batch 1); --no-fused for "
                         "the plain infer_action")
    ap.add_argument("--no-fused", dest="fused", action="store_false")
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


def load_model(args, cfg, device):
    """PiZeroVLA in bf16 (parameters and compute) with --ckpt's weights: a
    torch .pt of the reference's PiZero module tree."""
    from ..models.layers import load_state
    from ..policy.pizero import PiZeroVLA
    from ..utils.convert import from_jax_variables
    from ..utils.tools import (convert_pizero_torch_checkpoint,
                               load_torch_checkpoint)

    if not args.ckpt.endswith(".pt"):
        raise SystemExit("--ckpt: a torch .pt checkpoint (an orbax "
                         "directory is the JAX package's)")
    model = PiZeroVLA(cfg, param_dtype=torch.bfloat16,
                      compute_dtype=torch.bfloat16, device=device)
    model.requires_grad_(False)
    params = convert_pizero_torch_checkpoint(
        load_torch_checkpoint(args.ckpt), cfg.vlm.llm.num_layers,
        cfg.vlm.vision.num_layers)
    return load_state(model, from_jax_variables({"params": params}))


def build_adapter(args, cfg):
    """BridgeSimplerAdapter (--robot bridge) or EDRSimplerAdapter
    (fractal) over --stats, resizing to the ViT's input."""
    from ..envs.adapters import BridgeSimplerAdapter, EDRSimplerAdapter

    cls = BridgeSimplerAdapter if args.robot == "bridge" else EDRSimplerAdapter
    img = cfg.vlm.vision.image_size
    return cls(dataset_statistics_path=args.stats, image_size=(img, img))


def build_processor(cfg, tokenizer):
    from ..policy.processing import InternVLAProcessor

    return InternVLAProcessor(tokenizer,
                              num_image_tokens=cfg.vlm.num_image_token,
                              max_seq_len=cfg.max_image_text_tokens)


def build_server(args, model, adapter, processor, device):
    """PolicyServer over the model: under --fused the model is quantized
    in place for serving first, as the JAX CLI quantizes it (weight-only
    int8 over POLICY_PATTERNS; a model already quantized stays as it
    is)."""
    from ..core.quant import quantize_for_serving
    from ..serve.policy_server import PolicyServer

    if args.fused:
        quantize_for_serving(model, mode="int8", target="policy")
    return PolicyServer(model, None, adapter, processor, args.act_steps,
                        fused=args.fused, device=device)


def run(args, server, env=None, **runner_kw):
    """The JAX CLI's run: the fractal VA or VM grid sweep over
    build_env_from_spec's environments, else EvalRunner over --episodes
    on `env` (None: SimplerEnv's); `runner_kw` go to EvalRunner."""
    from ..eval.simpler_eval import EvalConfig, EvalRunner, run_fractal_protocol

    ecfg = EvalConfig(task=args.task, n_eval_episode=args.episodes,
                      act_steps=args.act_steps,
                      record_video_dir=args.video_dir,
                      results_path=args.results)
    if args.variant_aggregation or args.visual_matching:
        return run_fractal_protocol(
            ecfg, server, args.task,
            protocol="va" if args.variant_aggregation else "vm",
            **runner_kw)
    return EvalRunner(ecfg, server, env=env, **runner_kw).run()


def main(argv=None):
    """Parse argv (sys.argv when None), evaluate, print and return the
    summary."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    tokenizer = load_tokenizer(args)
    cfg = build_config(args, tokenizer)
    model = load_model(args, cfg, device)
    adapter = build_adapter(args, cfg)
    server = build_server(args, model, adapter, build_processor(cfg, tokenizer),
                          device)
    out = run(args, server)
    print(out)
    return out


if __name__ == "__main__":
    main()
