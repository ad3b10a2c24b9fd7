"""Routing guarantees of the port (vlaser_tpu_torch):
- importing it never imports jax;
- on CPU tensors the kernel wrappers run their plain twins and launch
  nothing; a tensor on a device with no route raises;
- chip_smoke.py refuses to run without a CUDA device."""

import os
import subprocess
import sys

import pytest
import torch

from vlaser_tpu.core.config import tiny_vla

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = (
    "vlaser_tpu_torch",
    "vlaser_tpu_torch.kernels._build",
    "vlaser_tpu_torch.kernels.ops",
    "vlaser_tpu_torch.kernels.fused_vit",
    "vlaser_tpu_torch.kernels.fused_decode",
    "vlaser_tpu_torch.core.quant",
    "vlaser_tpu_torch.models.layers",
    "vlaser_tpu_torch.models.internvit",
    "vlaser_tpu_torch.models.vlm",
    "vlaser_tpu_torch.utils.convert",
    "vlaser_tpu_torch.policy.joint",
    "vlaser_tpu_torch.policy.pizero",
    "vlaser_tpu_torch.policy.fused_infer",
    "vlaser_tpu_torch.serve.policy_server",
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in ('jax', 'flax', 'jaxlib') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout


def test_cpu_wrappers_take_the_twin_and_launch_nothing():
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.kernels import fused_decode, fused_vit
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.policy.fused_infer import make_fused_infer_action
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA

    cfg = tiny_vla(max_image_text_tokens=8)
    model = PiZeroVLA(cfg, compute_dtype=torch.float32)
    init_normal_(model, torch.Generator().manual_seed(0), std=0.1)
    quantize_for_serving(model, target="policy", mode="int8", min_size=1)
    g = torch.Generator().manual_seed(1)
    img = cfg.vlm.vision.image_size
    ids = torch.randint(1, 400, (1, 8), generator=g)
    ids[0, 1] = cfg.vlm.img_context_token_id
    args = (ids, torch.randn(1, img, img, 3, generator=g),
            torch.ones(1, 8, dtype=torch.int32),
            torch.randn(1, cfg.cond_steps, cfg.proprio_dim, generator=g),
            torch.randn(1, cfg.num_action_tokens, cfg.action_dim,
                        generator=g))
    before = (fused_vit.launch_count, fused_decode.launch_count)
    out = make_fused_infer_action(model)(*args)
    assert out.shape == (1, cfg.horizon_steps, cfg.action_dim)
    assert torch.isfinite(out).all()
    assert (fused_vit.launch_count, fused_decode.launch_count) == before


@pytest.mark.parametrize("which", ["fused_vit_stack", "fused_int8_stack"])
def test_no_route_for_other_devices(which):
    """A tensor that is neither on the CPU nor on a CUDA device raises
    instead of silently taking the twin."""
    from vlaser_tpu_torch.kernels import fused_decode, fused_vit

    x = torch.empty(4, 8, device="meta")
    fn = (fused_vit.fused_vit_stack if which == "fused_vit_stack"
          else fused_decode.fused_int8_stack)
    n_args = 17 if which == "fused_vit_stack" else 26
    with pytest.raises(RuntimeError, match="no route"):
        fn(x, *([None] * (n_args - 1)))


def test_chip_smoke_refuses_without_cuda(tmp_path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=60, env=env,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
