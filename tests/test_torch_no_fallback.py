"""Routing guarantees of the port (vlaser_tpu_torch):
- importing it, or what chip_smoke.py imports, never imports jax nor any
  module of the JAX package (vlaser_tpu);
- on CPU tensors the kernel wrappers run their plain twins and launch
  nothing, also when the kernel route is forced; a tensor on a device with
  no route raises;
- chip_smoke.py refuses to run without a CUDA device."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from vlaser_tpu_torch.core.config import tiny_vla

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = (
    "vlaser_tpu_torch",
    "vlaser_tpu_torch.kernels._build",
    "vlaser_tpu_torch.kernels.ops",
    "vlaser_tpu_torch.kernels.fused_vit",
    "vlaser_tpu_torch.kernels.fused_decode",
    "vlaser_tpu_torch.kernels.flash_attention",
    "vlaser_tpu_torch.kernels.rmsnorm",
    "vlaser_tpu_torch.core.config",
    "vlaser_tpu_torch.core.quant",
    "vlaser_tpu_torch.image.tiling",
    "vlaser_tpu_torch.envs.geometry",
    "vlaser_tpu_torch.envs.adapters",
    "vlaser_tpu_torch.models.layers",
    "vlaser_tpu_torch.models.internvit",
    "vlaser_tpu_torch.models.vlm",
    "vlaser_tpu_torch.utils.convert",
    "vlaser_tpu_torch.policy.joint",
    "vlaser_tpu_torch.policy.pizero",
    "vlaser_tpu_torch.policy.fused_infer",
    "vlaser_tpu_torch.policy.processing",
    "vlaser_tpu_torch.policy.flow",
    "vlaser_tpu_torch.train.optim",
    "vlaser_tpu_torch.train.train_step",
    "vlaser_tpu_torch.train.trainer",
    "vlaser_tpu_torch.serve.policy_server",
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _chip_smoke_imports():
    """Every module chip_smoke.py imports, at top level or in a function."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    return sorted(mods)


def test_port_never_imports_jax():
    mods = SLICE_MODULES + tuple(_chip_smoke_imports())
    assert "vlaser_tpu_torch.train.trainer" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'flax', 'jaxlib', 'vlaser_tpu')]\n"
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


def test_forced_kernel_route_on_cpu_launches_nothing():
    """impl="kernel" on CPU tensors runs the plain versions (forward and
    backward) and launches no kernel."""
    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import rmsnorm

    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 4, 16, generator=g).requires_grad_()
    kv = torch.randn(1, 8, 2, 16, generator=g).requires_grad_()
    x = torch.randn(6, 16, generator=g).requires_grad_()
    w = torch.ones(16, requires_grad=True)
    counts = lambda: (fa.fwd_launch_count, fa.bwd_launch_count,
                      rmsnorm.fwd_launch_count, rmsnorm.bwd_launch_count)
    before = counts()
    out = fa.attention(q, kv, kv, causal=True, impl="kernel")
    y = rmsnorm.rms_norm(x, w, impl="kernel")
    (out.sum() + y.sum()).backward()
    assert counts() == before
    assert q.grad is not None and w.grad is not None


@pytest.mark.parametrize("which", ["flash_attention_fwd", "rms_fwd"])
def test_new_kernels_have_no_route_for_other_devices(which):
    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import rmsnorm

    x = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(RuntimeError, match="no route"):
        if which == "rms_fwd":
            rmsnorm.rms_fwd(x[0, :, 0], x[0, 0, 0], 1e-6)
        else:
            fa.flash_attention_fwd(x, x, x, None, None)
