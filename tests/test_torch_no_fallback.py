"""Routing guarantees of the port (vlaser_tpu_torch):
- importing it, or what chip_smoke.py imports, never imports jax nor any
  module of the JAX package (vlaser_tpu);
- on CPU tensors the kernel wrappers run their plain twins and launch
  nothing, also when the kernel route is forced; a tensor on a device with
  no route raises; on a CUDA tensor a kernel library that cannot be built
  raises (no CPU carry-on);
- the entry points run on the card unless the caller asks for the CPU: a
  box without one raises (the training CLIs too, without --device cpu);
- chip_smoke.py refuses to run without a CUDA device."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from vlaser_tpu_torch.core.config import tiny_paligemma_vla, tiny_vla

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = (
    "vlaser_tpu_torch",
    "vlaser_tpu_torch.kernels._build",
    "vlaser_tpu_torch.kernels.ops",
    "vlaser_tpu_torch.kernels.fused_vit",
    "vlaser_tpu_torch.kernels.fused_decode",
    "vlaser_tpu_torch.kernels.flash_attention",
    "vlaser_tpu_torch.kernels.rmsnorm",
    "vlaser_tpu_torch.kernels.w8a8",
    "vlaser_tpu_torch.core.config",
    "vlaser_tpu_torch.core.quant",
    "vlaser_tpu_torch.image.tiling",
    "vlaser_tpu_torch.envs.geometry",
    "vlaser_tpu_torch.envs.adapters",
    "vlaser_tpu_torch.models.layers",
    "vlaser_tpu_torch.models.internvit",
    "vlaser_tpu_torch.models.siglip",
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
    "vlaser_tpu_torch.train.lora",
    "vlaser_tpu_torch.train.losses",
    "vlaser_tpu_torch.utils.monitoring",
    "vlaser_tpu_torch.serve.policy_server",
    "vlaser_tpu_torch.tokenizer.conversation",
    "vlaser_tpu_torch.models.qwen2",
    "vlaser_tpu_torch.inference.kv_cache",
    "vlaser_tpu_torch.inference.sampling",
    "vlaser_tpu_torch.inference.fused_runner",
    "vlaser_tpu_torch.inference.chat",
    "vlaser_tpu_torch.inference.speculative",
    "vlaser_tpu_torch.serve.engine",
    "vlaser_tpu_torch.serve.engine_chat",
    "vlaser_tpu_torch.serve.offline",
    "vlaser_tpu_torch.tokenizer.byte_tokenizer",
    "vlaser_tpu_torch.data.chat_dataset",
    "vlaser_tpu_torch.data.prefetch",
    "vlaser_tpu_torch.data.preference_dataset",
    "vlaser_tpu_torch.utils.hf_convert",
    "vlaser_tpu_torch.utils.tools",
    "vlaser_tpu_torch.utils.checkpoint",
    "vlaser_tpu_torch.utils.preemption",
    "vlaser_tpu_torch.train.mpo",
    "vlaser_tpu_torch.scripts.train_sft",
    "vlaser_tpu_torch.scripts.pretrain",
    "vlaser_tpu_torch.scripts.train_mpo",
    "vlaser_tpu_torch.train.metrics",
    "vlaser_tpu_torch.train.model_averaging",
    "vlaser_tpu_torch.train.optim8bit",
    "vlaser_tpu_torch.kernels.adam8bit",
    "vlaser_tpu_torch.data.rlds",
    "vlaser_tpu_torch.scripts.train_vla",
    "vlaser_tpu_torch.inference.beam_search",
    "vlaser_tpu_torch.serve.chat_server",
    "vlaser_tpu_torch.eval",
    "vlaser_tpu_torch.eval.vlm_benchmarks",
    "vlaser_tpu_torch.eval.mc_protocols",
    "vlaser_tpu_torch.eval.vqa_metrics",
    "vlaser_tpu_torch.eval.math_verify",
    "vlaser_tpu_torch.eval.grounding_bbox",
    "vlaser_tpu_torch.eval.ptb_tokenizer",
    "vlaser_tpu_torch.eval.caption_metrics",
    "vlaser_tpu_torch.eval.point_eval",
    "vlaser_tpu_torch.eval.embodied_benchmarks",
    "vlaser_tpu_torch.eval.protocol_runners",
    "vlaser_tpu_torch.scripts.serve_vlm",
    "vlaser_tpu_torch.scripts.eval_vlm",
    "vlaser_tpu_torch.policy.parallel_decoding",
    "vlaser_tpu_torch.eval.robotwin_eval",
    "vlaser_tpu_torch.serve.deploy_server",
    "vlaser_tpu_torch.data.hdf5_dataset",
    "vlaser_tpu_torch.data.robotwin_qa_dataset",
    "vlaser_tpu_torch.scripts.train_robotwin",
    "vlaser_tpu_torch.scripts.deploy_robotwin",
    "vlaser_tpu_torch.eval.variant_configs",
    "vlaser_tpu_torch.eval.simpler_eval",
    "vlaser_tpu_torch.scripts.eval_simpler",
    "vlaser_tpu_torch.eval.llm_judge",
    "vlaser_tpu_torch.models.moe",
    "vlaser_tpu_torch.native.build",
    "vlaser_tpu_torch.image.native",
    "vlaser_tpu_torch.data.native_loader",
    "vlaser_tpu_torch.core.mesh",
    "vlaser_tpu_torch.utils.memory_budget",
    "vlaser_tpu_torch.data.qa_generation",
    "vlaser_tpu_torch.data.reasoning_pipeline",
    "vlaser_tpu_torch.data.visualprm_pipeline",
    "vlaser_tpu_torch.scripts.generate_qa",
    "vlaser_tpu_torch.core.distributed",
    "vlaser_tpu_torch.core.tensor_parallel",
    "vlaser_tpu_torch.kernels.ring_attention",
    "vlaser_tpu_torch.graft_entry",
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
    assert "vlaser_tpu_torch.serve.offline" in mods
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


def test_the_8b_and_qwen3_families_never_import_jax():
    """The slice of the dense families beyond Vlaser-2B: its configs, the
    8B VLA and InternVL3.5-2B laid out on the meta device, a qk-norm
    mixture's refusal of the fused routes and the ViT's bicubic resize
    leave no jax and no vlaser_tpu in sys.modules."""
    code = (
        "import sys, torch\n"
        "from vlaser_tpu_torch.core import config as c\n"
        "from vlaser_tpu_torch.kernels import ops\n"
        "from vlaser_tpu_torch.models.vlm import InternVLChatModel\n"
        "from vlaser_tpu_torch.policy import fused_infer\n"
        "from vlaser_tpu_torch.policy.pizero import PiZeroVLA\n"
        "PiZeroVLA(c.vlaser_8b_vla(), device='meta')\n"
        "InternVLChatModel(c.internvl3_5_2b(), device='meta')\n"
        "q3 = PiZeroVLA(c.tiny_qwen3_vla(), device='cpu')\n"
        "for make in (fused_infer.make_fused_infer_action,\n"
        "             fused_infer.make_batched_infer_action):\n"
        "    try:\n"
        "        make(q3)\n"
        "        raise SystemExit('a fused route took a qk-norm mixture')\n"
        "    except NotImplementedError:\n"
        "        pass\n"
        "ops.bicubic_resize_2d(torch.zeros(1, 4, 4, 2), 2, 3)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'jaxlib', 'vlaser_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout


def test_the_moe_and_native_slice_never_imports_jax():
    """The native image loader and the Qwen3-MoE family: building and
    loading both native libraries, tiling a fixture JPEG, InternVL3.5-30B-A3B
    laid out on the meta device, a tiny MoE LLM's forward with its router
    loss and a Phi3 longrope table leave no jax and no vlaser_tpu in
    sys.modules."""
    code = (
        "import sys, torch\n"
        "from vlaser_tpu_torch.core import config as c\n"
        "from vlaser_tpu_torch.data import native_loader\n"
        "from vlaser_tpu_torch.image import native\n"
        "from vlaser_tpu_torch.kernels import ops\n"
        "from vlaser_tpu_torch.models import moe\n"
        "from vlaser_tpu_torch.models.qwen2 import Qwen2ForCausalLM\n"
        "from vlaser_tpu_torch.models.vlm import InternVLChatModel\n"
        "t = native_loader.load_image_tiles_native(\n"
        "    'vlaser_tpu_torch/native/fixtures/scene_4x3.jpg')\n"
        "assert t.shape == (13, 448, 448, 3)\n"
        "assert native.available()\n"
        "InternVLChatModel(c.internvl3_5_30b_a3b(), device='meta')\n"
        "lm = Qwen2ForCausalLM(c.tiny_qwen3_moe_llm(), device='cpu')\n"
        "with moe.collect_router_stats(lm) as st:\n"
        "    lm(input_ids=torch.ones(1, 5, dtype=torch.long))\n"
        "moe.router_aux_loss(*st[0])\n"
        "ops.rope_cos_sin_su(torch.arange(40)[None], 16, 1e4, (1.0,) * 8,\n"
        "                    (2.0,) * 8, 32, 128)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'jaxlib', 'vlaser_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout


def test_the_native_build_writes_nothing_under_the_jax_package(tmp_path):
    """The port's g++ builds (image ops and the JPEG loader), forced into a
    fresh directory, write their libraries there and leave every file under
    vlaser_tpu/ as it was: no new .so, none touched."""
    from pathlib import Path

    from vlaser_tpu_torch.native import build

    jax_pkg = Path(REPO) / "vlaser_tpu"
    before = {p: p.stat().st_mtime_ns for p in jax_pkg.rglob("*")
              if p.is_file()}
    code = ("import sys; from pathlib import Path\n"
            "from vlaser_tpu_torch.native import build as b\n"
            "b.BUILD_DIR = Path(sys.argv[1])\n"
            "print(b.build()); print(b.build_dataloader())\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=120,
                         env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    libs = [Path(p) for p in out.stdout.split()]
    assert len(libs) == 2 and all(p.parent == tmp_path and p.exists()
                                  for p in libs)
    after = {p: p.stat().st_mtime_ns for p in jax_pkg.rglob("*")
             if p.is_file()}
    assert after == before
    assert build.BUILD_DIR == Path(REPO) / "vlaser_tpu_torch" / "_build"


def test_cpu_wrappers_take_the_twin_and_launch_nothing():
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.kernels import fused_decode, fused_vit
    from vlaser_tpu_torch.models.layers import init_normal_
    from vlaser_tpu_torch.policy.fused_infer import make_fused_infer_action
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA

    cfg = tiny_vla(max_image_text_tokens=8)
    model = PiZeroVLA(cfg, compute_dtype=torch.float32, device="cpu")
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


def test_stack_launch_has_no_fallback_around_the_cooperative_launch():
    """The decoder stack's CUDA route is one cooperative launch whose error
    the wrapper raises: no `try` (that could turn a refused launch into the
    twin or the old kernel chain) in the wrapper or its entry point."""
    import inspect

    from vlaser_tpu_torch.kernels import fused_decode

    for fn in (fused_decode._launch, fused_decode.fused_int8_stack):
        src = inspect.getsource(fn)
        assert "try:" not in src and "except" not in src, fn.__name__
    assert "_build.check(code" in inspect.getsource(fused_decode._launch)


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


@pytest.mark.parametrize("which", ["flash_attention_fwd", "rms_fwd",
                                   "quantize_rows", "int8_gemm"])
def test_new_kernels_have_no_route_for_other_devices(which):
    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import rmsnorm, w8a8

    x = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(RuntimeError, match="no route"):
        if which == "rms_fwd":
            rmsnorm.rms_fwd(x[0, :, 0], x[0, 0, 0], 1e-6)
        elif which == "quantize_rows":
            w8a8.quantize_rows(x[0, :, 0])
        elif which == "int8_gemm":
            w8a8.int8_gemm(x[0, :, 0], None, None, None)
        else:
            fa.flash_attention_fwd(x, x, x, None, None)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it reaches a wrapper's CUDA
    route on a box without a card (the route must then build the kernel
    library, or raise)."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("which", ["quantize_rows", "int8_gemm",
                                   "fused_vit_stack_act_quant",
                                   "fused_int8_stack_decode",
                                   "fused_int8_stack_bf16"])
def test_new_wrappers_raise_when_the_library_cannot_load(monkeypatch, which):
    from vlaser_tpu_torch.kernels import _build, fused_decode, fused_vit, w8a8

    def no_library():
        raise RuntimeError("cannot build the kernel library: nvcc not found")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(w8a8, "_fns", {})
    monkeypatch.setattr(fused_vit, "_fns", {})
    monkeypatch.setattr(fused_decode, "_fns", {})
    card = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt).as_subclass(
        _OnCard)
    i8, bf = torch.int8, torch.bfloat16
    counts = (w8a8.quant_launch_count, w8a8.gemm_launch_count,
              fused_vit.act_quant_launch_count, fused_decode.launch_count)
    with pytest.raises(RuntimeError, match="cannot build"):
        if which.startswith("fused_int8_stack"):
            # the decode configuration: 1 row, fp32 rope tables, a cache of
            # 40 slots; int8 weights with scales or bf16 with unit scales
            L, C, H, KVH, D, I, E = 1, 256, 2, 1, 128, 512, 40
            wdt = bf if which.endswith("bf16") else i8
            mats = []
            for k, n in ((C, H * D), (C, KVH * D), (C, KVH * D), (H * D, C),
                         (C, I), (C, I), (I, C)):
                mats += [card(L, k, n, dt=wdt), card(L, 1, n)]
            fused_decode.fused_int8_stack(
                card(1, C, dt=bf), card(1, D), card(1, D), card(1, 1),
                card(1, E), card(L, C), card(L, C), card(L, H * D),
                card(L, KVH * D), card(L, KVH * D), *mats,
                card(L, E, KVH, D, dt=bf), card(L, E, KVH, D, dt=bf))
        elif which == "quantize_rows":
            w8a8.quantize_rows(card(4, 32, dt=torch.bfloat16))
        elif which == "int8_gemm":
            # the weight K-major [N, K]
            w8a8.int8_gemm(card(4, 32, dt=i8), card(4, 1), card(16, 32, dt=i8),
                           card(16))
        else:
            L, C, inter = 1, 128, 256
            vecs = [card(L, n) for n in (C,) * 8 + (3 * C, C, inter, C)]
            mats = [card(L, n, k, dt=i8) for k, n in (  # K-major
                (C, 3 * C), (C, C), (C, inter), (inter, C))]
            scales = [card(L, n) for n in (3 * C, C, inter, C)]
            fused_vit.fused_vit_stack(card(5, C, dt=torch.bfloat16), *vecs,
                                      *mats, *scales, num_heads=2,
                                      act_quant=True)
    assert (w8a8.quant_launch_count, w8a8.gemm_launch_count,
            fused_vit.act_quant_launch_count,
            fused_decode.launch_count) == counts


@pytest.mark.parametrize("D", [32, 96, 80])
def test_flash_cuda_route_refuses_other_head_dims(monkeypatch, D):
    """On a CUDA tensor a head dim without a kernel (the kernels take 64,
    72, 128 and 256) raises ValueError naming it, before any build or
    launch; the CPU route takes any head dim."""
    from vlaser_tpu_torch.kernels import _build
    from vlaser_tpu_torch.kernels import flash_attention as fa

    def no_library():
        raise AssertionError("the library must not be needed")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(fa, "_fns", {})
    q = torch.zeros(1, 8, 2, D, dtype=torch.bfloat16)
    m = torch.ones(1, 8, dtype=torch.int32)
    card = lambda t: t.as_subclass(_OnCard)
    counts = (fa.fwd_launch_count, fa.bwd_launch_count)
    with pytest.raises(ValueError, match=str(D)):
        fa.flash_attention_fwd(card(q), card(q), card(q), card(m), card(m))
    with pytest.raises(ValueError, match=str(D)):
        fa.flash_attention_bwd(card(q), card(q), card(q), card(m), card(m), 0,
                               card(q), card(torch.zeros(1, 2, 8)), card(q))
    assert (fa.fwd_launch_count, fa.bwd_launch_count) == counts
    out, lse = fa.flash_attention_fwd(q.float(), q.float(), q.float(), m, m)
    assert out.shape == q.shape and lse.shape == (1, 2, 8)


def test_entry_points_default_to_the_card():
    """PiZeroVLA (the internvl and the paligemma backbone), PolicyServer
    and generate_qa with no device take the card; without one they raise
    instead of building on the CPU."""
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA
    from vlaser_tpu_torch.scripts import generate_qa
    from vlaser_tpu_torch.serve.policy_server import PolicyServer

    cfg = tiny_vla(max_image_text_tokens=8)
    pali = tiny_paligemma_vla()
    if torch.cuda.is_available():
        assert PiZeroVLA(cfg).device.type == "cuda"
        assert PiZeroVLA(pali).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PiZeroVLA(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PiZeroVLA(pali)
    assert PiZeroVLA(pali, device="cpu").device.type == "cpu"
    model = PiZeroVLA(cfg, device="cpu")
    assert model.device.type == "cpu"
    with pytest.raises((RuntimeError, AssertionError)):
        PolicyServer(model)
    assert PolicyServer(model, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="--device cpu"):
        generate_qa.main(["--tiny", "--episodes_dir", ".", "--out",
                          "unused.jsonl"])


def test_chat_entry_points_default_to_the_card():
    """InternVLChatModel and VlaserChat with no device take the card;
    without one the model raises instead of building on the CPU, and a chat
    over a CPU model routes "auto" to the plain generator."""
    from vlaser_tpu_torch.core.config import tiny_vlm
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.inference.chat import VlaserChat
    from vlaser_tpu_torch.models.vlm import InternVLChatModel

    class Tok:
        def convert_tokens_to_ids(self, tok):
            return 2

    cfg = tiny_vlm()
    if torch.cuda.is_available():
        model = quantize_for_serving(InternVLChatModel(cfg), min_size=1)
        assert model.device.type == "cuda"
        assert VlaserChat(model, Tok())._fused_gen is not None
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InternVLChatModel(cfg)
    model = quantize_for_serving(InternVLChatModel(cfg, device="cpu"),
                                 min_size=1)
    chat = VlaserChat(model, Tok())
    assert chat.device.type == "cpu" and chat._fused_gen is None


def test_engine_runs_on_the_models_device():
    """The serving engine takes its model's device for its cache and row
    state: the card by default (the model raises without one), the CPU
    only for a model built there."""
    from vlaser_tpu_torch.core.config import tiny_vlm
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.serve.engine import ContinuousBatchingEngine

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    model = InternVLChatModel(tiny_vlm(),
                              device=None if dev == "cuda" else "cpu")
    eng = ContinuousBatchingEngine(model, num_slots=2, max_len=32,
                                   eos_token_ids=[3], pad_token_id=0)
    assert eng.device.type == dev
    assert eng.cache.k.device.type == eng.cache.length.device.type == dev


CLI_DATA = {"train_sft": "conv", "pretrain": "conv", "train_mpo": "pairs"}


@pytest.mark.parametrize("cli", sorted(CLI_DATA))
def test_training_clis_default_to_the_card(tmp_path, cli):
    """A port CLI given no --device runs on the card: on a box without one
    it raises before it builds or trains anything, in a process that
    loads no jax and no vlaser_tpu; each module also refuses --fsdp 2
    without a process group to shard over."""
    import json

    with open(tmp_path / "conv.jsonl", "w") as f:
        f.write(json.dumps({"conversations": [
            {"from": "human", "value": "hi"},
            {"from": "gpt", "value": "hello"}]}) + "\n")
    with open(tmp_path / "pairs.jsonl", "w") as f:
        f.write(json.dumps({"question": "q", "chosen": "a",
                            "rejected": "b"}) + "\n")
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    data = str(tmp_path / f"{CLI_DATA[cli]}.jsonl")
    code = ("import sys\n"
            f"from vlaser_tpu_torch.scripts import {cli} as m\n"
            "try:\n"
            f"    m.main(['--tiny', '--data', {data!r}, '--steps', '1',\n"
            f"            '--checkpoint_dir', {str(tmp_path / 'ck')!r}]\n"
            f"           if {cli!r} != 'train_mpo' else\n"
            f"           ['--tiny', '--data', {data!r}, '--steps', '1'])\n"
            "except RuntimeError as e:\n"
            "    assert '--device cpu' in str(e), e\n"
            "    bad = [k for k in sys.modules if k.split('.')[0] in\n"
            "           ('jax', 'flax', 'jaxlib', 'vlaser_tpu')]\n"
            "    assert not bad, bad\n"
            "    print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "refused" in out.stdout
    assert not (tmp_path / "ck").exists()
    from vlaser_tpu_torch.scripts import pretrain, train_mpo, train_sft

    mod = {"train_sft": train_sft, "pretrain": pretrain,
           "train_mpo": train_mpo}[cli]
    with pytest.raises(RuntimeError, match="process group"):
        mod.main(["--tiny", "--data", data, "--fsdp", "2", "--device",
                  "cpu"])


def test_port_and_chip_smoke_never_import_tensorflow():
    """tensorflow (the RLDS stream's host pipeline) is imported only inside
    data/rlds.py's functions: importing the port, or what chip_smoke.py
    imports, loads none of it."""
    mods = SLICE_MODULES + tuple(_chip_smoke_imports())
    assert "vlaser_tpu_torch.scripts.train_vla" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('tensorflow', 'tensorflow_datasets')]\n"
            "assert not bad, bad[:5]\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout


def _adam8bit_args(make, n=5000):
    nb = -(-n // 256)
    return (make(n), make(n), make(nb, 256, dt=torch.uint8), make(nb, 1),
            make(nb, 256, dt=torch.uint8), make(nb, 1))


def test_adamw8bit_has_no_route_for_other_devices():
    from vlaser_tpu_torch.kernels import adam8bit
    from vlaser_tpu_torch.train.optim8bit import hyper

    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    with pytest.raises(RuntimeError, match="no route"):
        adam8bit.adamw8bit(*_adam8bit_args(meta),
                           hyper(0.9, 0.999, 1e-8, 0.0, 1e-3, 1))


def test_adamw8bit_raises_when_the_library_cannot_load(monkeypatch):
    """A CUDA tensor reaches the kernel's build (which fails here), never
    the eager twin; AdamW8bit.step's 8-bit leaves go through this wrapper
    alone."""
    import inspect

    from vlaser_tpu_torch.kernels import _build, adam8bit
    from vlaser_tpu_torch.train import optim8bit

    def no_library():
        raise RuntimeError("cannot build the kernel library: nvcc not found")

    def no_twin(*a, **k):
        raise AssertionError("a CUDA tensor reached the twin")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(adam8bit, "_fns", {})
    monkeypatch.setattr(optim8bit, "adam8bit_update_plain", no_twin)
    monkeypatch.setattr(optim8bit, "_tables", {})
    monkeypatch.setattr(optim8bit, "code_tables", lambda dev: {
        "all": torch.zeros(766).as_subclass(_OnCard)})
    card = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt).as_subclass(
        _OnCard)
    before = adam8bit.launch_count
    with pytest.raises(RuntimeError, match="cannot build"):
        adam8bit.adamw8bit(*_adam8bit_args(card),
                           optim8bit.hyper(0.9, 0.999, 1e-8, 0.0, 1e-3, 1))
    assert adam8bit.launch_count == before
    src = inspect.getsource(optim8bit.AdamW8bit.step)
    assert "adam8bit_update_plain" not in src and "_kernel.adamw8bit" in src
    assert "try:" not in inspect.getsource(adam8bit.adamw8bit)


def test_train_vla_cli_defaults_to_the_card(tmp_path):
    """train_vla's main with no --device raises on a box without a card,
    before it builds or reads anything, in a process that loads no jax,
    no vlaser_tpu and no tensorflow; --fsdp 2 without a process group
    raises."""
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    code = ("import sys\n"
            "from vlaser_tpu_torch.scripts import train_vla as m\n"
            "try:\n"
            "    m.main(['--model_path', 'x', '--rlds_dir', 'y'])\n"
            "except RuntimeError as e:\n"
            "    assert '--device cpu' in str(e), e\n"
            "    bad = [k for k in sys.modules if k.split('.')[0] in\n"
            "           ('jax', 'flax', 'jaxlib', 'vlaser_tpu', 'tensorflow')]\n"
            "    assert not bad, bad\n"
            "    print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "refused" in out.stdout
    from vlaser_tpu_torch.scripts import train_vla

    with pytest.raises(RuntimeError, match="process group"):
        train_vla.main(["--model_path", "x", "--rlds_dir", "y", "--fsdp",
                        "2", "--device", "cpu"])


@pytest.mark.parametrize("cli", ["serve_vlm", "eval_vlm", "generate_qa"])
def test_serving_clis_default_to_the_card(tmp_path, cli):
    """serve_vlm / eval_vlm / generate_qa given no --device raise on a box
    without a card before they build a model, in a process that loads no
    jax, no vlaser_tpu and no PIL (a text-only run needs none)."""
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    argv = ["--tiny"] + {
        "eval_vlm": ["--benchmark", "mcq", "--data", "x.jsonl"],
        "generate_qa": ["--episodes_dir", ".", "--out", "o.jsonl"],
    }.get(cli, [])
    code = ("import sys\n"
            f"from vlaser_tpu_torch.scripts import {cli} as m\n"
            "try:\n"
            f"    m.main({argv!r})\n"
            "except RuntimeError as e:\n"
            "    assert '--device cpu' in str(e), e\n"
            "    bad = [k for k in sys.modules if k.split('.')[0] in\n"
            "           ('jax', 'flax', 'jaxlib', 'vlaser_tpu', 'PIL')]\n"
            "    assert not bad, bad\n"
            "    print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "refused" in out.stdout


def test_robotwin_and_simpler_entry_points_default_to_the_card(tmp_path):
    """ParallelDecodingVLA with no device takes the card, and so do the
    RoboTwin and SimplerEnv CLIs without --device; without a card they
    raise instead of running on the CPU."""
    from vlaser_tpu_torch.core.config import tiny_vlm
    from vlaser_tpu_torch.policy.parallel_decoding import (
        ParallelDecodingConfig, ParallelDecodingVLA)
    from vlaser_tpu_torch.scripts import (deploy_robotwin, eval_simpler,
                                          train_robotwin)

    cfg = ParallelDecodingConfig(vlm=tiny_vlm(), action_chunk=4, action_dim=6,
                                 state_dim=6, state_vocab_size=16,
                                 max_text_tokens=8, head_hidden=32)
    if torch.cuda.is_available():
        assert ParallelDecodingVLA(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParallelDecodingVLA(cfg)
    assert ParallelDecodingVLA(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_robotwin.main(["--tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        deploy_robotwin.main(["--tiny", "--port", "0"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        eval_simpler.main(["--model_path", str(tmp_path), "--ckpt", "x.pt",
                           "--stats", "s.json"])


def test_dryrun_multichip_never_imports_jax():
    """graft_entry.dryrun_multichip on 2 gloo ranks: every section's line
    with finite values (PPxFSDP-train and CPxFSDP-train run at n
    divisible by 8 only, as in JAX), none named as not ported, in a
    process that loads no jax and no vlaser_tpu."""
    code = ("import sys\n"
            "from vlaser_tpu_torch.graft_entry import dryrun_multichip\n"
            "lines = dryrun_multichip(2)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'flax', 'jaxlib', 'vlaser_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean', len(lines))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clean 7" in out.stdout
    # VLA and SFT on the JAX gate's mesh: tensor 2 first, then fsdp
    for section in ("VLA: mesh={'data': 1, 'fsdp': 1, 'tensor': 2} loss=",
                    "SFT: mesh={'data': 1, 'fsdp': 1, 'tensor': 2} loss=",
                    "TP-serve: actions (2, 4, 7)",
                    "TP-engine: 3 completions", "EP: MoE logits (4, 8, 512)",
                    "CP: ring attention over {'context': 2}",
                    "PP: 2-stage pipeline hidden (4, 8, 64)"):
        assert f"dryrun_multichip(2) {section}" in out.stdout, section
    assert "nan" not in out.stdout
    assert "not ported yet" not in out.stdout


@pytest.mark.parametrize("which", ["flash_attention_fwd", "flash_attention_bwd",
                                   "rms_fwd", "quantize_rows", "int8_gemm"])
def test_a_dtensor_at_a_kernel_entry_raises(tmp_path, which):
    """A DTensor reaching a kernel's entry raises instead of taking the
    plain twin by its device (a one-rank gloo group, torn down after)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import rmsnorm, w8a8

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        dt = lambda *s, dtype=torch.float32: DTensor.from_local(
            torch.ones(s, dtype=dtype), mesh, [Replicate()])
        bf, i8 = torch.bfloat16, torch.int8
        meta = torch.ones((1, 8), dtype=torch.int32)
        calls = {
            "flash_attention_fwd": lambda: fa.flash_attention_fwd(
                dt(1, 8, 2, 64, dtype=bf), dt(1, 8, 2, 64, dtype=bf),
                dt(1, 8, 2, 64, dtype=bf), meta, meta),
            "flash_attention_bwd": lambda: fa.flash_attention_bwd(
                torch.ones(1, 8, 2, 64), torch.ones(1, 8, 2, 64),
                torch.ones(1, 8, 2, 64), meta, meta, 0,
                torch.ones(1, 8, 2, 64), dt(1, 2, 8),
                torch.ones(1, 8, 2, 64)),
            "rms_fwd": lambda: rmsnorm.rms_fwd(torch.ones(4, 16), dt(16),
                                               1e-6),
            "quantize_rows": lambda: w8a8.quantize_rows(dt(4, 32, dtype=bf)),
            "int8_gemm": lambda: w8a8.int8_gemm(
                torch.ones(4, 32, dtype=i8), torch.ones(4, 1),
                dt(16, 32, dtype=i8), torch.ones(16)),
        }
        with pytest.raises(TypeError, match="DTensor"):
            calls[which]()
    finally:
        dist.destroy_process_group()


def test_ring_kernel_route_has_no_eager_fallback(monkeypatch):
    """The ring's chunk steps on a CUDA q go through the flash kernel's
    CUDA launch; when that launch fails the error leaves the ring instead
    of the eager chunk step taking over."""
    from vlaser_tpu_torch.kernels import flash_attention as fa
    from vlaser_tpu_torch.kernels import ring_attention as ra

    def launch(*args):
        raise RuntimeError("the CUDA launch was reached")

    monkeypatch.setattr(fa, "_fwd_launch", launch)
    monkeypatch.setattr(ra, "_kernel_route",
                        lambda q: q.device.type == "cuda")
    card = lambda *s, dt=torch.bfloat16: torch.ones(s, dtype=dt).as_subclass(
        _OnCard)
    with pytest.raises(RuntimeError, match="CUDA launch was reached"):
        ra.virtual_ring(card(1, 128, 2, 64), card(1, 128, 1, 64),
                        card(1, 128, 1, 64), 2, causal=True,
                        q_segment_ids=card(1, 128, dt=torch.int32))
