"""The port's training CLIs (vlaser_tpu_torch/scripts/train_sft.py,
pretrain.py, train_mpo.py) on the CPU under --tiny --device cpu, against
the JAX CLIs (scripts/) on the same JSONL files: the JAX CLI runs as
written, its trainer class swapped for a recorder that keeps its initial
weights, the batches it consumes and its metrics, on a one-device mesh;
the port's stages then build the same config, take those weights through
utils/convert.from_jax_variables, and must consume bit-equal batches and
give the JAX losses within LOSS_REL and grad norms within GNORM_REL (bf16
compute on both sides, as the CLIs run: one bf16 rounding of every
product, placed by two frameworks). Each port CLI's `main` also runs end
to end and leaves its checkpoint where --checkpoint_dir asked."""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import vlaser_tpu.train.mpo as jmpo
import vlaser_tpu.train.trainer as jtrainer
from vlaser_tpu.core import mesh as mesh_lib
from vlaser_tpu.core.distributed import put_global_batch
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.models.vlm import InternVLChatModel
from vlaser_tpu_torch.scripts import pretrain as ppre
from vlaser_tpu_torch.scripts import train_mpo as pmpo
from vlaser_tpu_torch.scripts import train_sft as psft
from vlaser_tpu_torch.utils.checkpoint import latest_step
from vlaser_tpu_torch.utils.convert import from_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bf16 compute on both sides; measured here: losses within 4.3e-4 and grad
# norms within 3.4e-3 relative
LOSS_REL, GNORM_REL = 2e-3, 1e-2
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Conversations (text, and one image item) and preference pairs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (30, 60, 3), dtype=np.uint8)).save(
        root / "img.png")
    words = "pick the red block and place it on the plate near a cube".split()
    say = lambda n: " ".join(rng.choice(words, n))
    with open(root / "conv.jsonl", "w") as f:
        for i in range(10):
            item = {"conversations": [
                {"from": "system", "value": "robot"},
                {"from": "human", "value": say(rng.integers(2, 12))},
                {"from": "gpt", "value": say(rng.integers(2, 25))}]}
            if i % 3 == 0:
                item = {"image": "img.png", "conversations": [
                    {"from": "human", "value": "<image>\n" + say(3)},
                    {"from": "gpt", "value": say(4)}]}
            f.write(json.dumps(item) + "\n")
    with open(root / "pairs.jsonl", "w") as f:
        for i in range(4):
            f.write(json.dumps({"question": say(5), "chosen": say(6),
                                "rejected": say(rng.integers(2, 9))}) + "\n")
    return root


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_cli_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _one_device():
    return mesh_lib.make_mesh(devices=jax.devices()[:1])


def _tee(batches, out):
    for b in batches:
        out.append(b)
        yield b


def _same(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        assert np.array_equal(x, y), (what, k)


def _port_model(cfg, params, remat):
    model = InternVLChatModel(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.bfloat16, device="cpu",
                              remat=remat)
    return load_state(model, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, {"params": params})))


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("packed", [True, False])
def test_train_sft_cli_matches_jax(data, tmp_path, monkeypatch, packed):
    rec = {"batches": []}

    class Recorder(jtrainer.SFTTrainer):
        def __init__(self, model, params, cfg, mesh=None):
            rec["params"] = jax.tree_util.tree_map(np.asarray,
                                                   params["params"])
            rec["cfg"] = model.cfg
            cfg = dataclasses.replace(
                cfg, checkpoint_dir=None, log_every=1,
                metrics_path=str(tmp_path / "jax.jsonl"))
            super().__init__(model, params, cfg, mesh=_one_device())

        def train(self, batches, data_state_fn=None, preemption_guard=None):
            return super().train(_tee(batches, rec["batches"]))

    flags = ["--tiny", "--data", str(data / "conv.jsonl"), "--image_root",
             str(data), "--steps", str(STEPS), "--batch", "2",
             "--max_seq", "512"] + (["--packed"] if packed else [])
    monkeypatch.setattr(jtrainer, "SFTTrainer", Recorder)
    monkeypatch.setattr(sys, "argv", ["train_sft.py"] + flags)
    _jax_cli("train_sft").main()

    args = psft.build_parser().parse_args(
        flags + ["--device", "cpu", "--checkpoint_dir", str(tmp_path / "ck")])
    tok = psft.load_tokenizer(args)
    cfg, n_added, start, end = psft.build_config(args, tok)
    assert n_added == 9
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rec["cfg"])
    model = _port_model(cfg, rec["params"], remat=True)
    dataset = psft.build_dataset(args, cfg, tok)
    batches, state_fn = psft.build_batches(args, cfg, dataset, start, end)
    trainer = psft.build_trainer(args, model)
    trainer.cfg.metrics_path, trainer.cfg.log_every = (
        str(tmp_path / "port.jsonl"), 1)
    got = []
    trainer.train(_tee(batches, got), data_state_fn=state_fn)
    batches.close()
    assert len(rec["batches"]) >= STEPS and len(got) >= STEPS
    for i in range(STEPS):
        _same(got[i], rec["batches"][i], f"batch {i}")
    if packed:
        assert any(int(b["image_flags"].sum()) for b in got[:STEPS])
    jm, pm = _metrics(tmp_path / "jax.jsonl"), _metrics(tmp_path /
                                                        "port.jsonl")
    assert [r["step"] for r in pm] == [r["step"] for r in jm] == [1, 2, 3]
    for p, j in zip(pm, jm):
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=LOSS_REL)
        np.testing.assert_allclose(p["grad_norm"], j["grad_norm"],
                                   rtol=GNORM_REL)
    assert latest_step(str(tmp_path / "ck")) == STEPS
    with open(tmp_path / "ck" / str(STEPS) / "meta.json") as f:
        meta = json.load(f)
    assert meta["step"] == STEPS
    assert (meta["data"] is not None) == packed


def test_train_mpo_cli_matches_jax(data, monkeypatch):
    rec = {"batches": [], "metrics": []}

    class Recorder(jmpo.MPOTrainer):
        def __init__(self, model, params, cfg, train_cfg=None, mesh=None):
            rec["params"] = jax.tree_util.tree_map(np.asarray,
                                                   params["params"])
            rec["cfg"], rec["beta"] = model.cfg, cfg.beta
            super().__init__(model, params, cfg, train_cfg, _one_device())

        def train(self, batches, num_steps):  # MPOTrainer.train's loop
            import jax.numpy as jnp

            rng = jax.random.PRNGKey(0)
            for i, batch in enumerate(batches):
                if i >= num_steps:
                    break
                rec["batches"].append(batch)
                rng, sub = jax.random.split(rng)
                delta = jnp.asarray(self.running.mean, jnp.float32)
                self.state, m = self._step(
                    self.state, self.ref_params,
                    put_global_batch(batch, self.mesh), delta, sub)
                self.running.update(np.asarray(m.pop("rewards")))
                rec["metrics"].append({k: float(v) for k, v in m.items()})
            return self.state

    flags = ["--tiny", "--data", str(data / "pairs.jsonl"), "--steps",
             str(STEPS), "--batch", "2", "--beta", "0.2", "--lr", "1e-3"]
    monkeypatch.setattr(jmpo, "MPOTrainer", Recorder)
    monkeypatch.setattr(sys, "argv", ["train_mpo.py"] + flags)
    _jax_cli("train_mpo").main()

    args = pmpo.build_parser().parse_args(flags + ["--device", "cpu"])
    tok = psft.load_tokenizer(args)
    cfg, _, _, _ = psft.build_config(args, tok)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rec["cfg"])
    trainer = pmpo.build_trainer(args, _port_model(cfg, rec["params"],
                                                   remat=False))
    assert trainer.cfg.beta == rec["beta"] == 0.2
    source = pmpo.batches(args, cfg, pmpo.build_dataset(args, cfg, tok))
    for i in range(STEPS):
        batch = next(source)
        _same(batch, rec["batches"][i], f"pair batch {i}")
        m = trainer.train(iter([batch]), 1)
        j = rec["metrics"][i]
        np.testing.assert_allclose(m["loss"].item(), j["loss"],
                                   rtol=LOSS_REL)
        np.testing.assert_allclose(m["grad_norm"].item(), j["grad_norm"],
                                   rtol=GNORM_REL)


def test_pretrain_cli_delegates_as_jax(data, tmp_path, monkeypatch):
    """The stage presets reach train_sft as the JAX pretrain passes them;
    stage 1 end to end on the CPU trains mlp1 alone and leaves its
    checkpoint."""
    jax_pre = _jax_cli("pretrain")
    import scripts.train_sft as jsft

    seen = []
    monkeypatch.setattr(jsft, "main", lambda: seen.append(sys.argv[1:]))
    for stage, extra in (("1", ["--packed"]), ("1.5", ["--lr", "3e-4"])):
        flags = ["--tiny", "--data", str(data / "conv.jsonl"), "--stage",
                 stage, "--steps", "2", "--checkpoint_dir",
                 str(tmp_path / stage)] + extra
        monkeypatch.setattr(sys, "argv", ["pretrain.py"] + flags)
        jax_pre.main()
        assert ppre.sft_argv(ppre.build_parser().parse_args(flags)) == \
            seen[-1]
    trainer = ppre.main(["--tiny", "--data", str(data / "conv.jsonl"),
                         "--stage", "1", "--steps", "2", "--batch", "2",
                         "--device", "cpu", "--checkpoint_dir",
                         str(tmp_path / "run")])
    assert trainer.step == 2 and latest_step(str(tmp_path / "run")) == 2
    fresh = psft.random_init_(InternVLChatModel(
        trainer.model.cfg, device="cpu"), torch.Generator().manual_seed(0))
    init = dict(fresh.named_parameters())
    moved = {n for n, p in trainer.model.named_parameters()
             if not torch.equal(p.detach(), init[n].detach())}
    assert moved and all(n.startswith("mlp1.") for n in moved), moved


@pytest.mark.parametrize("which", ["train_sft", "pretrain", "train_mpo"])
def test_cli_main_runs_on_the_cpu_and_leaves_its_checkpoint(data, tmp_path,
                                                            which):
    mod = {"train_sft": psft, "pretrain": ppre, "train_mpo": pmpo}[which]
    src = "pairs.jsonl" if which == "train_mpo" else "conv.jsonl"
    argv = ["--tiny", "--data", str(data / src), "--steps", "2", "--batch",
            "2", "--device", "cpu"]
    if which != "train_mpo":  # the JAX MPO CLI has no checkpoint flag
        argv += ["--checkpoint_dir", str(tmp_path / "ck")]
    trainer = mod.main(argv)
    assert trainer.step == 2
    if which != "train_mpo":
        assert sorted(os.listdir(tmp_path / "ck")) == ["2"]
