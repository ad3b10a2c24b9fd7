"""The port's VLA training CLI (vlaser_tpu_torch/scripts/train_vla.py)
against the JAX CLI (scripts/train_vla.py) on the CPU, on the same
injected RLDS trajectories (bridge_dataset's raw layout, through the real
standardize, statistics, window, frame and mixture stages): the JAX CLI
runs as written, with the tiny config and the byte tokenizer swapped in and
its VLATrainer swapped for a recorder that keeps its initial weights, the
batches it consumes and its metrics, on a one-device mesh; the port's
stages then take those weights (utils/convert.from_jax_variables) and must
consume bit-equal batches and reach the JAX losses within LOSS_REL and
grad norms within GNORM_REL (bf16 compute and remat on both sides, as the
CLIs run; one bf16 rounding of every product, placed by two frameworks).

Two swaps hold in both packages: the flow times and noise are the same
numpy draws (each package otherwise draws its own), and the train-time
image augmentation is off (AUGMENT_KWARGS_PRIMARY None): its per-frame
seed comes from an unseeded random op under a parallel map, which is not
reproducible from one pass to the next even within one package
(test_torch_rlds.py holds augment_image at fixed seeds). The port's
`main --device cpu --adam8bit` then trains and leaves its checkpoint."""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import vlaser_tpu.core.config as jconfig  # noqa: E402
import vlaser_tpu.data.rlds as jrlds  # noqa: E402
import vlaser_tpu.train.trainer as jtrainer  # noqa: E402
from vlaser_tpu.core import mesh as mesh_lib  # noqa: E402
from vlaser_tpu.tokenizer.byte_tokenizer import ByteTokenizer as JTok  # noqa
from vlaser_tpu.utils.tools import ensure_special_tokens as j_special  # noqa
from vlaser_tpu_torch.core.config import tiny_vla as p_tiny  # noqa: E402
from vlaser_tpu_torch.data import rlds as prlds  # noqa: E402
from vlaser_tpu_torch.models.layers import load_state  # noqa: E402
from vlaser_tpu_torch.scripts import train_vla as pcli  # noqa: E402
from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer as PTok
from vlaser_tpu_torch.train import trainer as ptrainer  # noqa: E402
from vlaser_tpu_torch.utils.checkpoint import latest_step  # noqa: E402
from vlaser_tpu_torch.utils.convert import from_jax_variables  # noqa: E402
from vlaser_tpu_torch.utils.tools import ensure_special_tokens as p_special

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bf16 compute on both sides; measured here: losses within 3.5e-3 and grad
# norms within 9.5e-3 relative (the flow loss is a mean of squared bf16
# velocity errors over a few actions; at fp32 compute the first loss agrees
# within 1e-5, which the test also holds)
LOSS_REL, GNORM_REL = 1e-2, 2e-2
STEPS, B, SEQ, IMG = 3, 2, 96, 28
FLAGS = ["--model_path", "unused", "--rlds_dir", "unused", "--datasets",
         "bridge_dataset", "--batch", str(B), "--steps", str(STEPS),
         "--lr", "1e-3", "--image_size", str(IMG), "--shuffle_buffer", "64"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridge_trajectories(n_traj=5, traj_len=9, seed=0):
    """Raw bridge_dataset episodes: image_0, state, action (gripper in
    [0, 1]), language_instruction."""
    rng = np.random.default_rng(seed)
    words = ["put the carrot on the plate", "pick up the spoon",
             "move the cube near the towel"]
    trajs = [{
        "observation": {
            "image_0": rng.integers(0, 255, (traj_len, 16, 16, 3), np.uint8),
            "state": rng.standard_normal((traj_len, 7)).astype(np.float32)},
        "action": np.concatenate([
            rng.standard_normal((traj_len, 6)),
            rng.integers(0, 2, (traj_len, 1))], 1).astype(np.float32),
        "language_instruction": np.array(
            [words[i % 3].encode()] * traj_len)} for i in range(n_traj)]
    spec = {"observation": {
        "image_0": tf.TensorSpec((None, 16, 16, 3), tf.uint8),
        "state": tf.TensorSpec((None, 7), tf.float32)},
        "action": tf.TensorSpec((None, 7), tf.float32),
        "language_instruction": tf.TensorSpec((None,), tf.string)}
    return tf.data.Dataset.from_generator(lambda: iter(trajs),
                                          output_signature=spec)


def _inject(mod, monkeypatch):
    """mod.make_dataset_from_rlds reads the synthetic episodes; the
    augmentation off."""
    orig = mod.make_dataset_from_rlds

    def make(cfg, **kw):
        return orig(cfg, trajectory_ds=_bridge_trajectories(), train=True)

    monkeypatch.setattr(mod, "make_dataset_from_rlds", make)
    monkeypatch.setattr(mod, "AUGMENT_KWARGS_PRIMARY", None)


def _tiny(tiny, tokenizer, ids):
    cfg = tiny(max_image_text_tokens=SEQ)
    vlm = cfg.vlm
    return dataclasses.replace(cfg, vlm=dataclasses.replace(
        vlm, llm=dataclasses.replace(vlm.llm, vocab_size=len(tokenizer)),
        img_context_token_id=ids[1], img_start_token_id=ids[2],
        img_end_token_id=ids[3], pad_token_id=tokenizer.pad_token_id))


def _fixed_draws(cfg):
    rng = np.random.default_rng(11)
    return (rng.uniform(0, 1, B).astype(np.float32),
            rng.standard_normal((B, cfg.num_action_tokens,
                                 cfg.action_dim)).astype(np.float32))


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


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_cli_train_vla", os.path.join(REPO, "scripts", "train_vla.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_swaps(monkeypatch):
    tok = PTok()
    ids = p_special(tok)
    cfg = _tiny(p_tiny, tok, ids)
    monkeypatch.setattr(pcli, "load_tokenizer", lambda args: tok)
    monkeypatch.setattr(pcli, "build_config", lambda args, t: cfg)
    _inject(prlds, monkeypatch)
    return tok, cfg


def test_train_vla_stages_match_the_jax_cli(tmp_path, monkeypatch):
    import transformers

    rec = {"batches": []}
    jtok = JTok()
    jids = j_special(jtok)
    jcfg = _tiny(jconfig.tiny_vla, jtok, jids)
    t, x0 = _fixed_draws(jcfg)

    class Recorder(jtrainer.VLATrainer):
        def __init__(self, model, params, cfg, mesh=None):
            rec["params"] = jax.tree_util.tree_map(np.asarray,
                                                   params["params"])
            rec["cfg"] = cfg
            cfg = dataclasses.replace(
                cfg, checkpoint_dir=None, log_every=1,
                metrics_path=str(tmp_path / "jax.jsonl"))
            super().__init__(model, params, cfg,
                             mesh=mesh_lib.make_mesh(
                                 devices=jax.devices()[:1]))

        def train_steps(self, batches, num_steps):
            return super().train_steps(_tee(batches, rec["batches"]),
                                       num_steps)

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **k: jtok)
    monkeypatch.setattr(jconfig, "vlaser_2b_vla", lambda vocab_size: jcfg)
    monkeypatch.setattr(jtrainer, "VLATrainer", Recorder)
    monkeypatch.setattr(jtrainer, "make_flow_loss", lambda model, s: (
        lambda p, b, r: model.apply(
            p, *(b[k] for k in ("input_ids", "pixel_values", "text_mask",
                                "proprios", "actions")),
            jnp.asarray(t), jnp.asarray(x0))))
    _inject(jrlds, monkeypatch)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")  # its stats/ cache
    monkeypatch.setattr(sys, "argv", ["train_vla.py"] + FLAGS)
    _jax_cli().main()
    # each train_steps loop draws one batch past its last step
    assert len(rec["batches"]) == STEPS + 1
    assert rec["cfg"].lr_action == rec["cfg"].lr_vlm == 1e-3
    assert not rec["cfg"].optimizer_8bit

    tok, cfg = _port_swaps(monkeypatch)
    monkeypatch.setattr(ptrainer, "make_flow_loss", lambda m, s, g: (
        lambda b: m(*(b[k] for k in ("input_ids", "pixel_values",
                                     "text_mask", "proprios", "actions")),
                    torch.from_numpy(t), torch.from_numpy(x0))))
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    args = pcli.build_parser().parse_args(FLAGS + ["--device", "cpu"])
    model = pcli.build_model(args, cfg, torch.device("cpu"))
    load_state(model, from_jax_variables({"params": rec["params"]}))
    processor = pcli.build_processor(cfg, pcli.load_tokenizer(args))
    batches = pcli.make_batches(pcli.build_dataset(args, cfg), processor,
                                cfg)
    # the JAX CLI draws model.init's batch from a first pass over the
    # mixture; its trainer takes the second (the shuffle reshuffles a pass)
    next(batches())
    trainer = pcli.build_trainer(args, model, log_every=1,
                                 metrics_path=str(tmp_path / "port.jsonl"))
    assert trainer.cfg.checkpoint_dir == "checkpoints/vla"
    trainer.cfg.checkpoint_dir = None
    taken = []
    trainer.train_steps(_tee(batches(), taken), STEPS)
    assert len(taken) == STEPS + 1
    for i, (a, b) in enumerate(zip(rec["batches"], taken)):
        _same(a, b, f"batch {i}")
    assert os.path.exists("stats/bridge_dataset.json")
    with open("stats/bridge_dataset.json") as f, open(
            tmp_path / "jax" / "stats" / "bridge_dataset.json") as g:
        assert json.load(f) == json.load(g)
    # at fp32 compute the first batch's loss agrees to fp32 summation order:
    # the bf16 gap above is rounding, not a difference of the two stages
    from vlaser_tpu.policy.pizero import PiZeroVLA as JVLA
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA as PVLA

    keys = ("input_ids", "pixel_values", "text_mask", "proprios", "actions")
    b0 = rec["batches"][0]
    jl = JVLA(jcfg, compute_dtype=jnp.float32).apply(
        {"params": rec["params"]}, *(jnp.asarray(b0[k]) for k in keys),
        jnp.asarray(t), jnp.asarray(x0))
    pm = load_state(PVLA(cfg, compute_dtype=torch.float32, device="cpu"),
                    from_jax_variables({"params": rec["params"]}))
    pl = pm(*(torch.as_tensor(b0[k]) for k in keys), torch.from_numpy(t),
            torch.from_numpy(x0))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    want, got = _metrics(tmp_path / "jax.jsonl"), _metrics(
        tmp_path / "port.jsonl")
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2, 3]
    for w, g in zip(want, got):
        assert abs(g["loss"] - w["loss"]) <= LOSS_REL * abs(w["loss"])
        assert abs(g["grad_norm"] - w["grad_norm"]) <= GNORM_REL * abs(
            w["grad_norm"])


def test_train_vla_main_on_the_cpu_leaves_its_checkpoint(tmp_path,
                                                         monkeypatch):
    """The port's main through argparse: --device cpu --adam8bit, with
    save_every cut to 2 so that 2 steps leave a checkpoint."""
    _port_swaps(monkeypatch)
    build = pcli.build_trainer
    monkeypatch.setattr(pcli, "build_trainer", lambda a, m, **kw: build(
        a, m, save_every=2, **kw))
    monkeypatch.chdir(tmp_path)
    ck = str(tmp_path / "ck")
    flags = [f for f in FLAGS]
    flags[flags.index("--steps") + 1] = "2"
    trainer = pcli.main(flags + ["--device", "cpu", "--adam8bit",
                                 "--checkpoint_dir", ck])
    from vlaser_tpu_torch.train.optim8bit import AdamW8bit

    assert isinstance(trainer.step_fn.optimizer, AdamW8bit)
    assert trainer.step == 2 and latest_step(ck) == 2
    assert trainer.model.device.type == "cpu"
    with pytest.raises(RuntimeError, match="process group"):
        pcli.main(FLAGS + ["--fsdp", "2", "--device", "cpu"])
