"""The port's RoboTwin slice against the JAX package on the CPU: the
closed-loop `eval_policy` over the JAX test's mock env, the deploy server
(the port's and the JAX client and server crossed), the HDF5 episode
dataset with `collate_robotwin` and the QA folder dataset, and the
`train_robotwin` / `deploy_robotwin` CLIs under --tiny: the JAX CLI runs
as written (its train step or HTTP server swapped for a recorder, on a
one-device mesh), the port's stages then take its initial weights through
utils/convert.from_jax_variables and must consume bit-equal batches, give
its losses within LOSS_REL, and serve its policy's actions within
POLICY_REL."""

import importlib.util
import json
import os
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from test_eval import TOKENS, MockRoboTwinEnv, TinyTok
from vlaser_tpu.core.config import tiny_vlm
from vlaser_tpu.eval import robotwin_eval as jrw
from vlaser_tpu.image.tiling import normalize_uint8
from vlaser_tpu.policy import parallel_decoding as jpd
from vlaser_tpu_torch.core.config import tiny_vlm as torch_tiny_vlm
from vlaser_tpu_torch.eval import robotwin_eval as trw
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.policy import parallel_decoding as tpd
from vlaser_tpu_torch.scripts import deploy_robotwin as pdeploy
from vlaser_tpu_torch.scripts import train_robotwin as ptrain
from vlaser_tpu_torch.utils.convert import from_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTIONS_ABS = 1e-4  # fp32 on both sides
# bf16 compute on both sides (the CLIs' dtype): one bf16 rounding of every
# product, placed by two frameworks; the tiny policy's actions (up to ~1.7)
# differed by up to 2.4% of the largest (measured here)
LOSS_REL, POLICY_REL = 2e-3, 4e-2
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_cli_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_state(params):
    return from_jax_variables(jax.tree_util.tree_map(np.asarray, params))


# -- eval_policy --------------------------------------------------------------

class _Recording:
    """A policy that records every chunk it returns."""

    def __init__(self, policy):
        self.policy, self.chunks = policy, []

    def get_actions(self, image, qpos, instruction):
        out = self.policy.get_actions(image, qpos, instruction)
        self.chunks.append(np.asarray(out))
        return out


@pytest.mark.parametrize("fail", [(), (0,), (0, 1, 2, 3, 4, 5, 6)])
def test_eval_policy_matches_jax(fail, tmp_path):
    """The JAX test's setup (tiny_vlm, chunk 4 x 6, fp32, the reference
    attention) on both packages: the same summary and results file, every
    action chunk within ACTIONS_ABS."""
    import jax.numpy as jnp

    kw = dict(action_chunk=4, action_dim=6, state_dim=6, state_vocab_size=16,
              max_text_tokens=8, head_hidden=32)
    jcfg = jpd.ParallelDecodingConfig(vlm=tiny_vlm(), **kw)
    tcfg = tpd.ParallelDecodingConfig(vlm=torch_tiny_vlm(), **kw)
    jmodel = jpd.ParallelDecodingVLA(jcfg, compute_dtype=jnp.float32,
                                     attn_impl="reference")
    jb = jpd.SequenceBuilder(jcfg, TOKENS, state_token_start=420,
                             pad_token_id=0)
    ids, mask = jb.build(np.zeros((1, 8), np.int64), np.zeros((1, 6)))
    img = jcfg.vlm.vision.image_size
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                         jnp.zeros((1, img, img, 3)), jnp.asarray(mask))
    tmodel = tpd.ParallelDecodingVLA(tcfg, compute_dtype=torch.float32,
                                     device="cpu")
    tb = tpd.SequenceBuilder(tcfg, TOKENS, state_token_start=420,
                             pad_token_id=0)
    jpol = _Recording(jrw.RoboTwinPolicy(jmodel, params, jb, TinyTok(),
                                         normalize_uint8))
    tpol = _Recording(trw.RoboTwinPolicy(tmodel, _port_state(params), tb,
                                         TinyTok(), normalize_uint8))
    cfgs = [cls(test_num=4, step_lim=8, chunk_exec=4, task_name="mock",
                results_dir=str(tmp_path / name))
            for cls, name in ((jrw.RoboTwinEvalConfig, "jax"),
                              (trw.RoboTwinEvalConfig, "port"))]
    want = jrw.eval_policy(cfgs[0], MockRoboTwinEnv(set(fail)), jpol)
    got = trw.eval_policy(cfgs[1], MockRoboTwinEnv(set(fail)), tpol)
    assert got == want
    assert got["evaluated"] == 4 - len([s for s in range(4) if s % 7 in fail])
    for name in ("jax", "port"):
        with open(tmp_path / name / "mock.json") as f:
            assert json.load(f) == want
    # the mock succeeds after 3 of the first chunk's 4 actions
    assert len(tpol.chunks) == len(jpol.chunks) == got["evaluated"]
    for a, b in zip(tpol.chunks, jpol.chunks):
        assert a.dtype == np.float32 and a.shape == (4, 6)
        assert np.abs(a - b).max() <= ACTIONS_ABS


# -- the deploy server ----------------------------------------------------------

def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=10)


@pytest.mark.parametrize("server,client", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_deploy_server_round_trip(server, client):
    from vlaser_tpu.serve import deploy_server as jds
    from vlaser_tpu_torch.serve import deploy_server as tds

    calls = {}

    def policy(image, instruction, qpos):
        calls.update(image=image, instruction=instruction, qpos=qpos)
        if instruction == "fail":
            raise RuntimeError("policy failed")
        return np.tile(np.arange(14, dtype=np.float32), (8, 1)) * (
            1 if qpos is None else qpos[0])

    resets = []
    srv_mod = tds if server == "port" else jds
    cli_mod = tds if client == "port" else jds
    srv = srv_mod.PolicyHTTPServer(policy, host="127.0.0.1", port=0,
                                   reset_fn=resets.append)
    srv.start_background()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        img = np.random.default_rng(0).integers(0, 255, (32, 32, 3), np.uint8)
        qpos = np.linspace(-1, 1, 14).astype(np.float32)
        action = cli_mod.act_request(url, img, "pick up the bell", qpos)
        assert action.shape == (8, 14) and action.dtype == np.float32
        np.testing.assert_array_equal(action, np.tile(np.arange(14.0), (8, 1))
                                      * qpos[0])
        np.testing.assert_array_equal(calls["image"], img)
        assert calls["image"].dtype == np.uint8
        assert calls["instruction"] == "pick up the bell"
        np.testing.assert_array_equal(calls["qpos"], qpos)
        action = cli_mod.act_request(url, img.tolist(), "no qpos")
        assert calls["qpos"] is None
        np.testing.assert_array_equal(calls["image"], img)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/act", {"instruction": "x"})
        assert ei.value.code == 400
        assert "missing field" in json.loads(ei.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            cli_mod.act_request(url, img, "fail")
        assert ei.value.code == 500
        body = json.loads(ei.value.read())
        assert body["error"] == "policy failed" and "Traceback" in body[
            "traceback"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/nowhere", {})
        assert ei.value.code == 404
        with _post(url + "/reset", {"instruction": "new task"}) as r:
            assert json.loads(r.read()) == {"ok": True}
        assert resets == ["new task"]
        with urllib.request.urlopen(url + "/health", timeout=10) as r:
            assert json.loads(r.read())["ok"] is True
    finally:
        srv.shutdown()
    a = np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2]
    for enc in (tds.encode_array, jds.encode_array):
        for dec in (tds.decode_value, jds.decode_value):
            np.testing.assert_array_equal(dec(enc(a)), a)
    assert tds.encode_array(a) == jds.encode_array(a)


# -- the datasets -----------------------------------------------------------

def _episodes(root, jpeg=False):
    """Episodes of 40-px frames (resized to 28), absolute actions, one with
    JPEG-encoded frames and bytes instructions, one shorter than a chunk."""
    import io

    import h5py
    from PIL import Image

    rng = np.random.default_rng(3)
    os.makedirs(root / "sub", exist_ok=True)
    for i, (t, where) in enumerate(((7, root), (3, root / "sub"), (5, root))):
        frames = rng.integers(0, 255, (t, 40, 40, 3), np.uint8)
        with h5py.File(where / f"ep{i}.hdf5", "w") as h:
            if jpeg and i == 2:
                enc = []
                for f in frames:
                    buf = io.BytesIO()
                    Image.fromarray(f).save(buf, format="JPEG")
                    enc.append(np.frombuffer(buf.getvalue(), np.uint8))
                data = np.empty(len(enc), dtype=object)
                data[:] = enc
                h.create_dataset("observations/head_camera", data=data,
                                 dtype=h5py.vlen_dtype(np.uint8))
            else:
                h.create_dataset("observations/head_camera", data=frames)
            h.create_dataset("qpos", data=rng.uniform(-1, 1, (t, 14)))
            h.create_dataset("action", data=rng.uniform(-1, 1, (t, 14)))
            if i != 1:
                h.attrs["instruction"] = (f"stack block {i}".encode()
                                          if i == 2 else f"stack block {i}")


def _same(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, str):
            assert x == y, (what, k)
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        assert np.array_equal(x, y), (what, k)


@pytest.mark.parametrize("delta", [True, False])
def test_hdf5_dataset_and_collate_bit_equal(tmp_path, delta):
    from vlaser_tpu.data import hdf5_dataset as jh
    from vlaser_tpu_torch.data import hdf5_dataset as th

    _episodes(tmp_path)
    jds = jh.HDF5VLADataset(jh.HDF5DatasetConfig(
        data_root=str(tmp_path), chunk_size=4, image_size=28,
        delta_actions=delta))
    tds = th.HDF5VLADataset(th.HDF5DatasetConfig(
        data_root=str(tmp_path), chunk_size=4, image_size=28,
        delta_actions=delta))
    assert len(tds) == len(jds) == 6 + 2 + 4
    assert tds.files == jds.files and tds.index == jds.index
    for i in range(len(tds)):
        _same(tds[i], jds[i], f"sample {i}")
    assert tds[0]["image"].shape == (28, 28, 3)
    # sorted paths: ep0 (6 samples), ep2 (4), sub/ep1 (2, no instruction)
    assert tds[10]["instruction"] == "complete the task"
    kw = dict(action_chunk=4, action_dim=14, state_dim=14,
              state_vocab_size=16, max_text_tokens=8, head_hidden=32)
    jb = jpd.SequenceBuilder(jpd.ParallelDecodingConfig(vlm=tiny_vlm(), **kw),
                             TOKENS, state_token_start=420, pad_token_id=0)
    tb = tpd.SequenceBuilder(tpd.ParallelDecodingConfig(
        vlm=torch_tiny_vlm(), **kw), TOKENS, state_token_start=420,
        pad_token_id=0)
    samples = [tds[i] for i in (0, 3, 7, 9, 11)]
    _same(th.collate_robotwin(samples, tb, TinyTok(), normalize_uint8),
          jh.collate_robotwin(samples, jb, TinyTok(), normalize_uint8),
          "collated batch")


def test_hdf5_dataset_decodes_jpeg_frames(tmp_path):
    from vlaser_tpu.data import hdf5_dataset as jh
    from vlaser_tpu_torch.data import hdf5_dataset as th

    _episodes(tmp_path, jpeg=True)
    jds = jh.HDF5VLADataset(jh.HDF5DatasetConfig(data_root=str(tmp_path),
                                                 image_size=28))
    tds = th.HDF5VLADataset(th.HDF5DatasetConfig(data_root=str(tmp_path),
                                                 image_size=28))
    for i in range(len(tds)):
        _same(tds[i], jds[i], f"sample {i}")
    assert tds[6]["instruction"] == "stack block 2"  # bytes, decoded


def test_robotwin_qa_folder_dataset_bit_equal(tmp_path):
    """The JAX test's folder tree, read by both packages: the same files,
    frames and resolved instructions, under each filter and source."""
    from PIL import Image

    from vlaser_tpu.data import robotwin_qa_dataset as jq
    from vlaser_tpu_torch.data import robotwin_qa_dataset as tq

    root, inst = tmp_path / "images", tmp_path / "instructions"
    for task in ("click_bell", "handover_mic"):
        for domain in ("Aloha-AgileX", "SomeOtherDomain"):
            for ep in ("episode0", "episode1"):
                d = root / task / domain / "frames" / ep
                d.mkdir(parents=True)
                for i in range(2):
                    Image.new("RGB", (64, 48), (i * 50, 80, 20)).save(
                        d / f"{i:03d}.jpg")
        (inst / task).mkdir(parents=True)
        with open(inst / task / "episode0.json", "w") as f:
            json.dump({"seen": [f"{task} seen A", f"{task} seen B"],
                       "unseen": ["u"]}, f)
    variants = (
        dict(instructions_root=str(inst), resize_to=(32, 32)),
        dict(instructions_root=str(inst), instruction_source="any",
             resize_to=None),
        dict(include_tasks=["handover_mic"], resize_to=None),
        dict(exclude_tasks=["handover_mic"], max_images=3,
             include_domains=("Aloha-AgileX", "SomeOtherDomain")),
    )
    for kw in variants:
        jds = jq.RoboTwinEpisodeFolderDataset(jq.RoboTwinQAFolderConfig(
            images_root=str(root), **kw))
        tds = tq.RoboTwinEpisodeFolderDataset(tq.RoboTwinQAFolderConfig(
            images_root=str(root), **kw))
        assert tds.files == jds.files and len(tds) > 0
        for i in range(len(tds)):
            _same(tds[i], jds[i], f"{kw} item {i}")
    for p in ("/x/t/d/frames/episode7/img.jpg", "/a/episode3/b.png",
              "/a/b/c.png"):
        assert tq.parse_triplet(p) == jq.parse_triplet(p)
    with pytest.raises(FileNotFoundError):
        tq.RoboTwinEpisodeFolderDataset(tq.RoboTwinQAFolderConfig(
            images_root=str(tmp_path / "missing")))


# -- the CLIs ---------------------------------------------------------------

def test_synthetic_episodes_bit_equal(tmp_path):
    import h5py

    _jax_cli("train_robotwin")._make_synthetic_episodes(str(tmp_path / "j"))
    ptrain.make_synthetic_episodes(str(tmp_path / "p"))
    for i in range(2):
        with h5py.File(tmp_path / "j" / f"ep{i}.hdf5") as a, h5py.File(
                tmp_path / "p" / f"ep{i}.hdf5") as b:
            for k in ("observations/head_camera", "qpos", "action"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k][:], b[k][:])
            assert a.attrs["instruction"] == b.attrs["instruction"]


def test_train_robotwin_cli_matches_jax(tmp_path, monkeypatch):
    """--tiny --steps 2 --batch 4 on both packages over the same episodes:
    bit-equal batches, losses within LOSS_REL (the JAX CLI on a one-device
    mesh; its initial weights carried into the port)."""
    from vlaser_tpu.core import mesh as jmesh
    from vlaser_tpu.train import train_step as jts

    rec = {"batches": [], "metrics": []}
    make = jts.make_train_step

    def recording_step(loss_fn, tx, *a, **kw):
        step = make(loss_fn, tx, *a, **kw)

        def run(state, batch, rng):
            if "params" not in rec:
                rec["params"] = jax.tree_util.tree_map(np.asarray,
                                                       state.params)
            rec["batches"].append(jax.tree_util.tree_map(np.asarray, batch))
            state, m = step(state, batch, rng)
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            return state, m

        return run

    one = jmesh.make_mesh(devices=jax.devices()[:1])
    monkeypatch.setattr(jts, "make_train_step", recording_step)
    monkeypatch.setattr(jmesh, "make_mesh", lambda **kw: one)
    root = tmp_path / "eps"
    root.mkdir()
    flags = ["--tiny", "--steps", str(STEPS), "--batch", "4", "--data_root",
             str(root)]
    monkeypatch.setattr(sys, "argv", ["train_robotwin.py"] + flags)
    _jax_cli("train_robotwin").main()
    assert len(rec["metrics"]) == STEPS

    args = ptrain.build_parser().parse_args(
        flags + ["--device", "cpu", "--checkpoint_dir", str(tmp_path / "ck")])
    ptrain.check_args(args)
    tok = ptrain.load_tokenizer(args)
    cfg, start = ptrain.build_config(args, tok)
    assert cfg.vlm.llm.vocab_size == 256 + 13 + 32 and start == 256 + 13
    builder = ptrain.build_builder(cfg, tok, start)
    model = ptrain.build_model(args, cfg, torch.device("cpu"))
    load_state(model, _port_state(rec["params"]))
    dataset = ptrain.build_dataset(args, cfg)
    step = ptrain.build_step(args, model)
    got = []

    def tee(batches):
        for b in batches:
            got.append(b)
            yield b

    logged = ptrain.train(args, model, step,
                          tee(ptrain.make_batches(dataset, args.batch,
                                                  builder, tok)),
                          torch.device("cpu"))
    for i in range(STEPS):
        _same(got[i], rec["batches"][i], f"batch {i}")
    assert [r["step"] for r in logged] == [1, 2]
    # the losses only: at bf16 on this tiny random model each package's
    # gradient leaves lie 9-28% (measured) from the fp32 gradient, which
    # test_torch_parallel_decoding holds leaf by leaf within 1e-3
    for p, j in zip(logged, rec["metrics"]):
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=LOSS_REL)
        assert np.isfinite(p["grad_norm"]) and p["grad_norm"] > 0
    vit = dict(model.vision_model.named_parameters())
    want = _port_state({"params": {"vision_model": rec["params"][
        "params"]["vision_model"]}})
    for k, v in want.items():  # the frozen ViT unchanged
        assert torch.equal(vit[k[len("vision_model."):]].detach(), v), k


def test_train_robotwin_main_and_its_raises(tmp_path, monkeypatch):
    """main end to end under --tiny (a checkpoint every step here), the
    checkpoint restored by deploy_robotwin's --ckpt stage bit for bit, and
    the raises."""
    from vlaser_tpu_torch.utils.checkpoint import latest_step

    root = tmp_path / "eps"
    root.mkdir()
    monkeypatch.setattr(ptrain, "SAVE_EVERY", 1)
    captured = {}
    build = ptrain.build_step

    def keep(args, model):
        captured["model"] = model
        return build(args, model)

    monkeypatch.setattr(ptrain, "build_step", keep)
    logged = ptrain.main(["--tiny", "--steps", "3", "--batch", "2",
                          "--data_root", str(root), "--device", "cpu",
                          "--checkpoint_dir", str(tmp_path / "ck")])
    assert [r["step"] for r in logged] == [1, 3]
    assert all(np.isfinite(r["loss"]) for r in logged)
    assert latest_step(str(tmp_path / "ck")) == 3
    args = pdeploy.build_parser().parse_args(
        ["--ckpt", str(tmp_path / "ck"), "--device", "cpu"])
    args.tiny = True  # the tiny config; the model stage then restores
    tok = pdeploy.load_tokenizer(args)
    cfg, _ = pdeploy.build_config(args, tok)
    args.tiny = False
    served = pdeploy.build_model(args, cfg, torch.device("cpu"))
    trained = captured["model"].state_dict()
    for k, v in served.state_dict().items():
        assert torch.equal(v, trained[k]), k
    assert not any(p.requires_grad for p in served.parameters())
    with pytest.raises(SystemExit, match="--ckpt"):
        pdeploy.build_model(pdeploy.build_parser().parse_args(
            ["--device", "cpu"]), cfg, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="--fsdp 2"):
        ptrain.main(["--tiny", "--fsdp", "2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        ptrain.main(["--steps", "1", "--device", "cpu"])


def test_deploy_robotwin_policy_matches_jax(monkeypatch):
    """deploy_robotwin --tiny on both packages over the JAX CLI's initial
    weights: the port's policy_fn gives the JAX policy_fn's actions within
    POLICY_REL of their largest (the CLIs' bf16 compute), for a frame at
    the ViT's size and one PIL resizes; the same two policies at fp32
    compute agree within ACTIONS_ABS."""
    import jax.numpy as jnp

    from vlaser_tpu.eval import robotwin_eval as jeval
    from vlaser_tpu.serve import deploy_server as jds

    rec = {}

    class Server:
        def __init__(self, policy_fn, host, port, reset_fn=None):
            rec["policy_fn"], self.port = policy_fn, port

        def serve_forever(self):
            pass

    class Policy(jeval.RoboTwinPolicy):
        def __init__(self, *a):
            rec["policy"] = self
            super().__init__(*a)

    monkeypatch.setattr(jds, "PolicyHTTPServer", Server)
    monkeypatch.setattr(jeval, "RoboTwinPolicy", Policy)
    monkeypatch.setattr(sys, "argv", ["deploy_robotwin.py", "--tiny",
                                      "--port", "0"])
    _jax_cli("deploy_robotwin").main()
    jpol = rec["policy"]

    args = pdeploy.build_parser().parse_args(["--tiny", "--device", "cpu"])
    tok = pdeploy.load_tokenizer(args)
    cfg, start = pdeploy.build_config(args, tok)
    builder = pdeploy.build_builder(cfg, tok, start)
    model = pdeploy.build_model(args, cfg, torch.device("cpu"))
    state = _port_state(jpol.params)
    load_state(model, state)
    fn = pdeploy.make_policy_fn(pdeploy.build_policy(model, builder, tok),
                                cfg)
    model32 = tpd.ParallelDecodingVLA(cfg, compute_dtype=torch.float32,
                                      device="cpu", attn_impl="reference")
    pol32 = trw.RoboTwinPolicy(model32, state, builder, tok,
                               ptrain.normalize)
    jpol32 = jrw.RoboTwinPolicy(jpol.model.clone(compute_dtype=jnp.float32),
                                jpol.params, jpol.builder, jpol.tokenizer,
                                jpol.normalize)
    rng = np.random.default_rng(5)
    for size, qpos in ((28, rng.uniform(-1, 1, 14)), (40, None)):
        img = rng.integers(0, 256, (size, size, 3), np.uint8)
        want = np.asarray(rec["policy_fn"](img, "place the cup", qpos))
        got = fn(img, "place the cup", qpos)
        assert got.shape == want.shape == (4, 14) and got.dtype == np.float32
        err = np.abs(got - want).max()
        assert err <= POLICY_REL * np.abs(want).max(), err
    img = rng.integers(0, 256, (28, 28, 3), np.uint8)
    q = rng.uniform(-1, 1, 14).astype(np.float32)
    want = jpol32.get_actions(img, q, "place the cup")
    got = pol32.get_actions(img, q, "place the cup")
    assert np.abs(got - want).max() <= ACTIONS_ABS
