"""The port's SimplerEnv harness against the JAX package on the CPU:
`EvalRunner` and `run_variant_aggregation` over the port's PolicyServer at
tiny_vla with the JAX test's mock env (the same episodes, success and env
actions as the JAX server's, which is fed the same noise), the fractal
protocol sweep over both packages' grids, `EDRSimplerAdapter` on seeded
observations (the sticky gripper's 15 repeats included), the variant
grids and `episodes_for_spec`, the `llm_judge` parsers and aggregations,
and the `eval_simpler` CLI's stages."""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_eval import STATS, MockSimplerEnv, TinyTok
from vlaser_tpu.core.config import tiny_vla
from vlaser_tpu.envs import adapters as jad
from vlaser_tpu.eval import llm_judge as jjudge
from vlaser_tpu.eval import simpler_eval as jse
from vlaser_tpu.eval import variant_configs as jvc
from vlaser_tpu.policy.pizero import PiZeroVLA
from vlaser_tpu.policy.processing import InternVLAProcessor
from vlaser_tpu.serve.policy_server import PolicyServer
from vlaser_tpu_torch.core.config import tiny_vla as torch_tiny_vla
from vlaser_tpu_torch.envs import adapters as tad
from vlaser_tpu_torch.eval import llm_judge as tjudge
from vlaser_tpu_torch.eval import simpler_eval as tse
from vlaser_tpu_torch.eval import variant_configs as tvc
from vlaser_tpu_torch.policy.pizero import PiZeroVLA as TorchVLA
from vlaser_tpu_torch.policy.processing import (
    InternVLAProcessor as TorchProcessor,
)
from vlaser_tpu_torch.scripts import eval_simpler as pcli
from vlaser_tpu_torch.serve.policy_server import PolicyServer as TorchServer
from vlaser_tpu_torch.utils.convert import from_jax_variables

ACTIONS_ABS = 1e-4  # the plain path, fp32 on both sides
FRAME = lambda env, obs: np.zeros((64, 48, 3), np.uint8)  # the JAX test's


@pytest.fixture(scope="module")
def tiny():
    """The JAX test's tiny VLA (32 prefix tokens) and its init."""
    cfg = tiny_vla(max_image_text_tokens=32)
    model = PiZeroVLA(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    img = cfg.vlm.vision.image_size
    proc = InternVLAProcessor(TinyTok(), num_image_tokens=cfg.vlm.num_image_token,
                              max_seq_len=32, pad_token_id=0)
    dummy = proc(["x"], np.zeros((1, 1, img, img, 3), np.uint8))
    params = model.init(
        jax.random.PRNGKey(0), jnp.asarray(dummy["input_ids"]),
        jnp.zeros((1, img, img, 3)), jnp.asarray(dummy["attention_mask"]),
        jnp.zeros((1, cfg.cond_steps, cfg.proprio_dim)),
        jnp.zeros((1, cfg.num_action_tokens, cfg.action_dim)),
        jnp.zeros((1,)), jnp.zeros((1, cfg.num_action_tokens, cfg.action_dim)))
    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, params))
    return dict(cfg=cfg, model=model, params=params, state=state, img=img)


class _Logged(MockSimplerEnv):
    """The JAX test's env, keeping every action it is stepped with."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def step(self, action):
        self.log.append(np.asarray(action))
        return super().step(action)


def _servers(tiny, seed=3):
    """The JAX server and the port's plain server over the same weights;
    the port's draws the noise the JAX server draws (its key split once a
    step, then normal)."""
    cfg, img = tiny["cfg"], tiny["img"]
    mk = lambda mod: mod.BridgeSimplerAdapter(dataset_statistics=STATS,
                                              image_size=(img, img))
    jproc = InternVLAProcessor(TinyTok(),
                               num_image_tokens=cfg.vlm.num_image_token,
                               max_seq_len=32, pad_token_id=0)
    tproc = TorchProcessor(TinyTok(), num_image_tokens=cfg.vlm.num_image_token,
                           max_seq_len=32, pad_token_id=0)
    jserver = PolicyServer(tiny["model"], tiny["params"], mk(jad), jproc,
                           act_steps=4, seed=seed)
    tserver = TorchServer(TorchVLA(torch_tiny_vla(max_image_text_tokens=32),
                                   compute_dtype=torch.float32, device="cpu"),
                          tiny["state"], mk(tad), tproc, act_steps=4,
                          seed=seed, device="cpu")
    key = [jax.random.PRNGKey(seed)]

    def noise():
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.array(jax.random.normal(
            sub, (1, cfg.num_action_tokens, cfg.action_dim), jnp.float32)))

    tserver.draw_noise = noise
    return jserver, tserver


def _close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape == (7,)
        assert np.abs(x - y).max() <= ACTIONS_ABS


def test_eval_runner_matches_jax(tiny, tmp_path):
    jserver, tserver = _servers(tiny)
    jlog, tlog = [], []
    out = {}
    for name, mod, server, log in (("jax", jse, jserver, jlog),
                                   ("port", tse, tserver, tlog)):
        cfg = mod.EvalConfig(task="mock", n_eval_episode=2, act_steps=4,
                             max_steps=12,
                             results_path=str(tmp_path / name / "r.json"))
        out[name] = mod.EvalRunner(cfg, server, env=_Logged(log),
                                   get_image=FRAME).run()
    assert out["port"] == out["jax"]
    assert out["port"]["n_episodes"] == 2
    assert out["port"]["success_rate"] == 1.0
    assert out["port"]["avg_steps"] == 6.0
    for name in ("jax", "port"):
        with open(tmp_path / name / "r.json") as f:
            assert json.load(f) == out["jax"]
    assert len(tlog) == 12
    _close(tlog, jlog)


def test_run_variant_aggregation_matches_jax(tiny):
    jserver, tserver = _servers(tiny, seed=5)
    jlog, tlog = [], []
    variants = [{"a": 1}, {"a": 2}]
    want = jse.run_variant_aggregation(
        jse.EvalConfig(task="mock", n_eval_episode=1, act_steps=4,
                       max_steps=12), jserver, variants=variants,
        env_factory=lambda v: _Logged(jlog), get_image=FRAME)
    got = tse.run_variant_aggregation(
        tse.EvalConfig(task="mock", n_eval_episode=1, act_steps=4,
                       max_steps=12), tserver, variants=variants,
        env_factory=lambda v: _Logged(tlog), get_image=FRAME)
    assert got == want
    assert len(got["per_variant"]) == 2
    assert got["variant_aggregation_success"] == 1.0
    _close(tlog, jlog)


def test_eval_runner_over_the_fused_server():
    """The port's fused PolicyServer (w8a8-quantized tiny VLA, the kernels'
    plain twins on the CPU) through EvalRunner: the mock's episodes."""
    from vlaser_tpu_torch.core.quant import quantize_for_serving
    from vlaser_tpu_torch.models.layers import init_normal_

    cfg = torch_tiny_vla(max_image_text_tokens=32)
    model = TorchVLA(cfg, compute_dtype=torch.float32, device="cpu")
    init_normal_(model, torch.Generator().manual_seed(0), std=0.1)
    quantize_for_serving(model, target="policy", min_size=1)
    img = cfg.vlm.vision.image_size
    proc = TorchProcessor(TinyTok(), num_image_tokens=cfg.vlm.num_image_token,
                          max_seq_len=32, pad_token_id=0)
    server = TorchServer(model, None, tad.EDRSimplerAdapter(
        dataset_statistics=STATS, image_size=(img, img)), proc, act_steps=4,
        fused=True, device="cpu")
    log = []
    out = tse.EvalRunner(tse.EvalConfig(task="mock", n_eval_episode=2,
                                        act_steps=4, max_steps=12), server,
                         env=_Logged(log), get_image=FRAME).run()
    assert out == {"task": "mock", "n_episodes": 2, "success_rate": 1.0,
                   "avg_steps": 6.0}
    assert len(log) == 12 and all(np.isfinite(a).all() for a in log)


class _GridEnv:
    """An env for the fractal sweep: reset(options) records the options,
    and an episode succeeds at step 2 when its robot and object init
    positions (in centimetres) plus its episode id sum to an even
    number."""

    class _Unwrapped:
        def get_language_instruction(self):
            return "open the drawer"

    def __init__(self, spec, log):
        self.unwrapped, self.spec, self.log = self._Unwrapped(), spec, log

    def reset(self, options=None):
        self.t = 0
        self.log.append(json.dumps(options, sort_keys=True, default=lambda a:
                                   np.asarray(a).tolist()))
        obj = options["obj_init_options"]
        key = sum(options["robot_init_options"]["init_xy"]) * 100 + (
            obj["episode_id"] if "episode_id" in obj
            else sum(obj["init_xy"]) * 100)
        self.win = int(round(key)) % 2 == 0
        return {}, {}

    def step(self, action):
        self.t += 1
        done = self.win and self.t >= 2
        return {}, float(done), done, self.t >= 3, {"success": done}

    def close(self):
        self.log.append("closed")


class _Stub:
    def reset(self, instruction):
        pass

    def step(self, obs, image):
        return np.zeros((4, 7))


@pytest.mark.parametrize("task,protocol", [
    ("google_robot_open_drawer", "vm"),
    ("google_robot_place_apple_in_closed_top_drawer", "vm"),
    ("google_robot_move_near_v0", "va")])
def test_fractal_protocol_sweep_matches_jax(task, protocol, monkeypatch):
    """run_fractal_protocol over each package's grid with a stub policy:
    the same specs, reset options in the same order, summary."""
    if protocol == "va":  # 60 episodes a spec: keep the first 3
        for mod in (jse, tse):
            keep = mod.episodes_for_spec
            monkeypatch.setattr(mod, "episodes_for_spec",
                                lambda s, keep=keep: keep(s)[:3])
    out, logs = {}, {"jax": [], "port": []}
    for name, mod in (("jax", jse), ("port", tse)):
        out[name] = mod.run_fractal_protocol(
            mod.EvalConfig(task=task, act_steps=4), _Stub(), task, protocol,
            env_factory=lambda spec, log=logs[name]: _GridEnv(spec, log),
            get_image=lambda env, obs: np.zeros((4, 4, 3), np.uint8))
    assert out["port"] == out["jax"]
    assert logs["port"] == logs["jax"] and "closed" in logs["port"]
    assert 0.0 < out["port"]["aggregate_success"] < 1.0


def test_variant_grids_and_episodes_equal_jax():
    for task in jvc.TASKS:
        for protocol in ("va", "vm"):
            want = jse.fractal_variant_specs(task, protocol)
            got = tse.fractal_variant_specs(task, protocol)
            assert got == want, (task, protocol)
            assert len(got) > 0
            for spec in got[:: max(1, len(got) // 8)]:
                a, b = tse.episodes_for_spec(spec), jse.episodes_for_spec(spec)
                assert len(a) == len(b) > 0
                dump = lambda e: json.dumps(
                    e, sort_keys=True,
                    default=lambda v: [np.asarray(v).dtype.str,
                                       np.asarray(v).tolist()])
                assert [dump(e) for e in a] == [dump(e) for e in b]
    for fam in (tvc.variant_aggregation_families("google_robot_pick_coke_can")
                + tvc.visual_matching_families("google_robot_open_drawer")):
        want = jvc.robot_init_quats(jvc.VariantFamily(**fam.__dict__))
        got = tvc.robot_init_quats(fam)
        for q, w in zip(got, want):
            np.testing.assert_array_equal(q, w)
    assert tvc.TASKS == jvc.TASKS
    assert tvc.DRAWER_VM_STATIONS == jvc.DRAWER_VM_STATIONS
    with pytest.raises(KeyError):
        tvc.variant_aggregation_families("unknown")


def _obs(rng):
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    return {"agent": {"eef_pos": np.concatenate(
        [rng.uniform(-0.5, 0.5, 3), q, rng.uniform(0, 1, 1)])}}


@pytest.mark.parametrize("proprio_dim", [7, 8])
def test_edr_adapter_equals_jax(proprio_dim):
    """Preprocess and postprocess over seeded observations and action
    chunks whose gripper column crosses the sticky threshold: equal to the
    JAX adapter's, bit for bit, with the 15-repeat hold and release."""
    rng = np.random.default_rng(proprio_dim)
    stats = {k: {kk: list(v) + [0.0] * (proprio_dim - 7) if k == "proprio"
                 else v for kk, v in d.items()} for k, d in STATS.items()}
    kw = dict(dataset_statistics=stats, image_size=(28, 28),
              proprio_dim=proprio_dim)
    ja, ta = jad.EDRSimplerAdapter(**kw), tad.EDRSimplerAdapter(**kw)
    img = rng.integers(0, 256, (28, 28, 3), np.uint8)
    held = 0
    for step in range(12):
        obs = _obs(rng)
        a, b = ta.preprocess(obs, img), ja.preprocess(obs, img)
        np.testing.assert_array_equal(a["proprio"], b["proprio"])
        np.testing.assert_array_equal(a["image"], b["image"])
        acts = rng.uniform(-1, 1, (4, 7))
        acts[:, -1] = rng.choice([0.02, 0.5, 0.6, 0.98], 4)
        got, want = ta.postprocess(acts), ja.postprocess(acts)
        np.testing.assert_array_equal(got, want)
        assert ta.sticky_action_is_on == ja.sticky_action_is_on
        assert ta.gripper_action_repeat == ja.gripper_action_repeat
        held = max(held, ta.gripper_action_repeat)
    assert held >= 10
    ta.reset()
    assert (ta.sticky_action_is_on, ta.gripper_action_repeat,
            ta.sticky_gripper_action) == (False, 0, 0.0)
    # the JAX test's sequence: one strong close, 14 weak, released on 15
    assert ta.postprocess_gripper(1.0) == -1.0
    for _ in range(14):
        assert ta.postprocess_gripper(0.5) == -1.0
    assert ta.sticky_action_is_on is False
    assert ta.postprocess_gripper(0.5) == -0.0


def test_llm_judge_equals_jax(tmp_path):
    for text in ("Short analysis.\nRating: 5, very informative",
                 "rating: 0, not informative", "Rating: 5 or Rating: 2",
                 "no rating here", "RATING: 6"):
        assert tjudge.mmhal_parse_rating(text) == jjudge.mmhal_parse_rating(
            text)
    for text in ("8 9\nGood answers.", "garbage", "7,3\n", "1 2 3", ""):
        assert tjudge.llava_parse_score(text) == jjudge.llava_parse_score(
            text)
    records = [{"image_content": ["Cat", "Mat"], "question": f"q{i}",
                "gt_answer": "a", "model_answer": "b"} for i in range(10)]
    judge = lambda prompt: f"Because.\nRating: {len(prompt) % 7}"
    assert tjudge.evaluate_mmhal(records, judge) == jjudge.evaluate_mmhal(
        records, judge)
    rules = {"llava_bench_conv": {"role": "Assistant", "prompt": "Rate."},
             "default": {"role": "Reviewer", "prompt": "Rate all."}}
    items = [{"category": c, "caption": cap, "question": f"Q{i}?",
              "answer1": "ref", "answer2": "model"}
             for i, (c, cap) in enumerate((("conv", ["a", "b"]),
                                           ("detail", "ctx"),
                                           ("conv", "x")))]
    reviews = ["8 6\nok", "garbage", "10 9\nok"]

    def mk_judge():
        it = iter(reviews)
        return lambda content, system=None: next(it)

    assert (tjudge.evaluate_llava_bench(items, mk_judge(), rules)
            == jjudge.evaluate_llava_bench(items, mk_judge(), rules))
    rule = {"role": "Assistant", "prompt": "PROMPT"}
    assert (tjudge.build_llava_review_content(["l1", "l2"], "Q", "A1", "A2",
                                              rule)
            == jjudge.build_llava_review_content(["l1", "l2"], "Q", "A1",
                                                 "A2", rule))
    assert tjudge.MMHAL_TEMPLATE == jjudge.MMHAL_TEMPLATE
    preds = {"0": "ans a", "1": "ans b"}
    tjudge.mmvet_dump_results(preds, str(tmp_path / "t.json"))
    jjudge.mmvet_dump_results(preds, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json"
                                                 ).read_text()


def _cli_args(tmp_path, *extra):
    stats = tmp_path / "stats.json"
    stats.write_text(json.dumps(STATS))
    return pcli.build_parser().parse_args(
        ["--model_path", "unused", "--ckpt", "vla.pt", "--stats", str(stats),
         "--episodes", "2", "--device", "cpu", "--results",
         str(tmp_path / "out.json"), *extra])


@pytest.mark.parametrize("robot,fused", [("bridge", True),
                                         ("fractal", False)])
def test_eval_simpler_stages(tmp_path, robot, fused):
    """The CLI's stages at tiny_vla (its model stage needs a .pt, so the
    test hands in a seeded model): the adapter class, the fused server's
    w8a8 quantization, EvalRunner over the JAX test's mock env."""
    from vlaser_tpu_torch.core.quant import is_quantized
    from vlaser_tpu_torch.models.layers import init_normal_

    args = _cli_args(tmp_path, "--robot", robot,
                     *(() if fused else ("--no-fused",)))
    assert args.fused is fused
    cfg = torch_tiny_vla(max_image_text_tokens=32)
    adapter = pcli.build_adapter(args, cfg)
    assert type(adapter) is (tad.BridgeSimplerAdapter if robot == "bridge"
                             else tad.EDRSimplerAdapter)
    assert adapter.stats == STATS
    model = TorchVLA(cfg, compute_dtype=torch.float32, device="cpu")
    init_normal_(model, torch.Generator().manual_seed(0), std=0.1)
    proc = TorchProcessor(TinyTok(), num_image_tokens=cfg.vlm.num_image_token,
                          max_seq_len=32, pad_token_id=0)
    server = pcli.build_server(args, model, adapter, proc, "cpu")
    assert server.serving_path == ("fused" if fused else "plain")
    assert is_quantized(model) is fused
    out = pcli.run(args, server, env=MockSimplerEnv(), get_image=FRAME)
    assert out["n_episodes"] == 2 and out["success_rate"] == 1.0
    with open(tmp_path / "out.json") as f:
        assert json.load(f) == out
    with pytest.raises(SystemExit, match=r"\.pt"):
        pcli.load_model(argparse.Namespace(ckpt="orbax_dir"), cfg, "cpu")
