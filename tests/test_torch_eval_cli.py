"""The port's serving and evaluation CLIs (vlaser_tpu_torch/scripts/
serve_vlm.py, eval_vlm.py) on the CPU: each `main` through argparse under
--tiny --device cpu (tiny_vlm with seeded weights and the byte tokenizer,
the tokenizer handling of the training CLIs' --tiny), every JAX flag
accepted, the weights stage reading an HF checkpoint directory bit for
bit, the refusals (--tp > 1, beams on the engine, --int8 beside
--quantize), and eval_vlm's results keeping the JAX CLI's keys on every
backend: VlaserChat with 1 and 2 beams, --engine, --offline and
--spec_draft."""

import json
import os
import re

import numpy as np
import pytest
import torch

from vlaser_tpu_torch.scripts import eval_vlm, serve_vlm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def items(tmp_path_factory):
    """A text-only multiple-choice JSONL file of 6 items."""
    root = tmp_path_factory.mktemp("items")
    rng = np.random.default_rng(0)
    words = "pick the red block and place it on the plate near a cube".split()
    with open(root / "mc.jsonl", "w") as f:
        for i in range(6):
            f.write(json.dumps({
                "question": " ".join(rng.choice(words, 4 + i)) + "?",
                "choices": ["left", "right", "up", "down"],
                "answer": "ABCD"[i % 4]}) + "\n")
    return root / "mc.jsonl"


def _jax_flags(script):
    with open(os.path.join(REPO, "scripts", script)) as f:
        return set(re.findall(r'add_argument\(\s*"(--\w+)"', f.read()))


@pytest.mark.parametrize("mod,script", [(serve_vlm, "serve_vlm.py"),
                                        (eval_vlm, "eval_vlm.py")])
def test_cli_takes_the_jax_flags_plus_device(mod, script):
    mine = {a for act in mod.build_parser()._actions
            for a in act.option_strings if a.startswith("--")}
    jax_flags = _jax_flags(script)
    assert jax_flags and jax_flags <= mine
    assert mine - jax_flags == {"--device", "--tiny", "--help"}


BACKENDS = {
    "beams1": [], "beams2": ["--num_beams", "2"], "engine": ["--engine"],
    "offline": ["--offline"], "spec": ["--engine", "--spec_draft", "3"],
}


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_eval_vlm_main_runs_on_the_cpu(items, tmp_path, backend):
    """The generic route (load_jsonl_benchmark -> evaluate_benchmark,
    --batch 4) end to end on every backend: the printed and written results
    carry the JAX CLI's keys, one response an item."""
    out = tmp_path / "res.json"
    res = eval_vlm.main(["--tiny", "--device", "cpu", "--benchmark", "mcq",
                         "--data", str(items), "--batch", "4",
                         "--max_new_tokens", "4", "--out", str(out)]
                        + BACKENDS[backend])
    assert sorted(res) == ["accuracy", "num_evaluated", "responses"]
    assert res["num_evaluated"] == 6 and len(res["responses"]) == 6
    assert all(isinstance(r, str) for r in res["responses"])
    saved = json.loads(out.read_text())
    assert saved == {"benchmark": "mcq", **res}


def test_eval_vlm_runner_route_on_text_rows(items, tmp_path):
    """scienceqa goes through RUNNERS["scienceqa"] (run_mc_benchmark),
    which takes text-only rows: accuracy and num_evaluated."""
    res = eval_vlm.main(["--tiny", "--device", "cpu", "--benchmark",
                         "scienceqa", "--data", str(items), "--batch", "3",
                         "--max_new_tokens", "3"])
    assert sorted(res) == ["accuracy", "num_evaluated"]
    assert res["num_evaluated"] == 6


def test_cli_refusals(items):
    base = ["--tiny", "--device", "cpu", "--benchmark", "mcq", "--data",
            str(items)]
    with pytest.raises(NotImplementedError):
        eval_vlm.main(base + ["--engine", "--tp", "2"])
    with pytest.raises(NotImplementedError):
        serve_vlm.main(["--tiny", "--device", "cpu", "--tp", "2"])
    with pytest.raises(ValueError):
        eval_vlm.main(base + ["--engine", "--num_beams", "2"])
    with pytest.raises(SystemExit):
        eval_vlm.main(base + ["--int8", "--quantize", "none"])
    with pytest.raises(SystemExit):
        serve_vlm.main(["--device", "cpu"])  # no --model_path, no --tiny


@pytest.mark.parametrize("engine", [False, True], ids=["static", "engine"])
def test_serve_vlm_main_serves_on_the_cpu(monkeypatch, engine):
    """main builds every stage and serves: a chat completion over a socket,
    then the server stops."""
    from vlaser_tpu_torch.serve.chat_server import (ChatHTTPServer,
                                                    chat_completion_request)

    seen = {}

    def serve_once(self):
        seen["thread"] = self.start_background()
        seen["out"] = chat_completion_request(
            f"http://127.0.0.1:{self.port}",
            [{"role": "user", "content": "hello there"}])
        seen["backend"] = type(self.chat).__name__

    monkeypatch.setattr(ChatHTTPServer, "serve_forever", serve_once)
    serve_vlm.main(["--tiny", "--device", "cpu", "--host", "127.0.0.1",
                    "--port", "0", "--max_new_tokens", "3"]
                   + (["--engine", "--num_slots", "2"] if engine else []))
    assert seen["backend"] == ("EngineChat" if engine else "VlaserChat")
    assert seen["out"]["object"] == "chat.completion"
    assert isinstance(seen["out"]["choices"][0]["message"]["content"], str)
    seen["thread"].join(timeout=10)
    assert not seen["thread"].is_alive()  # main shut the server down


def test_weights_stage_reads_an_hf_checkpoint_bit_for_bit(tmp_path):
    """load_model with --model_path: an HF checkpoint directory (the port's
    export of a seeded tiny model, bf16) lands in the bf16 serving model
    bit for bit; --quantize w8a8 then quantizes it in place."""
    from vlaser_tpu_torch.utils import hf_convert
    from vlaser_tpu_torch.utils.convert import to_jax_params

    args = serve_vlm.build_parser().parse_args(["--tiny", "--device", "cpu"])
    cfg = serve_vlm.build_config(args, serve_vlm.load_tokenizer(args))
    src = serve_vlm.load_model(args, cfg, "cpu")
    params = to_jax_params({k: v.float() for k, v in src.state_dict().items()})
    hf = {k: torch.from_numpy(np.array(v, np.float32)).to(torch.bfloat16)
          for k, v in hf_convert.export_internvl_chat(params).items()}
    hf_convert.save_hf_checkpoint_dir(hf, str(tmp_path / "ck"), num_shards=2)
    args = serve_vlm.build_parser().parse_args(
        ["--model_path", str(tmp_path / "ck"), "--device", "cpu"])
    model = serve_vlm.load_model(args, cfg, "cpu")
    got, want = model.state_dict(), src.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k],
                                                              want[k]), k
    serve_vlm.quantize(args, model)
    assert "kernel_q" in model.language_model.model.layers.self_attn \
        .q_proj._buffers
