"""The port's data-generation pipelines (vlaser_tpu_torch/data/
qa_generation.py, reasoning_pipeline.py, visualprm_pipeline.py) against the
JAX package's: byte-equal prompts, the same parses and answer checks on a
seeded list of strings, byte-equal JSONL and JPEG files from the same
callables, equal pairs and step scores; the port's PreferenceDataset reads
the written pairs; and the rest of utils/monitoring.py on the CPU."""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from vlaser_tpu.data import qa_generation as jqa
from vlaser_tpu.data import reasoning_pipeline as jrp
from vlaser_tpu.data import visualprm_pipeline as jprm
from vlaser_tpu_torch.data import qa_generation as tqa
from vlaser_tpu_torch.data import reasoning_pipeline as trp
from vlaser_tpu_torch.data import visualprm_pipeline as tprm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORDS = ["Question:", "Answer:", "Score:", "Final answer:", "The answer is",
         "answer", "\\boxed{", "}", "\n", "\n\n", " ", "7", "3.5", "42",
         "1,000", "50%", "$12", "10", "/10", "[", "]", "x^2", "1/2", "0.5",
         "cat", "Cat.", "the red block", "yes", "no", "two", "2", "-3",
         "sqrt(4)", "pi", "a", ".", ":", "：", "\\frac{1}{2}"]


def _strings(n=160, seed=19):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(WORDS, int(rng.integers(0, 12))))
            for _ in range(n)]


def test_prompt_constants_are_byte_equal():
    for name in ("GENERAL_QA_PROMPT", "GROUNDING_QA_PROMPT",
                 "SPATIAL_QA_PROMPT", "FILTER_PROMPT", "PROMPTS"):
        assert getattr(tqa, name) == getattr(jqa, name), name
    assert tprm.PRM_SYSTEM_PROMPT.encode() == jprm.PRM_SYSTEM_PROMPT.encode()
    assert tprm.STEP_SEP == jprm.STEP_SEP
    assert tqa.QAGenConfig() == tqa.QAGenConfig(**vars(jqa.QAGenConfig()))


def test_parsers_and_answer_checks_match_jax():
    strings = _strings()
    rng = np.random.default_rng(5)
    modes = ("exact", "relaxed_accuracy", "numeric", "math_verify",
             "vqa_score", "relaxed_accuracy numeric math_verify vqa_score")
    for s in strings:
        assert tqa.parse_qa_response(s) == jqa.parse_qa_response(s), s
        assert tqa.parse_score(s) == jqa.parse_score(s), s
        assert trp.extract_final_answer(s) == jrp.extract_final_answer(s), s
        gt = strings[int(rng.integers(len(strings)))]
        pred = trp.extract_final_answer(s)
        for gold in (gt, pred or "", s):
            assert trp.relaxed_correctness(gold, s) == \
                jrp.relaxed_correctness(gold, s)
            for mode in modes:
                assert trp.check_answer(pred, gold, mode) == \
                    jrp.check_answer(pred, gold, mode), (pred, gold, mode)


def _fake_gen(images, prompts):
    """Deterministic responses from the image bytes and the prompt: every
    third unparseable."""
    out = []
    for img, p in zip(images, prompts):
        h = int(np.asarray(img, np.int64).sum() + len(p)) % 97
        out.append("no structure here" if h % 3 == 0 else
                   f"Question: What is at {h}?\nAnswer: The {p[:12]!r} "
                   f"object, {h % 10}.")
    return out


def _frames(n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (16, 24, 3), np.uint8),
             "instruction": f"move block {i}"} for i in range(n)]


def _run_qa(mod, root, kind, shared):
    fn = None
    if shared:
        fn = lambda prompts, image: _fake_gen([image] * len(prompts), prompts)
    gen = mod.QAGenerator(_fake_gen, mod.QAGenConfig(
        kind=kind, images_dir=str(root / "imgs"), batch_size=3),
        shared_image_fn=fn)
    n = gen.generate(_frames(7), str(root / "qa.jsonl"))
    files = {f: (root / "imgs" / f).read_bytes()
             for f in sorted(os.listdir(root / "imgs"))}
    return n, (root / "qa.jsonl").read_bytes(), files


@pytest.mark.parametrize("kind,shared", [("general", False), ("all", False),
                                         ("all", True)])
def test_qa_generator_writes_what_jax_writes(tmp_path, kind, shared):
    want = _run_qa(jqa, tmp_path / "jax", kind, shared)
    got = _run_qa(tqa, tmp_path / "port", kind, shared)
    assert got[0] == want[0] > 0
    assert got[1] == want[1]
    assert got[2] == want[2] and got[2]
    items = [json.loads(l) for l in got[1].decode().splitlines()]

    def score_fn(prompts):
        return ["I rate it 8/10" if i % 4 == 3 else
                f"Score: {9 if i % 2 == 0 else 2}"
                for i in range(len(prompts))]

    kept = tqa.quality_filter(items, score_fn, threshold=5.0, batch_size=4)
    assert kept == jqa.quality_filter(items, score_fn, threshold=5.0,
                                      batch_size=4)
    assert 0 < len(kept) < len(items)


def test_unparseable_general_run_imports_no_pil(tmp_path):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from vlaser_tpu_torch.data.qa_generation import QAGenConfig, "
        "QAGenerator\n"
        f"gen = QAGenerator(lambda im, p: ['nothing'] * len(p), "
        f"QAGenConfig(images_dir={str(tmp_path / 'imgs')!r}))\n"
        "frames = [{'image': np.zeros((8, 8, 3), np.uint8), "
        "'instruction': 'x'}] * 3\n"
        f"assert gen.generate(frames, {str(tmp_path / 'qa.jsonl')!r}) == 0\n"
        "assert 'PIL' not in sys.modules, 'PIL imported'\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout


ITEMS = [{"image": f"img_{i % 3}.jpg", "question": f"What is {i} + {i}?",
          "answer": str(2 * i)} for i in range(6)]


def _rollout(item, k):
    """Correct, wrong or formatless by (item, k)."""
    i = int(item["answer"]) // 2
    r = (i + k) % 4
    if r == 0:
        return f"Add them.\n\nFinal answer: {2 * i}"
    if r == 1:
        return f"Guess.\n\nThe answer is {2 * i + 1}."
    if r == 2:
        return f"\\boxed{{{2 * i}}}"
    return ""


def test_reasoning_pipeline_matches_jax(tmp_path):
    outs = []
    for mod in (jrp, trp):
        roll = mod.sample_responses(ITEMS, _rollout, num_samples=5)
        pos, neg, fmt = mod.build_items_based_on_correctness(roll, "numeric")
        pairs = mod.build_pairs(pos, neg, max_pairs_per_key=3)
        ntp = mod.build_dropout_ntp_pairs(
            roll[:7], lambda it, pre: f" then {len(pre)}", drop_ratio=0.4)
        path = tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"
        mod.write_pairs_jsonl(pairs + ntp, str(path))
        outs.append((roll, dict(pos), dict(neg), dict(fmt), pairs, ntp,
                     path.read_bytes()))
    assert outs[0] == outs[1]
    assert outs[1][4] and outs[1][3]  # pairs and format negatives


def test_port_preference_dataset_reads_the_pairs(tmp_path):
    from vlaser_tpu_torch.data.preference_dataset import (
        PreferenceDataset, PreferenceDatasetConfig)
    from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer
    from vlaser_tpu_torch.utils.tools import ensure_special_tokens

    items = [dict(it, image="") for it in ITEMS]
    roll = trp.sample_responses(items, _rollout, num_samples=4)
    pos, neg, _ = trp.build_items_based_on_correctness(roll)
    pairs = trp.build_pairs(pos, neg)
    path = tmp_path / "pairs.jsonl"
    trp.write_pairs_jsonl(pairs, str(path))
    tok = ByteTokenizer()
    ensure_special_tokens(tok)
    ds = PreferenceDataset(PreferenceDatasetConfig(str(path), max_seq_length=
                                                   512), tok)
    assert len(ds) == len(pairs) > 0
    for i in range(len(ds)):
        s = ds[i]
        for side in ("chosen", "rejected"):
            assert (s[f"{side}_labels"] != -100).any()


def _continue(item, prefix):
    """Deterministic continuations: right while the prefix holds no
    'Wrong', with a numeric twist on odd lengths."""
    if "Wrong" in prefix:
        return "Final answer: -1"
    return f"Final answer: {item['answer']}" if len(prefix) % 2 == 0 \
        else f"so \\boxed{{{item['answer']}.0}}"


def _solution(item, k):
    steps = ["Read.", "Think.", "Wrong turn." if k % 2 else "Check.",
             "Add.", f"Final answer: {item['answer']}"]
    return "\n\n".join(steps[: 3 + k])


def test_visualprm_pipeline_matches_jax(tmp_path):
    resp = "\n\n".join(f"s{i}" for i in range(7))
    for m in (None, 1, 3, 7, 9):
        assert tprm.split_response(resp, max_steps=m) == \
            jprm.split_response(resp, max_steps=m)
    outs = []
    for mod in (jprm, tprm):
        rows = mod.build_process_supervision(
            ITEMS[:3], _solution, _continue, num_return_sequences=3,
            num_mc_sequences=3, max_steps=4, mode="numeric")
        lone = mod.mc_score_steps(ITEMS[1], _solution(ITEMS[1], 1),
                                  _continue, num_mc_sequences=2,
                                  early_stop=False)
        convs = [mod.item_to_prm_conversation(r, mc_threshold=t, early_stop=e)
                 for r in rows for t in (0.0, 0.5) for e in (True, False)]
        convs += [mod.item_to_orm_conversation(r, mc_threshold=t)
                  for r in rows for t in (0.0, 0.5)]
        path = tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"
        mod.write_conversations_jsonl(convs, str(path))
        outs.append((rows, lone, convs, path.read_bytes()))
    assert outs[0] == outs[1]
    scores = [s["score"] for r in outs[1][0] for s in r["steps_with_score"]]
    assert 0 in scores and 1.0 in scores


# -- utils/monitoring.py: the rest of the JAX module --------------------------

def test_monitoring_functions_on_the_cpu(tmp_path, caplog):
    import torch

    from vlaser_tpu_torch.utils import monitoring

    @monitoring.log_execution_time()
    def work(x):
        return x + 1

    with caplog.at_level(logging.INFO, logger="vlaser_tpu_torch"):
        assert work(1) == 2
        monitoring.log_device_memory("cpu box")
    assert any("work took" in r.getMessage() for r in caplog.records)
    assert not any("GiB" in r.getMessage() for r in caplog.records)
    rec = logging.LogRecord("x", logging.INFO, __file__, 1, "m", (), None)
    assert monitoring.MainProcessFilter(0).filter(rec)
    assert not monitoring.MainProcessFilter(1).filter(rec)
    assert monitoring.MainProcessFilter().process_index == 0
    with monitoring.profile_trace(None):
        pass
    with monitoring.profile_trace(str(tmp_path / "trace")):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    (trace,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
