"""The port's eval modules (vlaser_tpu_torch/eval/: copies of the JAX
package's framework-free benchmark harnesses, protocols and metrics) give
the JAX package's outputs: every case of the JAX eval tests
(tests/test_eval.py's point metrics, test_eval_protocols.py,
test_vlm_benchmarks.py, test_protocol_runners.py, test_caption_metrics.py)
runs on both packages' functions, and the outputs must be equal (an
exception must be the same type). run_benchmark and every RUNNERS entry,
driven by one stub chat on the same files, give equal result dicts and
hand the chat bit-equal tiles."""

import base64
import dataclasses
import importlib
import io
import json
import math

import numpy as np
import pytest
from PIL import Image

MODULES = ("vlm_benchmarks", "mc_protocols", "vqa_metrics", "math_verify",
           "grounding_bbox", "ptb_tokenizer", "caption_metrics", "point_eval",
           "embodied_benchmarks", "protocol_runners")


def _mods(name):
    return (importlib.import_module(f"vlaser_tpu.eval.{name}"),
            importlib.import_module(f"vlaser_tpu_torch.eval.{name}"))


def _plain(x):
    """Results of either package as comparable plain data."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, _plain(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, Image.Image):
        return ("image", x.mode, x.size, x.tobytes())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def _run(fn, m, d):
    try:
        return _plain(fn(m, d))
    except Exception as e:  # noqa: BLE001 — compared across the packages
        return ("raised", type(e).__name__)


class StubChat:
    """One chat for both packages: answers by the first rule whose key is
    in the question (else a fixed reply), and records what it was handed
    (questions, a digest of the tiles, num_patches_list)."""

    RULES = [("What animal?", "B. dog"), ("2+2?", "3"), ("dog", "Yes, a dog."),
             ("cat", "No."), ("car", "Yes, a car."), ("tree", "No tree."),
             ("What is it?", "It is a cat."), ("Value?", "104"),
             ("red cup", "[[100, 200, 300, 600]]"),
             ("referring points", "<point>[[500, 500], [10, 10]]</point>"),
             ("How far", "about 12.5 meters"), ("Which changed?", "A"),
             ("Q1", "A"), ("Q2", "B"), ("Q3", "A"), ("Q4", "A"),
             ("caption", "a red ball on green grass today ok"),
             ("Frame1", "(B) y"), ("x^2", "Answer: 4")]

    def __init__(self):
        self.calls = []

    def _answer(self, q):
        for key, resp in self.RULES:
            if key in q:
                return resp
        return "B"

    def _digest(self, px):
        if px is None:
            return None
        px = np.asarray(px)
        return (px.shape, px.dtype.str, px.tobytes())

    def batch_chat(self, questions, pixel_values, num_patches_list=None):
        self.calls.append(("batch", list(questions),
                           self._digest(pixel_values), num_patches_list))
        return [self._answer(q) for q in questions]

    def chat(self, question, pixel_values=None, **kw):
        self.calls.append(("chat", question, self._digest(pixel_values)))
        return self._answer(question)


def _img(path, seed, size=(64, 48)):
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (size[1], size[0], 3), np.uint8)).save(path)


def _jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    """The data directory every case reads: images, JSONL files, an
    MMBench TSV, MVBench frames."""
    root = tmp_path_factory.mktemp("eval")
    _img(root / "a.jpg", 0)
    _img(root / "b.jpg", 1, (40, 72))
    _img(root / "x.png", 2, (64, 64))
    frames = root / "video"
    frames.mkdir()
    for i in range(1, 13):
        _img(frames / f"{i:05d}.jpg", 10 + i, (32, 32))
    (root / "empty").mkdir()
    for i in range(1, 13):
        (root / "empty" / f"{i:05d}.jpg").write_bytes(b"")
    mc = [{"image": "a.jpg", "question": "What animal?",
           "choices": ["cat", "dog"], "answer": "B"},
          {"question": "2+2?", "choices": ["3", "4"], "answer": "B"},
          {"images": ["a.jpg", "b.jpg"], "question": "Which changed?",
           "choices": ["left", "right"], "answer": "A"}]
    _jsonl(root / "mc.jsonl", mc)
    _jsonl(root / "mc_text.jsonl", mc[1:2] * 3)
    _jsonl(root / "bench.jsonl", [
        {"question": f"q{i}", "answer": "B", "choices": ["a", "b", "c"],
         "image": "x.png"} for i in range(4)] + [
        {"question": "text only", "answer": "A", "choices": ["a", "b"]}])
    _jsonl(root / "vqa.jsonl", [
        {"image": "a.jpg", "question": "What is it?",
         "annotation": ["cat"] * 10},
        {"image": "b.jpg", "question": "Value?", "annotation": ["100"] * 10}])
    _jsonl(root / "ref.jsonl", [
        {"image": "a.jpg", "sent": "the red cup",
         "bbox": [100, 100, 300, 300], "width": 1000, "height": 500},
        {"image": "b.jpg", "sent": "a blue box", "bbox": [0, 0, 10, 10],
         "width": 40, "height": 72}])
    _jsonl(root / "mme.jsonl", [
        {"task": "existence", "image": "a.jpg",
         "question": "Is there a dog?", "answer": "yes"},
        {"task": "existence", "image": "a.jpg",
         "question": "Is there a cat?", "answer": "no"},
        {"task": "OCR", "image": "b.jpg", "question": "Is there a car?",
         "answer": "no"},
        {"task": "OCR", "image": "b.jpg", "question": "Is there a tree?",
         "answer": "yes"}])
    _jsonl(root / "mmvp.jsonl", [
        {"image": "a.jpg" if i % 2 == 0 else "b.jpg", "question": f"Q{i + 1}",
         "choices": ["x", "y"], "answer": "AB"[i % 2]} for i in range(4)])
    _jsonl(root / "cap.jsonl", [
        {"image": "a.jpg", "references": [
            "a red ball on green grass today ok",
            "red ball sits on the grass"]},
        {"image": "b.jpg", "references": ["two dogs play in the snow",
                                          "dogs playing in deep snow"]}])
    _jsonl(root / "mvbench.jsonl", [
        {"task_type": "action", "video": "video", "question": "Q?",
         "candidates": ["x", "y"], "answer": "y"},
        {"task_type": "object", "video": "video", "question": "What moved?",
         "candidates": ["ball", "cube", "cone"], "answer": "ball",
         "start": 0.5, "end": 3.0}])
    _jsonl(root / "mathvista.jsonl", [
        {"image": "a.jpg", "query": "What is x^2 at x = 2?",
         "question_type": "free_form", "answer_type": "integer",
         "precision": 0, "answer": "4"},
        {"query": "Which is larger?", "question_type": "multi_choice",
         "answer_type": "text", "choices": ["cat", "dog"], "answer": "dog"}])
    _jsonl(root / "pope.jsonl", [
        {"image": "x.png", "text": f"Is there a {w}?", "label": lab}
        for w, lab in (("dog", "yes"), ("cat", "no"), ("car", "no"),
                       ("tree", "yes"))])
    _jsonl(root / "pixmo.jsonl", [
        {"image": "a.jpg", "width": 200, "height": 200, "conversations": [
            {"from": "human", "value": "<image>\nPoint to <ref>the mug</ref>"},
            {"from": "gpt", "value": "<ref>the mug</ref><point>[[100, 100]]"
                                     "</point>"}]},
        {"image": "b.jpg", "width": 40, "height": 72, "conversations": [
            {"from": "human", "value": "Where is <ref>the box</ref>?"},
            {"from": "gpt", "value": "<ref>the box</ref>[[5, 7]]"}]}])
    mask = np.zeros((48, 64), bool)
    mask[20:30, 25:40] = True
    _jsonl(root / "region.jsonl", [
        {"image": "a.jpg", "expression": "free space", "width": 64,
         "height": 48, "mask": mask.tolist()},
        {"image": "b.jpg", "expression": "the shelf", "width": 40,
         "height": 72, "points": [[20, 36], [1, 1]]}])
    _jsonl(root / "vsi.jsonl", [
        {"question": "How far is the door?", "answer": "10"},
        {"question": "Which room?", "answer": "B", "choices": ["hall", "den"]},
        {"question": "How far is the bed?", "answer": "0"},
        {"question": "Count the chairs", "answer": "3"}])
    buf = io.BytesIO()
    Image.new("RGB", (16, 16), (200, 10, 10)).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    (root / "mmbench.tsv").write_text(
        "index\tquestion\thint\tA\tB\tC\tD\timage\tanswer\n"
        f"0\tWhat color?\tLook closely.\tred\tblue\tgreen\t\t{b64}\tA\n"
        f"1\tWhich shape?\tnan\tcircle\tsquare\t\t\t{b64}\tB\n")
    return root


# Each case: (module, fn(module, data dir) -> output). The inputs are the
# JAX eval tests' own.
CASES = {
    # vqa_metrics (test_eval_protocols.py)
    "evalai_processor": ("vqa_metrics", lambda m, d: [
        m.EvalAIAnswerProcessor()(s)
        for s in ("The two dogs", "a cat!", "isnt", "Three", "Yes, 2 cats.")]),
    "vqa_soft_score": ("vqa_metrics", lambda m, d: [
        m.vqa_soft_score(p, ["cat"] * 2 + ["dog"] * 8)
        for p in ("cat", "dog", "bird")]),
    "vqa_soft_score_requires_ten": ("vqa_metrics",
                                    lambda m, d: m.vqa_soft_score("x", ["x"] * 9)),
    "anls": ("vqa_metrics", lambda m, d: [
        m.anls_score("hello", ["hallo"]), m.anls_score("abc", ["xyz"]),
        m.anls_score("a", ["a", "zzz"])]),
    "relaxed_correctness": ("vqa_metrics", lambda m, d: [
        m.relaxed_correctness(p, t) for p, t in (
            ("100", "104"), ("100", "106"), ("50%", "0.52"), ("cat", "CAT"),
            ("0", "0.001"))]),
    "relaxed_and_exact": ("vqa_metrics", lambda m, d: [
        f([{"answer": "4", "annotation": "4"},
           {"answer": "10", "annotation": ["9.8", "12"]}])
        for f in (m.evaluate_relaxed_accuracy,
                  m.evaluate_exact_match_accuracy)]),
    "vqa_score_and_anls_entries": ("vqa_metrics", lambda m, d: [
        f([{"answer": "cat", "annotation": ["cat"] * 10},
           {"answer": "hallo", "annotation": ["hello"] * 10}])
        for f in (m.evaluate_vqa_score, m.evaluate_anls)]),
    "post_process_vqa": ("vqa_metrics", lambda m, d: [
        m.post_process_vqa(s) for s in (
            "The answer is a red apple.", "It is the Eiffel Tower, in Paris.",
            "Two.")]),
    "prompts_and_metric_table": ("vqa_metrics", lambda m, d: (
        m.BASE_PROMPT, m.VIZWIZ_PROMPT, m.METRIC_BY_DATASET,
        sorted(m.EVALUATORS))),
    # mc_protocols
    "build_mc_question": ("mc_protocols", lambda m, d: [
        m.build_mc_question("What is shown?", ["cat", "dog"]),
        m.build_mc_question("Pick one", ["a", "b", "c"], "Answer briefly.")]),
    "mc_post_process": ("mc_protocols", lambda m, d: [
        m.mc_post_process(p, {"A": "cat", "B": "dog"})
        for p in ("B", "B. dog", "it's a dog", "unclear")]),
    "mme": ("mc_protocols", lambda m, d: (
        [m.mme_parse_pred(s) for s in ("Yes, it is", "no", "maybe")],
        m.mme_task_metrics([[("yes", "Yes"), ("no", "No")],
                            [("yes", "No"), ("no", "No")]]),
        m.mme_suite_scores({"existence": [[("yes", "Yes"), ("no", "No")]],
                            "OCR": [[("yes", "No"), ("no", "No")]]}))),
    "mvbench_frames_and_template": ("mc_protocols", lambda m, d: (
        m.mvbench_frame_indices(32, num_segments=4, first_idx=0),
        m.mvbench_frame_indices(100, num_segments=4, bound=(2.0, 10.0)),
        m.mvbench_qa_template({"question": "What moves?",
                               "candidates": ["ball", "cube"],
                               "answer": "cube"}))),
    "mvbench_check_ans": ("mc_protocols", lambda m, d: [
        m.mvbench_check_ans(p, g) for p, g in (
            ("(B) cube", "(b) cube"), ("Answer: (A) ball moves", "(a) ball"),
            ("(A) ball", "(b) cube"))]),
    "mvbench_build_item": ("mc_protocols", lambda m, d: m.mvbench_build_item(
        {"question": "Q?", "candidates": ["x", "y"], "answer": "y"},
        str(d / "empty"), num_segments=4)),
    "mvbench_accuracy": ("mc_protocols", lambda m, d: m.mvbench_accuracy([
        ("a", "(B) y", "(B) y"), ("a", "(A) x", "(B) y"),
        ("b", "(A) x", "(A) x")])),
    # grounding_bbox
    "parse_bbox": ("grounding_bbox", lambda m, d: (
        [m.parse_bbox(s) for s in ("[[120, 30, 200, 400]]", "box: [1,2,3,4].",
                                   "no box here")],
        m.BBOX_PATTERN.findall("[[1,2,3,4]] and [[5,6,7,8]]"))),
    "grounding_scoring": ("grounding_bbox", lambda m, d: (
        m.score_grounding("[[100, 200, 300, 600]]", [100.0, 100.0, 300.0,
                                                     300.0], (500.0, 1000.0)),
        m.score_grounding("[[800, 800, 900, 900]]", [100.0, 100.0, 300.0,
                                                     300.0], (500.0, 1000.0)),
        m.evaluate_grounding([
            {"answer": "[[100, 200, 300, 600]]",
             "gt_bbox": [100.0, 100.0, 300.0, 300.0], "hw": (500.0, 1000.0)},
            {"answer": "nope", "gt_bbox": [100.0, 100.0, 300.0, 300.0],
             "hw": (500.0, 1000.0)}]),
        m.build_grounding_question("the red cup"))),
    # caption_metrics + ptb_tokenizer (test_caption_metrics.py)
    "bleu": ("caption_metrics", lambda m, d: [
        m.corpus_bleu(["a cat sits on the mat today ok"],
                      [["a cat sits on the mat today ok"]]),
        m.corpus_bleu(["xyz abc"], [["completely different words here"]]),
        m.corpus_bleu(["a b c d"], [["a b c d e f g h"]])]),
    "cider_and_captions": ("caption_metrics", lambda m, d: (
        m.cider_d(["a red ball on green grass", "two dogs play in snow"],
                  [["a red ball on green grass", "red ball on the grass"],
                   ["two dogs play in snow", "dogs playing in the snow"]]),
        m.cider_d(["something else entirely", "irrelevant text output"],
                  [["a red ball on green grass", "red ball on the grass"],
                   ["two dogs play in snow", "dogs playing in the snow"]]),
        m.evaluate_captions([{"caption": "A dog, running!",
                              "references": ["a dog running"]}]),
        [m.tokenize(s) for s in ("A dog, running!", "it doesn't bark")],
        m.CAPTION_PROMPT)),
    "ptb_tokenize": ("ptb_tokenizer", lambda m, d: [
        (m.ptb_word_tokenize(s), m.ptb_tokenize(s)) for s in (
            '"Oh, no," she\'s saying, "our $400 blender can\'t handle '
            'something this hard!"',
            "A man (wearing a red hat) doesn't ride a horse; it's grazing.",
            "Two dogs -- one black, one white -- play fetch... happily!",
            "There are 3,000 people; they're watching fireworks.",
            "Children playing soccer on a field { and bushes } [ at dusk ].",
            "Someone's gonna eat the last slice of pizza, isn't he?",
            "a [sic] dog")] + [sorted(m.PUNCTUATIONS)]),
    # math_verify
    "verify_math": ("math_verify", lambda m, d: [
        m.verify_math(g, p) for g, p in (
            ("0.5", "1/2"), ("\\frac{1}{2}", "0.5"),
            ("2*pi", "6.283185307179586"), ("x**2 - 1", "(x-1)*(x+1)"),
            ("3", "4"), ("50%", "0.5"), ("1,234", "1234"),
            ("(1, 2)", "(1.0, 2.0)"), ("", "1"), ("\\sqrt{4}", "2"),
            ("\\boxed{7}", "7"), ("3^{2}", "9"))]),
    "mathvista": ("math_verify", lambda m, d: (
        m.extract_answer("Final answer: 42", {}),
        m.extract_answer('The answer is "B".', {}),
        m.normalize_extracted_answer("(b)", ["cat", "dog"], "multi_choice",
                                     "text", 2),
        m.normalize_extracted_answer("dgo", ["cat", "dog"], "multi_choice",
                                     "text", 2),
        m.normalize_extracted_answer("3.14159", [], "free_form", "float", 2),
        m.normalize_extracted_answer("7.0", [], "free_form", "integer", 2),
        m.mathvista_score([
            {"response": "Answer: 3", "question_type": "free_form",
             "answer_type": "integer", "precision": 2, "answer": "3"},
            {"response": "Answer: (A)", "question_type": "multi_choice",
             "answer_type": "text", "choices": ["cat", "dog"],
             "answer": "dog"}]))),
    "score_rollouts_math": ("math_verify", lambda m, d: m.score_rollouts_math(
        "1/2", ["reasoning...\nFinal answer: 0.5", "Answer: 0.7", "garbage"])),
    # point_eval (test_eval.py, test_vlm_benchmarks.py)
    "point_metrics": ("point_eval", lambda m, d: (
        m.point_in_radius((10, 10), [(30, 10)], radius=25),
        m.point_in_radius((10, 10), [(40, 10)], radius=25),
        m.parse_points("the point is [123, 45] ok [6,7]"),
        m.evaluate_points([
            {"image": "img.jpg", "expression": "red cup",
             "response": "[105, 98]", "width": 640, "height": 480},
            {"image": "img.jpg", "expression": "red cup",
             "response": "[400, 400]", "width": 640, "height": 480}],
            {("img.jpg", "red cup"): [(100, 100)]}))),
    "point_precision": ("point_eval", lambda m, d: m.evaluate_points_precision(
        [{"image": "im.png", "expression": "the mug", "width": 200,
          "height": 200, "response": "<point>[[500, 500], [10, 10]]</point>"},
         {"image": "im.png", "expression": "the mug", "width": 200,
          "height": 200, "response": "somewhere on the left"}],
        {("im.png", "the mug"): [(100, 100)]}, radius=25.0,
        normalized_scale=1000.0)),
    "point_prompt_and_gt": ("point_eval", lambda m, d: (
        m.build_point_prompt("the red block"),
        m.parse_ref_expression("<ref>the mug</ref> at [1, 2]"),
        sorted(m.load_gt_points(str(d / "pixmo.jsonl")).items()))),
    # vlm_benchmarks (test_vlm_benchmarks.py)
    "mc_extraction_and_matchers": ("vlm_benchmarks", lambda m, d: (
        [m.extract_mc_answer(s) for s in (
            "The answer is B.", "b", "I think (C) is right",
            "no letters here", "cabbage")],
        m.exact_match(" Yes ", "yes"), m.exact_match("yes indeed", "yes"),
        m.substring_match("the red cup is on the left", "red cup"),
        m.format_mc_question(m.BenchmarkItem(
            question="Which object?", answer="B",
            choices=["cup", "plate", "fork"])))),
    "load_jsonl_benchmark": ("vlm_benchmarks", lambda m, d:
                             m.load_jsonl_benchmark(str(d / "bench.jsonl"),
                                                    str(d))),
    "evaluate_benchmark": ("vlm_benchmarks", lambda m, d: [
        (m.evaluate_benchmark(chat, m.load_jsonl_benchmark(
            str(d / "bench.jsonl"), str(d)), mode=mode, batch_size=2,
            max_tiles=2, image_size=28), chat.calls)
        for mode, chat in (("multiple_choice", StubChat()),
                           ("exact", StubChat()), ("substring", StubChat()))]),
    "mmbench_tsv": ("vlm_benchmarks", lambda m, d: (
        m.load_mmbench_tsv(str(d / "mmbench.tsv")), m.MMBENCH_PROMPT)),
    "pope": ("vlm_benchmarks", lambda m, d: (
        [m.pope_yes_no(s) for s in ("No, there is not.",
                                    "Yes. It is on the table.",
                                    "There is not a dog, only a cat.")],
        m.evaluate_pope(StubChat(), m.load_pope(str(d / "pope.jsonl"),
                                                str(d)), batch_size=4,
                        max_tiles=1, image_size=28))),
    # embodied_benchmarks
    "mra_and_numbers": ("embodied_benchmarks", lambda m, d: (
        [m.mra_score(p, g) for p, g in ((10.0, 10.0), (1000.0, 10.0),
                                        (12.0, 10.0), (0.0, 0.0))],
        [m.parse_number(s) for s in ("about 12.5 meters", "no idea",
                                     "1,200 m")])),
    "point_in_mask": ("embodied_benchmarks", lambda m, d: (lambda mask: [
        m.point_in_mask(p, mask) for p in ((7, 5), (5, 7), (100, 100))])(
        np.eye(10, 20, k=2, dtype=bool))),
    "load_point_benchmark": ("embodied_benchmarks", lambda m, d:
                             m.load_point_benchmark(str(d / "pixmo.jsonl"),
                                                    str(d))),
    # protocol_runners
    "chat_batches_multi_image": ("protocol_runners", lambda m, d: (
        lambda chat: (m._chat_batches(
            chat, ["Image-1: <image>\nImage-2: <image>\nQ", "text"],
            [[Image.open(d / "a.jpg"), Image.open(d / "b.jpg")], None],
            max_tiles=1, image_size=28), chat.calls))(StubChat())),
}


RAISES = {"vqa_soft_score_requires_ten"}  # an AssertionError in both


def test_every_ported_eval_module_has_cases():
    assert {name for name, _ in CASES.values()} == set(MODULES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_function_matches_jax(d, case):
    name, fn = CASES[case]
    jmod, pmod = _mods(name)
    want = _run(fn, jmod, d)
    assert _run(fn, pmod, d) == want
    raised = isinstance(want, tuple) and want[0] == "raised"
    assert raised == (case in RAISES), want


# (route, data file, keywords): every RUNNERS entry and every family of
# run_benchmark, on the data the JAX runner tests use
ROUTES = [
    ("mmmu", "mc.jsonl", {}), ("scienceqa", "mc_text.jsonl", {}),
    ("seed", "mc.jsonl", {"max_tiles": 2}), ("mmvp", "mmvp.jsonl", {}),
    ("mme", "mme.jsonl", {}), ("mvbench", "mvbench.jsonl",
                               {"num_segments": 4}),
    ("vqa", "vqa.jsonl", {}), ("vqa", "vqa.jsonl",
                               {"dataset": "chartqa_human"}),
    ("vqa", "vqa.jsonl", {"dataset": "vizwiz_val"}),
    ("refcoco", "ref.jsonl", {}), ("caption", "cap.jsonl", {}),
    ("mathvista", "mathvista.jsonl", {}),
    ("erqa", "bench.jsonl", {}), ("pixmo", "pixmo.jsonl", {}),
    ("where2place", "region.jsonl", {}), ("vsi", "vsi.jsonl", {}),
]


@pytest.mark.parametrize("route,data,kw", ROUTES,
                         ids=[f"{r}-{f.split('.')[0]}-{len(k)}"
                              for r, f, k in ROUTES])
def test_runners_and_run_benchmark_match_jax(d, route, data, kw):
    """The same stub chat drives both packages' route: equal result dicts,
    and the chat was handed the same questions, tiles (bit for bit) and
    num_patches_list in the same calls."""
    out = []
    for pkg in ("vlaser_tpu", "vlaser_tpu_torch"):
        chat = StubChat()
        if route in ("erqa", "pixmo", "where2place", "vsi"):
            emb = importlib.import_module(f"{pkg}.eval.embodied_benchmarks")
            res = emb.run_benchmark(route, chat, str(d / data), str(d),
                                    max_tiles=2, **kw)
        else:
            runners = importlib.import_module(
                f"{pkg}.eval.protocol_runners").RUNNERS
            res = runners[route](chat, str(d / data), str(d), batch_size=2,
                                 image_size=28, **kw)
        out.append((_plain(res), chat.calls))
    assert out[1][0] == out[0][0]
    assert out[1][1] == out[0][1]
    assert out[0][1]  # the chat was asked


def test_text_only_jsonl_loads_without_pil(d, monkeypatch):
    """load_jsonl_benchmark imports PIL only for a row that names an image
    (the card's machine has none): a text-only file loads with PIL gone."""
    import sys

    from vlaser_tpu_torch.eval import vlm_benchmarks as vb

    monkeypatch.setitem(sys.modules, "PIL", None)
    items = vb.load_jsonl_benchmark(str(d / "mc_text.jsonl"))
    assert [it.question for it in items] == ["2+2?"] * 3
    with pytest.raises(ImportError):
        vb.load_jsonl_benchmark(str(d / "bench.jsonl"), str(d))
