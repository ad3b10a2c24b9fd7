"""Multiple-choice benchmark protocols: MMMU, ScienceQA, MME, MVBench.

Parity surface: Vlaser_VLA/Simpler/src/model/internvl_chat/eval/ —
- mmmu/evaluate_mmmu.py:70-157 (option assembly + letter post-process)
- scienceqa/evaluate_scienceqa.py:59-160 (same post-process, CoT-optional)
- mme/calculation.py:16-140 (yes/no parse on a 4-char prefix, per-task
  accuracy + acc_plus over the two questions sharing one image)
- mvbench/evaluate_mvbench.py:63-264 (bounded frame sampling, qa_template,
  check_ans on the leading option token)

These produce/score prompts for `inference.chat.VlaserChat`; the generic
batched loop lives in eval/vlm_benchmarks.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

MC_LETTERS = ["A", "B", "C", "D", "E", "F", "G", "H", "I", "J", "K", "L", "M"]

MMMU_PROMPT = {
    "multiple-choice":
        "Answer with the option's letter from the given choices directly.",
    "open": "Answer the question using a single word or phrase.",
}


def build_mc_question(
    question: str, choices: Sequence[str], prompt: Optional[str] = None
) -> Tuple[str, Dict[str, str]]:
    """MMMU/ScienceQA option assembly (evaluate_mmmu.py:82-108): 'A. text'
    lines appended to the question, then the answer-directly prompt.
    Returns (question, {letter: choice})."""
    options = {}
    lines = []
    for i, c in enumerate(choices):
        c = c.strip()
        lines.append(f"{MC_LETTERS[i]}. {c}")
        options[MC_LETTERS[i]] = c
    if lines:
        question = question.strip() + "\n" + "\n".join(lines)
    if prompt is None:
        prompt = MMMU_PROMPT["multiple-choice" if choices else "open"]
    if prompt:
        question = question + "\n" + prompt
    return question.strip(), options


def mc_post_process(pred: str, options: Dict[str, str]) -> str:
    """Letter extraction (evaluate_mmmu.py:145-157 post_process, shared by
    scienceqa): a single char passes through; otherwise the first char if it
    is an option letter; otherwise the option whose text appears in pred."""
    pred = pred.strip()
    cand = list(options.keys())
    if len(pred) == 1:
        return pred
    if pred and pred[0] in cand:
        return pred[0]
    for k, v in options.items():
        if v in pred:
            return k
    return pred


def score_mc(pred: str, options: Dict[str, str], answer: str) -> bool:
    return mc_post_process(pred, options) == answer


# --------------------------------------------------------------------------
# MME (mme/calculation.py)
# --------------------------------------------------------------------------

MME_EVAL_TYPES = {
    "Perception": [
        "existence", "count", "position", "color", "posters", "celebrity",
        "scene", "landmark", "artwork", "OCR",
    ],
    "Cognition": [
        "commonsense_reasoning", "numerical_calculation", "text_translation",
        "code_reasoning",
    ],
}


def mme_parse_pred(pred_ans: str) -> str:
    """calculation.py:24-38: exact yes/no, else a 4-char prefix scan."""
    pred_ans = pred_ans.lower()
    if pred_ans in ("yes", "no"):
        return pred_ans
    prefix = pred_ans[:4]
    if "yes" in prefix:
        return "yes"
    if "no" in prefix:
        return "no"
    return "other"


def mme_task_metrics(
    pairs: Sequence[Sequence[Tuple[str, str]]]
) -> Dict[str, float]:
    """One MME task. `pairs` = per-image [(gt, raw_pred), (gt, raw_pred)] —
    two questions per image (calculation.py:96-140). Returns acc, acc_plus,
    precision/recall on the yes class, and the task score acc+acc_plus
    (both in percent, as the reference reports)."""
    gts, preds = [], []
    acc_plus_correct = 0
    for img_items in pairs:
        assert len(img_items) == 2, "MME pairs two questions per image"
        img_correct = 0
        for gt, raw in img_items:
            gt = gt.lower()
            assert gt in ("yes", "no")
            pred = mme_parse_pred(raw)
            gts.append(gt)
            preds.append(pred)
            img_correct += int(gt == pred)
        acc_plus_correct += int(img_correct == 2)
    n = len(gts)
    acc = sum(g == p for g, p in zip(gts, preds)) / max(n, 1)
    acc_plus = acc_plus_correct / max(len(pairs), 1)
    tp = sum(g == "yes" and p == "yes" for g, p in zip(gts, preds))
    fp = sum(g == "no" and p == "yes" for g, p in zip(gts, preds))
    fn = sum(g == "yes" and p == "no" for g, p in zip(gts, preds))
    other = sum(p == "other" for p in preds)
    return {
        "acc": acc,
        "acc_plus": acc_plus,
        "precision": tp / max(tp + fp, 1),
        "recall": tp / max(tp + fn, 1),
        "other_num": other,
        "score": (acc + acc_plus) * 100.0,
    }


def mme_suite_scores(
    task_pairs: Dict[str, Sequence[Sequence[Tuple[str, str]]]]
) -> Dict[str, float]:
    """Per-split totals: sum of task scores (max 200/task), the headline
    Perception/Cognition numbers."""
    out: Dict[str, float] = {}
    for split, tasks in MME_EVAL_TYPES.items():
        total = 0.0
        for t in tasks:
            if t not in task_pairs:
                continue
            m = mme_task_metrics(task_pairs[t])
            out[f"{t}_score"] = m["score"]
            total += m["score"]
        out[split] = total
    return out


# --------------------------------------------------------------------------
# MVBench (mvbench/evaluate_mvbench.py)
# --------------------------------------------------------------------------

MVBENCH_SYSTEM = (
    "Carefully watch the video and pay attention to the cause and sequence "
    "of events, the detail and movement of objects, and the action and pose "
    "of persons. Based on your observations, select the best option that "
    "accurately addresses the question.\n"
)
MVBENCH_QUESTION_PROMPT = "\nOnly give the best option."


def mvbench_frame_indices(
    num_frames: int,
    num_segments: int = 16,
    bound: Optional[Tuple[float, float]] = None,
    fps: float = 3.0,
    first_idx: int = 0,
) -> List[int]:
    """Uniform segment-center sampling (evaluate_mvbench.py:116-128):
    indices = start + seg/2 + i*seg over num_segments segments of
    [max(round(start*fps), first_idx), min(round(end*fps), max_frame)].

    Distinct from utils/tools.video_frame_indices (extract_video_frames.py's
    unbounded sampler with short-clip padding) — the two reference scripts
    use different rounding/bound conventions and are kept protocol-exact
    separately."""
    if bound:
        start, end = bound[0], bound[1]
    else:
        start, end = -100000.0, 100000.0
    start_idx = max(first_idx, round(start * fps))
    end_idx = min(round(end * fps), num_frames - 1 + first_idx)
    seg_size = float(end_idx - start_idx) / num_segments
    return [
        int(start_idx + (seg_size / 2) + round(seg_size * i))
        for i in range(num_segments)
    ]


@dataclass
class MVBenchItem:
    question: str  # fully-assembled prompt (frames + system + QA)
    answer: str  # '(A) text'
    frame_paths: List[str] = field(default_factory=list)
    task_type: str = ""


def mvbench_qa_template(data: Dict) -> Tuple[str, str]:
    """:167-178 — 'Question: ...\\nOptions:\\n(A) ...' and '(X) answer'."""
    question = f"Question: {data['question']}\n"
    question += "Options:\n"
    answer = data["answer"]
    answer_idx = -1
    for idx, c in enumerate(data["candidates"]):
        question += f"({chr(ord('A') + idx)}) {c}\n"
        if c == answer:
            answer_idx = idx
    question = question.rstrip()
    answer = f"({chr(ord('A') + answer_idx)}) {answer}"
    return question, answer


def mvbench_build_item(
    data: Dict, frames_dir: str, *, num_segments: int = 16,
    bound: Optional[Tuple[float, float]] = None, fps: float = 3.0,
) -> MVBenchItem:
    """Frames-directory convention (video decoders are not available on the
    bench box — SURVEY video delta): frames are '{i:05d}.jpg', 1-based, fps
    as archived (read_frame:157-165)."""
    import os

    n = len(os.listdir(frames_dir))
    idxs = mvbench_frame_indices(n, num_segments, bound, fps, first_idx=1)
    paths = [os.path.join(frames_dir, f"{i:05d}.jpg") for i in idxs]
    special = "\n".join(
        f"Frame{i + 1}: <image>" for i in range(len(paths))
    )
    q, a = mvbench_qa_template(data)
    question = special + "\n" + MVBENCH_SYSTEM + "\n" + q \
        + MVBENCH_QUESTION_PROMPT
    return MVBenchItem(question=question, answer=a, frame_paths=paths,
                       task_type=data.get("task_type", ""))


def mvbench_check_ans(pred: str, gt: str) -> bool:
    """:246-262 — compare the leading option token."""
    pred = pred.replace("Answer: ", "")
    pred_list = pred.lower().split(" ")
    pred_option = pred_list[0]
    gt_list = gt.lower().split(" ")
    gt_option = gt_list[0]
    if pred_option.replace(".", "") in gt_option:
        return True
    if gt_option in pred_option:
        return True
    return False


def mvbench_accuracy(results: Sequence[Tuple[str, str, str]]) -> Dict[str, float]:
    """results: [(task_type, pred, gt)] -> per-task and overall accuracy
    (:320-345 correct/total bookkeeping)."""
    per: Dict[str, List[bool]] = {}
    for task, pred, gt in results:
        per.setdefault(task, []).append(mvbench_check_ans(pred, gt))
    out = {t: sum(v) / len(v) for t, v in per.items()}
    allv = [x for v in per.values() for x in v]
    out["overall"] = sum(allv) / max(len(allv), 1)
    return out
