"""MMPR-style reasoning preference-data pipeline (a copy of
vlaser_tpu/data/reasoning_pipeline.py; the math_verify and vqa_score
modes go through the port's eval/).

Parity surface: Vlaser_VLM/internvl_chat/tools/reasoning_data_pipeline/
- mmpr_data_pipeline_correctness.py: sample N rollouts per (image, question)
- utils/accuracy_reward.py check_answer(:467): exact / relaxed / numeric /
  math_verify (sympy-backed, eval/math_verify.py) / vqa_score
  (EvalAI-normalized, eval/vqa_metrics.py) correctness — all native now
- mmpr_data_pipeline_correctness_postprocess.py: bucket rollouts into
  pos/neg/format-neg per question key and build chosen/rejected pairs
  (:22-160); output schema {image, question, chosen, rejected, answer_gt}
  feeds data/preference_dataset.py -> scripts/train_mpo.py directly
- mmpr_data_pipeline_dropout_ntp.py: for unverifiable samples, rejected =
  truncated response + model continuation (DropoutNTP)
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# --------------------------------------------------------------------------
# answer extraction + correctness
# --------------------------------------------------------------------------

_BOXED = re.compile(r"\\boxed\{([^{}]*)\}")
_FINAL = re.compile(
    r"(?:final answer|the answer is|answer)\s*[:：]?\s*(.+?)\s*$",
    re.IGNORECASE | re.MULTILINE,
)


def extract_final_answer(response: str) -> Optional[str]:
    """boxed{} > 'Final answer:' line > last non-empty line."""
    m = _BOXED.findall(response)
    if m:
        return m[-1].strip()
    m = _FINAL.findall(response)
    if m:
        return m[-1].strip().rstrip(".")
    lines = [l.strip() for l in response.strip().splitlines() if l.strip()]
    return lines[-1] if lines else None


def _to_float(s: str) -> Optional[float]:
    s = s.replace(",", "").replace("%", "").strip().strip("$")
    try:
        return float(s)
    except ValueError:
        return None


def relaxed_correctness(gt: str, pred: str, tol: float = 0.05) -> int:
    """ChartQA relaxed accuracy: numeric within 5% relative, else exact
    (accuracy_reward.py relaxed_correctness)."""
    g, p = _to_float(gt), _to_float(pred)
    if g is not None and p is not None:
        if g == 0:
            return int(p == 0)
        return int(abs(p - g) / abs(g) <= tol)
    return int(gt.strip().lower() == pred.strip().lower())


def check_answer(answer_pred: str, answer_gt: str, mode: str = "exact") -> int:
    """accuracy_reward.py:467-510 semantics. Modes: 'exact' (plus the
    substring modes below), 'relaxed_accuracy', 'numeric', 'math_verify'
    (sympy-backed symbolic/numeric equivalence, eval/math_verify.py —
    replacing the reference's external math_verify package),
    'vqa_score' (EvalAI-normalized match, eval/vqa_metrics.py)."""
    if answer_pred is None:
        return 0
    if answer_pred.strip().lower() == answer_gt.strip().lower():
        return 1
    acc = 0
    if "relaxed_accuracy" in mode:
        acc = max(acc, relaxed_correctness(answer_gt, answer_pred))
    if "numeric" in mode:
        g, p = _to_float(answer_gt), _to_float(answer_pred)
        if g is not None and p is not None:
            acc = max(acc, int(abs(p - g) < 1e-6 * max(1.0, abs(g))))
    if "math_verify" in mode and not acc:
        from ..eval.math_verify import verify_math

        acc = max(acc, int(verify_math(answer_gt, answer_pred)))
    if "vqa_score" in mode and not acc:
        from ..eval.vqa_metrics import EvalAIAnswerProcessor

        proc = EvalAIAnswerProcessor()
        acc = max(acc, int(proc(answer_pred) == proc(answer_gt)))
    return acc


# --------------------------------------------------------------------------
# rollout sampling
# --------------------------------------------------------------------------

def sample_responses(
    items: Sequence[Dict],  # {image?, question, answer}
    generate_fn: Callable[[Dict, int], str],  # (item, sample_idx) -> response
    num_samples: int = 8,
) -> List[Dict]:
    """N rollouts per item (mmpr_data_pipeline_correctness.py main loop)."""
    out = []
    for item in items:
        for k in range(num_samples):
            out.append({**item, "response": generate_fn(item, k)})
    return out


# --------------------------------------------------------------------------
# pos/neg bucketing + pair construction
# --------------------------------------------------------------------------

def _key(item: Dict) -> Tuple[str, str, str]:
    return (item.get("image", ""), item["question"], str(item["answer"]))


def build_items_based_on_correctness(
    rollouts: Sequence[Dict], mode: str = "exact",
):
    """-> (pos, neg, format_neg) dicts keyed by (image, question, answer)
    (postprocess.py:22-93). format_neg = responses with no parsable answer."""
    pos = defaultdict(list)
    neg = defaultdict(list)
    fmt = defaultdict(list)
    for item in rollouts:
        key = _key(item)
        pred = extract_final_answer(item["response"])
        if pred is None:
            fmt[key].append(item)
            continue
        if check_answer(pred, str(item["answer"]), mode):
            pos[key].append(item)
        else:
            neg[key].append(item)
    return pos, neg, fmt


def build_pairs(
    pos: Dict, neg: Dict, max_pairs_per_key: int = 15,
) -> List[Dict]:
    """Cross-product chosen x rejected per key, capped
    (postprocess.py:96-160); schema matches PreferenceDataset."""
    pairs = []
    for key in pos:
        if key not in neg:
            continue
        count = 0
        for item_pos in pos[key]:
            for item_neg in neg[key]:
                if count >= max_pairs_per_key:
                    break
                pairs.append({
                    "image": item_pos.get("image", ""),
                    "question": item_pos["question"],
                    "chosen": item_pos["response"],
                    "rejected": item_neg["response"],
                    "answer_gt": str(item_pos["answer"]),
                })
                count += 1
    return pairs


def build_dropout_ntp_pairs(
    items: Sequence[Dict],  # {image?, question, answer?, response}
    continue_fn: Callable[[Dict, str], str],  # (item, prefix) -> continuation
    drop_ratio: float = 0.5,
) -> List[Dict]:
    """DropoutNTP (mmpr_data_pipeline_dropout_ntp.py): for samples without a
    verifiable answer, rejected = first (1-drop_ratio) of the response + the
    model's continuation without image/context grounding."""
    pairs = []
    for item in items:
        resp = item["response"]
        cut = max(1, int(len(resp) * (1 - drop_ratio)))
        prefix = resp[:cut]
        continuation = continue_fn(item, prefix)
        pairs.append({
            "image": item.get("image", ""),
            "question": item["question"],
            "chosen": resp,
            "rejected": prefix + continuation,
        })
    return pairs


def write_pairs_jsonl(pairs: Sequence[Dict], path: str):
    with open(path, "w") as f:
        for p in pairs:
            f.write(json.dumps(p, ensure_ascii=False) + "\n")
