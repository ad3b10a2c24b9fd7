"""RefCOCO-family visual-grounding eval (bbox precision@IoU0.5).

Parity surface: Vlaser_VLA/Simpler/src/model/internvl_chat/eval/refcoco/
evaluate_grounding.py — the prompt (:261), the bbox regex (:257), the
/1000-normalized coordinate convention and IoU>=0.5 precision@1 (:186-210).
Runs on jsonl rows {image, sent, bbox, width, height} for
refcoco/refcoco+/refcocog splits (:17-26).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

GROUNDING_PROMPT = (
    "Please provide the bounding box coordinate of the region this sentence "
    "describes: <ref>{}</ref>"
)

# '[[x1, y1, x2, y2]]' with optional extra brackets (evaluate_grounding.py:257)
BBOX_PATTERN = re.compile(r"\[*\[(.*?),(.*?),(.*?),(.*?)\]\]*")


def parse_bbox(answer: str) -> Tuple[float, float, float, float]:
    """First bbox match; unparseable -> all-zero box (scores 0 IoU)."""
    m = BBOX_PATTERN.findall(answer)
    try:
        return tuple(float(v) for v in m[0])  # type: ignore[return-value]
    except (IndexError, ValueError):
        return (0.0, 0.0, 0.0, 0.0)


def box_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two xyxy boxes."""
    area_a = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
    area_b = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[0] * wh[1]
    union = area_a + area_b - inter
    return float(inter / union) if union > 0 else 0.0


def score_grounding(
    answer: str,
    gt_bbox: Sequence[float],
    hw: Tuple[float, float],
    iou_threshold: float = 0.5,
) -> bool:
    """One sample: parse -> de-normalize (/1000 if coords look normalized,
    i.e. sum >= 4, matching :192-196) -> scale by (w, h) -> IoU test."""
    pred = np.asarray(parse_bbox(answer), np.float32)
    if pred.sum() >= 4:
        pred = pred / 1000.0
    h, w = hw
    pred = pred * np.asarray([w, h, w, h], np.float32)
    return box_iou(pred, np.asarray(gt_bbox, np.float32)) >= iou_threshold


def evaluate_grounding(
    outputs: Sequence[Dict], iou_threshold: float = 0.5
) -> Dict[str, float]:
    """outputs: [{'answer': str, 'gt_bbox': [x1,y1,x2,y2] px,
    'hw': (h, w)}] -> precision@1 (:186-210)."""
    correct = sum(
        score_grounding(o["answer"], o["gt_bbox"], o["hw"], iou_threshold)
        for o in outputs
    )
    total = max(len(outputs), 1)
    return {"precision@1": correct / total, "num_evaluated": len(outputs)}


def build_grounding_question(sentence: str) -> str:
    return GROUNDING_PROMPT.format(sentence)
