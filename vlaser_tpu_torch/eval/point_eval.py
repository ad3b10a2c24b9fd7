"""Point-grounding evaluation (Pixmo-Points / Paco-Lavis protocol).

Parity surface: Vlaser_VLM/internvl_chat/eval/evaluate_point_pixmo.py —
point_in_radius (:24, radius 25px), <ref>...</ref> expression parsing, [x, y]
point extraction from model output, accuracy = fraction of predictions within
radius of any GT point.
"""

from __future__ import annotations

import json
import re
from math import sqrt
from typing import Dict, List, Optional, Sequence, Tuple


# exact prompts of the reference point evals (evaluate_point_pixmo.py:115-117,
# evaluate_point_paco.py:153-157) — the instruction defines the output format
# the parser below expects
POINT_SYSTEM_PROMPT = (
    ' You are InternVL. Your task is to locate several points in the given '
    'image according to the task descriptions. Your answer should be '
    'formatted as "<point>[[x1, y1], [x2, y2],...]</point>". The point '
    'coordinates are normalized to integers between 0 and 1000. Return the '
    'answer in the point format directly.'
)
POINT_QUERY_PROMPT = " Please provide the referring points of {}."


def build_point_prompt(expression: str) -> str:
    return POINT_SYSTEM_PROMPT + POINT_QUERY_PROMPT.format(expression)


def point_in_radius(
    pred: Tuple[float, float],
    targets: Sequence[Tuple[float, float]],
    radius: float = 25.0,
) -> bool:
    for tgt in targets:
        if sqrt((pred[0] - tgt[0]) ** 2 + (pred[1] - tgt[1]) ** 2) <= radius:
            return True
    return False


def parse_points(text: str) -> List[Tuple[int, int]]:
    """Extract [x, y] integer points from a model response."""
    return [(int(x), int(y)) for x, y in re.findall(
        r"\[\s*(\d+)\s*,\s*(\d+)\s*\]", text)]


def parse_ref_expression(text: str) -> Optional[str]:
    m = re.search(r"<ref>(.*?)</ref>", text)
    return m.group(1) if m else None


def load_gt_points(jsonl_path: str) -> Dict[Tuple[str, str], List[Tuple[int, int]]]:
    """(image, expression) -> GT points, from conversation-format jsonl."""
    gt = {}
    with open(jsonl_path) as f:
        for line in f:
            item = json.loads(line.strip())
            image = item["image"]
            for conv in item["conversations"]:
                if conv["from"] == "gpt":
                    expr = parse_ref_expression(conv["value"])
                    points = parse_points(conv["value"])
                    if expr and points:
                        gt[(image, expr)] = points
    return gt


def evaluate_points_precision(
    predictions: Sequence[Dict],  # {image, expression, response, width, height}
    gt: Dict[Tuple[str, str], List[Tuple[int, int]]],
    radius: float = 25.0,
    normalized_scale: Optional[float] = None,
) -> Dict[str, float]:
    """Reference-exact scoring (evaluate_point_pixmo.py:166-186):
    every predicted point is judged against the GT set; precision =
    in-radius predictions / total predictions (samples with no parsable
    prediction contribute 1 to the denominator)."""
    correct = total = 0
    for p in predictions:
        targets = gt.get((p["image"], p["expression"]))
        if targets is None:
            continue
        pts = [(float(x), float(y)) for x, y in re.findall(
            r"\[\s*(\d+\.?\d*)\s*,\s*(\d+\.?\d*)\s*\]", p["response"])]
        if normalized_scale:
            pts = [
                (x / normalized_scale * p["width"], y / normalized_scale * p["height"])
                for x, y in pts
            ]
        for pt in pts:
            correct += int(point_in_radius(pt, targets, radius))
        total += len(pts) if pts else 1
    return {
        "precision": correct / max(total, 1),
        "num_predictions": total,
        "num_correct": correct,
    }


def evaluate_points(
    predictions: Sequence[Dict],  # {image, expression, response, width, height}
    gt: Dict[Tuple[str, str], List[Tuple[int, int]]],
    radius: float = 25.0,
    normalized_scale: Optional[float] = None,  # e.g. 1000 if model emits 0-1000
) -> Dict[str, float]:
    correct = total = 0
    for p in predictions:
        targets = gt.get((p["image"], p["expression"]))
        if targets is None:
            continue
        total += 1
        pts = parse_points(p["response"])
        if not pts:
            continue
        x, y = pts[0]
        if normalized_scale:
            x = x / normalized_scale * p["width"]
            y = y / normalized_scale * p["height"]
        if point_in_radius((x, y), targets, radius):
            correct += 1
    return {
        "accuracy": correct / max(total, 1),
        "num_evaluated": total,
        "num_correct": correct,
    }
