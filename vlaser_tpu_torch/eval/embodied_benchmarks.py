"""Embodied-reasoning benchmark adapters (the BASELINE.md VLM table).

The reference evaluates Vlaser on ERQA, EgoPlan2, Where2place, PointArena,
Paco-Lavis, Pixmo, VSI-Bench, RefSpatial and MMSI (README table / paper); the
repo ships explicit scripts only for the point benchmarks
(internvl_chat/eval/evaluate_point_{pixmo,paco}.py) plus 23 generic benchmark
dirs (Simpler/src/model/internvl_chat/eval/). This module is the one place
that binds each benchmark name to (loader, prompt format, metric) on top of
the generic harness (eval/vlm_benchmarks.py) and the point machinery
(eval/point_eval.py):

- multiple-choice accuracy: ERQA, EgoPlan2, RefSpatial, MMSI, and the MC
  subset of VSI-Bench
- numeric MRA (mean relative accuracy over thresholds 0.5..0.95): the
  numerical-answer subset of VSI-Bench
- point precision @ 25px in original-image pixels: Pixmo, Paco-Lavis
  (reference-exact counting, evaluate_point_pixmo.py:166-186)
- point-in-region: Where2place, PointArena (point benchmarks whose GT is a
  region mask; hit = first predicted point lands inside the mask, the
  radius rule is the fallback when no mask is shipped)

Expected data layout is the conversation/jsonl convention used across this
repo; loaders document their fields.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .point_eval import (
    build_point_prompt,
    evaluate_points_precision,
    load_gt_points,
    parse_points,
    point_in_radius,
)
from .vlm_benchmarks import (
    BenchmarkItem,
    evaluate_benchmark,
    extract_mc_answer,
    format_mc_question,
    load_jsonl_benchmark,
)

MC_BENCHMARKS = ("erqa", "egoplan2", "refspatial", "mmsi")
POINT_BENCHMARKS = ("pixmo", "paco_lavis")
REGION_BENCHMARKS = ("where2place", "pointarena")


# --------------------------------------------------------------------------
# VSI-Bench: MC + numeric questions; numeric scored with MRA
# --------------------------------------------------------------------------

VSI_NUMERIC_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05))


def mra_score(pred: float, gt: float,
              thresholds: Sequence[float] = VSI_NUMERIC_THRESHOLDS) -> float:
    """Mean Relative Accuracy: fraction of confidence thresholds theta for
    which |pred - gt| / |gt| < 1 - theta (the VSI-Bench numeric metric)."""
    if gt == 0:
        return float(pred == 0)
    rel = abs(pred - gt) / abs(gt)
    return float(np.mean([rel < 1.0 - t for t in thresholds]))


def parse_number(text: str) -> Optional[float]:
    m = re.search(r"-?\d+\.?\d*", text.replace(",", ""))
    return float(m.group(0)) if m else None


def evaluate_vsi(chat, items: Sequence[BenchmarkItem], **kw) -> Dict[str, float]:
    """VSI-Bench: items with `choices` score as MC; others numerically."""
    mc_items = [it for it in items if it.choices]
    num_items = [it for it in items if not it.choices]
    out: Dict[str, float] = {}
    n_total = 0
    acc_sum = 0.0
    if mc_items:
        mc = evaluate_benchmark(chat, mc_items, mode="multiple_choice", **kw)
        out["mc_accuracy"] = mc["accuracy"]
        acc_sum += mc["accuracy"] * len(mc_items)
        n_total += len(mc_items)
    if num_items:
        res = evaluate_benchmark(chat, num_items, mode="exact", **kw)
        scores = []
        for it, resp in zip(num_items, res["responses"]):
            pred = parse_number(resp)
            gt = parse_number(it.answer)
            scores.append(0.0 if pred is None or gt is None else mra_score(pred, gt))
        out["numeric_mra"] = float(np.mean(scores))
        acc_sum += out["numeric_mra"] * len(num_items)
        n_total += len(num_items)
    out["accuracy"] = acc_sum / max(n_total, 1)
    out["num_evaluated"] = n_total
    return out


# --------------------------------------------------------------------------
# Point benchmarks
# --------------------------------------------------------------------------

def load_point_benchmark(jsonl_path: str, image_root: str = "") -> List[Dict]:
    """Pixmo/Paco conversation jsonl -> [{image, expression, width, height}]
    (evaluate_point_pixmo.py PixmoPointsDataset:50-80)."""
    out = []
    with open(jsonl_path) as f:
        for line in f:
            item = json.loads(line.strip())
            w, h = item.get("width"), item.get("height")
            for conv in item["conversations"]:
                if conv["from"] != "human":
                    continue
                m = re.search(r"<ref>(.*?)</ref>", conv["value"])
                if not m:
                    continue
                out.append({
                    "image": item["image"],
                    "image_path": os.path.join(image_root, item["image"]),
                    "expression": m.group(1),
                    "width": w,
                    "height": h,
                })
    return out


def evaluate_point_benchmark(
    chat,
    jsonl_path: str,
    image_root: str = "",
    *,
    radius: float = 25.0,
    input_size: int = 448,
    max_tiles: int = 6,
) -> Dict[str, float]:
    """Pixmo / Paco-Lavis: exact reference prompt + precision@radius in
    original-image pixels (model emits 0-1000-normalized coordinates)."""
    from PIL import Image

    from ..image.tiling import load_image_tiles

    data = load_point_benchmark(jsonl_path, image_root)
    preds = []
    for d in data:
        img = Image.open(d["image_path"]).convert("RGB")
        tiles = load_image_tiles(img, input_size, max_num=max_tiles)
        q = "<image>\n" + build_point_prompt(d["expression"])
        resp = chat.chat(q, tiles)
        preds.append({**d, "response": resp})
    gt = load_gt_points(jsonl_path)
    return evaluate_points_precision(
        preds, gt, radius=radius, normalized_scale=1000.0
    )


def point_in_mask(point, mask: np.ndarray) -> bool:
    """mask [H, W] bool/0-1; point (x, y) in image pixels."""
    x, y = int(round(point[0])), int(round(point[1]))
    h, w = mask.shape[:2]
    return 0 <= y < h and 0 <= x < w and bool(mask[y, x])


def evaluate_region_benchmark(
    chat,
    items: Sequence[Dict],  # {image_path, expression, mask|points, width, height}
    *,
    radius: float = 25.0,
    input_size: int = 448,
    max_tiles: int = 6,
) -> Dict[str, float]:
    """Where2place / PointArena: first predicted point must land inside the
    GT region mask (fallback: within `radius` px of a GT point)."""
    from PIL import Image

    from ..image.tiling import load_image_tiles

    correct = total = 0
    for d in items:
        img = Image.open(d["image_path"]).convert("RGB")
        tiles = load_image_tiles(img, input_size, max_num=max_tiles)
        q = "<image>\n" + build_point_prompt(d["expression"])
        resp = chat.chat(q, tiles)
        total += 1
        pts = parse_points(resp)
        if not pts:
            continue
        x, y = pts[0]
        x = x / 1000.0 * d["width"]
        y = y / 1000.0 * d["height"]
        if d.get("mask") is not None:
            ok = point_in_mask((x, y), np.asarray(d["mask"]))
        else:
            ok = point_in_radius((x, y), d["points"], radius)
        correct += int(ok)
    return {"accuracy": correct / max(total, 1), "num_evaluated": total,
            "num_correct": correct}


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

@dataclass
class BenchmarkSpec:
    name: str
    kind: str  # 'mc' | 'point' | 'region' | 'vsi'
    runner: Callable


def run_benchmark(name: str, chat, data_path: str, image_root: str = "",
                  **kw) -> Dict[str, float]:
    """Dispatch by benchmark name (the BASELINE.md embodied table)."""
    key = name.lower().replace("-", "_")
    if key in MC_BENCHMARKS:
        items = load_jsonl_benchmark(data_path, image_root)
        return evaluate_benchmark(chat, items, mode="multiple_choice", **kw)
    if key in POINT_BENCHMARKS:
        return evaluate_point_benchmark(chat, data_path, image_root, **kw)
    if key in REGION_BENCHMARKS:
        with open(data_path) as f:
            items = [json.loads(l) for l in f]
        for it in items:
            it.setdefault("image_path", os.path.join(image_root, it["image"]))
        return evaluate_region_benchmark(chat, items, **kw)
    if key in ("vsi", "vsi_bench"):
        items = load_jsonl_benchmark(data_path, image_root)
        return evaluate_vsi(chat, items, **kw)
    raise KeyError(f"unknown benchmark {name!r}")
