"""Batched VLM benchmark evaluation (the embodied-reasoning sweep).

Parity surface: Vlaser_VLM/internvl_chat/eval/* — the reference ships one
script per benchmark (vqa, mmbench, pope, ERQA, EgoPlan, VSI, ... 23 dirs,
SURVEY.md §2.3); they all share the same skeleton: jsonl/dataset iteration ->
dynamic tiling -> model.chat -> answer extraction -> accuracy. Here that
skeleton is one harness with pluggable answer extractors:

- multiple-choice (mmbench/ERQA/EgoPlan/VSI style): first A-E letter match
- exact / substring match (VQA style)
- point grounding lives in eval/point_eval.py

Items are batched through VlaserChat.batch_chat with tile-count bucketing so
repeated batches reuse compiled programs.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


def extract_mc_answer(response: str, choices: Sequence[str] = "ABCDE") -> Optional[str]:
    """First standalone choice letter (eval scripts' common post-processing)."""
    m = re.search(rf"\b([{''.join(choices)}])\b", response.strip().upper())
    return m.group(1) if m else None


def exact_match(response: str, answer: str) -> bool:
    return response.strip().lower() == answer.strip().lower()


def substring_match(response: str, answer: str) -> bool:
    return answer.strip().lower() in response.strip().lower()


@dataclass
class BenchmarkItem:
    question: str
    answer: str
    image: Optional[object] = None  # PIL image or None
    choices: Optional[List[str]] = None


def load_jsonl_benchmark(path: str, image_root: str = "") -> List[BenchmarkItem]:
    """PIL is imported only for a row that names an image, so a text-only
    file loads on a machine without it."""
    import os

    items = []
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            img = None
            if d.get("image"):
                from PIL import Image

                img = Image.open(os.path.join(image_root, d["image"])).convert("RGB")
            items.append(
                BenchmarkItem(
                    question=d["question"], answer=str(d["answer"]),
                    image=img, choices=d.get("choices"),
                )
            )
    return items


def format_mc_question(item: BenchmarkItem) -> str:
    q = item.question
    if item.choices:
        opts = "\n".join(
            f"{chr(ord('A') + i)}. {c}" for i, c in enumerate(item.choices)
        )
        q = f"{q}\n{opts}\nAnswer with the option's letter from the given choices directly."
    return q


def evaluate_benchmark(
    chat,  # inference.chat.VlaserChat
    items: Sequence[BenchmarkItem],
    *,
    mode: str = "multiple_choice",  # multiple_choice | exact | substring
    batch_size: int = 8,
    max_tiles: int = 12,
    image_size: int = 448,
) -> Dict[str, float]:
    from ..image.tiling import load_image_tiles

    correct = total = 0
    responses = []
    for i in range(0, len(items), batch_size):
        chunk = items[i : i + batch_size]
        questions, tiles_list, num_patches = [], [], []
        for it in chunk:
            q = format_mc_question(it) if mode == "multiple_choice" else it.question
            if it.image is not None:
                tiles = load_image_tiles(it.image, image_size, max_num=max_tiles)
                tiles_list.append(tiles)
                num_patches.append(len(tiles))
                q = "<image>\n" + q
            else:
                num_patches.append(0)
            questions.append(q)
        pixel_values = (
            np.concatenate(tiles_list, axis=0) if tiles_list else None
        )
        outs = chat.batch_chat(questions, pixel_values, num_patches_list=num_patches)
        for it, resp in zip(chunk, outs):
            responses.append(resp)
            total += 1
            if mode == "multiple_choice":
                ok = extract_mc_answer(resp) == it.answer.strip().upper()
            elif mode == "exact":
                ok = exact_match(resp, it.answer)
            else:
                ok = substring_match(resp, it.answer)
            correct += int(ok)
    return {
        "accuracy": correct / max(total, 1),
        "num_evaluated": total,
        "responses": responses,
    }


# --------------------------------------------------------------------------
# Benchmark-specific loaders/metrics (the reference's per-benchmark dirs)
# --------------------------------------------------------------------------

MMBENCH_PROMPT = {
    "en": "Answer with the option's letter from the given choices directly.",
    "cn": "请直接回答选项字母。",
}


def load_mmbench_tsv(path: str, language: str = "en") -> List[BenchmarkItem]:
    """MMBench TSV (base64 images, hint + A-E options)
    (eval/mmbench/evaluate_mmbench.py:77-135): the question is pre-assembled
    exactly as the reference does (hint newline question, per-option lines,
    trailing language prompt), so format_mc_question must not re-wrap it."""
    import base64 as b64
    import csv
    import io

    from PIL import Image

    items = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            q = row["question"]
            hint = row.get("hint") or ""
            if hint and hint.lower() != "nan":
                q = hint + "\n" + q
            for cand in "ABCDE":
                v = row.get(cand) or ""
                if v and v.lower() != "nan":
                    q += f"\n{cand}. {v}"
            q += "\n" + MMBENCH_PROMPT[language]
            img = Image.open(io.BytesIO(b64.b64decode(row["image"]))).convert("RGB")
            items.append(BenchmarkItem(
                question=q, answer=str(row.get("answer") or ""), image=img,
                choices=None,  # options already inlined
            ))
    return items


def load_pope(question_file: str, image_root: str = "") -> List[BenchmarkItem]:
    """POPE jsonl: {question_id?, image, text, label(yes/no)}."""
    import os

    from PIL import Image

    items = []
    with open(question_file) as f:
        for line in f:
            d = json.loads(line)
            img = Image.open(
                os.path.join(image_root, d["image"])
            ).convert("RGB")
            items.append(BenchmarkItem(
                question=d.get("text") or d["question"],
                answer=str(d.get("label", d.get("answer", ""))).lower(),
                image=img,
            ))
    return items


def pope_yes_no(text: str) -> str:
    """eval/pope/eval_pope.py:10-21 mapping: first sentence, 'no'/'not' wins."""
    if "." in text:
        text = text.split(".")[0]
    words = text.replace(",", "").split(" ")
    return "no" if ("No" in words or "not" in words or "no" in words) else "yes"


def evaluate_pope(chat, items: Sequence[BenchmarkItem], **kw) -> Dict[str, float]:
    """POPE metrics: accuracy + precision/recall/F1 over yes/no
    (eval_pope.py:38-65; yes = positive class)."""
    res = evaluate_benchmark(chat, items, mode="exact", **kw)
    tp = tn = fp = fn = 0
    yes = 0
    for it, resp in zip(items, res["responses"]):
        pred = pope_yes_no(resp)
        label = "no" if "no" in it.answer else "yes"
        yes += int(pred == "yes")
        if pred == "yes" and label == "yes":
            tp += 1
        elif pred == "no" and label == "no":
            tn += 1
        elif pred == "yes" and label == "no":
            fp += 1
        else:
            fn += 1
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    n = max(len(items), 1)
    return {
        "accuracy": (tp + tn) / n,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "yes_ratio": yes / n,
    }
