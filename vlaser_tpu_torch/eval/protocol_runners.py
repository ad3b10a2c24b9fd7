"""Chat-driven runners for the benchmark-specific protocols.

One function per protocol family, all sharing the batched
`VlaserChat.batch_chat` loop from eval/vlm_benchmarks.py. Inputs are jsonl
files (schemas documented per loader) so the runners stay independent of
where the benchmark archives live.

Parity: these route prompts/metrics through the protocol modules
(mc_protocols / vqa_metrics / grounding_bbox / caption_metrics /
math_verify), each of which cites its reference script.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from .caption_metrics import CAPTION_PROMPT, evaluate_captions
from .grounding_bbox import build_grounding_question, evaluate_grounding
from .math_verify import mathvista_score
from .mc_protocols import (build_mc_question, mc_post_process,
                           mme_suite_scores, mvbench_accuracy,
                           mvbench_build_item)
from .vqa_metrics import (BASE_PROMPT, EVALUATORS, METRIC_BY_DATASET,
                          VIZWIZ_PROMPT, post_process_vqa)


def _read_jsonl(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def _chat_batches(
    chat, questions: Sequence[str], images: Sequence,
    *, batch_size: int = 8, max_tiles: int = 12, image_size: int = 448,
) -> List[str]:
    """Shared batched loop (vlm_benchmarks.evaluate_benchmark's core).
    `images` entries: None, a PIL image, or a list of PIL images (video)."""
    from ..image.tiling import load_image_tiles

    outs: List[str] = []
    for i in range(0, len(questions), batch_size):
        qs = list(questions[i : i + batch_size])
        tiles_list, num_patches = [], []
        for img in images[i : i + batch_size]:
            if img is None:
                num_patches.append(0)
                continue
            if isinstance(img, list):
                # multi-image/video: one per-frame tile count per <image>
                # tag so batch_chat expands every placeholder
                per_img = []
                for fr in img:
                    tiles = load_image_tiles(fr, image_size,
                                             max_num=max_tiles)
                    tiles_list.append(tiles)
                    per_img.append(len(tiles))
                num_patches.append(per_img)
            else:
                tiles = load_image_tiles(img, image_size, max_num=max_tiles)
                tiles_list.append(tiles)
                num_patches.append(len(tiles))
        pixel_values = (
            np.concatenate(tiles_list, axis=0) if tiles_list else None
        )
        outs.extend(
            chat.batch_chat(qs, pixel_values, num_patches_list=num_patches)
        )
    return outs


def _open_image(path: str, root: str = ""):
    import os

    from PIL import Image

    return Image.open(os.path.join(root, path)).convert("RGB")


# --------------------------------------------------------------- MC family


def run_mc_benchmark(
    chat, data_path: str, image_root: str = "", *,
    prompt: Optional[str] = None, **kw,
) -> Dict[str, float]:
    """MMMU / ScienceQA / SEED-style: jsonl rows {image?, question,
    choices: [str], answer: letter}. Letter post-processing per
    mc_protocols.mc_post_process."""
    rows = _read_jsonl(data_path)
    questions, images, options_list = [], [], []
    for r in rows:
        q, options = build_mc_question(
            r["question"], r.get("choices") or r.get("options") or [], prompt
        )
        if r.get("images"):
            # multi-image MC (mmiu / mirb / mantis style): one <image> tag
            # per frame, Image-N labels like the reference multi-image
            # preprocessors
            imgs = [_open_image(p, image_root) for p in r["images"]]
            tags = "\n".join(
                f"Image-{i + 1}: <image>" for i in range(len(imgs))
            )
            q = tags + "\n" + q
            images.append(imgs)
        elif r.get("image"):
            q = "<image>\n" + q
            images.append(_open_image(r["image"], image_root))
        else:
            images.append(None)
        questions.append(q)
        options_list.append(options)
    preds = _chat_batches(chat, questions, images, **kw)
    correct = sum(
        mc_post_process(p, o) == str(r["answer"]).strip()
        for p, o, r in zip(preds, options_list, rows)
    )
    return {"accuracy": correct / max(len(rows), 1),
            "num_evaluated": len(rows)}


def run_mmvp(chat, data_path: str, image_root: str = "", **kw) -> Dict:
    """MMVP pair accuracy (evaluate_mmvp.py:207-228): questions come in
    consecutive pairs over near-duplicate images; a pair scores only when
    BOTH answers are right. Rows: {image, question, choices, answer}."""
    rows = _read_jsonl(data_path)
    questions, images, options_list = [], [], []
    for r in rows:
        q, options = build_mc_question(
            r["question"], r.get("choices") or r.get("options") or []
        )
        questions.append("<image>\n" + q)
        images.append(_open_image(r["image"], image_root))
        options_list.append(options)
    preds = _chat_batches(chat, questions, images, **kw)
    ok = [
        mc_post_process(p, o) == str(r["answer"]).strip()
        for p, o, r in zip(preds, options_list, rows)
    ]
    pairs = [ok[i] and ok[i + 1] for i in range(0, len(ok) - 1, 2)]
    return {
        "pair_accuracy": sum(pairs) / max(len(pairs), 1),
        "question_accuracy": sum(ok) / max(len(ok), 1),
        "num_pairs": len(pairs),
    }


def run_mme(chat, data_path: str, image_root: str = "", **kw) -> Dict:
    """MME: jsonl rows {task, image, question, answer(yes|no)} — two rows
    per image per task. Scores per mc_protocols.mme_suite_scores."""
    rows = _read_jsonl(data_path)
    questions = ["<image>\n" + r["question"] for r in rows]
    images = [_open_image(r["image"], image_root) for r in rows]
    preds = _chat_batches(chat, questions, images, **kw)
    by_task: Dict[str, Dict[str, List]] = {}
    for r, p in zip(rows, preds):
        by_task.setdefault(r["task"], {}).setdefault(r["image"], []).append(
            (str(r["answer"]).lower(), p)
        )
    task_pairs = {
        t: [pair for pair in imgs.values() if len(pair) == 2]
        for t, imgs in by_task.items()
    }
    dropped = sum(
        len(pair) for imgs in by_task.values()
        for pair in imgs.values() if len(pair) != 2
    )
    out = mme_suite_scores(task_pairs)
    if dropped:
        # MME requires exactly two questions per image (calculation.py
        # asserts it); malformed groups are excluded, never silently folded
        import warnings

        warnings.warn(
            f"run_mme: {dropped} rows dropped — their image did not group "
            "into exactly 2 questions per task"
        )
        out["dropped_rows"] = dropped
    return out


def run_mvbench(
    chat, data_path: str, frames_root: str = "", *, num_segments: int = 16,
    **kw,
) -> Dict[str, float]:
    """MVBench on the frames-directory convention: json rows {task_type,
    video(frames dir), question, candidates, answer, start?, end?, fps?}."""
    import os

    rows = _read_jsonl(data_path)
    questions, images, answers, tasks = [], [], [], []
    from PIL import Image

    for r in rows:
        bound = (r["start"], r["end"]) if "start" in r and "end" in r else None
        item = mvbench_build_item(
            r, os.path.join(frames_root, r["video"]),
            num_segments=num_segments, bound=bound, fps=r.get("fps", 3.0),
        )
        questions.append(item.question)
        images.append([Image.open(p).convert("RGB")
                       for p in item.frame_paths])
        answers.append(item.answer)
        tasks.append(item.task_type or r.get("task_type", ""))
    # one tile per frame (the reference evaluates video at max_num=1)
    kw.setdefault("max_tiles", 1)
    preds = _chat_batches(chat, questions, images, **kw)
    return mvbench_accuracy(list(zip(tasks, preds, answers)))


# --------------------------------------------------------------- VQA family


def run_vqa(
    chat, data_path: str, image_root: str = "", *,
    metric: str = "vqa_score", dataset: Optional[str] = None, **kw,
) -> Dict[str, float]:
    """VQA family: jsonl rows {image, question, annotation: str|[str]}.
    metric in EVALUATORS (or derived from `dataset` via METRIC_BY_DATASET).
    Applies the reference's single-word prompt + free-form post-process."""
    if dataset is not None:
        metric = METRIC_BY_DATASET.get(dataset, metric)
    rows = _read_jsonl(data_path)
    prompt = VIZWIZ_PROMPT if (dataset or "").startswith("vizwiz") \
        else BASE_PROMPT
    questions = [
        "<image>\n" + r["question"].strip() + " " + prompt for r in rows
    ]
    images = [_open_image(r["image"], image_root) for r in rows]
    preds = _chat_batches(chat, questions, images, **kw)
    entries = []
    for r, p in zip(rows, preds):
        ans = post_process_vqa(p) if metric == "vqa_score" else p.strip()
        entries.append({"answer": ans, "annotation": r["annotation"]})
    return {
        metric: EVALUATORS[metric](entries),
        "num_evaluated": len(entries),
    }


# --------------------------------------------------------------- grounding


def run_grounding(
    chat, data_path: str, image_root: str = "", **kw
) -> Dict[str, float]:
    """RefCOCO family: jsonl rows {image, sent, bbox, width, height}."""
    rows = _read_jsonl(data_path)
    questions = [
        "<image>\n" + build_grounding_question(r["sent"]) for r in rows
    ]
    images = [_open_image(r["image"], image_root) for r in rows]
    kw.setdefault("max_tiles", 6)  # evaluate_grounding.py default max_num=6
    preds = _chat_batches(chat, questions, images, **kw)
    outputs = [
        {"answer": p, "gt_bbox": r["bbox"],
         "hw": (r["height"], r["width"])}
        for p, r in zip(preds, rows)
    ]
    return evaluate_grounding(outputs)


# ----------------------------------------------------------------- caption


def run_caption(
    chat, data_path: str, image_root: str = "", **kw
) -> Dict[str, float]:
    """Caption: jsonl rows {image, references: [str]}."""
    rows = _read_jsonl(data_path)
    questions = ["<image>\n" + CAPTION_PROMPT] * len(rows)
    images = [_open_image(r["image"], image_root) for r in rows]
    preds = _chat_batches(chat, questions, images, **kw)
    return evaluate_captions([
        {"caption": p, "references": r["references"]}
        for p, r in zip(preds, rows)
    ])


# --------------------------------------------------------------- mathvista


def run_mathvista(
    chat, data_path: str, image_root: str = "", **kw
) -> Dict[str, float]:
    """MathVista testmini: jsonl rows {image?, query, question_type,
    answer_type, choices?, precision?, answer}."""
    rows = _read_jsonl(data_path)
    questions, images = [], []
    for r in rows:
        q = r.get("query") or r["question"]
        if r.get("image"):
            q = "<image>\n" + q
            images.append(_open_image(r["image"], image_root))
        else:
            images.append(None)
        questions.append(q)
    preds = _chat_batches(chat, questions, images, **kw)
    return mathvista_score([{**r, "response": p}
                            for r, p in zip(rows, preds)])


RUNNERS = {
    "mmmu": run_mc_benchmark,
    "scienceqa": run_mc_benchmark,
    "seed": run_mc_benchmark,
    "mmvp": run_mmvp,
    "mme": run_mme,
    "mvbench": run_mvbench,
    "vqa": run_vqa,
    "refcoco": run_grounding,
    "caption": run_caption,
    "mathvista": run_mathvista,
}
