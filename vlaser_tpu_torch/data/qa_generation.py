"""In-domain QA data generation + quality filtering (a copy of
vlaser_tpu/data/qa_generation.py; numpy, PIL imported only where a frame's
JPEG is saved).

Parity surface: data-pipeline/src/agent/ --
- train_general_qa.py (:39-119): per-frame QA generation over robot episodes
  (prompted VLM emits 'Question:/Answer:' pairs, parsed into SFT conversation
  items with <image> placeholders)
- train_grounding.py: visual-grounding QA emitting <ref>expr</ref> + [x, y]
  points
- train_spatial_intelligence.py: spatial-relation QA
- filter.py (:45-341): VLM-scored quality filtering with a numeric threshold

The reference drives a vLLM server; generation here goes through any
`generate_fn` (e.g. inference.chat.VlaserChat.batch_chat or
serve.engine_chat.EngineChat on the card, or an HTTP endpoint). Outputs
are JSONL items directly consumable by data.chat_dataset.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

GENERAL_QA_PROMPT = """You are an AI assistant analyzing robot arm camera images and task instructions.

Given the robot arm camera image and the task instruction: "{instruction}"

Please generate a natural question-answer pair about this image and task. The question should be open-ended and could ask about:
- Objects visible in the image
- The robot arm's current state or position
- How to accomplish the given task
- What obstacles or challenges might exist
- Safety considerations for the task

Please respond in the following format:
Question: [Your question here]
Answer: [Your detailed answer here]"""

GROUNDING_QA_PROMPT = """You are an AI assistant for visual grounding in robot manipulation scenes.

Given the robot camera image and the task instruction: "{instruction}"

Identify one task-relevant object in the image and give its pixel location.
Respond in the following format:
Question: Where is <ref>[object expression]</ref> in the image? Answer with a point.
Answer: <ref>[object expression]</ref> [x, y]"""

SPATIAL_QA_PROMPT = """You are an AI assistant analyzing spatial relations in robot manipulation scenes.

Given the robot camera image and the task instruction: "{instruction}"

Generate a question-answer pair about SPATIAL relationships (left/right, near/far, above/below, distances, relative positions between objects or between the gripper and objects).
Respond in the following format:
Question: [Your spatial question here]
Answer: [Your detailed answer here]"""

FILTER_PROMPT = """You are a strict data-quality rater. Rate the following question-answer pair about a robot camera image on a scale of 1-10 (10 = accurate, specific, useful for training; 1 = wrong or useless).

Question: {question}
Answer: {answer}

Respond with only: Score: [number]"""


def parse_qa_response(text: str) -> Optional[Dict[str, str]]:
    """'Question: ... / Answer: ...' -> dict (train_general_qa.py:119-160)."""
    q_match = re.search(r"Question:\s*(.+?)(?=\n\s*Answer:|\Z)", text, re.S)
    a_match = re.search(r"Answer:\s*(.+)", text, re.S)
    if not q_match or not a_match:
        return None
    q = q_match.group(1).strip()
    a = a_match.group(1).strip()
    if not q or not a:
        return None
    return {"question": q, "answer": a}


def parse_score(text: str) -> Optional[float]:
    m = re.search(r"Score:\s*\[?\s*(\d+(?:\.\d+)?)", text)
    if m:
        return float(m.group(1))
    m = re.search(r"\b(\d+(?:\.\d+)?)\s*/\s*10", text)
    return float(m.group(1)) if m else None


@dataclass
class QAGenConfig:
    kind: str = "general"  # general | grounding | spatial | all
    images_dir: str = "qa_images"
    batch_size: int = 16


PROMPTS = {
    "general": GENERAL_QA_PROMPT,
    "grounding": GROUNDING_QA_PROMPT,
    "spatial": SPATIAL_QA_PROMPT,
}


class QAGenerator:
    """generate_fn(images [B,H,W,3] uint8, prompts [B]) -> responses [B].

    shared_image_fn(prompts [K], image [H,W,3]) -> responses [K]: optional
    fast path for kind="all" — K kind-prompts about ONE frame (the
    reference runs general/spatial/grounding generators as separate vLLM
    jobs over the same episodes; data-pipeline/slurm/data_generator.sh).
    EngineChat.batch_chat_shared_image prefills the frame's image block
    once and serves all K prompts against the cached prefix."""

    def __init__(self, generate_fn: Callable, cfg: QAGenConfig,
                 shared_image_fn: Optional[Callable] = None):
        self.generate_fn = generate_fn
        self.cfg = cfg
        self.shared_image_fn = shared_image_fn
        os.makedirs(cfg.images_dir, exist_ok=True)
        self._idx = 0

    def generate(
        self, frames: Iterable, out_path: str
    ) -> int:
        """frames: iterable of {image [H,W,3] uint8, instruction str}.
        Writes SFT-format JSONL; returns number of items written."""
        written = 0
        buf_imgs, buf_meta = [], []
        kinds = (
            tuple(PROMPTS) if self.cfg.kind == "all" else (self.cfg.kind,)
        )

        def write_item(fout, img, fname, resp):
            nonlocal written
            qa = parse_qa_response(resp)
            if qa is None:
                return fname
            if fname is None:
                from PIL import Image

                fname = f"qa_{self._idx:06d}.jpg"
                Image.fromarray(img).save(
                    os.path.join(self.cfg.images_dir, fname)
                )
            item = {
                "id": self._idx,
                "image": fname,
                "width": int(img.shape[1]),
                "height": int(img.shape[0]),
                "conversations": [
                    {"from": "human", "value": f"<image>\n{qa['question']}"},
                    {"from": "gpt", "value": qa["answer"]},
                ],
            }
            fout.write(json.dumps(item) + "\n")
            self._idx += 1
            written += 1
            return fname

        def flush(fout):
            if not buf_imgs:
                return
            if self.shared_image_fn is not None and len(kinds) > 1:
                # one image prefill per frame, all kind-prompts against it
                for img, meta in zip(buf_imgs, buf_meta):
                    prompts = [PROMPTS[k].format(instruction=meta["instruction"])
                               for k in kinds]
                    fname = None
                    for resp in self.shared_image_fn(prompts, img):
                        fname = write_item(fout, img, fname, resp)
            else:
                prompts, imgs = [], []
                for img, meta in zip(buf_imgs, buf_meta):
                    for k in kinds:
                        prompts.append(
                            PROMPTS[k].format(instruction=meta["instruction"])
                        )
                        imgs.append(img)
                responses = self.generate_fn(np.stack(imgs), prompts)
                for i, img in enumerate(buf_imgs):
                    fname = None
                    for j in range(len(kinds)):
                        resp = responses[i * len(kinds) + j]
                        fname = write_item(fout, img, fname, resp)
            buf_imgs.clear()
            buf_meta.clear()

        with open(out_path, "w") as fout:
            for frame in frames:
                buf_imgs.append(np.asarray(frame["image"], np.uint8))
                buf_meta.append(frame)
                if len(buf_imgs) >= self.cfg.batch_size:
                    flush(fout)
            flush(fout)
        return written


def quality_filter(
    items: Sequence[Dict],
    score_fn: Callable[[List[str]], List[str]],  # prompts -> responses
    threshold: float = 6.0,
    batch_size: int = 32,
) -> List[Dict]:
    """VLM-scored filtering (filter.py:45-341): keep items scoring >= threshold."""
    kept = []
    for i in range(0, len(items), batch_size):
        chunk = items[i : i + batch_size]
        prompts = []
        for it in chunk:
            convs = it["conversations"]
            q = convs[0]["value"].replace("<image>\n", "")
            a = convs[1]["value"]
            prompts.append(FILTER_PROMPT.format(question=q, answer=a))
        for it, resp in zip(chunk, score_fn(prompts)):
            score = parse_score(resp)
            if score is not None and score >= threshold:
                it = dict(it)
                it["quality_score"] = score
                kept.append(it)
    return kept
