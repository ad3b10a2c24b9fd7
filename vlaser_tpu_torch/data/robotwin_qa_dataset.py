"""RoboTwin episode-frame folder dataset for QA generation.

Parity surface: data-pipeline/RoboTwin-QA/QA_dataset.py
AlohaAgileXFolderDataset — walks
  <images_root>/<task>/<domain>/frames/<episode*>/<frame images>
with domain/task filters, resolves a per-episode instruction from JSON files
({"seen": [...], "unseen": [...]}) with stable per-episode sampling, and
yields frames ready for the QA generators (data/qa_generation.py).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp")


@dataclass
class RoboTwinQAFolderConfig:
    images_root: str
    include_domains: Sequence[str] = (
        "Aloha-AgileX", "Aloha-AgileX_domain_randomized",
    )
    include_tasks: Optional[Sequence[str]] = None
    exclude_tasks: Optional[Sequence[str]] = None
    frames_dirname: str = "frames"
    episode_glob: str = "episode*"
    max_images: Optional[int] = None
    # <instructions_root>/<task>/<episode>.json with {"seen": [...], ...}
    instructions_root: Optional[str] = None
    instruction_source: str = "seen"  # seen | unseen | any
    default_instruction_tpl: str = (
        "Task: {task}. Describe the scene and how to safely complete it."
    )
    resize_to: Optional[Tuple[int, int]] = (448, 448)
    stable_sampling: bool = True


def parse_triplet(path: str, frames_dirname: str = "frames") -> Tuple[str, str, str]:
    """.../<task>/<domain>/frames/<episode>/img.jpg -> (task, domain, episode)
    (QA_dataset.py:63-114)."""
    parts = os.path.normpath(path).split(os.sep)
    task = domain = episode = ""
    for j, seg in enumerate(parts):
        if seg == frames_dirname:
            if j + 1 < len(parts):
                episode = parts[j + 1]
            if j >= 1:
                domain = parts[j - 1]
            if j >= 2:
                task = parts[j - 2]
            break
    if not episode:
        for seg in parts:
            if seg.lower().startswith("episode"):
                episode = seg
                break
    if not episode and len(parts) >= 2:
        episode = parts[-2]
    return task, domain, episode


class RoboTwinEpisodeFolderDataset:
    """Flat index over frame images; items carry the resolved instruction."""

    def __init__(self, cfg: RoboTwinQAFolderConfig):
        self.cfg = cfg
        if not os.path.isdir(cfg.images_root):
            raise FileNotFoundError(f"images_root missing: {cfg.images_root}")
        self.files = self._collect()
        if cfg.max_images:
            self.files = self.files[: cfg.max_images]
        if not self.files:
            raise FileNotFoundError(
                f"no frames under {cfg.images_root} "
                f"(domains={list(cfg.include_domains)}, "
                f"frames_dirname={cfg.frames_dirname!r})"
            )
        self._instruction_cache: Dict[Tuple[str, str], List[str]] = {}

    def _collect(self) -> List[str]:
        cfg = self.cfg
        out: List[str] = []
        for task in sorted(os.listdir(cfg.images_root)):
            tdir = os.path.join(cfg.images_root, task)
            if not os.path.isdir(tdir):
                continue
            if cfg.include_tasks and task not in cfg.include_tasks:
                continue
            if cfg.exclude_tasks and task in cfg.exclude_tasks:
                continue
            for domain in cfg.include_domains:
                pattern = os.path.join(
                    tdir, domain, cfg.frames_dirname, cfg.episode_glob, "*"
                )
                out.extend(
                    f for f in glob.glob(pattern)
                    if f.lower().endswith(IMAGE_EXTS)
                )
        return sorted(out)

    def __len__(self):
        return len(self.files)

    def _instructions(self, task: str, episode: str) -> List[str]:
        cfg = self.cfg
        key = (task, episode)
        if key in self._instruction_cache:
            return self._instruction_cache[key]
        opts: List[str] = []
        if cfg.instructions_root:
            path = os.path.join(cfg.instructions_root, task, f"{episode}.json")
            if os.path.exists(path):
                with open(path) as f:
                    data = json.load(f)
                if cfg.instruction_source == "any":
                    opts = list(data.get("seen", [])) + list(data.get("unseen", []))
                else:
                    opts = list(data.get(cfg.instruction_source, []))
        if not opts:
            opts = [cfg.default_instruction_tpl.format(task=task)]
        self._instruction_cache[key] = opts
        return opts

    def __getitem__(self, i: int) -> Dict:
        cfg = self.cfg
        path = self.files[i]
        task, domain, episode = parse_triplet(path, cfg.frames_dirname)
        opts = self._instructions(task, episode)
        if cfg.stable_sampling:
            # same episode -> same instruction across runs (QA_dataset.py
            # stable_sampling)
            h = int(hashlib.md5(f"{task}/{episode}".encode()).hexdigest(), 16)
            instruction = opts[h % len(opts)]
        else:
            import random

            instruction = random.choice(opts)

        from PIL import Image

        img = Image.open(path).convert("RGB")
        if cfg.resize_to is not None:
            img = img.resize(cfg.resize_to, Image.BICUBIC)
        return {
            "image": np.asarray(img, np.uint8),
            "image_path": path,
            "task": task,
            "domain": domain,
            "episode": episode,
            "instruction": instruction,
        }
