"""RoboTwin HDF5 episode dataset + collator.

Parity surface: RoboTwin policy data_utils/
- load_data/hdf5_vla_dataset_read_all_data.py HDF5VLADataset(:16): episodes
  with head-camera RGB frames, 14-dim qpos, future action chunks (joint
  deltas), instruction per episode
- materialize.py get_vla_dataset_and_collator(:126) +
  PaddedCollatorForImageActionPrediction(:75)

Expected HDF5 schema per episode file (one file per episode):
  /observations/head_camera  [T, H, W, 3] uint8 (or JPEG-encoded bytes)
  /qpos                      [T, 14] float
  /action                    [T, 14] float (absolute or delta joint targets)
  attrs['instruction']       str
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class HDF5DatasetConfig:
    data_root: str
    chunk_size: int = 8  # action chunk (RoboTwin: 8)
    image_size: int = 224
    delta_actions: bool = True  # actions stored absolute -> emit deltas


class HDF5VLADataset:
    """Flat index over (episode, timestep) pairs; lazy HDF5 reads."""

    def __init__(self, cfg: HDF5DatasetConfig):
        self.cfg = cfg
        self.files = sorted(glob.glob(os.path.join(cfg.data_root, "**/*.hdf5"),
                                      recursive=True))
        assert self.files, f"no .hdf5 episodes under {cfg.data_root}"
        self.index: List = []
        import h5py

        self._lengths = []
        for fi, f in enumerate(self.files):
            with h5py.File(f, "r") as h:
                t = h["qpos"].shape[0]
            self._lengths.append(t)
            # each timestep with a full future chunk is a sample
            for ts in range(max(1, t - 1)):
                self.index.append((fi, ts))

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        import h5py

        cfg = self.cfg
        fi, ts = self.index[i]
        with h5py.File(self.files[fi], "r") as h:
            img = h["observations/head_camera"][ts]
            if img.dtype.kind in ("S", "O") or img.ndim == 1:  # encoded bytes
                from PIL import Image
                import io

                img = np.asarray(Image.open(io.BytesIO(bytes(img))).convert("RGB"))
            qpos = np.asarray(h["qpos"][ts], np.float32)
            t_total = h["action"].shape[0]
            idx = np.minimum(np.arange(ts, ts + cfg.chunk_size), t_total - 1)
            chunk = np.asarray(h["action"][:][idx], np.float32)
            if cfg.delta_actions:
                prev = np.concatenate(
                    [qpos[None], np.asarray(h["action"][:][idx[:-1]], np.float32)], 0
                )
                chunk = chunk - prev
            instruction = h.attrs.get("instruction", "complete the task")
            if isinstance(instruction, bytes):
                instruction = instruction.decode()
        if img.shape[0] != cfg.image_size:
            from PIL import Image

            img = np.asarray(
                Image.fromarray(img).resize(
                    (cfg.image_size, cfg.image_size), Image.BICUBIC
                )
            )
        return {
            "image": img.astype(np.uint8),
            "qpos": qpos,
            "actions": chunk,  # [chunk, 14]
            "instruction": str(instruction),
        }


def collate_robotwin(
    samples: List[Dict[str, np.ndarray]],
    builder,  # policy.parallel_decoding.SequenceBuilder
    tokenizer,
    image_normalizer,
) -> Dict[str, np.ndarray]:
    """PaddedCollatorForImageActionPrediction analogue: tokenize instruction,
    build the static parallel-decoding layout, normalize pixels."""
    max_text = builder.cfg.max_text_tokens
    text_ids = np.zeros((len(samples), max_text), np.int64)
    for i, s in enumerate(samples):
        ids = tokenizer(s["instruction"], add_special_tokens=False)["input_ids"]
        ids = ids[:max_text]
        text_ids[i, : len(ids)] = ids
    qpos = np.stack([s["qpos"] for s in samples])
    input_ids, mask = builder.build(text_ids, qpos)
    images = np.stack([s["image"] for s in samples])
    return {
        "input_ids": input_ids,
        "text_mask": mask,
        "pixel_values": image_normalizer(images).astype(np.float32),
        "actions": np.stack([s["actions"] for s in samples]),
    }
