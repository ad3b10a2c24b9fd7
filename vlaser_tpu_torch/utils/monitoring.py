"""Timing and scalar logging (port of `Timer` and `MetricsWriter` of
vlaser_tpu/utils/monitoring.py; no jax)."""

from __future__ import annotations

import json
import os
import time


class Timer:
    """Seconds since the last reset (construction, or a call with
    reset=True)."""

    def __init__(self):
        self._start = time.perf_counter()

    def __call__(self, reset: bool = True) -> float:
        now = time.perf_counter()
        dt = now - self._start
        if reset:
            self._start = now
        return dt


class MetricsWriter:
    """Append-only JSONL scalar log (the reference's wandb / tensorboard
    role): one {"step": n, ...scalars} line a call, flushed at once so that
    a crash loses nothing. Only process 0 writes (process_index, 0 on one
    device)."""

    def __init__(self, path, process_index: int = 0):
        self._fh = None
        if process_index == 0:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def write(self, step: int, **scalars):
        if self._fh is None:
            return
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
