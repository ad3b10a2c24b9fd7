"""Timing, logging and profiling utilities (port of
vlaser_tpu/utils/monitoring.py; no jax).

Parity surface: src/utils/monitor.py (Timer, log_execution_time,
log_allocated_gpu_memory, MainRankFilter). `profile_trace` wraps
torch.profiler, `log_device_memory` reads the CUDA caching allocator.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import time
from typing import Optional

log = logging.getLogger("vlaser_tpu_torch")


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


def log_execution_time(logger=None):
    """Decorator logging wall time of the wrapped call (monitor.py:15)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            (logger or log).info(
                "%s took %.3fs", fn.__name__, time.perf_counter() - t0
            )
            return out

        return wrapped

    return deco


def log_device_memory(tag: str = ""):
    """Device memory of every CUDA device: the bytes the caching allocator
    holds for tensors (`allocated_bytes.all.current`) against the device's
    total (log_allocated_gpu_memory analogue). Logs nothing without a
    card."""
    import torch

    if not torch.cuda.is_available():
        return
    for i in range(torch.cuda.device_count()):
        used = torch.cuda.memory_stats(i).get(
            "allocated_bytes.all.current", 0) / 2**30
        free, total = torch.cuda.mem_get_info(i)
        log.info("%s cuda:%d: %.2f/%.2f GiB allocated (%.2f GiB free)",
                 tag, i, used, total / 2**30, free / 2**30)


class MainProcessFilter(logging.Filter):
    """Only log from process 0 (MainRankFilter analogue): the rank of
    torch.distributed when it is initialized, else 0."""

    def __init__(self, process_index: Optional[int] = None):
        super().__init__()
        if process_index is None:
            import torch.distributed as dist

            process_index = (dist.get_rank() if dist.is_available()
                             and dist.is_initialized() else 0)
        self.process_index = process_index

    def filter(self, record):
        return self.process_index == 0


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """torch.profiler over the block (CPU and, with a card, CUDA
    activity), its Chrome trace written into `logdir`; no-op when logdir
    is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
