"""Preemption-safe training: checkpoint on SIGTERM (`PreemptionGuard` of
vlaser_tpu/utils/preemption.py, standard library only).

Cluster schedulers deliver SIGTERM with a grace window before eviction.
The guard turns the signal into a clean final checkpoint: the trainers
poll `should_stop()` once per step and, when it is set, write a last
checkpoint and return instead of dying mid-step. The port trains in one
process, so `should_stop` reads the local flag (the JAX guard OR-reduces it
across processes only when there are several).
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Context manager: installs handlers for `signals` that set a flag
    (chaining any previous handler) and restores them on exit. Safe to use
    from non-main threads — installation is skipped with a warning (signal
    handlers are main-thread-only in CPython) and `request_stop()` still
    works programmatically."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._prev = {}
        self._event = threading.Event()

    def __enter__(self):
        if threading.current_thread() is not threading.main_thread():
            logger.warning(
                "PreemptionGuard outside the main thread: signal handlers "
                "not installed (request_stop() remains available)"
            )
            return self
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        return False

    def _handle(self, signum, frame):
        logger.warning("signal %s received: finishing step, then "
                       "checkpointing and exiting", signum)
        self._event.set()
        prev = self._prev.get(signum)
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    def request_stop(self):
        """Programmatic preemption (tests, external watchdogs)."""
        self._event.set()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def should_stop(self) -> bool:
        """True once a signal arrived or request_stop() was called."""
        return self._event.is_set()
