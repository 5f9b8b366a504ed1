"""Checkpoint on SIGTERM (the port's copy of ``slime_tpu/train/preemption.py``).

A preemptible host gets SIGTERM and a short grace window before it is
reclaimed. ``PreemptionGuard`` installs a handler that only sets a flag
(async-signal-safe, no I/O in the handler); the trainer polls it between
steps, where the train state is consistent, saves and returns.
"""
from __future__ import annotations

import signal
import threading
from typing import Iterable


class PreemptionGuard:
    """Context manager: latch termination signals into a pollable flag.

    Only the main thread may install signal handlers (a CPython rule);
    ``install_ok`` says whether this is it, so a trainer driven from another
    thread runs unguarded."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._flag = threading.Event()
        self._signals = tuple(signals)
        self._prev = {}

    @staticmethod
    def install_ok() -> bool:
        return threading.current_thread() is threading.main_thread()

    def __enter__(self) -> "PreemptionGuard":
        if self.install_ok():
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}

    def _on_signal(self, signum, frame) -> None:
        self._flag.set()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def trigger(self) -> None:
        """Mark as preempted from code (tests, cooperative shutdown)."""
        self._flag.set()
