"""Tracing and throughput counters.

Counterpart of ``bridgerl_tpu/utils/profiling.py``: ``trace(log_dir)``
profiles a region with ``torch.profiler`` (host and, where a card is
present, CUDA activity) and writes a Chrome trace into ``log_dir``, which
Perfetto and ``chrome://tracing`` open; ``StepTimer`` counts steps/s and
windows/s per card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the enclosed region into ``log_dir/trace.json``; a no-op
    when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


class StepTimer:
    """Steps/s since the last reset, and windows/s per card at
    ``window_batch`` windows a step."""

    def __init__(self, window_batch: int = 0):
        self.window_batch = window_batch
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, n: int = 1) -> None:
        self._steps += n

    @property
    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0

    @property
    def windows_per_sec_per_chip(self) -> float:
        return self.steps_per_sec * self.window_batch / max(torch.cuda.device_count(), 1)
