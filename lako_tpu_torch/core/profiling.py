"""Profiling hooks on ``torch.profiler``: the port of lako_tpu/core/profiling.py.

:func:`start_trace` records host and CUDA activity until the function it
returns is called, which writes a Chrome trace (``chrome://tracing``,
Perfetto) into the profile directory and returns its path.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity


def start_trace(profile_dir: str) -> Callable[[], str]:
    """Start tracing the CPU and, where the build supports it, CUDA; returns
    the function that stops the trace and writes it into ``profile_dir``."""
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    prof = torch.profiler.profile(activities=activities)
    prof.start()

    def stop() -> str:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        path = str(Path(profile_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        return path

    return stop


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """Trace the block into ``profile_dir``; a no-op when it is None."""
    if profile_dir is None:
        yield
        return
    stop = start_trace(profile_dir)
    try:
        yield
    finally:
        stop()


class StepTimer:
    """Rolling per-step wall-clock stats for train loops."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
        return dt

    @property
    def mean(self) -> float:
        n = self.count - self.warmup
        return self.total / n if n > 0 else float("nan")

    def annotate(self, name: str):
        return torch.profiler.record_function(name)
