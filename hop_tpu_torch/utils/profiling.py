"""Profiling hooks: torch.profiler traces and step timing (port of
hop_tpu/utils/profiling.py).

`trace(logdir)` records the host (and, where a card is present, CUDA
kernels through CUPTI) and writes a Chrome trace, `logdir/trace.json`,
viewable in Perfetto or chrome://tracing; `start_trace` / `stop_trace` are
its two halves for a window that does not fit a `with` block (the training
loop's steps 2-5, `--profile-dir`). `StepTimer` gives s/iter percentiles.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def start_trace() -> torch.profiler.profile:
    """A started profiler of the CPU and, where a card is present, CUDA."""
    profiler = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        *([torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available() else [])])
    profiler.start()
    return profiler


def stop_trace(profiler: torch.profiler.profile, logdir: str) -> str:
    """Wait for the card, stop `profiler` and write `logdir/trace.json`;
    returns its path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    profiler.stop()
    Path(logdir).mkdir(parents=True, exist_ok=True)
    path = str(Path(logdir) / "trace.json")
    profiler.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Trace the block into `logdir` (default: hop_tpu_torch_trace in the
    temporary directory); yields the directory."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "hop_tpu_torch_trace")
    profiler = start_trace()
    try:
        yield logdir
    finally:
        stop_trace(profiler, logdir)


class StepTimer:
    def __init__(self):
        self.durations = []
        self._t = None

    def start(self):
        self._t = time.perf_counter()

    def stop(self):
        assert self._t is not None
        self.durations.append(time.perf_counter() - self._t)
        self._t = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> dict:
        d = np.asarray(self.durations)
        if d.size == 0:
            return {}
        return {"mean_s": float(d.mean()), "p50_s": float(np.median(d)),
                "p95_s": float(np.percentile(d, 95)),
                "steps_per_sec": float(1.0 / d.mean())}
