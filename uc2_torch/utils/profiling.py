"""Profiling and tracing (port of uc2_tpu/utils/profiling.py).

* ``StepTimer``: host time a step, with an EMA and a percentile summary
  (the same summary as the reference's).
* ``trace(logdir)``: ``torch.profiler`` over the CPU and, where there is
  one, the CUDA device around a block; writes ``logdir/trace.json``
  (Chrome trace format) and yields the profiler, whose ``key_averages()``
  the caller may read. A profiler that fails to start raises (the
  reference's ``jax.profiler`` trace swallows that and records nothing).
* ``annotate(name)``: a ``record_function`` range in the trace, and an
  NVTX range on the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

TRACE_FILE = "trace.json"


class StepTimer:
    """``with timer:`` around each step; ``summary()`` of the samples."""

    def __init__(self, smooth: float = 0.99):
        self.smooth = smooth
        self.ema: Optional[float] = None
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        self.ema = dt if self.ema is None else (
            self.smooth * self.ema + (1 - self.smooth) * dt)

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {"mean_s": sum(s) / n, "p50_s": s[n // 2],
                "p90_s": s[int(n * 0.9)], "ema_s": self.ema,
                "steps_per_s": n / sum(s)}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU, and CUDA when a card is visible) and write
    its Chrome trace to ``logdir/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """A named range: ``record_function`` in a profiler trace, plus NVTX
    on the card."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
