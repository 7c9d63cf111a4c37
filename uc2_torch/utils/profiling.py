"""Profiling and tracing: the port's spans and counters, and a Chrome
trace exporter.

* ``span(name, stream=False)``: a named span around a block of the port's
  work. It records nothing unless a ``torch.profiler`` session is running
  (``torch.autograd.profiler._is_profiler_enabled``, the flag torch keeps
  for such checks): then one flag read and a branch is all it costs.
  While a profiler runs, a span opens ``record_function(name)``, so it
  sits in the profiler's trace beside the card's kernels on one clock,
  and keeps a ``Record`` (name, id, the enclosing span's id, the entry
  span's id, host start and end in ``perf_counter_ns``, counts) in a ring
  of the newest ``RING`` records. A ``stream=True`` span also marks the
  current CUDA stream at entry and exit with timing events (on a process
  that has not initialised CUDA: the host's clock), read after the caller
  has synchronised (``Record.stream_ms``).
* ``count(key, n)``: adds ``n`` to the innermost open span's counts; a
  no-op outside one.
* ``records()``: the ring's records, oldest first.
* ``trace(logdir)``: ``torch.profiler`` over the CPU and, where there is
  one, the CUDA device around a block; writes ``logdir/trace.json``
  (Chrome trace format), spans included, and yields the profiler, whose
  ``key_averages()`` the caller may read. A profiler that fails to start
  raises (the reference's ``jax.profiler`` trace swallows that and
  records nothing).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

TRACE_FILE = "trace.json"
RING = 4096

_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


class Record:
    """One span's record. ``marks`` is None, or the (entry, exit) marks of
    a stream span: CUDA events, or host ``perf_counter_ns`` readings."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "counts", "marks")

    def __init__(self, name: str, id_: int, parent: Optional["Record"]):
        self.name, self.id = name, id_
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else id_
        self.counts: Dict[str, int] = {}
        self.marks: Optional[list] = None
        self.end_ns = 0
        self.start_ns = time.perf_counter_ns()

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def on_device(self) -> bool:
        """True when the stream marks are CUDA events."""
        return bool(self.marks) and isinstance(self.marks[0],
                                               torch.cuda.Event)

    def stream_ms(self) -> Optional[float]:
        """Milliseconds between the stream marks (None for a span without
        them); for CUDA events, call after synchronising."""
        if not self.marks or len(self.marks) < 2:
            return None
        a, b = self.marks
        return a.elapsed_time(b) if self.on_device else (b - a) * 1e-6


def _stack() -> List[Record]:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _mark():
    if torch.cuda.is_initialized():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter_ns()


class _Span:
    __slots__ = ("name", "stream", "rec", "rf")

    def __init__(self, name: str, stream: bool):
        self.name, self.stream = name, stream

    def __enter__(self):
        stack = _stack()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        rec = self.rec = Record(self.name, next(_ids),
                                stack[-1] if stack else None)
        if self.stream:
            rec.marks = [_mark()]
        _ring.append(rec)
        stack.append(rec)
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if self.stream:
            rec.marks.append(_mark())
        rec.end_ns = time.perf_counter_ns()
        _stack().pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str, stream: bool = False):
    """A context manager: a span named ``name`` while a profiler runs,
    else nothing (see the module's docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, stream)


def count(key: str, n) -> None:
    """Add ``n`` to the innermost open span's ``counts[key]``."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _stack()
    if stack:
        c = stack[-1].counts
        c[key] = c.get(key, 0) + int(n)


def records() -> List[Record]:
    """The ring's records, oldest first (by entry)."""
    return list(_ring)


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
