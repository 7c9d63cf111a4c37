"""What every cell shares: finding a cell's files by name, running it,
reading the profiler's trace, and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix. The harness reads ``configs/<config>.json``
and ``traffic/<traffic>.json``, runs the driver that the traffic names
(``drivers/<driver>.py``) for set-up, a window of ``--seconds`` and, with
``--trace 1``, a traced slice after it; each per-layer metric of the cell
is ``metrics/<metric>.py``'s ``read(trace)``; the checks that decide
``correct`` are held to ``workloads/<cell>.json``'s limits. Adding a
cell, a configuration or a metric adds files and entries; no code here
names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "uc2_tpu")


class Bench:
    """``BENCHMARK.json`` and the benchmark's files under ``root``."""

    def __init__(self, root: Path = HERE.parent, files: Path = HERE):
        self.root, self.files = Path(root), Path(files)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> Dict:
        path = self.files / kind / f"{name}.json"
        if not path.is_file():
            raise ValueError(f"no {kind} file {path}")
        return json.loads(path.read_text())

    def workload(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> Dict:
        return self._json("workloads", cell)["checks"]

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str) -> Callable:
        return load_reader(self.files / "metrics" / f"{metric}.py")


def load_reader(path: Path) -> Callable:
    """The ``read`` function of the metric reader at ``path``."""
    name = path.name[:-len(".py")]
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{len(name)}_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Trace:
    """The profiler's record of a traced slice, in seconds on the trace's
    clock: CUDA kernels, every device operation (kernels, copies, sets)
    and the host's operations, each (name, start, end); the slice's
    bounds (``start`` None: ``end`` is its length, from its first device
    operation); and what the driver says it ran in it (``units``,
    ``shapes``) and in the window (``window``: its seconds and counts)."""

    def __init__(self, events, start: float, end: float, units: int,
                 shapes: List, window: Dict, model: Dict):
        self.kernels, self.device_ops, self.host_ops = [], [], []
        for e in events:
            name, (s, t) = e.name(), _span(e)
            if _on_device(e):
                if _annotation(e):
                    continue
                self.device_ops.append((name, s, t))
                if not name.startswith(("Memcpy", "Memset")):
                    self.kernels.append((name, s, t))
            elif name != SLICE:
                self.host_ops.append((name, s, t))
        if start is None:       # (None, length): from the first operation
            first = min((s for _, s, _ in self.device_ops), default=0.0)
            last = max((t for _, _, t in self.device_ops), default=0.0)
            start, end = first, first + max(end, last - first)
        self.start, self.end = start, end
        self.units, self.shapes = units, shapes
        self.window, self.model = window, model

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> List:
        """The union of the device operations inside the slice, sorted."""
        ivs = sorted((max(s, self.start), min(e, self.end))
                     for _, s, e in self.device_ops)
        out = []
        for s, e in ivs:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_table(self) -> List:
        """(name, launches, seconds) of each kernel, the most time first."""
        t: Dict[str, list] = {}
        for n, s, e in self.kernels:
            c = t.setdefault(_short(n), [0, 0.0])
            c[0] += 1
            c[1] += e - s
        return sorted(((n, c, sec) for n, (c, sec) in t.items()),
                      key=lambda r: -r[2])

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.kernels if match(n))

    def breakdown(self, top: int = 10, gaps_read: int = 500) -> Dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the host operation running at their middle (the
        innermost; "host" where none was recorded)."""
        by_op: Dict[str, float] = {}
        for n, s, e in self.device_ops:
            by_op[_short(n)] = by_op.get(_short(n), 0.0) + (e - s)
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)
        hs = np.asarray([s for _, s, _ in self.host_ops] or [0.0])
        he = np.asarray([e for _, _, e in self.host_ops] or [0.0])
        by_host: Dict[str, float] = {}
        for length, s, e in gaps[:gaps_read]:
            mid = 0.5 * (s + e)
            inside = np.flatnonzero((hs <= mid) & (he >= mid))
            name = ("host" if inside.size == 0 else _short(self.host_ops[
                inside[np.argmin(he[inside] - hs[inside])]][0]))
            by_host[name] = by_host.get(name, 0.0) + length
        return {"device_ops": _top(by_op, top), "idle_gaps": _top(by_host,
                                                                  top)}


SLICE = "h100bench.slice"


def _span(e):
    """(start, end) of a profiler event in seconds."""
    if hasattr(e, "start_ns"):
        return e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
    return e.start_us() * 1e-6, (e.start_us() + e.duration_us()) * 1e-6


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _annotation(e) -> bool:
    """A ``record_function`` range's copy on the device's timeline: no
    operation of its own."""
    flag = getattr(e, "is_user_annotation", None)
    return (e.name() == SLICE or (flag is not None and flag())
            or (_on_device(e) and e.name().startswith(("Optimizer.",
                                                       "ProfilerStep"))))


def _short(name: str) -> str:
    """A kernel's or operation's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120] or name[:120]


def _top(d: Dict[str, float], k: int) -> List:
    return [[n, v] for n, v in sorted(d.items(), key=lambda x: -x[1])[:k]]


def capture(fn: Callable, device, host: bool) -> tuple:
    """Run ``fn`` under ``torch.profiler``: the card's activity, and with
    ``host`` the host's operations too (which slow a host-bound loop, so
    the metrics read a slice traced without them). Returns (the events,
    the slice's start and end on the trace's clock; without ``host``,
    None and the slice's length on the host's clock)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = str(device).startswith("cuda")
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(SLICE):
            fn()
            if cuda:
                torch.cuda.synchronize()
        t1 = time.perf_counter()
    events = list(prof.profiler.kineto_results.events())
    if not host:
        return events, None, t1 - t0
    start, end = _span(next(e for e in events if e.name() == SLICE
                            and not _on_device(e)))
    return events, start, end


def driver(traffic: Dict):
    return importlib.import_module(f"h100bench.drivers.{traffic['driver']}")


def run_cell(bench: Bench, cell: str, seed: int, seconds: float,
             trace: bool, device, t0: Optional[float] = None) -> Dict:
    """One run of ``cell``: the result line's dict (without printing it)."""
    t0 = time.perf_counter() if t0 is None else t0
    w = bench.workload(cell)
    cfg, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    limits = bench.limits(cell)
    d = driver(traffic).Driver(cfg, traffic, seed, device)
    d.setup()
    setup_s = time.perf_counter() - t0
    win = d.window(seconds)
    per_layer = {}
    dev_info = {}
    if trace:
        ran = []
        tr = Trace(*capture(lambda: ran.append(d.traced_slice()), device,
                            host=False), *ran[0], win, cfg)
        for m in bench.per_layer(cell):
            v = bench.reader(m["name"])(tr)
            if v is not None:
                per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        for name, n, sec in tr.kernel_table()[:24]:
            print(f"h100bench: kernel {n} x {sec:.6f} s {name}",
                  file=sys.stderr)
        breakdown = Trace(*capture(d.traced_slice, device, host=True), 0, [],
                          win, cfg).breakdown()
    peak = d.memory_peak()
    d.free()
    checks = d.check()
    metrics = per_layer if trace else {}
    if not trace:
        for m in bench.end_to_end(cell):
            v = setup_s if m["name"] == "setup_s" else win["metrics"].get(
                m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    held = {name: {"value": checks[name], "limit": lim["limit"]}
            for name, lim in limits.items() if name in checks}
    correct = (set(held) == set(limits) and win["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in held.values()))
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics,
              "device": dict(d.device_info(), memory_peak_bytes=peak,
                             **dev_info)}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = held
    return result


def forbidden_modules(modules) -> List[str]:
    """The loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted(k for k in modules if k.split(".")[0] in FORBIDDEN)
