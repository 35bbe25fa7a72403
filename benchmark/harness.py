"""What every run shares: finding a cell's files by name, the run's
context, host spans, the check of loaded modules and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration's sizes and flags;
- ``traffic/<mix>.json``: the mix's parameters, with ``driver`` naming
  ``drivers/<driver>.py``, whose ``run(ctx)`` runs the cell once;
- ``limits/<cell>.json``: the limit of each number the cell's
  correctness check compares;
- ``metrics/<metric>.py``: one reader per metric, ``read(r)`` of the run's
  readings, returning a number or None (nothing to read).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "littlegan_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def bench_file(kind: str, name: str, ext: str, bench: str = BENCH) -> str:
    path = os.path.join(bench, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{kind} {name!r}: no file {os.path.relpath(path, os.path.dirname(bench))}")
    return path


_MODULES: Dict[str, Any] = {}


def load_module(kind: str, name: str, bench: str = BENCH):
    """``<bench>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = bench_file(kind, name, ".py", bench)
    if path not in _MODULES:
        mod_name = f"benchmark_{kind}_{name}".replace(".", "_").replace("-", "_")
        loaded = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(loaded)
        loaded.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


def applies(metric: dict, cell: dict, end_to_end: List[dict]) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or, with
    no ``workloads`` key, wherever the end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if "moves" in metric:
        return applies(find(end_to_end, metric["moves"], "end-to-end metric"), cell, end_to_end)
    return True


@dataclass
class Cell:
    """One cell with everything its files say."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    bench: str = BENCH

    @classmethod
    def load(cls, name: str, root: str = ROOT, bench: str = BENCH) -> "Cell":
        s = spec(root)
        w = find(s["workloads"], name, "workload")
        c = find(s["configs"], w["config"], "configuration")
        return cls(
            name=name, chips=w["chips"], config=load_json(os.path.join(root, c["file"])),
            traffic=load_json(bench_file("traffic", w["traffic"], ".json", bench)),
            limits=load_json(bench_file("limits", name, ".json", bench)),
            end_to_end=[m for m in s["end_to_end"] if applies(m, w, s["end_to_end"])],
            per_layer=[m for m in s["per_layer"] if applies(m, w, s["end_to_end"])], bench=bench,
        )

    def driver(self):
        return load_module("drivers", self.traffic["driver"], self.bench)


class Spans:
    """Host spans around the harness's calls into the program, kept as
    (start, end) host times by name: ``timed`` ones always, the others
    while a trace is taken, to name the device's idle gaps."""

    def __init__(self):
        self.tracing = False
        self.times: Dict[str, List[Tuple[float, float]]] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, timed: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if timed or self.tracing:
                t1 = time.perf_counter()
                with self._lock:
                    self.times.setdefault(name, []).append((t0, t1))

    def durations(self, name: str, lo: float = -math.inf, hi: float = math.inf) -> List[float]:
        return [b - a for a, b in self.times.get(name, []) if lo <= a < hi]

    def between(self, lo: float, hi: float) -> List[Tuple[float, float, str]]:
        with self._lock:
            return [(a, b, n) for n, ts in self.times.items() for a, b in ts if b >= lo and a <= hi]


def profiled(spans: Spans, body: Callable[[], None], lead: Callable[[], None] = lambda: None):
    """Run ``lead`` and then ``body`` under ``torch.profiler`` (CPU and
    CUDA), ``body`` inside a ``bench:traced_window`` range (``lead`` fills
    the device's queue first, so that the window does not open on an idle
    device); returns the ``benchmark.trace.Trace`` with the host spans
    taken in the window put on the trace's clock."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import SPAN_PREFIX, WINDOW_SPAN, Trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    spans.tracing = True
    with profile(activities=acts) as prof:
        lead()
        with torch.profiler.record_function(SPAN_PREFIX + WINDOW_SPAN):
            t0 = time.perf_counter()
            body()
            t1 = time.perf_counter()
    spans.tracing = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = Trace.load(path)
    finally:
        os.remove(path)
    if trace.window is not None:  # the window's range gives the offset of the two clocks
        off = trace.window[0] - t0
        trace.spans = [(a + off, b + off, n) for a, b, n in spans.between(t0, t1)]
    return trace


@dataclass
class Context:
    """What a driver gets: the cell, the run's arguments and the device."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    controls: bool = False  # also read the control and the planted faults (benchmark/calibrate.py)
    spans: Spans = field(default_factory=Spans)
    log: Callable[[str], None] = field(default=lambda msg: print(msg, file=sys.stderr, flush=True))

    def sub_seed(self, stream: int) -> int:
        """A seed of its own for each random stream of the run."""
        return (self.seed * 1_000_003 + stream * 7919) % (1 << 63)


@dataclass
class Outcome:
    """What a driver returns. ``readings``: what the metric readers read
    (with ``--trace 1``: ``trace``, the traced window's
    ``benchmark.trace.Trace``, and ``idle_gaps``); ``checks``: (name,
    value, limit) of every number compared."""

    attempted: int
    failed: int
    readings: Dict[str, Any]
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int


def correct(checks: List[Tuple[str, float, float]]) -> bool:
    return bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def read_metrics(entries: List[dict], readings: dict, bench: str = BENCH) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"], bench).read(readings)
        if value is not None:
            value = float(value)
            out[m["name"]] = {"value": value if math.isfinite(value) else 1e300, "unit": m["unit"]}
    return out


def cache_env(root: str = ROOT) -> None:
    """Fixed cache directories inside the checkout (set before torch loads)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(root, ".bench_cache", sub)
