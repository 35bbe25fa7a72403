"""Reading a ``torch.profiler`` Chrome trace: device time by category,
busy and idle time, and the idle gaps named by what the host was doing.

The kernel-name demangler and the category rules are copies of the port's
``scripts/trace_top_ops.py``, frozen here so that later changes to the
program cannot move the yardstick: the port's kernels by source file, then
convolutions, GEMMs, NCCL, foreach (multi-tensor) ops, reductions and
elementwise ops (copies, casts, pads, ``where``) by name.

The traced window is a ``torch.profiler.record_function`` range named
``bench:traced_window``; the harness's host spans around its calls into the
program are put on the trace's clock from it (``harness.profiled``), or
read from ranges named ``bench:<span>``.
"""

from __future__ import annotations

import collections
import json
import re
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench:"
WINDOW_SPAN = "traced_window"

_PORT_FWD = {"stats_kernel", "dev_kernel", "apply_kernel", "cluster_kernel"}  # norm_lrelu.cu
_PORT_BWD = {"sums_kernel", "apply_kernel", "cluster_kernel", "totals_kernel"}  # norm_lrelu_bwd.cu
_PORT_CONV = {"conv3x3_stats_kernel", "conv3x3_mma_kernel", "reduce_partials_kernel"}  # boundary_conv.cu
_PORT_FOLD = {"fold_kernel", "fold_scalar_kernel", "bias_grad_kernel"}  # boundary_conv_bwd.cu
PORT_CATS = ("K1 norm_lrelu.cu", "K2 norm_lrelu_bwd.cu", "K1/K2 norm_lrelu*.cu", "K3 boundary_conv.cu",
             "K3 bwd boundary_conv_bwd.cu")

_RULES = (  # (category, pattern on the name), the first match wins
    ("nccl", re.compile(r"nccl", re.I)),
    ("conv", re.compile(r"conv|cudnn|implicit_?gemm|wgrad|dgrad|fprop|xmma_fprop", re.I)),
    ("gemm", re.compile(r"gemm|cutlass|sm\d+_xmma|ampere_|hopper_|nvjet", re.I)),
    ("foreach", re.compile(r"multi_tensor_apply|foreach", re.I)),
    ("reduce", re.compile(r"reduce|norm_kernel|welford|softmax", re.I)),
    ("elementwise", re.compile(r"elementwise|unrolled|vectorized|index|cat_|copy|fill|where", re.I)),
)


def kernel_name(mangled: str) -> str:
    """The kernel's own name and template arguments out of its mangled
    name: the <length><name> part that ends in "kernel"."""
    for m in re.finditer(r"(?<=\d)[A-Za-z_]", mangled):
        i = m.start()
        digits = re.search(r"\d+$", mangled[:i]).group()
        for k in range(len(digits)):
            name = mangled[i:i + int(digits[k:])]
            if name.endswith("kernel"):
                args = re.match(r"I(\w*?)E", mangled[i + len(name):])
                return name + (f"<{args.group(1)}>" if args else "")
    return mangled


def port_kernel(name: str):
    """(category, short name) of one of the port's kernels, or None."""
    if name.startswith("_Z"):
        if "_GLOBAL__N_" not in name:
            return None
        short = kernel_name(name)
        base, args = short.split("<")[0], None
    else:
        m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)(<[^(]*>)?\((.*)\)\s*$", name)
        if m is None:
            return None
        base, short, args = m.group(1), m.group(1) + (m.group(2) or ""), m.group(3).split(", ")
    if base in _PORT_CONV:
        return "K3 boundary_conv.cu", short
    if base in _PORT_FOLD:
        return "K3 bwd boundary_conv_bwd.cu", short
    if base in _PORT_FWD | _PORT_BWD:
        if base not in _PORT_FWD & _PORT_BWD:
            bwd = base in _PORT_BWD
        elif args is None:
            return "K1/K2 norm_lrelu*.cu", short
        else:
            bwd = len(args) > 1 and args[1].endswith("const*")
        return ("K2 norm_lrelu_bwd.cu", short) if bwd else ("K1 norm_lrelu.cu", short)
    return None


def categorize(name: str, cat: str) -> Tuple[str, str]:
    """(category, the name as printed) of one device event."""
    if cat != "kernel":
        return cat, name
    port = port_kernel(name)
    if port is not None:
        return port
    for category, pattern in _RULES:
        if pattern.search(name):
            return category, name
    return "other", name


class Trace:
    """The parts of one trace the metrics read. Times in seconds."""

    def __init__(self, events: Sequence[dict]):
        self.device: List[Tuple[float, float, str, str]] = []  # (start, end, category, name)
        self.spans: List[Tuple[float, float, str]] = []  # (start, end, span name)
        window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
            if e.get("cat") in DEVICE_CATS:
                category, name = categorize(e.get("name", ""), e["cat"])
                self.device.append((ts, ts + dur, category, name))
            elif e.get("cat") == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
                span = e["name"][len(SPAN_PREFIX):]
                if span == WINDOW_SPAN:
                    window = (ts, ts + dur)
                else:
                    self.spans.append((ts, ts + dur, span))
        self.device.sort()
        if window is None and self.device:
            window = (self.device[0][0], max(e[1] for e in self.device))
        self.window = window

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            trace = json.load(f)
        return cls(trace["traceEvents"] if isinstance(trace, dict) else trace)

    @property
    def window_s(self) -> float:
        return 0.0 if self.window is None else self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events inside the window, merged."""
        if self.window is None:
            return []
        lo, hi = self.window
        merged: List[List[float]] = []
        for s, e, _, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def by_category(self) -> Dict[str, float]:
        """Device seconds per category (events summed, overlaps counted twice)."""
        out: Dict[str, float] = collections.Counter()
        for s, e, c, _ in self.device:
            out[c] += e - s
        return dict(out)

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` device operations that took most time, by name, in seconds."""
        out: Dict[str, float] = collections.Counter()
        for s, e, _, name in self.device:
            out[name] += e - s
        return sorted(out.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, priority: Sequence[str], default: str) -> List[Tuple[str, float]]:
        """Each idle stretch of the window (between merged device events),
        named by the first span of ``priority`` that covers its middle
        (else ``default``), summed by name; the longest first."""
        if self.window is None:
            return []
        edges = [self.window[0]]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.window[1])
        out: Dict[str, float] = collections.Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                out[self.span_at((a + b) / 2, priority, default)] += b - a
        return sorted(out.items(), key=lambda kv: -kv[1])

    def span_at(self, t: float, priority: Sequence[str], default: str) -> str:
        covering = {name for s, e, name in self.spans if s <= t <= e}
        for name in priority:
            if name in covering:
                return name
        return default
