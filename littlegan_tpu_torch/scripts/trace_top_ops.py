"""Summarize a torch.profiler trace: the top device ops by time, the
counterpart of the JAX repo's ``scripts/xplane_top_ops.py``.

Usage: python -m littlegan_tpu_torch.scripts.trace_top_ops <trace_dir_or_json> [N] [--json]

Reads one Chrome-format trace (what ``torch.profiler``'s
``export_chrome_trace`` writes: ``scripts/scaling_curve.py --trace``'s
``rank<r>.json``), or the newest ``*.pt.trace.json`` under a directory
(what ``training/trainer.py::ProfileWindow`` writes for ``profile_steps``).
Its device events (``cat`` kernel, gpu_memcpy, gpu_memset) are summed by
name, and it prints the total device time, the shares by category and the
top N (default 30) names by time with their counts, in the JAX script's
layout; with ``--json`` a last line of the same as one JSON object. A trace
without a device event (a CPU run) is no device summary: it exits 1.

Categories (the JAX script reads XLA's own; a CUDA trace has none, so they
come from the name): the port's kernels (``littlegan_tpu_torch/csrc``) as
K1, K2, K3 and K3's backward by source file, convolutions, GEMMs, NCCL,
foreach (multi-tensor) ops, reductions, elementwise ops, copies and sets,
else "other". The port's kernels are named by their demangled name
without the argument list (a mangled one through :func:`kernel_name`,
which ``chip_smoke.py`` also uses to list the built kernels).

Then the program's host spans (``utils/spans.py``'s ``littlegan:<name>``
ranges): count and host ms per name; and the device's idle time in the
window split by the CUDA-graph replays (:func:`replay_split`). The window is
a ``bench:traced_window`` range where the trace has one (the benchmark's
traced window), else the first device event's start to the last one's
end. A replay is the ``cudaGraphLaunch`` inside a ``dispatch.replay`` span;
the device events with its correlation id are the replay's, and its extent
runs from their first start to their last end. Idle time inside a replay's
extent is in-graph (between the graph's own kernels), the rest is between
replays (the host's); with ``host ms per replay``, the ``step.schedule``
and ``dispatch.*`` spans but the staging wait that start in the window
over the replays that start there. Without a replay span, or with a replay
span without a launch or a launch without a device event, no split.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "littlegan:"
WINDOW = "bench:traced_window"
REPLAY = "dispatch.replay"
HOST_WORK = ("step.schedule", "dispatch.stage", "dispatch.inputs", REPLAY, "dispatch.outputs")

# the port's kernels, by name and source file (littlegan_tpu_torch/csrc); ``apply_kernel`` and
# ``cluster_kernel`` are in both norm files: the backward's second argument is the const dy
_PORT_FWD = {"stats_kernel", "dev_kernel", "apply_kernel", "cluster_kernel"}  # norm_lrelu.cu
_PORT_BWD = {"sums_kernel", "apply_kernel", "cluster_kernel", "totals_kernel"}  # norm_lrelu_bwd.cu
_PORT_CONV = {"conv3x3_stats_kernel", "conv3x3_mma_kernel", "reduce_partials_kernel"}  # boundary_conv.cu
_PORT_FOLD = {"fold_kernel", "fold_scalar_kernel", "bias_grad_kernel"}  # boundary_conv_bwd.cu

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
        elif args is None:  # a mangled name: its arguments unread
            return "K1/K2 norm_lrelu*.cu", short
        else:
            bwd = len(args) > 1 and args[1].endswith("const*")
        return ("K2 norm_lrelu_bwd.cu", short) if bwd else ("K1 norm_lrelu.cu", short)
    return None


def categorize(name: str, cat: str):
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


def load(path: str):
    """(the trace file read, its events): ``path`` or the newest
    ``*.pt.trace.json`` under it."""
    if os.path.isdir(path):
        hits = glob.glob(os.path.join(path, "**", "*.pt.trace.json"), recursive=True)
        if not hits:
            raise SystemExit(f"no *.pt.trace.json under {path}")
        path = max(hits, key=os.path.getmtime)
    with open(path) as f:
        trace = json.load(f)
    return path, trace["traceEvents"] if isinstance(trace, dict) else trace


def summarize(events, top_n: int = 30) -> dict:
    """Device time (µs in the trace, ms out) by name and by category."""
    agg, counts, cats = collections.Counter(), collections.Counter(), {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        category, name = categorize(e.get("name", ""), e["cat"])
        agg[name] += e["dur"]
        counts[name] += 1
        cats[name] = category
    total = sum(agg.values())
    by_cat = collections.Counter()
    for name, us in agg.items():
        by_cat[cats[name]] += us
    top = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))[:top_n]
    return {
        "total_ms": total / 1e3, "n_events": sum(counts.values()),
        "by_category": [{"category": c, "ms": us / 1e3, "share": us / total}
                        for c, us in sorted(by_cat.items(), key=lambda kv: (-kv[1], kv[0]))],
        "top": [{"name": name, "ms": us / 1e3, "share": us / total, "count": counts[name],
                 "category": cats[name]} for name, us in top],
    }


def host_spans(events) -> list:
    """Count and host ms of each ``littlegan:`` span name, the most ms first."""
    ms, counts = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
            name = e["name"][len(SPAN_PREFIX):]
            ms[name] += e.get("dur", 0.0) / 1e3
            counts[name] += 1
    return [{"name": n, "count": counts[n], "ms": v} for n, v in sorted(ms.items(), key=lambda kv: (-kv[1], kv[0]))]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a: float, b: float, merged) -> float:
    return sum(max(0.0, min(b, e) - max(a, s)) for s, e in merged)


def replay_split(events):
    """The window's idle time in and between the graph replays (µs in the
    trace, ms out), or None (no replay, or one the trace cannot place)."""
    device, corr, spans, launches, window = [], collections.defaultdict(list), [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        cat, name, c = e.get("cat"), e.get("name", ""), (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, end))
            if c is not None:
                corr[c].append((ts, end))
        elif cat == "user_annotation" and name == WINDOW:
            window = (ts, end)
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((ts, end, name[len(SPAN_PREFIX):]))
        elif cat == "cuda_runtime" and name.startswith("cudaGraphLaunch") and c is not None:
            launches.append((ts, c))
    if not device:
        return None
    if window is None:
        window = (min(s for s, _ in device), max(e for _, e in device))
    lo, hi = window
    extents = []
    for s, e, name in spans:
        if name != REPLAY:
            continue
        inside = [c for t, c in launches if s <= t <= e]
        if not inside or not all(corr.get(c) for c in inside):
            return None
        evs = [iv for c in inside for iv in corr[c]]
        extents.append((min(a for a, _ in evs), max(b for _, b in evs), len(evs)))
    if not extents:
        return None
    busy = _merge([(max(s, lo), min(e, hi)) for s, e in device if min(e, hi) > max(s, lo)])
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    in_graph = _merge([(s, e) for s, e, _ in extents])
    graph = sum(_overlap(a, b, in_graph) for a, b in gaps)
    idle = sum(b - a for a, b in gaps)
    work = sum(e - s for s, e, name in spans if name in HOST_WORK and lo <= s < hi)
    n_window = sum(1 for s, _, name in spans if name == REPLAY and lo <= s < hi)
    return {"window_ms": (hi - lo) / 1e3, "idle_ms": idle / 1e3, "graph_gap_ms": graph / 1e3,
            "host_gap_ms": (idle - graph) / 1e3, "replays": len(extents),
            "device_events_per_replay": sum(n for _, _, n in extents) / len(extents),
            "host_ms_per_replay": work / n_window / 1e3 if n_window else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", help="a trace JSON, or a directory holding *.pt.trace.json")
    ap.add_argument("top_n", type=int, nargs="?", default=30)
    ap.add_argument("--json", action="store_true", help="also print the summary as one JSON line, last")
    args = ap.parse_args(argv)
    path, events = load(args.path)
    print(f"# {path}")
    s = summarize(events, args.top_n)
    if not s["n_events"]:
        print(f"trace_top_ops: no device event in {path} (a CPU trace?)", file=sys.stderr)
        return 1
    print(f"\n== device  total device time {s['total_ms']:.3f} ms over {s['n_events']} events")
    for c in s["by_category"]:
        print(f"  [cat] {c['category']:30s} {c['ms']:9.3f} ms  {100 * c['share']:5.1f}%")
    print()
    for t in s["top"]:
        print(f"  {t['ms']:9.3f} ms {100 * t['share']:5.1f}%  n={t['count']:4d}  [{t['category']}] {t['name'][:110]}")
    s["spans"], s["idle_split"] = host_spans(events), replay_split(events)
    if s["spans"]:
        print("\n== host spans (littlegan:)")
        for sp in s["spans"]:
            print(f"  {sp['ms']:9.3f} ms  {sp['count']:5d} calls  {sp['ms'] / sp['count']:8.3f} ms each  {sp['name']}")
    r = s["idle_split"]
    if r is None:
        print("\n== idle  no graph replay placed (no dispatch.replay span with its launch's device events)")
    else:
        w = r["window_ms"]
        per = "not read" if r["host_ms_per_replay"] is None else f"{r['host_ms_per_replay']:.3f} ms"
        print(f"\n== idle  {r['idle_ms']:.3f} ms of a {w:.3f} ms window ({100 * r['idle_ms'] / w:.3f}%): "
              f"in-graph {r['graph_gap_ms']:.3f} ms ({100 * r['graph_gap_ms'] / w:.3f}%), between replays "
              f"{r['host_gap_ms']:.3f} ms ({100 * r['host_gap_ms'] / w:.3f}%)")
        print(f"  {r['replays']} replays, {r['device_events_per_replay']:.1f} device events each, "
              f"host ms per replay {per}")
    if args.json:
        print(json.dumps({"path": path, **s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
