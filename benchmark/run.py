"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix,
limits and metric readers are the files ``BENCHMARK.json`` names (see
``benchmark/harness.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checked``: each
number the correctness check compared, beside its limit. The same numbers
are the last lines of standard error. Without a card, with fewer cards
than the cell asks for, or with JAX or the JAX package loaded when the
window has closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

T_START = time.perf_counter()
if __name__ == "__main__" and not __package__:  # run as a script: the checkout, not benchmark/, on the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell: harness.Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Run the cell's driver and build the result line's dict."""
    ctx = harness.Context(cell, seed, seconds, trace, device, t_start)
    out = cell.driver().run(ctx)
    metrics = harness.read_metrics(cell.per_layer if trace else cell.end_to_end, out.readings, cell.bench)
    dev = {"platform": "gpu" if str(device).startswith("cuda") else "cpu", "kind": out.readings["device_kind"],
           "count": 1, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": harness.correct(out.checks), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    traced = out.readings.get("trace")
    if traced is not None:
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": [[k, v] for k, v in traced.top_ops(10)],
                               "idle_gaps": [[k, v] for k, v in out.readings["idle_gaps"][:10]]}
    result["checked"] = {name: {"value": finite(v), "limit": lim} for name, v, lim in out.checks}
    return result


def finite(value: float) -> float:
    """A number JSON can carry: a value that is not finite (a request that
    never came back, a check that could not be read) as 1e300."""
    return value if math.isfinite(value) else 1e300


def main(argv=None) -> int:
    args = parse_args(argv)
    harness.cache_env()
    try:
        cell = harness.Cell.load(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {type(e).__name__}: {e}; no result", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}; no result", file=sys.stderr)
        return 1
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(bad)}; no result", file=sys.stderr)
        return 1
    for name, c in result["checked"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
