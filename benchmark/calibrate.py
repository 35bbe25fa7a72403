"""Readings the limits and the serving rates were set from; not part of a
benchmark run.

    python3 benchmark/calibrate.py limits --workload <cell> --seeds 1,2,3 --seconds 2
    python3 benchmark/calibrate.py knee --workload <serve cell> --rates 500,1000,2000 --seconds 5

``limits``: for each seed, one short run of the cell in this process
(weights, data and set-up from that seed) with the program's numbers, and
from the same inputs the control (the plain reference in float8 e4m3 in the
program's place) and the planted faults (training: each loss over half the
batch; serving: answers handed to other requests), each against the
float32 reference. ``knee``: the cell's open loop at each rate, its
latencies and completions. One JSON line per reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__" and not __package__:  # run as a script: the checkout, not benchmark/, on the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402
from benchmark.metrics_common import percentile  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("limits", "knee"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    harness.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    cell = harness.Cell.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = [(s, None) for s in seeds] if args.what == "limits" else [
        (seeds[0], float(r)) for r in args.rates.split(",")]
    for seed, rate in runs:
        if rate is not None:
            cell.traffic = {**cell.traffic, "rate": rate}
        torch.cuda.reset_peak_memory_stats(dev)
        ctx = harness.Context(cell, seed, args.seconds, False, dev, time.perf_counter(), controls=rate is None)
        out = cell.driver().run(ctx)
        r = out.readings
        line = {"workload": cell.name, "seed": seed, "checks": out.checks, "attempted": out.attempted,
                "failed": out.failed, "setup_s": r["setup_s"], "peak": out.memory_peak_bytes}
        for key in ("program", "control", "half_batch", "swapped"):
            if key in r:
                line[key] = r[key]
        if rate is not None:
            lat = r["latencies_ms"]
            tail = sorted(lat[-len(lat) // 10:])
            line.update(rate=rate, p50=percentile(r, 0.5), p95=percentile(r, 0.95), p99=percentile(r, 0.99),
                        last_tenth_p50=tail[len(tail) // 2] if tail else None,
                        rows_per_call=r["batch_rows"] / max(1.0, r["batch_dispatches"]))
        print(json.dumps(line), flush=True)
        del out, r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
