"""The readings a train cell's limits were set from, planted faults included;
not part of a benchmark run.

    python3 benchmark/calibrate_faults.py --workload stylegan2-ffhq-256.train-graph --seeds 1,2,3

For each seed, one short run of the cell in this process with the control
and the planted faults (``harness.Context(controls=True)``), as
``benchmark/calibrate.py limits`` makes it; where that prints the program's
and the control's readings, this prints every reading set the driver
returns (the program, the control and each planted fault), each with its
numbers and the limits it fails. One JSON line per seed on standard output.
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


def reading_sets(readings: dict, limits: dict) -> dict:
    """Each reading set (a dict holding every limit's number) of a run,
    with its numbers and the limits it fails."""
    out = {}
    for name, nums in readings.items():
        if isinstance(nums, dict) and limits and all(k in nums for k in limits):
            out[name] = {"fails": sorted(k for k, lim in limits.items() if not nums[k] <= float(lim)),
                         **{k: v for k, v in nums.items() if isinstance(v, (int, float))}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    harness.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("calibrate_faults: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    cell = harness.Cell.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        ctx = harness.Context(cell, seed, args.seconds, False, dev, t0, controls=True)
        out = cell.driver().run(ctx)
        line = {"workload": cell.name, "seed": seed, "limits": cell.limits, "wall_s": time.perf_counter() - t0,
                "setup_s": out.readings["setup_s"], **reading_sets(out.readings, cell.limits)}
        print(json.dumps(line), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
