"""Autotune: measure THIS card's fastest trainer configuration, the
counterpart of the JAX repo's ``scripts/autotune.py``.

The reference hardcodes one training configuration; the port has opt-in
levers whose payoff depends on the hardware: ``adj_half_batch`` (the
adjuster on one alternating batch, about a fifth of the step's FLOPs),
``moment_dtype: bfloat16`` (half the optimizer state's bytes) and
``steps_per_dispatch`` (K updates per CUDA graph replay: host dispatch
amortised, the same math as K sequential steps). This script sweeps them at
a FIXED image size and batch (those change training semantics, so it never
recommends them) on the card, through the bench harness
(``littlegan_tpu_torch/bench.py``: the card store, the K-update graph,
best-of-windows timing), and prints:

- one JSON line per point: its step ms and images/s, the graph's capture
  seconds (its eager warm-up included) and the run's peak memory
  (``torch.cuda.max_memory_allocated``); a point that fails (a graph too
  large to capture, memory) prints its error and is listed under
  ``failed``, never dropped;
- a last ``RECOMMEND`` line with ``parity`` (the fastest point whose math
  is the reference's: only K varies), ``fastest`` (the fastest overall) and
  ``opt_ins`` (the semantics changes ``fastest`` relies on).

Usage:
  python -m littlegan_tpu_torch.scripts.autotune                 # 128², b32, K 4, 8, 16
  python -m littlegan_tpu_torch.scripts.autotune --ks 8,16,64 --skip-adj-half --skip-moment-dtype
Without a card it exits 2 and prints no point: a CPU sweep would tune
nothing the card runs (``--device cpu`` asks for the CPU explicitly, for
the tests).
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ks", default="4,8,16", help="comma-separated steps_per_dispatch candidates")
    ap.add_argument("--skip-adj-half", action="store_true", help="leave the adj_half_batch lever out")
    ap.add_argument("--skip-moment-dtype", action="store_true", help="leave the bfloat16 Adam-moment lever out")
    ap.add_argument("--measure-dispatches", type=int, default=5,
                    help="timed dispatches per window (3 windows, the best kept; see bench.time_scan_dispatches)")
    ap.add_argument("--out", default="", help="also write the recommendation to this JSON file")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU; default: the card")
    args = ap.parse_args(argv)

    import torch

    from littlegan_tpu_torch import bench  # the one harness: autotune must not drift from it

    if args.device is None and not torch.cuda.is_available():
        print("autotune: no CUDA device. Its results are the card's, so there is no CPU fallback "
              "(--device cpu asks for the CPU explicitly)", file=sys.stderr)
        return 2
    from littlegan_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    ks = [int(k) for k in args.ks.split(",") if k]
    adj_opts = [False] if args.skip_adj_half else [False, True]
    mom_opts = ["float32"] if args.skip_moment_dtype else ["float32", "bfloat16"]

    results, failed = [], []
    for adj_half, moment_dtype, k in itertools.product(adj_opts, mom_opts, ks):
        cfg = bench.bench_config(args.dim, args.batch, adj_half, moment_dtype)
        point = {"adj_half_batch": adj_half, "moment_dtype": moment_dtype, "steps_per_dispatch": k}
        t0 = time.time()
        state = dispatch = None
        try:
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            state, dispatch = bench.build_scan_harness(cfg, k=k, device=device)
            t1 = time.perf_counter()
            dispatch.prepare()
            bench.synchronize(state)
            capture_s = time.perf_counter() - t1
            step_s, _ = bench.time_scan_dispatches(state, dispatch, k=k, measure=args.measure_dispatches)
        except Exception as e:  # noqa: BLE001 - one point that cannot run must not end the sweep
            rec = {**point, "error": f"{type(e).__name__}: {e}"[:300]}
            failed.append(rec)
            print(json.dumps(rec), flush=True)
            continue
        finally:
            peak = torch.cuda.max_memory_allocated(device) if cuda else None
            del state, dispatch
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        rec = {
            **point,
            "step_ms": round(step_s * 1000, 3),
            "images_per_sec": round(2 * args.batch / step_s, 1),
            "graph_capture_s": round(capture_s, 3) if cuda else None,
            "peak_memory_mb": round(peak / 2 ** 20, 1) if cuda else None,
            "capture_plus_measure_secs": round(time.time() - t0, 1),
        }
        results.append(rec)
        print(json.dumps(rec), flush=True)

    if not results:
        print("autotune: no point measured successfully", file=sys.stderr)
        return 1

    def best(rows):
        return min(rows, key=lambda r: r["step_ms"])

    parity_rows = [r for r in results if not r["adj_half_batch"] and r["moment_dtype"] == "float32"]
    pick_parity = best(parity_rows) if parity_rows else None
    pick_fast = best(results)
    opt_ins = []
    if pick_fast["adj_half_batch"]:
        opt_ins.append("adj_half_batch: the adjuster trains on ONE alternating N-row batch per step instead of "
                       "the reference's 2N concat (not reference math)")
    if pick_fast["moment_dtype"] == "bfloat16":
        opt_ins.append("moment_dtype bfloat16: Adam moments STORED in bf16 (update math f32; not bit-parity)")
    recommend = {
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "image_dim": args.dim,
        "batch_size": args.batch,
        "kernels": cuda,  # the route the card takes: the kernels launch there
        "parity": pick_parity,
        "fastest": pick_fast,
        "opt_ins": opt_ins,
        "failed": failed,
        "config_snippet": {
            "steps_per_dispatch": pick_fast["steps_per_dispatch"],
            "device_data": True,
            **({"adj_half_batch": True} if pick_fast["adj_half_batch"] else {}),
            **({"moment_dtype": "bfloat16"} if pick_fast["moment_dtype"] == "bfloat16" else {}),
        },
    }
    print("RECOMMEND", json.dumps(recommend), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recommend, f, indent=1)
        print(f"recommendation -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
