"""Multi-card scaling curve: images/s per card for the DP and spatial
steps, the counterpart of the JAX repo's ``scripts/scaling_curve.py``.

  python -m littlegan_tpu_torch.scripts.scaling_curve                   # 1, 2, 4, ... every visible card
  python -m littlegan_tpu_torch.scripts.scaling_curve --devices 1,2,4   # an explicit curve
  python -m littlegan_tpu_torch.scripts.scaling_curve --virtual 2       # N gloo ranks on the CPU

The JAX script runs one process over N devices; PyTorch runs one process
per card, as the port's data-parallel and spatial paths do. So each point
of n cards starts n rank processes with the environment ``torchrun`` gives
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), which meet at a file in the
point's temporary directory (no port to pick) in one process group (NCCL
on cards, gloo on the CPU). Each rank builds the host-fed train step over
the group (``parallel/train.py::GradSync``, the gradients' all-reduce in
every update) and times steady-state steps between two synchronisations
(the card's, then a barrier). DP points keep ``--batch`` rows per card
(global batch b x n: WEAK scaling, the regime DP training runs in);
spatial points put the ranks on an ``[n/2, 2]`` ``('data', 'model')`` mesh
(``parallel/mesh.py::spatial_group``) with b x n/2 global rows, each rank
holding half of every image's rows. Per point:

  - img_s          global images/s
  - img_s_chip     images/s per card (a flat curve is linear scaling)
  - step_ms        wall per step
  - efficiency     img_s_chip over the 1-card DP point's (1.0 is linear)

``--trace DIR`` writes a ``torch.profiler`` trace of one step per rank and
point under ``DIR/<tag>/`` (Chrome format), outside the timed window, to
attribute the collectives' time per step.

``--virtual N`` runs the same code on N gloo ranks on the CPU at tiny
shapes; its points are labelled ``backend: cpu-virtual`` and are NOT
measurements of any card. It exists so that the harness is testable
without cards. Without ``--virtual`` it needs the cards: with none it exits
2, and a point of more cards than are visible raises before any runs.
Results go to ``--out`` (default ``scaling_curve_<backend>.json`` in the
current directory).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from littlegan_tpu_torch.parallel.launch import run_ranks


def _rank_point(spec: dict) -> dict:
    """One rank of a point (its environment says which): build the step
    over the group, time it; rank 0's result is the point's."""
    import torch
    import torch.distributed as dist

    from littlegan_tpu_torch.config import Config
    from littlegan_tpu_torch.parallel.launch import join_group
    from littlegan_tpu_torch.parallel.mesh import spatial_group
    from littlegan_tpu_torch.parallel.train import GradSync, local_draws, replicate_state, shard_local_batch
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import draw_step, make_train_step
    from littlegan_tpu_torch.utils.device import resolve_device
    from littlegan_tpu_torch.utils.image import soft

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = resolve_device("cpu" if spec["virtual"] else None)
    if spec["virtual"]:
        torch.set_num_threads(1)
    dg = None
    if world > 1:
        dg = join_group(device, spec["rendezvous"])
        if spec["spatial"]:
            dg = spatial_group(dg, (world // 2, 2))
    try:
        cfg = Config(**spec["cfg"])
        state = create_train_state(cfg, device)
        replicate_state(state, dg)
        step = make_train_step(cfg, state, GradSync(dg) if dg is not None else None)
        rng = np.random.default_rng(1)  # the global batches, each rank taking its part

        def batch():
            img = rng.uniform(-1.0, 1.0, (cfg.batch_size, *cfg.image_shape)).astype(np.float32)
            cond = soft(np.where(rng.random((cfg.batch_size, cfg.cond_dim)) < 0.5, -1.0, 1.0)).astype(np.float32)
            return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                         for x in shard_local_batch((img, cond), dg))

        b1, b2 = batch(), batch()
        gen = torch.Generator(device=device).manual_seed(2)
        draws = local_draws(draw_step(gen, cfg, cfg.batch_size, device), dg)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if dg is not None:
                dist.barrier(dg.control)

        for _ in range(max(1, spec["warmup"])):
            step(state, b1, b2, draws, 11)
        sync()
        t0 = time.perf_counter()
        for _ in range(spec["iters"]):
            step(state, b1, b2, draws, 11)
        sync()
        sps = spec["iters"] / (time.perf_counter() - t0)
        if spec.get("trace"):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=acts) as prof:
                step(state, b1, b2, draws, 11)
                sync()
            os.makedirs(spec["trace"], exist_ok=True)
            prof.export_chrome_trace(os.path.join(spec["trace"], f"rank{rank}.json"))
        return {"steps_per_sec": sps, "rank": rank, "world": world}
    finally:
        if dg is not None:
            dist.barrier(dg.control)
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", default="", help="comma list of card counts (default: 1, 2, 4, ... up to all)")
    ap.add_argument("--virtual", type=int, default=0, help="N gloo ranks on the CPU (harness test mode)")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32, help="rows per card for DP points; per data index for spatial")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--no-spatial", action="store_true", help="skip the ('data', 'model') points")
    ap.add_argument("--kernels", action="store_true",
                    help="both kernel flags on (the spatial step turns them off, as JAX's does)")
    ap.add_argument("--trace", default="", help="a torch.profiler trace per rank and point under DIR/<tag>")
    ap.add_argument("--out", default="", help="output JSON path (default scaling_curve_<backend>.json)")
    ap.add_argument("--rank", nargs=2, metavar=("SPEC", "OUT"), help=argparse.SUPPRESS)  # one rank of a point
    args = ap.parse_args(argv)

    if args.rank:
        with open(args.rank[0]) as f:
            result = _rank_point(json.load(f))
        with open(args.rank[1], "w") as f:
            json.dump(result, f)
        return 0

    import torch

    if args.virtual:
        n_all, backend = args.virtual, "cpu-virtual"
    else:
        if not torch.cuda.is_available():
            print("scaling_curve: no CUDA device (--virtual N runs gloo ranks on the CPU, as no card's "
                  "measurement)", file=sys.stderr)
            return 2
        n_all, backend = torch.cuda.device_count(), "cuda"
    counts = ([int(x) for x in args.devices.split(",")] if args.devices
              else [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= n_all])
    bad = [n for n in counts if n > n_all]
    if bad:
        raise SystemExit(f"scaling_curve: card counts {bad} exceed the {n_all} visible "
                         f"({'--virtual' if args.virtual else 'CUDA devices'})")

    base = dict(image_dim=args.dim, init_dim=args.dim // 16,
                compute_dtype="float32" if args.virtual else "bfloat16", use_partition=True, train_adj=True,
                use_pallas=args.kernels, use_pallas_boundary=args.kernels, debug=True)
    if args.virtual:  # tiny shapes: the harness is checked, no card is measured
        base.update(image_dim=16, init_dim=1, noise_dim=13, conv_filter=[24, 16, 12, 8, 4])
    kind = torch.cuda.get_device_name(0) if backend == "cuda" else "cpu"
    points = [("dp", n, args.batch * n) for n in counts]
    if not args.no_spatial:
        points += [("spatial_model2", n, args.batch * (n // 2)) for n in counts if n >= 2 and n % 2 == 0]

    results, single = [], None
    for regime, n, global_batch in points:
        tag = f"{'dp' if regime == 'dp' else 'spatial'}_n{n}"
        cfg = {**base, "batch_size": global_batch}
        if regime != "dp":
            cfg.update(mesh_axes=["data", "model"], mesh_shape=[n // 2, 2])
        spec = {"tag": tag, "cfg": cfg, "virtual": bool(args.virtual), "spatial": regime != "dp",
                "warmup": args.warmup, "iters": args.iters,
                "trace": os.path.join(args.trace, tag) if args.trace else ""}
        rank0 = run_ranks("littlegan_tpu_torch.scripts.scaling_curve", spec, n, cpu=bool(args.virtual))[0]
        sps = rank0["steps_per_sec"]
        img_s = sps * global_batch
        if regime == "dp" and n == 1:
            single = img_s
        rec = {
            "regime": regime, "n_devices": n, "batch_global": global_batch, "dim": base["image_dim"],
            "step_ms": round(1000.0 / sps, 3), "img_s": round(img_s, 1), "img_s_chip": round(img_s / n, 1),
            "efficiency": round((img_s / n) / single, 4) if single else None,
            "backend": backend, "device_kind": kind,
        }
        results.append(rec)
        print(json.dumps(rec), flush=True)

    out = args.out or f"scaling_curve_{backend}.json"
    with open(out, "w") as f:
        json.dump({"results": results, "iters": args.iters, "kernels": args.kernels,
                   "timing_note": "host-fed steps, one per call, between a card synchronise and a barrier"},
                  f, indent=1)
    print(f"curve -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
