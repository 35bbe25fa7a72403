"""Train-state memory report: what fits, and what each flag buys. The
counterpart of the JAX package's ``scripts/memory_report.py``.

- how many bytes of params / Adam moments / EMA the config needs,
- per card, under any combination of ``shard_opt_state``, ``shard_dense``,
  ``moment_dtype``, ``ema_decay``, and a mesh shape
  (``parallel/zero.py::state_bytes_report``, the JAX function's arithmetic
  leaf for leaf; the model is built on the meta device, nothing is
  allocated);
- ``--measure`` (the counterpart of ``--compile``): the card's own peak,
  ``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
  over one update of the step form the flags select (``--grad-accum`` M >
  1: the accumulation step; ``--remat``, ``--adj-half`` as configured;
  the kernels launch, as on every card), after one warm-up update. One card:
  it refuses ``--mesh``, and without a card it exits 1 and prints no
  result line. A step that does not fit is a result, as JAX's compile
  OOM is: ``torch.OutOfMemoryError`` in either update gives ``fits:
  false`` with the allocator's reserved bytes at the failure
  (``oom_used_bytes``) and the card's capacity, "DOES NOT FIT" and exit 0
  (``scripts/fit_frontier.py`` reads it as ``oom``).

``--topology`` (an ahead-of-time XLA compile for a TPU slice) has no torch
counterpart and is refused.

Usage:
  python -m littlegan_tpu_torch.scripts.memory_report --dim 1024 --batch 8
  python -m littlegan_tpu_torch.scripts.memory_report --dim 1024 --batch 32 \\
      --mesh data=4,model=2 --shard-opt-state --shard-dense \\
      --moment-dtype bfloat16 --ema 0.999
  python -m littlegan_tpu_torch.scripts.memory_report --dim 128 --batch 32 --measure
Prints one JSON line (machine-readable) after a human-readable table.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict


def _fmt(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n:.2f} GiB"


TOPOLOGY_REFUSAL = ("memory_report: --topology compiles for a TPU slice ahead of time and has no counterpart in "
                    "the port; --measure runs one update on this card")
MESH_REFUSAL = "memory_report: --measure runs one card; it takes no --mesh"


def measured_step_report(cfg, device=None) -> Dict:
    """The card's peak over one update of ``cfg``'s step form (after one
    warm-up update): the bytes allocated before it (the train state and
    the inputs) and the peak during it, with the kernels' launches in it;
    ``fits`` and the card's ``hbm_capacity_bytes``. An out-of-memory error
    in either update (the warm-up is the same update) is the verdict
    ``fits: false``, with the bytes the allocator held at the failure
    (``oom_used_bytes``) and the error's text; any other error raises.
    ``device``: the card (default the current one)."""
    import numpy as np
    import torch

    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import draw_step, make_accum_train_step, make_train_step, stack_draws

    device = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    state = create_train_state(cfg, device)
    rng = np.random.default_rng(0)
    m = cfg.grad_accum
    lead = (m,) if m > 1 else ()
    gen = torch.Generator(device=device).manual_seed(0)

    def batch():
        img = rng.uniform(-1, 1, (*lead, cfg.batch_size, *cfg.image_shape)).astype(np.float32)
        cond = rng.uniform(0, 1, (*lead, cfg.batch_size, cfg.cond_dim)).astype(np.float32)
        return torch.from_numpy(img).to(device), torch.from_numpy(cond).to(device)

    def draws():
        if m == 1:
            return draw_step(gen, cfg, cfg.batch_size, device)
        return stack_draws([draw_step(gen, cfg, cfg.batch_size, device) for _ in range(m)])

    step = (make_accum_train_step if m > 1 else make_train_step)(cfg, state)
    b1, b2 = batch(), batch()
    rep = {"device": torch.cuda.get_device_name(device), "step": "accum" if m > 1 else "train",
           "kernels": _build.runs_kernel(device),
           "hbm_capacity_bytes": int(torch.cuda.mem_get_info(device)[1])}
    try:
        step(state, b1, b2, draws(), 11)  # warm-up: the kernels' build, cuDNN's plans
        d = draws()
        torch.cuda.synchronize(device)
        for c in _build.COUNTERS.values():
            c.reset()
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = step(state, b1, b2, d, 12)
        torch.cuda.synchronize(device)
    except torch.OutOfMemoryError as e:
        return {**rep, "fits": False, "oom_used_bytes": int(torch.cuda.memory_reserved(device)),
                "oom_error": str(e)[:500]}
    peak = torch.cuda.max_memory_allocated(device)
    losses = [float(v) for v in out.metrics.values()]
    return {**rep, "fits": True, "before_bytes": int(before), "peak_bytes": int(peak),
            "launches": {k: v for k, v in _build.launch_counts().items() if v},
            "losses_finite": bool(np.all(np.isfinite(losses)))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--mesh", default=None, help="e.g. 'data=8' or 'data=4,model=2'")
    p.add_argument("--shard-opt-state", action="store_true")
    p.add_argument("--shard-dense", action="store_true")
    p.add_argument("--moment-dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--ema", type=float, default=0.0)
    p.add_argument("--remat", action="store_true",
                   help="recompute block internals in the backward (Config.remat): moves only --measure")
    p.add_argument("--grad-accum", type=int, default=1, metavar="M",
                   help="--measure the accumulation step: M micro-pairs of --batch rows per update, one "
                        "micro-pair's activations live")
    p.add_argument("--adj-half", action="store_true",
                   help="the adjuster on one alternating batch (Config.adj_half_batch): moves only --measure")
    p.add_argument("--measure", action="store_true",
                   help="also run one update on the card and report its peak (torch.cuda.max_memory_allocated)")
    p.add_argument("--topology", default=None, metavar="NAME", help="refused: a TPU-only AOT compile")
    args = p.parse_args(argv)

    if args.topology is not None:
        print(TOPOLOGY_REFUSAL, file=sys.stderr)
        return 2
    mesh_shape = None
    if args.mesh:
        mesh_shape = {}
        for part in args.mesh.split(","):
            k, v = part.split("=")
            mesh_shape[k.strip()] = int(v)
    if args.measure:
        import torch

        if mesh_shape:
            print(MESH_REFUSAL, file=sys.stderr)
            return 2
        if not torch.cuda.is_available():
            print("memory_report: --measure needs a CUDA device (a CPU number is no card's)", file=sys.stderr)
            return 1

    from littlegan_tpu_torch.config import Config
    from littlegan_tpu_torch.parallel.zero import state_bytes_report

    cfg = Config(
        image_dim=args.dim, init_dim=args.dim // 16, batch_size=args.batch, compute_dtype="bfloat16",
        shard_opt_state=args.shard_opt_state, shard_dense=args.shard_dense, moment_dtype=args.moment_dtype,
        ema_decay=args.ema, remat=args.remat, grad_accum=args.grad_accum, adj_half_batch=args.adj_half,
        debug=True,
    )
    rep = state_bytes_report(cfg, mesh_shape)
    print(f"train-state memory @ {args.dim}² b{args.batch} "
          f"(mesh={mesh_shape or 'single chip'}, moment_dtype={args.moment_dtype}, "
          f"shard_opt_state={args.shard_opt_state}, shard_dense={args.shard_dense}, "
          f"ema={args.ema}):")
    for name in ("params", "opt_mu_nu", "ema"):
        r = rep[name]
        print(f"  {name:10s} global {_fmt(r['global_bytes']):>12s}   "
              f"per-chip {_fmt(r['per_chip_bytes']):>12s}")
    print(f"  {'TOTAL':10s} global {_fmt(rep['total_global_bytes']):>12s}   "
          f"per-chip {_fmt(rep['total_per_chip_bytes']):>12s}")
    out = {
        "dim": args.dim, "batch": args.batch, "mesh": mesh_shape,
        "moment_dtype": args.moment_dtype,
        "shard_opt_state": args.shard_opt_state, "shard_dense": args.shard_dense,
        "ema_decay": args.ema, "remat": args.remat, "grad_accum": args.grad_accum,
        "adj_half_batch": args.adj_half,
        **rep,
    }
    if args.measure:
        meas = measured_step_report(cfg)
        if meas["fits"]:
            print(f"  measured {meas['step']} step on {meas['device']}: {_fmt(meas['before_bytes'])} allocated "
                  f"before it, peak {_fmt(meas['peak_bytes'])}")
        else:
            print(f"  measured {meas['step']} step on {meas['device']}: DOES NOT FIT — "
                  f"{_fmt(meas['oom_used_bytes'])} reserved of {_fmt(meas['hbm_capacity_bytes'])}")
        out["measured"] = meas
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
