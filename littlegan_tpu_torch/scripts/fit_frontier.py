"""What fits on one card: a frontier of (dim, batch) x flag-set points, the
counterpart of the JAX repo's ``scripts/fit_frontier.py``.

Each probe runs ``python -m littlegan_tpu_torch.scripts.memory_report
--measure`` in a SUBPROCESS of its own (an out-of-memory error must not
poison later probes, and a hung probe must time out, not wedge the sweep):
one warm-up and one measured update of the step on the card, whose JSON
last line gives the verdict: ``fits`` (with the update's peak), ``oom``
(the allocator's reserved bytes when the update ran out of memory; the
report says "DOES NOT FIT" and exits 0), ``timeout`` or ``error`` (no
result line: the exit code and the end of its standard error). One JSON
line per probe, and with ``--search`` one ``max_fitting_batch`` line per
flag set. A probe that gives no verdict (``timeout``, ``error``) makes the
run exit 1 after the others; without a card it exits 2 before any probe.

The verdict is for the single host-fed train step (or with ``accumM`` the
accumulation step). The card-resident dataset (``device_data``) adds its
uint8 store on top: the ``n_images_headroom`` column says how many store
images fit in the card's memory left over after the step's peak (0 when
the step alone does not fit), the capacity being the one the probe
reports (``torch.cuda.mem_get_info``'s total), not a constant.

Usage:
  python -m littlegan_tpu_torch.scripts.fit_frontier --points 128:32,128:256 \\
      --flagsets parity,remat [--out fit_h100.json]
  python -m littlegan_tpu_torch.scripts.fit_frontier --search 1024 --flagsets remat  # max batch

Flags inside a flag set (joined with '+'), as in JAX: parity (none), remat,
adjhalf, mbf16, ema, zero (shard_opt_state), sdense (shard_dense), accumM
(the accumulation step: M micro-pairs of ``batch`` rows per update, one
micro-pair's activations live). ``zero`` and ``sdense`` go to the probe as
given: one card shards nothing, and the row records the flags with the
verdict the probe gives.

``--topology`` (the multi-chip step compiled ahead of time for a TPU
slice) has no counterpart on a card and is refused, with ``memory_report``'s
own refusal, and so is ``--mesh`` (``--measure`` runs one card). JAX's
``--hbm-gib`` is gone: the probe reports the card's capacity.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

from littlegan_tpu_torch.scripts.memory_report import MESH_REFUSAL, TOPOLOGY_REFUSAL

_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FLAG_ARGS = {
    "parity": [],
    "remat": ["--remat"],
    "adjhalf": ["--adj-half"],
    "mbf16": ["--moment-dtype", "bfloat16"],
    "ema": ["--ema", "0.999"],
    "zero": ["--shard-opt-state"],
    "sdense": ["--shard-dense"],
}


def flagset_args(flagset: str) -> list[str]:
    args: list[str] = []
    for f in flagset.split("+"):
        m = re.fullmatch(r"accum(\d+)", f)  # accumM: M micro-pairs per update
        if m:
            args += ["--grad-accum", m.group(1)]
            continue
        if f not in FLAG_ARGS:
            raise SystemExit(f"unknown flag '{f}' (know: {sorted(FLAG_ARGS)} + 'accumM')")
        args += FLAG_ARGS[f]
    return args


def probe(dim: int, batch: int, flagset: str, timeout_s: int) -> dict:
    """One measured update in a fresh subprocess; returns the verdict."""
    cmd = [sys.executable, "-m", "littlegan_tpu_torch.scripts.memory_report", "--dim", str(dim),
           "--batch", str(batch), "--measure", *flagset_args(flagset)]
    path = os.environ.get("PYTHONPATH", "")
    env = {**os.environ, "PYTHONPATH": _PACKAGE_PARENT + (os.pathsep + path if path else "")}
    point = {"dim": dim, "batch": batch, "flags": flagset}
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s, cwd=_PACKAGE_PARENT, env=env)
    except subprocess.TimeoutExpired:
        return {**point, "verdict": "timeout", "note": f"probe exceeded {timeout_s}s"}
    # memory_report prints the machine-readable JSON as its last stdout line
    rep = None
    for line in reversed(r.stdout.splitlines()):
        if line.startswith("{"):
            rep = json.loads(line)
            break
    if r.returncode != 0 or rep is None or "measured" not in rep:
        return {**point, "verdict": "error", "exit": r.returncode, "stderr_tail": r.stderr[-400:]}
    meas = rep["measured"]
    out = {**point, "device": meas["device"], "n_chips": 1, "state_bytes": rep["total_per_chip_bytes"],
           "hbm_capacity_bytes": meas["hbm_capacity_bytes"]}
    if meas["fits"]:
        out.update(verdict="fits", peak_bytes=meas["peak_bytes"])
    else:
        out.update(verdict="oom", oom_used_bytes=meas["oom_used_bytes"], oom_error=meas["oom_error"])
    return out


def headroom_images(res: dict, dim: int) -> int | None:
    """How many uint8 store images fit next to the step's peak
    (``device_data`` budgeting) in the capacity the probe reported: 0 when
    the step alone does not fit (the allocator's reserved bytes at an OOM
    stay below the capacity, so they are no peak), None when the probe gave
    no peak or capacity."""
    if res.get("verdict") == "oom":
        return 0
    peak, cap = res.get("peak_bytes"), res.get("hbm_capacity_bytes")
    if peak is None or cap is None:
        return None
    per_image = dim * dim * 3  # uint8 HWC
    return max(0, (cap - peak) * res.get("n_chips", 1) // per_image)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--points", default=None, help="comma list of dim:batch probes, e.g. '128:32,128:256'")
    p.add_argument("--search", type=int, default=None, metavar="DIM",
                   help="binary-search the largest fitting batch at DIM")
    p.add_argument("--max-batch", type=int, default=64, help="--search upper bound")
    p.add_argument("--flagsets", default="parity,remat",
                   help=f"comma list of '+'-joined flag sets per point (flags: {sorted(FLAG_ARGS)} + 'accumM')")
    p.add_argument("--timeout", type=int, default=1500, help="seconds per probe")
    p.add_argument("--topology", default=None, metavar="NAME", help="refused: a TPU-only AOT compile")
    p.add_argument("--mesh", default=None, metavar="SPEC", help="refused: a probe measures one card")
    p.add_argument("--out", default=None, help="also write results JSON here")
    args = p.parse_args(argv)
    if args.topology is not None or args.mesh is not None:
        print(TOPOLOGY_REFUSAL if args.topology is not None else MESH_REFUSAL, file=sys.stderr)
        return 2
    if not args.points and args.search is None:
        p.error("need --points or --search")
    import torch

    if not torch.cuda.is_available():  # the parent opens no CUDA context: every byte is the probes'
        print("fit_frontier: no CUDA device (each probe measures an update on the card)", file=sys.stderr)
        return 2

    flagsets = [f.strip() for f in args.flagsets.split(",") if f.strip()]
    for fs in flagsets:
        flagset_args(fs)  # validate before the first probe
    results: list[dict] = []

    def record(res: dict) -> None:
        res["n_images_headroom"] = headroom_images(res, res["dim"])
        results.append(res)
        print(json.dumps(res), flush=True)

    if args.points:
        for part in args.points.split(","):
            d, b = part.strip().split(":")
            for fs in flagsets:
                record(probe(int(d), int(b), fs, args.timeout))

    if args.search is not None:
        for fs in flagsets:
            lo, hi = 0, args.max_batch  # invariant: lo fits (0 = vacuous), hi+1 unknown
            # first check the upper bound: if it fits, no search needed
            top = probe(args.search, args.max_batch, fs, args.timeout)
            record(top)
            if top["verdict"] == "fits":
                lo = args.max_batch
            else:
                hi = args.max_batch - 1
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    res = probe(args.search, mid, fs, args.timeout)
                    record(res)
                    if res["verdict"] == "fits":
                        lo = mid
                    else:  # oom, timeout or error: a non-fit, and the search goes on
                        hi = mid - 1
            best = {"dim": args.search, "flags": fs, "max_fitting_batch": lo}
            print(json.dumps(best), flush=True)
            results.append(best)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        caps = {r["hbm_capacity_bytes"] for r in results if r.get("hbm_capacity_bytes")}
        with open(args.out, "w") as f:
            json.dump({"hbm_bytes": caps.pop() if len(caps) == 1 else None, "results": results}, f, indent=1)
        print(f"wrote {args.out}")
    failed = [r for r in results if r.get("verdict") in ("error", "timeout")]
    if failed:
        print(f"fit_frontier: {len(failed)} probe(s) gave no verdict (error or timeout)", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
