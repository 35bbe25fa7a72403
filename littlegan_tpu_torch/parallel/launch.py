"""Rank processes on one host, for the tools that run one process per card
(``scripts/scaling_curve.py``, ``dryrun.py``).

:func:`run_ranks` starts ``n`` processes of a module with the environment
``torchrun`` gives (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), each as
``python -m <module> --rank SPEC OUT``; the ranks meet at a file in the
run's temporary directory (no port to pick), which :func:`join_group` hands
to ``torch.distributed``. The module's ``--rank`` branch writes its result
as JSON to OUT, and :func:`run_ranks` returns every rank's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from typing import List

_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(module: str, spec: dict, n: int, cpu: bool, timeout: float = 1800.0) -> List[dict]:
    """Start ``n`` rank processes of ``module`` on ``spec`` (plus its
    ``rendezvous`` file) and return their results in rank order; raises
    with the failed ranks' output if any fails. ``cpu``: one thread per
    rank (gloo ranks share the host's cores)."""
    with tempfile.TemporaryDirectory(prefix="lg_ranks_") as tmp:
        spec = {**spec, "rendezvous": os.path.join(tmp, "rendezvous")}
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        path = os.environ.get("PYTHONPATH", "")
        base = {**os.environ, "PYTHONPATH": _PACKAGE_PARENT + (os.pathsep + path if path else ""),
                "WORLD_SIZE": str(n), "LOCAL_WORLD_SIZE": str(n)}
        if cpu:
            base["OMP_NUM_THREADS"] = "1"
        procs = []
        for r in range(n):
            env = {**base, "RANK": str(r), "LOCAL_RANK": str(r)}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, "--rank", spec_path, os.path.join(tmp, f"{r}.json")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"{module} {spec.get('tag', '')}: ranks {bad} failed:\n"
                               + "\n".join(f"--- rank {r}\n{logs[r][-4000:]}" for r, _ in bad))
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"{r}.json")) as f:
                out.append(json.load(f))
        return out


def join_group(device, rendezvous: str):
    """This rank (its environment says which) joined to the others at the
    ``rendezvous`` file, NCCL on a card and gloo on the CPU; returns its
    :class:`~littlegan_tpu_torch.parallel.mesh.DataGroup`."""
    import torch
    import torch.distributed as dist

    from littlegan_tpu_torch.parallel.mesh import data_group

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=f"file://{rendezvous}",
                            world_size=int(os.environ["WORLD_SIZE"]), rank=int(os.environ["RANK"]))
    return data_group(device)
