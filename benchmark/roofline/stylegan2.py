"""The least time the card could take for StyleGAN2's FIR resampling (S4,
``csrc/upfirdn2d.cu``), worked out from a configuration's layer shapes.

A launch's bytes count its input read once and its output written once;
its operations are two per nonzero filter tap of each output (16 taps, 4
where the map is zero-inserted). The bound is the larger of bytes over the
card's memory bandwidth and operations over its peak rate
(``benchmark/roofline``'s constants); S4 is bytes-bound at every shape.

The launches of one iteration, by the phases that run (``training/
stylegan2.py``; each G pass at batch n filters ``conv0``'s output at every
resolution r from 8 up, a (n, C_r, 2r+1, 2r+1) -> (n, C_r, 2r, 2r) map in
the compute dtype, and upsamples the float32 (n, 3, r/2, r/2) image; each D
pass filters every block's (n, C_r, r, r) input padded by 2 to (r+1)^2 and
downsamples it to (r/2)^2 for the skip):

- Gmain: a G and a D pass at B, forward; the adjoint of each (the
  generator's loss reaches every filter's input);
- Greg: a G pass at B / pl_batch_shrink; the first backward's adjoints of
  all its filters; the second backward runs the forward form again on the
  ``conv0`` filters' adjoints (the image's are functions of the constant
  noise alone) and the adjoint of the ``conv0`` filters (the
  demodulation's gradient reads their outputs);
- Dmain: a G pass (no gradient) and two D passes at B, the adjoints of the
  two D passes;
- Dreg: a D pass at B, its adjoints, and both again in the double backward
  (the minibatch stddev's gradient reads every block's output).

Forward-form launches count on ``stylegan2.upfirdn2d``, adjoint-form ones on
``stylegan2.upfirdn2d_bwd`` (``ops/cuda/upfirdn2d.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from benchmark.roofline import ITEM, bound_s

Launch = Tuple[int, int, int, int, int, str]  # (in elements, out elements, taps, count, bwd?, dtype)
COUNTERS = ("stylegan2.upfirdn2d", "stylegan2.upfirdn2d_bwd")


def _ch(cfg: dict, res: int) -> int:
    return min(cfg["channel_base"] // res, cfg["channel_max"])


def _res(cfg: dict) -> List[int]:
    return [2 ** i for i in range(3, int(math.log2(cfg["image_dim"])) + 1)]


def g_filters(cfg: dict, n: int, conv0_only: bool = False) -> List[Tuple[int, int, int, str]]:
    """(in elements, out elements, taps, dtype) of a G pass's filters."""
    dt = cfg.get("compute_dtype", "bfloat16")
    out = []
    for r in _res(cfg):
        c = _ch(cfg, r)
        out.append((n * c * (2 * r + 1) ** 2, n * c * (2 * r) ** 2, 16, dt))
        if not conv0_only:
            out.append((n * 3 * (r // 2) ** 2, n * 3 * r * r, 4, "float32"))
    return out


def d_filters(cfg: dict, n: int) -> List[Tuple[int, int, int, str]]:
    dt = cfg.get("compute_dtype", "bfloat16")
    out = []
    for r in _res(cfg):
        c = _ch(cfg, r)
        out.append((n * c * r * r, n * c * (r + 1) ** 2, 16, dt))
        out.append((n * c * r * r, n * c * (r // 2) ** 2, 16, dt))
    return out


def adjoint(launches):
    """The adjoint forms: input and output swapped (4 taps where the adjoint's input is zero-inserted)."""
    return [(o, i, 4 if i > o else taps, dt) for i, o, taps, dt in launches]


def iteration_launches(cfg: dict, greg: bool, dreg: bool) -> Dict[str, list]:
    """``{"fwd": [...], "bwd": [...]}`` (in, out, taps, dtype) of one iteration's S4 launches."""
    b = cfg["batch_size"]
    fwd, bwd = [], []
    g, d = g_filters(cfg, b), d_filters(cfg, b)
    fwd += g + d
    bwd += adjoint(g) + adjoint(d)
    if greg:
        nb = b // cfg.get("pl_batch_shrink", 2)
        gp, conv0 = g_filters(cfg, nb), g_filters(cfg, nb, conv0_only=True)
        fwd += gp + adjoint(adjoint(conv0))
        bwd += adjoint(gp) + adjoint(conv0)
    fwd += g + d + d
    bwd += adjoint(d) + adjoint(d)
    if dreg:
        fwd += d + d
        bwd += adjoint(d) + adjoint(d)
    return {"fwd": fwd, "bwd": bwd}


def launch_bound_s(launch) -> float:
    i, o, taps, dt = launch
    return bound_s((i + o) * ITEM[dt], 2.0 * taps * o, "bfloat16" if dt == "bfloat16" else "float32")


def period_bound(cfg: dict) -> Dict[str, Tuple[float, int]]:
    """Per form, (bound in seconds, launches) over one lazy period of
    ``lcm(g_reg_interval, d_reg_interval)`` iterations."""
    gi, di = cfg.get("g_reg_interval", 4), cfg.get("d_reg_interval", 16)
    out = {"fwd": [0.0, 0], "bwd": [0.0, 0]}
    for it in range(math.lcm(gi, di)):
        for form, launches in iteration_launches(cfg, it % gi == 0, it % di == 0).items():
            out[form][0] += sum(launch_bound_s(x) for x in launches)
            out[form][1] += len(launches)
    return {k: (v[0], v[1]) for k, v in out.items()}
