"""Isolation benchmark of K3, the boundary conv kernel, against the library
conv at the train step's shapes: the counterpart of the JAX repo's
``scripts/bench_boundary_conv.py``.

K3 (``ops/cuda/boundary_conv.py::conv3x3_same_stats``: the s2d encoder
block1's 3x3 SAME conv 12 -> 64 plus bias, with each sample's sum and sum
of squares) is timed beside ``F.conv2d`` plus the two sums (cuDNN) and
beside its plain version, at the adjuster's 64 rows, the G/D batch of 32
and the serving batch of 8, in bf16 and float32. Each time is a call's
device time from a CUDA graph of ``REPS`` calls replayed (as
``chip_smoke.py`` phase (b) times the kernels: no host launch in it), L2
warm; float32 convolutions without TF32, as ``chip_smoke.py`` runs them.
Beside it: the bound (bytes over 3.35 TB/s or operations over the dtype's
peak, the larger; H100 SXM data sheet) and K3's largest error against the
plain version, which must stay within phase (b)'s tolerance.

One line per shape and dtype, then one JSON line per row. Needs a card:
without one it raises (``utils/device.py::resolve_device``). Exits 1 when
K3 disagrees with its plain version.

  python -m littlegan_tpu_torch.scripts.bench_boundary_conv
"""

from __future__ import annotations

import argparse
import json
import sys

SHAPES = [  # (N, H, W, Cin, Cout, label)
    (64, 64, 64, 12, 64, "enc block1, adjuster batch"),
    (32, 64, 64, 12, 64, "enc block1, G/D batch"),
    (8, 64, 64, 12, 64, "enc block1, serving batch"),
]
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}  # (atol, rtol) of y, as chip_smoke.py's
REPS = 20  # calls per captured graph


def graph_ms(fn) -> float:
    """Device ms of one ``fn()``: ``REPS`` calls captured in one CUDA graph,
    replayed after a warm-up, timed by CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * REPS)


def bound_ms(n, h, w, cin, cout, dtype: str):
    """(ms, "bytes" or "operations"): x, w, b read once, y and the two sums
    written once; 2 x 9 x Cin multiply-adds per output plus the bias and
    the two sums."""
    item = 2 if dtype == "bfloat16" else 4
    n_out = n * h * w * cout
    nbytes = (n * h * w * cin + 9 * cin * cout + cout + n_out) * item + 2 * 4 * n
    flops = 2 * n_out * 9 * cin + 3 * n_out
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bench(device=None) -> list:
    """Every row of :data:`SHAPES` x (bf16, f32): times, bound, error."""
    from littlegan_tpu_torch.eval.inception import exact_float32
    from littlegan_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"bench_boundary_conv times K3 on a card, not on {dev}")
    with exact_float32():  # the float32 plain version and library conv without TF32, as phase (b) runs them
        return _bench(dev)


def _bench(dev) -> list:
    import torch
    import torch.nn.functional as F

    from littlegan_tpu_torch.ops.cuda.boundary_conv import conv3x3_same_stats, conv3x3_same_stats_plain, kernel_route

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for n, h, w, cin, cout, label in SHAPES:
            x = torch.randn((n, h, w, cin), device=dev, generator=gen).to(dt)
            wt = (torch.randn((3, 3, cin, cout), device=dev, generator=gen) * 0.2).to(dt)
            b = (torch.randn((cout,), device=dev, generator=gen) * 0.1).to(dt)
            y, _, _ = conv3x3_same_stats(x, wt, b)
            py, _, _ = conv3x3_same_stats_plain(x, wt, b)
            torch.cuda.synchronize()
            err = float((y.float() - py.float()).abs().max())
            atol, rtol = TOL[dtype]
            ok = bool(((y.float() - py.float()).abs() <= atol + rtol * py.float().abs()).all())
            xt = x.permute(0, 3, 1, 2)
            wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

            def library():
                out = F.conv2d(xt, wl, b, padding=1)
                return out, out.float().sum((1, 2, 3)), out.float().square().sum((1, 2, 3))

            k3 = graph_ms(lambda: conv3x3_same_stats(x, wt, b))
            lib = graph_ms(library)
            plain = graph_ms(lambda: conv3x3_same_stats_plain(x, wt, b))
            bnd, by = bound_ms(n, h, w, cin, cout, dtype)
            rows.append({"label": label, "shape": [n, h, w, cin], "cout": cout, "dtype": dtype,
                         "route": kernel_route(dt), "k3_ms": k3, "library_ms": lib, "plain_ms": plain,
                         "bound_ms": bnd, "bound_by": by, "max_abs_err": err, "within_tol": ok,
                         "tflops": 2 * n * h * w * cout * 9 * cin / (k3 * 1e-3) / 1e12})
            del x, xt, y, py
    return rows


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    import torch

    rows = bench()
    print(f"# {torch.cuda.get_device_name(0)}")
    for r in rows:
        print(f"{r['label']:28s} {r['dtype']:8s} {tuple(r['shape'])} -> {r['cout']}: "
              f"library {r['library_ms'] * 1e3:8.1f}us | K3 ({r['route']}) {r['k3_ms'] * 1e3:8.1f}us "
              f"({r['tflops']:5.1f} TF/s, bound {r['bound_ms'] * 1e3:6.1f}us by {r['bound_by']}) | "
              f"plain {r['plain_ms'] * 1e3:8.1f}us | speedup {r['library_ms'] / r['k3_ms']:5.2f}x | "
              f"max_abs_err {r['max_abs_err']:.3g}{'' if r['within_tol'] else ' OVER TOLERANCE'}")
    for r in rows:
        print(json.dumps(r))
    return 0 if all(r["within_tol"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
