"""Training throughput and MFU on one card, the counterpart of the JAX
repo's ``bench.py``.

    python -m littlegan_tpu_torch.bench                  # 128², batch 32, one JSON line
    python -m littlegan_tpu_torch.bench --kernels        # both kernel flags on
    python -m littlegan_tpu_torch.bench --dim 512 --batch 8 --k 4

It measures the full train step (G, D and the adjuster forward and
backward, the on-card augmentation, the three masked Adams and the
partition schedule) at the reference's training scale, 128x128 images,
batch 32, bf16, through the production dispatch path: a uint8 store of
batches on the card and ``steps_per_dispatch`` K updates as one CUDA graph
replay (``training/step.py::make_scan_train_step``,
``training/dispatch.py``), the path ``device_data`` training takes.

Accounting is the reference's: each step consumes TWO batches
(``eager_trainer.py:117-118``), so images/s = 2 x batch / step time.

Besides images/s the line carries:

- ``step_ms``: wall time per update, the best of ``repeats`` windows of
  ``MEASURE_DISPATCHES`` dispatches, each window closed by
  ``torch.cuda.synchronize()``;
- ``model_tflops_per_step``: the FLOPs of one step, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over one plain-op step
  (forward plus the three ``autograd.grad`` of ``micro_grads``) on the meta
  device, after the timing, with the kernel flags and ``remat`` off (the
  kernels are invisible to the counter and compute the same function;
  recompute is not model work). The counter counts every tap of a
  convolution; XLA's cost model, which the JAX bench reads, leaves out the
  taps that fall on padding, so the port's count is the larger by their
  share (``tests/test_torch_bench.py`` states the ratio);
- ``mfu``: achieved FLOP/s over the card's dense bf16 peak, looked up by
  ``torch.cuda.get_device_name()`` in :data:`PEAK_TFLOPS_BF16`; a card not
  in the table gets no ``mfu`` (null), never a guess;
- ``vs_baseline``: against the derived V100 baseline of the JAX bench (the
  reference publishes no numbers): fp32 peak 15.7 TFLOP/s x 30% assumed
  utilisation;
- ``graph_capture_s`` and ``peak_memory_mb``: the K-update graph's capture
  (its eager warm-up included) and ``torch.cuda.max_memory_allocated``
  over the whole run; ``kernel_launches`` with ``--kernels``: each kernel
  wrapper's launches over the timed windows.

Without a card it exits 1 and prints no result: there is no CPU fallback.
``--device cpu`` asks for the CPU explicitly (the tests' smoke run); its
line says ``"device": "cpu"`` and its times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Tuple

# K updates per CUDA graph replay when --k is not given (dispatch plumbing:
# the K updates are exactly K sequential steps). Swept with
# scripts/autotune.py --ks 1,2,4,8,16,32,64 at 128², batch 32 on an H100
# 80GB HBM3 at a 700 W power limit: with both kernel flags K = 1-16 took
# 10.82-10.86 ms per update, K = 32 10.38 and K = 64 10.31 (the fastest);
# without them every K took 25.0-26.0 ms. A graph of K updates holds more
# memory as K grows (peak 1.8 GB at K = 8, 3.2 GB at K = 64 with the
# kernels).
STEPS_PER_DISPATCH = 64
WARMUP_DISPATCHES = 2
MEASURE_DISPATCHES = 5
N_STORE_BATCHES = 16

# dense bf16 tensor-core peak (FLOP/s, no sparsity) by torch.cuda.get_device_name()
PEAK_TFLOPS_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # H100 SXM5, NVIDIA's data sheet
}

# Derived V100 baseline of the JAX bench: fp32 peak x assumed utilisation.
V100_FP32_PEAK = 15.7e12
V100_ASSUMED_UTIL = 0.30


def bench_config(dim: int, batch: int, adj_half: bool = False, moment_dtype: str = "float32", remat: bool = False,
                 no_s2d: bool = False, kernels: bool = False):
    """The measured configuration: the JAX bench's (bf16, partition
    schedule, adjuster), with the kernel flags as asked."""
    from littlegan_tpu_torch.config import Config

    return Config(
        image_dim=dim, init_dim=dim // 16, batch_size=batch, compute_dtype="bfloat16", use_partition=True,
        train_adj=True, adj_half_batch=adj_half, moment_dtype=moment_dtype, remat=remat, use_s2d=not no_s2d,
        use_pallas=kernels, use_pallas_boundary=kernels, debug=True,
    )


def auto_k(dim: int, batch: int, cap: int = STEPS_PER_DISPATCH) -> int:
    """K when none is asked: ``cap``, shrunk so one dispatch's f32
    batch-pair bytes stay under 1 GiB at large ``dim`` (the JAX bench's
    rule, ``bench.py:321-322``)."""
    pair_bytes = 2 * 4 * batch * dim * dim * 3
    return max(1, min(cap, (1 << 30) // max(1, pair_bytes)))


def auto_store_batches(cfg, k: int) -> int:
    """The store's size in batches when the caller pins none: one dispatch
    takes batch ids [0, 2k), so hold at least 2k (and 16), capped at 2 GiB
    of uint8 images so a large ``dim`` measures the step rather than the
    store (ids past the store clamp onto its last batch)."""
    batch_bytes = cfg.batch_size * cfg.image_dim ** 2 * cfg.image_channel
    return max(2, min(max(N_STORE_BATCHES, 2 * k), (2 << 30) // max(1, batch_bytes)))


def build_scan_harness(cfg, k: int = STEPS_PER_DISPATCH, n_store: Optional[int] = None, device=None):
    """The production-path harness, shared with ``scripts/autotune.py``: a
    uint8 store of ``n_store`` batches made on the device from a seed, the
    K-update step, and the K updates' draws (drawn once from a seed: every
    dispatch reuses them, as the JAX harness reuses its key). Returns
    ``(state, dispatch)``; ``dispatch(state, d)`` runs dispatch ``d``
    (batch ids [0, K) and [K, 2K), batch numbers from ``11 + d*K``) and
    returns the state (updated in place); ``dispatch.prepare()`` captures
    the CUDA graph (on the CPU: nothing to do), which the first call would
    do otherwise, and ``dispatch.step`` is the K-update step."""
    import numpy as np
    import torch

    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import draw_step, make_scan_train_step, stack_draws
    from littlegan_tpu_torch.utils.device import resolve_device
    from littlegan_tpu_torch.utils.image import soft

    device = resolve_device(device)
    if n_store is None:
        n_store = auto_store_batches(cfg, k)
    state = create_train_state(cfg, device)
    step = make_scan_train_step(cfg, state, k)
    gen = torch.Generator(device=device).manual_seed(1)
    shape = (cfg.batch_size, cfg.image_dim, cfg.image_dim, cfg.image_channel)
    # a uint8 store, as the production device_data store (the step rescales on the card)
    images = torch.empty((n_store, *shape), dtype=torch.uint8, device=device)
    for i in range(n_store):
        x = torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0
        images[i] = torch.round((x + 1.0) * 127.5).to(torch.uint8)
    bits = torch.rand((n_store, cfg.batch_size, cfg.cond_dim), generator=gen, device=device) < 0.5
    conds = torch.where(bits, soft(1.0), soft(-1.0)).float()
    draw_gen = torch.Generator(device=device).manual_seed(2)
    draws = stack_draws([draw_step(draw_gen, cfg, cfg.batch_size, device) for _ in range(k)])
    b1s = np.minimum(np.arange(k), n_store - 1)  # ids past the store clamp onto its last batch
    b2s = np.minimum(np.arange(k) + k, n_store - 1)

    def dispatch(state, d: int):
        step(state, images, conds, b1s, b2s, draws, 11 + d * k)
        return state

    dispatch.prepare = lambda: step.prepare(state, images, conds)
    dispatch.step = step
    return state, dispatch


def synchronize(state) -> None:
    """Wait for the card's work on ``state`` (nothing to wait for on the CPU)."""
    import torch

    p = next(state.model.parameters())
    if p.is_cuda:
        torch.cuda.synchronize(p.device)


def time_scan_dispatches(state, dispatch, k: int = STEPS_PER_DISPATCH, warmup: int = WARMUP_DISPATCHES,
                         measure: int = MEASURE_DISPATCHES, start: int = 0,
                         repeats: int = 3) -> Tuple[float, Dict[str, int]]:
    """Warm up, then time ``repeats`` windows of ``measure`` dispatches,
    each closed by a synchronise; returns (the best window's seconds per
    update, each kernel wrapper's launches over the timed windows). Best of
    windows: a window's host wall can only be stretched by what else runs
    on the host, never shortened."""
    from littlegan_tpu_torch.ops.cuda import _build

    for d in range(warmup):
        state = dispatch(state, start + d)
    synchronize(state)
    for c in _build.COUNTERS.values():
        c.reset()
    best = float("inf")
    d0 = start + warmup
    for _ in range(repeats):
        t0 = time.perf_counter()
        for d in range(measure):
            state = dispatch(state, d0 + d)
        synchronize(state)
        best = min(best, (time.perf_counter() - t0) / (measure * k))
        d0 += measure
    return best, {name: n for name, n in _build.launch_counts().items() if n}


def count_step_flops(cfg) -> float:
    """FLOPs of one train step of ``cfg``: ``FlopCounterMode`` over
    ``micro_grads`` (the forward and its three ``autograd.grad``) on the
    meta device, the kernel flags and ``remat`` off. Takes no device
    memory."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from littlegan_tpu_torch.models.littlegan import LittleGAN
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import _adj_sel, micro_grads, zero_draws

    cfg = cfg.replace(use_pallas=False, use_pallas_boundary=False, remat=False)
    with torch.device("meta"):
        model = LittleGAN(cfg)
    state = create_train_state(cfg, "meta", model)
    shape = (cfg.batch_size, cfg.image_dim, cfg.image_dim, cfg.image_channel)
    batch = lambda: (torch.empty(shape, dtype=torch.uint8, device="meta"),  # noqa: E731
                     torch.empty((cfg.batch_size, cfg.cond_dim), device="meta"))
    with FlopCounterMode(display=False) as counter:
        micro_grads(state, batch(), batch(), zero_draws(cfg, cfg.batch_size, "meta"), cfg,
                    _adj_sel(11, cfg, "meta"))
    return float(counter.get_total_flops())


def metric_name(args, auto_k_value: int, auto_store: int) -> str:
    """The JAX bench's metric name for the same flags (``bench.py:378-389``),
    with ``_kernels`` last for the port's kernel flag."""
    suffix = "_adjhalf" if args.adj_half else ""
    if args.moment_dtype == "bfloat16":
        suffix += "_mbf16"
    if args.remat:
        suffix += "_remat"
    if args.no_s2d:
        suffix += "_nos2d"
    if args.k and args.k != auto_k_value:
        suffix += f"_k{args.k}"
    if args.store_batches and args.store_batches != auto_store:
        suffix += f"_store{args.store_batches}"
    if args.kernels:
        suffix += "_kernels"
    return f"train_images_per_sec_per_chip_{args.dim}px_b{args.batch}{suffix}"


def _nonneg_int(value: str) -> int:
    n = int(value)
    if n < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {n}")
    return n


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--adj-half", action="store_true",
                    help="the opt-in adj_half_batch step (an _adjhalf suffix; not the parity step)")
    ap.add_argument("--moment-dtype", default="float32", choices=("float32", "bfloat16"),
                    help="Adam moment storage dtype; bfloat16 adds an _mbf16 suffix")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each network application in the backward (a _remat suffix)")
    ap.add_argument("--no-s2d", action="store_true",
                    help="turn off the space-to-depth boundary layout (a _nos2d suffix)")
    ap.add_argument("--store-batches", type=_nonneg_int, default=0,
                    help="the store's size in batches (0 = auto: max(16, 2K) capped at 2 GiB); "
                         "another size adds a _storeN suffix")
    ap.add_argument("--k", type=_nonneg_int, default=0,
                    help=f"updates per CUDA graph replay (0 = auto: {STEPS_PER_DISPATCH}, shrunk as the batch "
                         "pair's bytes pass 1 GiB); another K adds a _kN suffix")
    ap.add_argument("--kernels", action="store_true",
                    help="both kernel flags on (use_pallas, use_pallas_boundary; a _kernels suffix); the line "
                         "then carries kernel_launches")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU; default: the card")
    return ap.parse_args(argv)


def measure(args) -> dict:
    """The measurement; returns the JSON line's dict."""
    import torch

    from littlegan_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    cfg = bench_config(args.dim, args.batch, args.adj_half, args.moment_dtype, args.remat, args.no_s2d,
                       args.kernels)
    k_auto = auto_k(args.dim, args.batch)
    k = args.k or k_auto
    store_auto = auto_store_batches(cfg, k)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    state, dispatch = build_scan_harness(cfg, k=k, n_store=args.store_batches or store_auto, device=device)
    t0 = time.perf_counter()
    dispatch.prepare()
    synchronize(state)
    capture_s = time.perf_counter() - t0
    step_s, launches = time_scan_dispatches(state, dispatch, k=k)
    peak_mb = torch.cuda.max_memory_allocated(device) / 2 ** 20 if cuda else None
    images_per_sec = 2 * cfg.batch_size / step_s

    # the FLOP count after the timing, on the meta device: no device memory
    try:
        flops_per_step, flops_note = count_step_flops(cfg), None
    except Exception as e:  # noqa: BLE001 - a failed count loses mfu, not the throughput line
        flops_per_step, flops_note = 0.0, f"flops count failed ({type(e).__name__}: {e}); mfu omitted"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    out = {
        "metric": metric_name(args, k_auto, store_auto),
        "value": round(images_per_sec, 2),
        "unit": "images/sec",
        "step_ms": round(step_s * 1000, 3),
        "steps_per_dispatch": k,
        "device_kind": kind,
        "device": device.type,
        "graph_capture_s": round(capture_s, 3) if cuda else None,
        "peak_memory_mb": round(peak_mb, 1) if cuda else None,
    }
    if args.kernels:
        out["kernel_launches"] = launches
    if flops_per_step > 0:
        achieved = flops_per_step / step_s
        baseline_img_s = 2 * cfg.batch_size / (flops_per_step / (V100_FP32_PEAK * V100_ASSUMED_UTIL))
        ratio = images_per_sec / baseline_img_s
        peak = PEAK_TFLOPS_BF16.get(kind)
        out.update({
            "vs_baseline": round(ratio, 3 if ratio >= 0.01 else 6),
            "model_tflops_per_step": round(flops_per_step / 1e12, 4),
            "achieved_tflops": round(achieved / 1e12, 2),
            "baseline_images_per_sec": round(baseline_img_s, 1),
            "baseline_derivation": (f"V100 fp32 peak {V100_FP32_PEAK / 1e12:.1f}TF x {V100_ASSUMED_UTIL:.0%} "
                                    "assumed util (TF1.15 eager+defun)"),
            "mfu": round(achieved / peak, 4) if peak else None,
            "peak_tflops_bf16": round(peak / 1e12, 1) if peak else None,
        })
        if peak is None:
            out["mfu_note"] = f"no bf16 peak known for device {kind!r}"
    else:  # the count failed: the line stays valid and says why
        out.update({"vs_baseline": 0.0, "baseline_derivation": flops_note, "flops_note": flops_note,
                    "mfu": None, "peak_tflops_bf16": None})
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print("bench: no CUDA device (pass --device cpu to run on the CPU); no result", file=sys.stderr)
            return 1
    print(json.dumps(measure(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
