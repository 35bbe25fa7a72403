#!/usr/bin/env python3
"""Drive the PyTorch port (littlegan_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which fails the run on any error:

  (a) print the card's name and power limit, build the CUDA kernels from
      ``littlegan_tpu_torch/csrc`` with nvcc, print the build time and each
      kernel's registers and spills, and require tensor-core (HMMA)
      instructions in the bf16 boundary conv kernel's SASS;
  (b) hold every kernel against its plain PyTorch version on the card, in
      float32 and bfloat16, with the tolerances stated in ``TOL``,
      ``BWD_TOL``, ``GRAD_SUM_RTOL`` and ``CONV_BWD_REL``: the forward
      kernels at the serve path's shapes (batch 8, 128x128 model), K1, K1'
      and K3 forward also at the train step's (``K1_STEP``, ``K3_STEP``),
      K1 also with a mean 30 times its std (two-pass moments) and its
      (mean, std) output, and on its routes off the main path
      (``K1_OFF_PATH``); the backward kernels at the train step's (batch 32
      and the adjuster's 64 rows): K2 (the fused norm + LeakyReLU
      backward), the stats-in norm's backward and the boundary conv's
      backward (its stats fold kernel plus PyTorch's conv gradients,
      against autograd through its plain version); time the kernel, the
      kernel launched from Python, the plain version and, where one exists,
      a PyTorch library call; and time K1's routes (two launches, clusters
      of 2 to 16 blocks) and the norm backward's two routes against each
      other, each in one run;
  (c) build an InferenceEngine at the full default width (128x128,
      conv_filter [384, 256, 128, 64, 32], bf16, s2d on, both kernels on,
      seeded random weights, batch 8), start ``serve()`` on an ephemeral
      port, answer HTTP requests to /generate, /adjust, /discriminate and
      /metrics, check the kernels' launch counts per engine call, and compare
      the engine's outputs with the same weights run through the plain
      versions on the card;
  (d) trains the full-width model (128x128, batch 32, bf16, s2d, adjuster,
      partition schedule, clipping, both kernel flags on) through
      ``Trainer`` on the synthetic dataset for 12 steps in a temporary
      result directory: checks the losses, the kernels' launches per step,
      the train image and the epoch checkpoint, and that the checkpoint
      restores in a new ``Trainer``; then one step's losses and gradients
      with the kernels against the same step through the plain versions,
      and the step's host and device times with the kernels on and off;
  (e) trains the same configuration over the card-resident dataset
      (``device_data``) with ``steps_per_dispatch`` 8: one epoch of 20
      steps (updates 1-8 and 9-16 as replays of one CUDA graph, 17-20 of
      the remainder's), crossing the partition batches and the adjuster
      gate inside a replay; checks the kernels' launches (each replay adds
      what its graph holds) and the same counts read from the kernels a
      profiler trace of the epoch saw run, the logged losses, the image, the
      checkpoint and its restore; runs the same epoch from the same init through the
      gather step (one eager update per call) and holds every step's losses
      and each group's final weights against the graph run; holds 8 updates
      of ``grad_accum`` 2 in two 4-update replays against the same updates
      run eagerly; and times the host-fed step, the gather step and the
      8-update graph in turns;
  (f) drives the sampling and evaluation path through the command line
      (``littlegan_tpu_torch.cli.main``) at the same full width in a
      temporary directory: one ``train`` epoch on the synthetic dataset
      for weights, then ``export-model``, ``plot``, ``random-sample``,
      ``condition-sample`` and ``interpolate`` (their files checked), then
      ``evaluate-sample`` of ``EVAL_SAMPLES`` images (32 ``sample_u8``
      calls at batch 32: the JPEGs and score files checked, and K1, K1'
      and K3 launched ``SAMPLE_LAUNCHES`` times per call); holds one
      ``sample_u8`` batch against the same weights through the plain
      versions (``SAMPLE_TOL``) and profiles its device time; writes
      ``EVAL_SAMPLES`` synthetic images as JPEGs, pre-calculates their
      Inception statistics with ``python -m
      littlegan_tpu_torch.eval.evaluate`` and runs ``evaluate`` with FID,
      IS, KID and PRDC on ``gen`` and ``adj`` (finite values, RANDOM-INIT
      tags); holds Inception features of 16 images on the card against the
      CPU's (``FEATURE_TOL``, float32 without TF32; the TF32 error and time
      are printed beside it) and the Newton–Schulz FID against the exact
      value of a well-conditioned 2048-d pair and against scipy's on a
      ``NS_SCIPY_DIM``-d one (``NS_RTOL``); prints evaluate-sample's
      images/s, Inception images/s at batch 100 and ``evaluate``'s host
      wall;
  (g) drives the single-card trainer's remaining options at the same full
      width: ``GP_K`` updates with the gradient penalty (both kernel flags
      off) as one CUDA graph replay against the same updates run eagerly,
      bit for bit, with the update's time and peak memory against the same
      graph without the penalty, and a GP step with a kernel flag refused;
      ``REMAT_STEPS`` steps with both kernel flags on with and without
      ``remat`` from one init (losses and weights to ``REMAT_TOL``, the
      kernels' launches per step exactly ``EXPECTED_REMAT_LAUNCHES`` and
      ``EXPECTED_TRAIN_LAUNCHES``, peak memory and time per step); one
      ``GP_K``-update replay over an s2d-layout store against the raw
      store (bit for bit, the same launches); a host-fed ``Trainer``
      epoch with ``profile_steps`` whose trace holds K1's and K3's kernels
      (its window gives the host-fed path's idle share); host-fed
      ``Trainer`` epochs with the prefetch, with a synchronous copy and
      through the gather path, in turns (images/s); and the CelebA
      pipeline on synthetic JPEGs at 128x128 and 178x218 with the native
      loader and with PIL (images/s on the host, and which decoder ran: a
      host without libjpeg decodes with PIL). Each phase's wall is printed
      after (g).

The last two lines of standard output are the card's ``nvidia-smi`` name
and power limit, then ``{"ok": true, "device": {...}}``; the line before them
is the kernels' JSON record. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core and
# float32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# |kernel - plain| <= atol + rtol*|plain|, per dtype. float32: the JAX
# package's forward tolerance (tests/test_pallas.py), sums in another order.
# bfloat16: one rounding step of 2^-8 relative can land either side, so a
# few ulps. Stats (f32 in both dtypes): s2 to rtol 1e-4; s1 to 1e-4 of
# sum|y|, since s1 may cancel to near 0.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
STATS_RTOL = 1e-4
# engine (both kernels) vs the same weights through the plain versions, bf16
ENGINE_TOL = {"image_max": 0.1, "image_mean": 5e-3, "prob_max": 0.02}

BATCH = 8
# K1's seven calls on one /adjust (encoder blocks 2-4, decoder blocks 1-4;
# decoder block4 is in s2d form); /generate makes the last four,
# /discriminate the first three
K1_SHAPES = [
    (8, 32, 32, 128), (8, 16, 16, 256), (8, 8, 8, 384),
    (8, 16, 16, 256), (8, 32, 32, 128), (8, 64, 64, 64), (8, 64, 64, 128),
]
K3_SHAPE = ((8, 64, 64, 12), 64)  # s2d encoder input -> conv_filter[3]
# K1 on routes no path of the model runs, held against the plain version
# all the same: a sample too large for one cluster's shared memory (two
# launches), and one of 75 elements (scalar loads on the cluster route)
K1_OFF_PATH = [(2, 256, 256, 64), (3, 5, 5, 3)]
# K1 with a mean 30 times its std at a whole-sample train shape: the
# two-pass moments the Pallas op takes there, against the plain version's
K1_OFFSET = ((32, 32, 32, 128), 30.0)
# K1's forward launches in one train step, by shape: G's decoder (blocks
# 1-4) and D's encoder blocks 2-4 on the real batch and on fake at 32 rows;
# the adjuster's encoder and decoder and D on its output at 64 rows
K1_STEP = [
    ((32, 32, 32, 128), 3), ((32, 16, 16, 256), 3), ((32, 8, 8, 384), 2), ((32, 64, 64, 64), 1),
    ((32, 64, 64, 128), 1), ((64, 32, 32, 128), 3), ((64, 16, 16, 256), 3), ((64, 8, 8, 384), 2),
    ((64, 64, 64, 64), 1), ((64, 64, 64, 128), 1),
]
# K3's forward launches in one train step: encoder block1 of D on the real
# batch and on fake (32 rows), of the adjuster and of D on its output (64);
# x shapes, y has 64 channels
K3_STEP = [((32, 64, 64, 12), 2), ((64, 64, 64, 12), 2)]
# K3 shapes no path runs, held against the plain version all the same: rows
# too wide for the bf16 kernel's two staging buffers (it keeps one), and an
# input width that is not a multiple of 4 channels (plain loads, no cp.async)
K3_OFF_PATH = [((2, 16, 640, 12), 64), ((2, 16, 64, 3), 32)]
# |kernel - plain| <= atol + rtol*|plain| for the backward's dx, per dtype
# (f32: tests/test_pallas.py's grad tolerance); the batch sums (dgamma,
# dbeta, the stats' cotangents) to GRAD_SUM_RTOL of the largest value of
# their kind; the boundary conv's (dx, dw, db) by relative norm error
BWD_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 2e-2)}
GRAD_SUM_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
# where the normalised value z lies this close to LeakyReLU's kink, rounding
# decides its slope (1 or alpha) differently in the kernel and in the plain
# version: such elements are left out of the dx checks, and counted
KINK = 1e-5
CONV_BWD_REL = {"float32": 1e-4, "bfloat16": 2e-2}
# one train step with the kernels vs the same step through the plain
# versions, bf16, same weights and draws: the losses to loss_rtol; each
# group's gradient to a relative norm error of grad_rel, or of floor_x
# times bf16's own error on that step (the plain bf16 step against the
# plain float32 one), whichever is larger: the gradient of the adjuster's
# head comes at the end of the longest backward chain
TRAIN_TOL = {"loss_rtol": 2e-2, "grad_rel": 5e-2, "floor_x": 3.0}
TRAIN_BATCH = 32
TRAIN_STEPS = 12  # crosses the partition batches 5 and 10 and the adjuster gate (batch_no > 10)
# K2's launches in one train step, by shape: D's encoder blocks 2-4 at batch
# 32 go backward three times (D on the real batch and on fake for the disc
# loss, D on fake again for the gen loss), G's decoder once; at the
# adjuster's 64 rows D's blocks 2-4 and the decoder once each (adj loss)
K2_STEP = [
    ((32, 32, 32, 128), 4), ((32, 16, 16, 256), 4), ((32, 8, 8, 384), 3), ((32, 64, 64, 64), 1),
    ((32, 64, 64, 128), 1), ((64, 32, 32, 128), 2), ((64, 16, 16, 256), 2), ((64, 8, 8, 384), 1),
    ((64, 64, 64, 64), 1), ((64, 64, 64, 128), 1),
]
# encoder block1's backward (the stats-in norm's, then the boundary conv's)
# in one step: D on the real batch and on fake, D on fake again, the
# adjuster's D; x shapes, y has 64 channels
BLOCK1_STEP = [((32, 64, 64, 12), 3), ((64, 64, 64, 12), 1)]
EXPECTED_TRAIN_LAUNCHES = {  # per train step
    "fused_instance_norm_lrelu": sum(c for _, c in K1_STEP), "norm_lrelu_from_stats": 4,
    "conv3x3_same_stats": sum(c for _, c in K3_STEP),
    "fused_instance_norm_lrelu_bwd": sum(c for _, c in K2_STEP),
    "norm_lrelu_from_stats_bwd": sum(c for _, c in BLOCK1_STEP),
    "conv3x3_bwd_fold": sum(c for _, c in BLOCK1_STEP),
}
# phase (e): one epoch of DISPATCH_STEPS updates, DISPATCH_K per CUDA graph
# replay: 8 + 8 + a remainder of 4, the partition batches 5, 10, 15, 20 and
# the adjuster gate (batch_no > 10) inside replays; then ACCUM_UPDATES
# updates of ACCUM_M micro-pairs, ACCUM_K per replay. The graph runs against
# eager runs of the same updates: losses to TRAIN_TOL["loss_rtol"], the
# weights at each group's end to a relative norm error of DISPATCH_PARAM_REL
DISPATCH_K = 8
DISPATCH_STEPS = 20
ACCUM_M, ACCUM_K, ACCUM_UPDATES = 2, 4, 8
DISPATCH_PARAM_REL = 1e-3
EXPECTED_LAUNCHES = {  # per engine call
    "generate": {"fused_instance_norm_lrelu": 4, "conv3x3_same_stats": 0, "norm_lrelu_from_stats": 0},
    "adjust": {"fused_instance_norm_lrelu": 7, "conv3x3_same_stats": 1, "norm_lrelu_from_stats": 1},
    "discriminate": {"fused_instance_norm_lrelu": 3, "conv3x3_same_stats": 1, "norm_lrelu_from_stats": 1},
}


def log(*a) -> None:
    print(*a, flush=True)


def require(ok, what) -> None:
    """A check that stays under ``python -O`` (unlike assert)."""
    if not ok:
        raise AssertionError(what)


def device_events(prof):
    """The device-side events (kernels, copies) of a torch.profiler run."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("Activity Buffer")]


def traced_launches(events) -> dict:
    """Each train-path wrapper's launches, counted from the kernels a
    torch.profiler trace saw run on the card (``device_events``), by the
    kernel that starts each launch (littlegan_tpu_torch/csrc): K1 its cluster
    kernel or the stats kernel of its two-launch route; K1' the forward's
    apply kernel, less those of K1's two-launch route; K2 and K1' bwd the
    backward's cluster or sums kernel (template argument kFromStats false,
    true); K3 its conv kernel; the fold its fold kernel. They sit in the
    sources' top-level anonymous namespace. A forward and a backward kernel
    of one name differ in their second argument: the forward's y is
    written, the backward's dy read."""
    out = dict.fromkeys(EXPECTED_TRAIN_LAUNCHES, 0)
    fwd_apply = stats = 0
    for e in events:
        m = re.match(r"void \(anonymous namespace\)::(\w+)(?:<([^>]*)>)?\((.*)\)\s*$", e.key)
        if m is None:
            continue
        name, targs, args = m.group(1), (m.group(2) or "").split(", "), m.group(3).split(", ")
        bwd = len(args) > 1 and args[1].endswith("const*")
        if name == "cluster_kernel" and not bwd:
            out["fused_instance_norm_lrelu"] += e.count
        elif name == "stats_kernel":
            stats += e.count
        elif name == "apply_kernel" and len(targs) == 1:
            fwd_apply += e.count
        elif name in ("sums_kernel", "cluster_kernel"):
            out["norm_lrelu_from_stats_bwd" if targs[-1] == "true" else "fused_instance_norm_lrelu_bwd"] += e.count
        elif name in ("conv3x3_mma_kernel", "conv3x3_stats_kernel"):
            out["conv3x3_same_stats"] += e.count
        elif name == "fold_kernel":
            out["conv3x3_bwd_fold"] += e.count
    out["fused_instance_norm_lrelu"] += stats
    out["norm_lrelu_from_stats"] += fwd_apply - stats
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    replayed after a warm-up, timed by CUDA events. The graph leaves out the
    host's launch overhead, which :func:`eager_ms` keeps."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def eager_ms(fn, reps: int = 50) -> float:
    """Time of one call launched from Python, back to back, by CUDA events:
    the larger of the device time and the host's launch time."""
    import torch

    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _within(got, want, atol, rtol) -> bool:
    return bool(((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all())


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_kernels():
    """Phase (b): every kernel against its plain version, timed. Returns the
    per-kernel records (without launches) and raises on a miss."""
    import torch
    import torch.nn.functional as F

    from littlegan_tpu_torch.ops.cuda import norm_lrelu as nl
    from littlegan_tpu_torch.ops.cuda.boundary_conv import (
        conv3x3_same_stats, conv3x3_same_stats_plain, kernel_route,
    )
    from littlegan_tpu_torch.ops.cuda.norm_lrelu import (
        fused_instance_norm_lrelu, fused_instance_norm_lrelu_plain,
        norm_lrelu_from_stats, norm_lrelu_from_stats_plain,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    gamma = torch.tensor([1.3], device=dev)
    beta = torch.tensor([-0.2], device=dev)
    failures = []
    records = {}

    def k1_check(x, what):
        """K1 (y and its (mean, std)) against the plain version; appends a
        failure naming ``what`` and returns y's max error. The moments, f32
        sums in another order: the mean to 1e-6 of |mean| + std, the std to
        rtol 1e-5."""
        atol, rtol = TOL[str(x.dtype).split(".")[1]]
        got, stats = nl._fused_forward(x, gamma, beta, 0.3, 1e-3)
        want = fused_instance_norm_lrelu_plain(x, gamma, beta, 0.3)
        mo = nl.instance_norm_moments_plain(x)
        torch.cuda.synchronize()
        if not _within(got, want, atol, rtol):
            failures.append(f"{what}: max_abs_err {_max_err(got, want):.3g}")
        if not (bool(((stats[0] - mo[0]).abs() <= 1e-6 * (mo[0].abs() + mo[1])).all())
                and bool(((stats[1] - mo[1]).abs() <= 1e-5 * mo[1]).all())):
            failures.append(f"{what}: (mean, std) {stats[:, :4].tolist()} vs {mo[:, :4].tolist()}")
        return _max_err(got, want)

    def rec(name, dtype, shape, err, fn, plain_ms, lib_ms, bnd, per_step=None, **extra):
        ms, em = time_ms(fn), eager_ms(fn)
        r = records.setdefault(name, {"shapes": []})
        path = {} if per_step is None else {"per_step": per_step}
        r["shapes"].append({
            "shape": list(shape), "dtype": dtype, **path, "max_abs_err": err, "ms": ms, "eager_ms": em,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bnd[0], "bound_by": bnd[1], **extra,
        })
        log(f"  {name} {dtype} {tuple(shape)}{'' if per_step is None else f' x{per_step}/step'}: "
            f"max_abs_err {err:.3g}  kernel {ms:.4f} ms (launched from Python {em:.4f} ms)  "
            f"plain {plain_ms:.4f} ms  library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}  "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})" + "".join(f"  {k} {tuple(v.values()) if isinstance(v, dict) else v}"
                                                        for k, v in extra.items()))

    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        atol, rtol = TOL[dtype_name]
        item = torch.tensor([], dtype=dt).element_size()
        log(f"K1 fused_instance_norm_lrelu, {dtype_name}, serve shapes then train-step shapes "
            "(no single PyTorch call computes it: library_ms null)")
        for shape, per_step in [(s, None) for s in K1_SHAPES] + K1_STEP:
            x = (torch.randn(shape, device=dev, generator=gen) * 2.0 + 0.5).to(dt)
            err = k1_check(x, f"K1 {dtype_name} {shape}")
            pms = time_ms(lambda: fused_instance_norm_lrelu_plain(x, gamma, beta, 0.3))
            plan = nl.fwd_plan(shape[0], x[0].numel(), item, nl._sms(dev), nl.holds_whole_sample(shape))
            rec("fused_instance_norm_lrelu", dtype_name, shape, err,
                lambda: fused_instance_norm_lrelu(x, gamma, beta, 0.3), pms, None,
                bound(2 * x.numel() * item + 8 * shape[0] + 8, 7 * x.numel(), dtype_name), per_step,
                plan=plan._asdict())
            del x
        if dtype_name == "float32":
            shape, offset = K1_OFFSET
            x = torch.randn(shape, device=dev, generator=gen) + offset
            log(f"  K1 float32 {shape}, mean {offset} times the std: max_abs_err "
                f"{k1_check(x, f'K1 float32 {shape} offset {offset}'):.3g}")
        for shape in K1_OFF_PATH:
            x = (torch.randn(shape, device=dev, generator=gen) * 2.0 + 0.5).to(dt)
            plan = nl.fwd_plan(shape[0], x[0].numel(), item, nl._sms(dev), nl.holds_whole_sample(shape))
            log(f"  K1 {dtype_name} {shape} off the main path, {plan}: max_abs_err "
                f"{k1_check(x, f'K1 {dtype_name} {shape}'):.3g}")
            del x

        log(f"K1' norm_lrelu_from_stats (stats-in apply), {dtype_name}, serve shape then train-step shapes "
            "(encoder block1 after K3: K3_STEP's launches)")
        for xshape, per_step in [(K3_SHAPE[0], None)] + K3_STEP:
            shape = xshape[:3] + (K3_SHAPE[1],)
            y = (torch.randn(shape, device=dev, generator=gen) + 0.3).to(dt)
            yf = y.float()
            s1, s2 = yf.sum((1, 2, 3)), yf.square().sum((1, 2, 3))
            got = norm_lrelu_from_stats(y, s1, s2, gamma, beta, 0.3)
            want = norm_lrelu_from_stats_plain(y, s1, s2, gamma, beta, 0.3)
            torch.cuda.synchronize()
            if not _within(got, want, atol, rtol):
                failures.append(f"K1' {dtype_name} {shape}: max_abs_err {_max_err(got, want):.3g}")
            pms = time_ms(lambda: norm_lrelu_from_stats_plain(y, s1, s2, gamma, beta, 0.3))
            rec("norm_lrelu_from_stats", dtype_name, shape, _max_err(got, want),
                lambda: norm_lrelu_from_stats(y, s1, s2, gamma, beta, 0.3), pms, None,
                bound(2 * y.numel() * item + 8 * shape[0] + 8, 4 * y.numel(), dtype_name), per_step)
            del y, yf, got, want

        log(f"K3 conv3x3_same_stats, {dtype_name}, serve shape then train-step shapes "
            "(library: F.conv2d + the two sums), then, checked only, two shapes off the main path: "
            "rows too wide for two staging buffers, and Cin 3")

        def k3_check(xshape, cout):
            x = torch.randn(xshape, device=dev, generator=gen).to(dt)
            w = (torch.randn((3, 3, xshape[3], cout), device=dev, generator=gen) * 0.2).to(dt)
            b = (torch.randn((cout,), device=dev, generator=gen) * 0.1).to(dt)
            y, s1, s2 = conv3x3_same_stats(x, w, b)
            py, ps1, ps2 = conv3x3_same_stats_plain(x, w, b)
            torch.cuda.synchronize()
            scale = py.float().abs().sum((1, 2, 3))
            if not _within(y, py, atol, rtol):
                failures.append(f"K3 y {dtype_name} {xshape}: max_abs_err {_max_err(y, py):.3g}")
            if not bool(((s1 - ps1).abs() <= STATS_RTOL * scale).all()):
                failures.append(f"K3 s1 {dtype_name} {xshape}: {s1.tolist()} vs {ps1.tolist()}")
            if not bool(((s2 - ps2).abs() <= STATS_RTOL * ps2.abs()).all()):
                failures.append(f"K3 s2 {dtype_name} {xshape}: {s2.tolist()} vs {ps2.tolist()}")
            return x, w, b, _max_err(y, py)

        cout = K3_SHAPE[1]
        for xshape, per_step in [(K3_SHAPE[0], None)] + K3_STEP:
            x, w, b, err = k3_check(xshape, cout)
            xt = x.permute(0, 3, 1, 2)
            wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

            def library():
                out = F.conv2d(xt, wt, b, padding=1)
                return out, out.float().sum((1, 2, 3)), out.float().square().sum((1, 2, 3))

            pms = time_ms(lambda: conv3x3_same_stats_plain(x, w, b))
            lms = time_ms(library)
            n_out = xshape[0] * xshape[1] * xshape[2] * cout
            nbytes = (x.numel() + w.numel() + b.numel() + n_out) * item + 2 * 4 * xshape[0]
            flops = 2 * n_out * 9 * xshape[3] + 3 * n_out
            rec("conv3x3_same_stats", dtype_name, xshape + (cout,), err,
                lambda: conv3x3_same_stats(x, w, b), pms, lms,
                bound(nbytes, flops, dtype_name), per_step, kernel_route=kernel_route(x.dtype))
            del x, xt
        for xshape, cout in K3_OFF_PATH:
            log(f"  conv3x3_same_stats {dtype_name} {xshape} -> {cout}: max_abs_err {k3_check(xshape, cout)[3]:.3g}")
    if failures:
        raise AssertionError("kernel/plain mismatch:\n  " + "\n  ".join(failures))
    return records


def _kernel_name(mangled: str) -> str:
    """The kernel's own name and template arguments out of its mangled
    name: the <length><name> part that ends in "kernel"."""
    for m in re.finditer(r"(?<=\d)[A-Za-z_]", mangled):
        i = m.start()
        digits = re.search(r"\d+$", mangled[:i]).group()
        for k in range(len(digits)):
            name = mangled[i:i + int(digits[k:])]
            if name.endswith("kernel"):
                args = re.match(r"I(\w*?)E", mangled[i + len(name):])
                return name + (f"<{args.group(1)}>" if args else "")
    return mangled


def check_tensor_cores(so: str) -> dict:
    """K3's bf16 route must run on the tensor cores: ``cuobjdump -sass`` of
    the built library has to show HMMA instructions in every instance of
    its kernel. Returns {kernel: HMMA count}; raises if there are none."""
    from littlegan_tpu_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=300, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
        elif current is not None and re.search(r"\bHMMA\b", line):
            counts[current] += 1
    mma = {k: v for k, v in counts.items() if "conv3x3_mma_kernel" in k}
    log(f"K3 bf16 route, HMMA instructions in the SASS per kernel instance: {mma}")
    require(mma and all(v > 0 for v in mma.values()), f"K3's bf16 kernel has no tensor-core instructions: {mma}")
    return mma


def _rel_err(got, want) -> float:
    """||got - want|| / ||want||, in f32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def check_backward_kernels():
    """Phase (b), backward: K2, the stats-in norm's backward and the
    boundary conv's backward against their plain versions at the train
    step's shapes, timed. Returns the per-kernel records (each shape with
    its launches per step) and raises on a miss."""
    import torch

    from littlegan_tpu_torch.ops.cuda import boundary_conv as bc
    from littlegan_tpu_torch.ops.cuda import norm_lrelu as nl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    gamma = torch.tensor([1.3], device=dev)
    beta = torch.tensor([-0.2], device=dev)
    failures = []
    records = {}

    def rec(name, dtype, shape, count, err, fn, plain_ms, lib_ms, bnd, **extra):
        ms, em = time_ms(fn), eager_ms(fn)
        r = records.setdefault(name, {"shapes": []})
        r["shapes"].append({
            "shape": list(shape), "dtype": dtype, "per_step": count, "max_abs_err": err, "ms": ms, "eager_ms": em,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bnd[0], "bound_by": bnd[1], **extra,
        })
        log(f"  {name} {dtype} {tuple(shape)} x{count}/step: max_abs_err {err:.3g}  kernel {ms:.4f} ms "
            f"(launched from Python {em:.4f} ms)  plain {plain_ms:.4f} ms  "
            f"library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound {bnd[0]:.4f} ms ({bnd[1]})"
            + "".join(f"  {k} {v:.4f}" for k, v in extra.items()))

    kinks = {}  # elements left out of the dx checks, by kernel, dtype and shape

    def sums_ok(got, want, rtol):
        return bool(((got - want).abs() <= rtol * want.abs().max().clamp_min(1e-30)).all())

    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        atol, rtol = BWD_TOL[dtype_name]
        srtol = GRAD_SUM_RTOL[dtype_name]
        item = torch.tensor([], dtype=dt).element_size()
        log(f"K2 fused_instance_norm_lrelu_bwd, {dtype_name} (no single PyTorch call computes it: library_ms null)")
        for shape, count in K2_STEP:
            x = (torch.randn(shape, device=dev, generator=gen) * 2.0 + 0.5).to(dt)
            dy = torch.randn(shape, device=dev, generator=gen).to(dt)
            _, stats = nl._fused_forward(x, gamma, beta, 0.3, 1e-3)
            got = nl.fused_instance_norm_lrelu_bwd(x, dy, gamma, beta, 0.3, 1e-3, stats)
            want = nl.fused_instance_norm_lrelu_bwd_plain(x, dy, gamma, beta, 0.3)
            xf = x.float()
            mean = xf.mean((1, 2, 3), keepdim=True)
            nrm = (xf - mean) / (xf.var((1, 2, 3), unbiased=False, keepdim=True).sqrt() + 1e-3)
            away = (nrm * gamma + beta).abs() > KINK
            torch.cuda.synchronize()
            if not _within(got[0][away], want[0][away], atol, rtol):
                failures.append(f"K2 dx {dtype_name} {shape}: max_abs_err {_max_err(got[0][away], want[0][away]):.3g}")
            kinks[("K2", dtype_name, shape)] = int((~away).sum())
            if shape == K2_STEP[0][0]:  # without the forward's partials: the stats pass runs first, same result
                again = nl.fused_instance_norm_lrelu_bwd(x, dy, gamma, beta, 0.3, 1e-3)
                if not all(torch.equal(a, b) for a, b in zip(again, got)):
                    failures.append(f"K2 {dtype_name} {shape}: the stats-less call differs from the stats-in one")
            # dgamma = sum(dz * n), dbeta = sum(dz) over the batch: held to
            # srtol of the sums of their terms' magnitudes (they may cancel)
            scales = {1: float((dy.float() * nrm).abs().sum()), 2: float(dy.float().abs().sum())}
            for i, nm in ((1, "dgamma"), (2, "dbeta")):
                if not float((got[i] - want[i]).abs()) <= srtol * scales[i]:
                    failures.append(f"K2 {nm} {dtype_name} {shape}: {float(got[i])} vs {float(want[i])}")
            del xf, mean, nrm
            pms = time_ms(lambda: nl.fused_instance_norm_lrelu_bwd_plain(x, dy, gamma, beta, 0.3))
            n_el = x.numel()
            rec("fused_instance_norm_lrelu_bwd", dtype_name, shape, count, _max_err(got[0][away], want[0][away]),
                lambda: nl.fused_instance_norm_lrelu_bwd(x, dy, gamma, beta, 0.3, 1e-3, stats), pms, None,
                bound(3 * n_el * item + 4 * stats.numel() + 16, 14 * n_el, dtype_name))

        log(f"K1' norm_lrelu_from_stats_bwd, {dtype_name} (no single PyTorch call computes it: library_ms null)")
        for xshape, count in BLOCK1_STEP:
            shape = xshape[:3] + (64,)
            y = (torch.randn(shape, device=dev, generator=gen) + 0.3).to(dt)
            dout = torch.randn(shape, device=dev, generator=gen).to(dt)
            yf = y.float()
            s1, s2 = yf.sum((1, 2, 3)), yf.square().sum((1, 2, 3))
            got = nl.norm_lrelu_from_stats_bwd(y, s1, s2, gamma, beta, dout, 0.3)
            want = nl.norm_lrelu_from_stats_bwd_plain(y, s1, s2, gamma, beta, dout, 0.3)
            mean = (s1 / yf[0].numel()).reshape(-1, 1, 1, 1)
            std = (s2 / yf[0].numel()).reshape(-1, 1, 1, 1) - mean.square()
            away = (((yf - mean) / (std.clamp_min(0).sqrt() + 1e-3)) * gamma + beta).abs() > KINK
            torch.cuda.synchronize()
            kinks[("K1' bwd", dtype_name, shape)] = int((~away).sum())
            if not _within(got[0][away], want[0][away], atol, rtol):
                failures.append(f"K1' bwd dy {dtype_name} {shape}: max_abs_err "
                                f"{_max_err(got[0][away], want[0][away]):.3g}")
            for i, nm in ((1, "ds1"), (2, "ds2")):
                if not sums_ok(got[i], want[i], srtol):
                    failures.append(f"K1' bwd {nm} {dtype_name} {shape}: max_abs_err {_max_err(got[i], want[i]):.3g}")
            if not float((got[4] - want[4]).abs()) <= srtol * float(dout.float().abs().sum()):
                failures.append(f"K1' bwd dbeta {dtype_name} {shape}: {float(got[4])} vs {float(want[4])}")
            if not float((got[3] - want[3]).abs()) <= srtol * float(dout.float().abs().sum()) * 4:
                failures.append(f"K1' bwd dgamma {dtype_name} {shape}: {float(got[3])} vs {float(want[3])}")
            pms = time_ms(lambda: nl.norm_lrelu_from_stats_bwd_plain(y, s1, s2, gamma, beta, dout, 0.3))
            rec("norm_lrelu_from_stats_bwd", dtype_name, shape, count, _max_err(got[0][away], want[0][away]),
                lambda: nl.norm_lrelu_from_stats_bwd(y, s1, s2, gamma, beta, dout, 0.3), pms, None,
                bound(3 * y.numel() * item + 16 * shape[0] + 16, 12 * y.numel(), dtype_name))

        log(f"K3 backward (stats fold kernel + PyTorch conv gradients), {dtype_name}; "
            "library: one aten.convolution_backward returning dx, dw, db")
        for xshape, count in BLOCK1_STEP:
            x = torch.randn(xshape, device=dev, generator=gen).to(dt)
            w = (torch.randn((3, 3, 12, 64), device=dev, generator=gen) * 0.2).to(dt)
            b = torch.randn((64,), device=dev, generator=gen) * 0.1
            yshape = xshape[:3] + (64,)
            gy = torch.randn(yshape, device=dev, generator=gen).to(dt)
            gs1 = torch.randn((xshape[0],), device=dev, generator=gen) * 1e-3
            gs2 = torch.randn((xshape[0],), device=dev, generator=gen) * 1e-4
            ins = [t.clone().requires_grad_() for t in (x, w, b)]
            outs = bc.BoundaryConvS2D.apply(*ins)
            torch.autograd.backward(outs, (gy, gs1, gs2))
            pins = [t.clone().requires_grad_() for t in (x, w, b)]
            pouts = bc.conv3x3_same_stats_plain(*pins)
            torch.autograd.backward(pouts, (gy, gs1, gs2))
            torch.cuda.synchronize()
            errs = {nm: _rel_err(a.grad, p.grad) for nm, a, p in zip(("dx", "dw", "db"), ins, pins)}
            bad = {k: v for k, v in errs.items() if v > CONV_BWD_REL[dtype_name]}
            if bad or ins[2].grad.dtype != torch.float32:
                failures.append(f"K3 bwd {dtype_name} {xshape}: relative norm errors {errs}, db {ins[2].grad.dtype}")
            y = outs[0].detach()
            fold = lambda: bc.conv3x3_bwd_fold(y, gy, gs1, gs2)  # noqa: E731
            fy, fdb = fold()
            py, pdb = bc.conv3x3_bwd_fold_plain(y, gy, gs1, gs2)
            torch.cuda.synchronize()
            if not _within(fy, py, atol, rtol) or not sums_ok(fdb, pdb, srtol):
                failures.append(f"K3 bwd fold {dtype_name} {xshape}: max_abs_err {_max_err(fy, py):.3g}, "
                                f"db {_max_err(fdb, pdb):.3g}")
            pms = time_ms(lambda: bc.conv3x3_bwd_fold_plain(y, gy, gs1, gs2))
            wc = w.permute(3, 2, 0, 1)
            lms = time_ms(lambda: torch.ops.aten.convolution_backward(
                gy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wc, [64], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [True, True, True]))
            whole = time_ms(lambda: bc.boundary_conv_s2d_bwd(x, w, y, gy, gs1, gs2))
            rec("conv3x3_bwd_fold", dtype_name, xshape, count, _max_err(fy, py), fold, pms, lms,
                bound(3 * y.numel() * item + 8 * xshape[0] + 4 * 64, 4 * y.numel(), dtype_name),
                backward_ms=whole, **{f"rel_err_{k}": v for k, v in errs.items()})
    log(f"elements within {KINK} of LeakyReLU's kink, left out of the dx checks: "
        + ", ".join(f"{k[0]} {k[1]} {k[2]}: {v}" for k, v in kinks.items() if v))
    if failures:
        raise AssertionError("backward kernel/plain mismatch:\n  " + "\n  ".join(failures))
    return records


# blocks per sample on K1's cluster route, timed by compare_fwd_routes
# against the two-launch route (0) and the default plan
FWD_BLOCKS = (0, 2, 4, 8, 16)


def compare_fwd_routes():
    """K1, bf16, at every serve and train-step shape: the two-launch route
    (one-pass moments at every shape, as before the cluster route) against
    the cluster route with 2, 4, 8 and 16 blocks per sample (where a share
    fits shared memory), timed in this one run in turns, forward through
    ``FWD_BLOCKS`` and back; then the default plan, and at the two-pass
    shapes the default cluster with one-pass moments (what the second
    exchange costs). Returns one record per shape, with the totals per
    /adjust call and per train step logged."""
    import torch

    from littlegan_tpu_torch.ops.cuda import norm_lrelu as nl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    gamma = torch.tensor([1.3], device=dev)
    beta = torch.tensor([-0.2], device=dev)
    log("K1 routes, bf16, in turns in this run (default: as fwd_plan picks):")
    out = []
    for shape, per_step in [(s, None) for s in dict.fromkeys(K1_SHAPES)] + K1_STEP:
        x = (torch.randn(shape, device=dev, generator=gen) * 2.0 + 0.5).bfloat16()
        n, m, sms = shape[0], x[0].numel(), nl._sms(dev)
        whole = nl.holds_whole_sample(shape)
        plans = {}
        for b in FWD_BLOCKS:
            try:
                plans["two launches" if b == 0 else f"cluster {b}"] = nl.fwd_plan(n, m, 2, sms, whole and b > 0, b)
            except ValueError:  # a share beyond shared memory: not timed
                pass
        keys = list(plans)
        plans["default"] = nl.fwd_plan(n, m, 2, sms, whole)
        if whole:  # the price of the second exchange: the same cluster with one-pass moments
            plans["default, one pass"] = plans["default"]._replace(two_pass=False)
        times = {}
        for k in keys + keys[::-1] + list(plans)[len(keys):]:
            times.setdefault(k, []).append(
                time_ms(lambda: nl.fused_instance_norm_lrelu(x, gamma, beta, 0.3, 1e-3, plans[k])))
        bnd = bound(2 * x.numel() * 2 + 8 * n + 8, 7 * x.numel(), "bfloat16")[0]
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        log(f"  {shape}{'' if per_step is None else f' x{per_step}/step'}, bound {bnd:.4f} ms, "
            f"default {tuple(plans['default'])}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
        out.append({"shape": list(shape), "per_step": per_step, "bound_ms": bnd, "ms": ms, "runs_ms": times,
                    "plan": plans["default"]._asdict()})
        del x
    serve = {tuple(r["shape"]): r for r in out if r["per_step"] is None}
    adjust = [serve[s] for s in K1_SHAPES]  # the seven calls of one /adjust
    train = [r for r in out if r["per_step"] is not None]
    for label, rows, mult in (("per /adjust call", adjust, lambda r: 1), ("per train step", train,
                                                                          lambda r: r["per_step"])):
        common = [k for k in rows[0]["ms"] if all(k in r["ms"] for r in rows)]
        tot = {k: sum(r["ms"][k] * mult(r) for r in rows) for k in common}
        log(f"  K1 {label} (bound {sum(r['bound_ms'] * mult(r) for r in rows):.4f} ms): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in tot.items()))
    return out


# shared memory per block of the backward's cluster route, timed by
# compare_bwd_routes (0: the two-pass route)
BWD_SMEM = (0, 16 << 10, 32 << 10, 64 << 10, 128 << 10)


def compare_bwd_routes():
    """K2 and K1' bwd, bf16, at every train-step shape: the two-pass route
    against the cluster route (taken at every shape) keeping a fixed 16 to
    128 KB of x and dy per block in shared memory (``BWD_SMEM``), timed in
    this one run in turns, forward through ``BWD_SMEM`` and back; then the
    default plan (which picks the route and the share itself). Returns one
    record per shape, with the per-step totals logged."""
    import torch

    from littlegan_tpu_torch.ops.cuda import norm_lrelu as nl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    gamma = torch.tensor([1.3], device=dev)
    beta = torch.tensor([-0.2], device=dev)
    cases = [("fused_instance_norm_lrelu_bwd", s, c) for s, c in K2_STEP]
    cases += [("norm_lrelu_from_stats_bwd", x[:3] + (64,), c) for x, c in BLOCK1_STEP]
    label = lambda b: "two passes" if b == 0 else f"cluster {b >> 10} KB"  # noqa: E731
    log("backward routes, bf16, in turns in this run (default: the cluster route where the batch's x and dy "
        "outgrow L2, keeping the share its rule picks, else two passes):")
    out = []
    for name, shape, count in cases:
        x = (torch.randn(shape, device=dev, generator=gen) * 2.0 + 0.5).bfloat16()
        dy = torch.randn(shape, device=dev, generator=gen).bfloat16()
        if name == "fused_instance_norm_lrelu_bwd":
            _, stats = nl._fused_forward(x, gamma, beta, 0.3, 1e-3)
            fn = lambda plan: nl.fused_instance_norm_lrelu_bwd(x, dy, gamma, beta, 0.3, 1e-3, stats, plan)  # noqa: E731
        else:
            xf = x.float()
            s1, s2 = xf.sum((1, 2, 3)), xf.square().sum((1, 2, 3))
            fn = lambda plan: nl.norm_lrelu_from_stats_bwd(x, s1, s2, gamma, beta, dy, 0.3, 1e-3, plan)  # noqa: E731
        n, m, sms = shape[0], x[0].numel(), nl._sms(dev)
        plans = {label(b): nl.bwd_plan(n, m, 2, sms, smem=b, two_pass_bytes=0) for b in BWD_SMEM}
        plans["default"] = nl.bwd_plan(n, m, 2, sms)
        times = {}
        for k in list(plans)[:-1] + list(plans)[-2::-1] + ["default"]:
            times.setdefault(k, []).append(time_ms(lambda: fn(plans[k])))
        bnd = bound(3 * x.numel() * 2, 14 * x.numel(), "bfloat16")[0]
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        log(f"  {name} {shape} x{count}/step, bound {bnd:.4f} ms, default plan {tuple(plans['default'])}: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
        out.append({"name": name, "shape": list(shape), "per_step": count, "bound_ms": bnd, "ms": ms,
                    "runs_ms": times, "plan": plans["default"]._asdict()})
        del x, dy
    for name in ("fused_instance_norm_lrelu_bwd", "norm_lrelu_from_stats_bwd"):
        rows = [r for r in out if r["name"] == name]
        tot = {k: sum(r["ms"][k] * r["per_step"] for r in rows) for k in rows[0]["ms"]}
        log(f"  {name} per train step (bound {sum(r['bound_ms'] * r['per_step'] for r in rows):.4f} ms): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in tot.items()))
    return out


def _counters(names=("fused_instance_norm_lrelu", "conv3x3_same_stats", "norm_lrelu_from_stats")):
    from littlegan_tpu_torch.ops.cuda import boundary_conv as bc
    from littlegan_tpu_torch.ops.cuda import norm_lrelu as nl

    fns = {
        "fused_instance_norm_lrelu": nl.fused_instance_norm_lrelu,
        "norm_lrelu_from_stats": nl.norm_lrelu_from_stats,
        "conv3x3_same_stats": bc.conv3x3_same_stats,
        "fused_instance_norm_lrelu_bwd": nl.fused_instance_norm_lrelu_bwd,
        "norm_lrelu_from_stats_bwd": nl.norm_lrelu_from_stats_bwd,
        "conv3x3_bwd_fold": bc.conv3x3_bwd_fold,
    }
    return {k: fns[k].launches for k in names}


def _http(url: str, payload=None):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data, {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = r.read()
        return r.status, body


def _png_b64(img_u8) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img_u8).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def full_config():
    """The served configuration: the defaults (128x128, conv_filter
    [384, 256, 128, 64, 32], bf16, s2d on) with both kernels on, seeded
    fresh weights, batch 8."""
    from littlegan_tpu_torch.config import Config

    cfg = Config(use_pallas=True, use_pallas_boundary=True, restore=False, seed=0, batch_size=BATCH,
                 exp_name="chip_smoke")
    require((cfg.image_dim, cfg.conv_filter, cfg.compute_dtype, cfg.use_s2d) == (
        128, [384, 256, 128, 64, 32], "bfloat16", True), "the defaults are no longer the full-width model")
    return cfg


def check_serving(cfg, device=None):
    """Phase (c): an engine for ``cfg`` behind serve(), driven over HTTP.
    Returns each kernel's launches in the served run; raises on any miss."""
    import threading

    import numpy as np
    import torch

    from littlegan_tpu_torch.models import LittleGAN
    from littlegan_tpu_torch.serving import InferenceEngine, serve

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    engine = InferenceEngine(cfg, batch_size=BATCH, device=device)  # device=None: the card
    log(f"engine on {engine.device} in {time.time() - t0:.1f} s "
        f"({sum(p.numel() for p in engine.model.parameters())} parameters)")

    calls = {"generate": 0, "adjust": 0, "discriminate": 0}
    for name in calls:  # count engine calls (one per batched device call)
        real = getattr(engine, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        setattr(engine, name, counted)

    started = threading.Event()
    box = {}

    def on_start(server):
        box["server"] = server
        started.set()

    thread = threading.Thread(
        target=serve, args=(cfg,),
        kwargs=dict(host="127.0.0.1", port=0, batch_size=BATCH, max_wait_ms=2.0, engine=engine,
                    on_start=on_start),
        daemon=True, name="chip-smoke-serve",
    )
    thread.start()
    if not started.wait(120):
        raise RuntimeError("serve() did not start")
    server = box["server"]
    url = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(0)
    soft = lambda bits: np.where(bits, 0.98, -0.94).astype(np.float32)  # noqa: E731
    images_u8 = rng.integers(0, 256, size=(3, cfg.image_dim, cfg.image_dim, 3), dtype=np.uint8)
    lat = {"generate": [], "adjust": [], "discriminate": []}
    deltas = {}
    try:
        status, body = _http(url + "/healthz")
        require(status == 200 and json.loads(body)["status"] == "ok", body)
        # warm-up request per endpoint (cuDNN picks its algorithms), outside the count
        _http(url + "/generate", {"cond": [soft(rng.random(cfg.cond_dim) < 0.5).tolist()], "seed": 0})
        _http(url + "/adjust", {"image_b64": _png_b64(images_u8[0]), "cond": [[0.98] * cfg.cond_dim]})
        _http(url + "/discriminate", {"image_b64": _png_b64(images_u8[0])})
        for c in calls:
            calls[c] = 0
        counters = _counters()
        for c in counters.values():
            c.reset()
        requests = (
            [("generate", {"cond": [soft(rng.random(cfg.cond_dim) < 0.5).tolist()], "seed": i}, 1) for i in range(3)]
            + [("generate", {"cond": soft(rng.random((BATCH, cfg.cond_dim)) < 0.5).tolist(), "seed": 9}, BATCH)]
            + [("adjust", {"image_b64": _png_b64(images_u8[i]), "cond": [soft(rng.random(cfg.cond_dim) < 0.5).tolist()]}, 1)
               for i in range(3)]
            + [("discriminate", {"image_b64": _png_b64(images_u8[i])}, 1) for i in range(3)]
        )
        for endpoint, payload, rows in requests:
            before = {k: c.value for k, c in counters.items()}
            calls_before = calls[endpoint]
            t = time.perf_counter()
            status, body = _http(f"{url}/{endpoint}", payload)
            lat[endpoint].append((time.perf_counter() - t) * 1e3)
            out = json.loads(body)
            require(status == 200, (endpoint, status, out))
            if endpoint == "discriminate":
                pr, dc = np.asarray(out["pr"]), np.asarray(out["cond"])
                require(pr.shape == (1, 1) and dc.shape == (1, cfg.cond_dim), (pr.shape, dc.shape))
                require(np.isfinite(pr).all() and np.isfinite(dc).all() and (0 <= pr).all() and (pr <= 1).all(),
                        (pr, dc))
            else:
                require(len(out["images"]) == rows, (endpoint, len(out["images"])))
            n_calls = calls[endpoint] - calls_before
            for k, c in counters.items():
                d = c.value - before[k]
                want = EXPECTED_LAUNCHES[endpoint][k] * n_calls
                if d != want:
                    raise AssertionError(f"{endpoint}: {k} launched {d} times in {n_calls} engine calls, want {want}")
                deltas[k] = deltas.get(k, 0) + d
        launches = {k: c.value for k, c in counters.items()}
        status, body = _http(url + "/metrics")
        text = body.decode()
        require(status == 200 and 'littlegan_requests_total{endpoint="adjust",code="200"}' in text, text[:500])
    finally:
        server.shutdown()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("serve() did not drain")
    require(launches == deltas, (launches, deltas))
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the served path: {missing}")
    for ep, ms in lat.items():
        log(f"  /{ep}: {len(ms)} requests, client latency ms: " + ", ".join(f"{v:.2f}" for v in ms))
    log(f"served-run launches: {launches}; engine calls {calls}")

    # the same weights through the plain versions, on the card
    plain_cfg = cfg.replace(use_pallas=False, use_pallas_boundary=False)
    plain = LittleGAN(plain_cfg)
    plain.load_state_dict(engine.model.state_dict())
    plain = plain.to(engine.device).eval()
    noise = rng.normal(size=(BATCH, cfg.noise_dim)).astype(np.float32)
    cond = soft(rng.random((BATCH, cfg.cond_dim)) < 0.5)
    images = (images_u8[rng.integers(0, 3, BATCH)] / 127.5 - 1.0).astype(np.float32)
    dev = engine.device
    with torch.inference_mode():
        want_g = plain.generator(torch.from_numpy(noise).to(dev), torch.from_numpy(cond).to(dev)).float().cpu().numpy()
        want_a = plain.adjuster(torch.from_numpy(images).to(dev), torch.from_numpy(cond).to(dev)).float().cpu().numpy()
        wp, wc = plain.discriminator(torch.from_numpy(images).to(dev))
    got_g = engine.generate(cond, noise)
    got_a = engine.adjust(images, cond)
    got_d = engine.discriminate(images)
    errs = {
        "generate": (np.abs(got_g - want_g).max(), np.abs(got_g - want_g).mean()),
        "adjust": (np.abs(got_a - want_a).max(), np.abs(got_a - want_a).mean()),
        "discriminate": (max(np.abs(got_d["pr"] - wp.cpu().numpy()).max(),
                             np.abs(got_d["cond"] - wc.cpu().numpy()).max()), None),
    }
    for name, out in (("generate", got_g), ("adjust", got_a)):
        require(out.shape == (BATCH, cfg.image_dim, cfg.image_dim, cfg.image_channel), (name, out.shape))
        require(np.isfinite(out).all() and np.abs(out).max() <= 1.0, f"{name}: values outside [-1, 1]")
    log("engine (kernels) vs plain versions, bf16, same weights: " + ", ".join(
        f"{k} max {v[0]:.4g}" + ("" if v[1] is None else f" mean {v[1]:.4g}") for k, v in errs.items()))
    bad = [k for k in ("generate", "adjust")
           if errs[k][0] > ENGINE_TOL["image_max"] or errs[k][1] > ENGINE_TOL["image_mean"]]
    if errs["discriminate"][0] > ENGINE_TOL["prob_max"]:
        bad.append("discriminate")
    if bad:
        raise AssertionError(f"engine disagrees with the plain versions on {bad} (tolerance {ENGINE_TOL})")
    log("engine call time, batch 8:")
    time_engine(engine, noise, cond, images)
    return launches


def time_engine(engine, noise, cond, images):
    """Per endpoint: host wall ms of one batch-8 engine call (inputs copied
    in, outputs copied out, synchronous) and the device's busy ms in it: the
    sum of the device-side events (kernels, copies) torch.profiler records.
    A CPU op's own device time repeats its kernels' and is left out. The gap
    between the two is the device's idle time."""
    from torch.profiler import ProfilerActivity, profile

    calls = {
        "generate": lambda: engine.generate(cond, noise),
        "adjust": lambda: engine.adjust(images, cond),
        "discriminate": lambda: engine.discriminate(images),
    }
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        t = time.perf_counter()
        for _ in range(20):
            fn()
        wall = (time.perf_counter() - t) * 1e3 / 20
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
        device = device_events(prof)
        busy = sum(e.self_device_time_total for e in device) / 5 / 1e3
        kernels = sum(e.count for e in device) / 5
        log(f"  engine.{name}: {wall:.3f} ms per call (host wall); device busy {busy:.3f} ms "
            f"({kernels:.0f} device ops); idle share {1 - busy / wall:.1%}")
        top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
        for e in top:
            log(f"    {e.self_device_time_total / 5 / 1e3:.4f} ms  x{e.count / 5:g}  {e.key[:90]}")


def train_config(root):
    """The trained configuration: the defaults (128x128, conv_filter
    [384, 256, 128, 64, 32], bf16, s2d, train_adj, use_partition, use_clip)
    with both kernels on, batch 32, one epoch of TRAIN_STEPS steps, one
    train image at the last step, no fixture predict, in ``root``."""
    from littlegan_tpu_torch.config import Config

    cfg = Config(use_pallas=True, use_pallas_boundary=True, seed=0, batch_size=TRAIN_BATCH, epoch=1,
                 freq_gen=TRAIN_STEPS, freq_test=0, debug=True, exp_name="chip_smoke_train",
                 all_result_dir=os.path.join(root, "result"), test_data_dir=os.path.join(root, "test-data"))
    require((cfg.image_dim, cfg.conv_filter, cfg.compute_dtype, cfg.use_s2d, cfg.train_adj, cfg.use_partition,
             cfg.use_clip) == (128, [384, 256, 128, 64, 32], "bfloat16", True, True, True, True),
            "the defaults are no longer the full-width training configuration")
    return cfg


def check_training():
    """Phase (d): TRAIN_STEPS steps of ``Trainer.train`` at full width on the
    synthetic dataset, in a temporary directory. Returns (each kernel's
    launches in that run, the comparison and timing record); raises on any
    miss."""
    import tempfile

    import numpy as np
    import torch

    from littlegan_tpu_torch.data import SyntheticDataset
    from littlegan_tpu_torch.training.trainer import Trainer
    from littlegan_tpu_torch.utils.tensorboard import read_scalars

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        cfg = train_config(root)
        data = SyntheticDataset(cfg, num_items=2 * TRAIN_STEPS * cfg.batch_size)
        t0 = time.time()
        trainer = Trainer(cfg, data)  # device=None: the card
        log(f"trainer on {trainer.device} in {time.time() - t0:.1f} s")
        counters = _counters(tuple(EXPECTED_TRAIN_LAUNCHES))
        for c in counters.values():
            c.reset()
        t0 = time.time()
        trainer.train()
        torch.cuda.synchronize()
        log(f"trained {TRAIN_STEPS} steps in {time.time() - t0:.1f} s (first steps include cuDNN's warm-up)")
        launches = {k: c.value for k, c in counters.items()}
        want = {k: v * TRAIN_STEPS for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
        require(launches == want, f"train-run launches {launches}, want {want}")
        log(f"train-run launches: {launches} ({TRAIN_STEPS} steps)")

        scalars = read_scalars(os.path.join(cfg.result_dir, "log"))
        counts = {k: len(v) for k, v in scalars.items()}
        require(counts == {"loss/gen": TRAIN_STEPS, "loss/disc": TRAIN_STEPS, "loss/adj": TRAIN_STEPS - 10},
                f"logged losses {counts}")
        vals = [v for series in scalars.values() for _, v in series]
        require(all(np.isfinite(vals)), f"non-finite losses: {scalars}")
        log("losses per step: " + "; ".join(
            f"{k} " + ", ".join(f"{v:.4f}" for _, v in series) for k, series in sorted(scalars.items())))
        image = os.path.join(cfg.result_dir, "train", "gen", f"1-{TRAIN_STEPS}.jpg")
        ckpt = os.path.join(cfg.result_dir, "checkpoint", "ckpt-1.npz")
        require(os.path.isfile(image) and os.path.isfile(ckpt), (image, ckpt, os.listdir(os.path.dirname(image))))

        again = Trainer(cfg, data)
        require((again.global_epoch, again.global_step) == (2, TRAIN_STEPS),
                (again.global_epoch, again.global_step))
        live = dict(trainer.state.model.named_parameters())
        same = all(torch.equal(p, live[n]) for n, p in again.state.model.named_parameters())
        opts = all(getattr(again.state, o).count == getattr(trainer.state, o).count for o in ("opt_g", "opt_d", "opt_a"))
        require(same and opts, "the epoch checkpoint did not restore the trained state")
        log(f"epoch checkpoint {os.path.getsize(ckpt) / 1e6:.1f} MB restores into a new Trainer")
        del again
        record = compare_plain_step(trainer)
        record.update(time_train_step(trainer))
    return launches, record


def _put(batch, device):
    """One host (images, conds) batch on ``device``, copied synchronously
    from pageable memory."""
    import numpy as np
    import torch

    img, cond = batch
    return (torch.from_numpy(np.ascontiguousarray(img)).to(device),
            torch.from_numpy(np.ascontiguousarray(cond, np.float32)).to(device))


def compare_plain_step(trainer):
    """One step's losses and gradients with the kernels against the same
    weights and draws through the plain versions, on the card, bf16."""
    import torch

    from littlegan_tpu_torch.training.state import A_KEYS, D_KEYS, G_KEYS, create_train_state, subtree
    from littlegan_tpu_torch.training.step import LOSS_KEYS, compute_grads

    cfg = trainer.cfg
    it = trainer.dataset.epoch_iterator(1)
    b1, b2 = _put(next(it), trainer.device), _put(next(it), trainer.device)
    draws = trainer.draws(10_000)
    batch_no = 12
    grads, aux = compute_grads(trainer.state, b1, b2, draws, batch_no, cfg)
    plain_cfg = cfg.replace(use_pallas=False, use_pallas_boundary=False)
    plain_model = type(trainer.state.model)(plain_cfg).to(trainer.device)
    plain_model.load_state_dict(trainer.state.model.state_dict())
    plain_state = create_train_state(plain_cfg, trainer.device, plain_model)
    pgrads, paux = compute_grads(plain_state, b1, b2, draws, batch_no, plain_cfg)
    f32_cfg = plain_cfg.replace(compute_dtype="float32")
    f32_model = type(trainer.state.model)(f32_cfg).to(trainer.device)
    f32_model.load_state_dict(trainer.state.model.state_dict())
    fgrads, _ = compute_grads(create_train_state(f32_cfg, trainer.device, f32_model), b1, b2, draws, batch_no,
                              f32_cfg)
    torch.cuda.synchronize()
    losses = {k: (float(aux[k]), float(paux[k])) for k in LOSS_KEYS}
    rel, floor = {}, {}
    for group, keys in (("G", G_KEYS), ("D", D_KEYS), ("A", A_KEYS)):
        names = list(subtree(trainer.state.model, keys))
        flat = lambda g: torch.cat([g[n].float().flatten() for n in names])  # noqa: E731
        rel[group] = _rel_err(flat(grads), flat(pgrads))
        floor[group] = _rel_err(flat(pgrads), flat(fgrads))
    log("train step, kernels vs plain versions, bf16, same weights and draws: losses "
        + ", ".join(f"{k} {a:.5f} vs {b:.5f}" for k, (a, b) in losses.items())
        + "; gradient relative norm error " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + "; plain bf16 vs plain f32 " + ", ".join(f"{k} {v:.3g}" for k, v in floor.items()))
    bad = [k for k, (a, b) in losses.items() if abs(a - b) > TRAIN_TOL["loss_rtol"] * abs(b)]
    bad += [k for k, v in rel.items() if not v <= max(TRAIN_TOL["grad_rel"], TRAIN_TOL["floor_x"] * floor[k])]
    if bad:
        raise AssertionError(f"train step disagrees with the plain versions on {bad} (tolerance {TRAIN_TOL})")
    return {"losses_kernels_vs_plain": losses, "grad_rel_err": rel, "grad_rel_err_bf16_vs_f32": floor}


def time_train_step(trainer, reps: int = 10):
    """Host wall ms of one train step (two batches already on the card,
    synchronous), the device's busy ms in it (sum of device-side events in
    torch.profiler, as time_engine) and images/s counted as the trainer
    counts them (2 x batch per step); with both kernel flags on (the
    trainer's state) and off (a copy of it through the plain versions),
    measured on, off, on, off in this one run."""
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import make_train_step

    cfg = trainer.cfg
    it = trainer.dataset.epoch_iterator(2)
    b1, b2 = _put(next(it), trainer.device), _put(next(it), trainer.device)
    plain_cfg = cfg.replace(use_pallas=False, use_pallas_boundary=False)
    plain_model = type(trainer.state.model)(plain_cfg).to(trainer.device)
    plain_model.load_state_dict(trainer.state.model.state_dict())
    plain_state = create_train_state(plain_cfg, trainer.device, plain_model)
    runs = {
        "kernels": (trainer.state, trainer._train_step),
        "plain": (plain_state, make_train_step(plain_cfg, plain_state)),
    }
    out = {}
    for rnd in range(2):
        for name, (state, step_fn) in runs.items():
            step = lambda i: step_fn(state, b1, b2, trainer.draws(20_000 + i), 11 + i % 5)  # noqa: E731
            r = _time_steps(step, reps, cfg.batch_size, top=12 if rnd == 0 and name == "kernels" else 0)
            log(f"train step, batch {cfg.batch_size}, {name} (round {rnd + 1}): {r['step_ms']:.3f} ms per step "
                f"(host wall, mean of {reps}); device busy {r['device_busy_ms']:.3f} ms ({r['device_ops']:.0f} "
                f"device ops); idle share {r['idle_share']:.1%}; {r['images_per_s']:.1f} images/s")
            out.setdefault(name, []).append(r)
    return {"step": out}


def _time_steps(step, reps, batch, top=0):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(reps):
        step(i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / reps
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n_prof):
            step(i)
        torch.cuda.synchronize()
    device = device_events(prof)
    busy = sum(e.self_device_time_total for e in device) / n_prof / 1e3
    ops = sum(e.count for e in device) / n_prof
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / n_prof / 1e3:.4f} ms  x{e.count / n_prof:g}  {e.key[:90]}")
    return {"step_ms": wall, "device_busy_ms": busy, "device_ops": ops, "idle_share": 1 - busy / wall,
            "images_per_s": 2 * batch / (wall / 1e3)}


def _flat_params(model):
    import torch

    return torch.cat([p.detach().float().flatten() for p in model.parameters()])


def _snapshotting(step, model, box):
    """``step`` that appends the weights after each call to ``box``."""
    def wrapped(*a, **k):
        out = step(*a, **k)
        box.append(_flat_params(model))
        return out

    return wrapped


def _hold(what, losses, want_losses, params, want_params):
    """Hold per-update losses (lists of (gen, disc, adj)) and per-group
    weights against an eager run's; returns the record, raises on a miss."""
    import torch

    loss_rel = max(abs(a - b) / max(abs(b), 1e-12) for la, lb in zip(losses, want_losses) for a, b in zip(la, lb))
    param_rel = max(_rel_err(a, b) for a, b in zip(params, want_params))
    bitwise = losses == want_losses and all(torch.equal(a, b) for a, b in zip(params, want_params))
    log(f"{what}: largest loss difference {loss_rel:.3g} (relative), weights at the groups' ends "
        f"{param_rel:.3g} (relative norm); bitwise: {bitwise}")
    require(len(losses) == len(want_losses) and len(params) == len(want_params), (what, len(losses), len(params)))
    if not loss_rel <= TRAIN_TOL["loss_rtol"] or not param_rel <= DISPATCH_PARAM_REL:
        raise AssertionError(f"{what}: the graph run disagrees with the eager one (losses {loss_rel}, "
                             f"weights {param_rel}; tolerance {TRAIN_TOL['loss_rtol']}, {DISPATCH_PARAM_REL})")
    return {"loss_rel": loss_rel, "param_rel": param_rel, "bitwise": bitwise}


def check_dispatch():
    """Phase (e): DISPATCH_STEPS updates of ``Trainer`` over the device
    store in CUDA-graph replays of DISPATCH_K, against the gather step; the
    accumulation graph against eager accumulation steps; the timing.
    Returns (each kernel's launches in the graph run, the record)."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from littlegan_tpu_torch.data import SyntheticDataset
    from littlegan_tpu_torch.training.trainer import Trainer
    from littlegan_tpu_torch.utils.tensorboard import read_scalars

    record = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dispatch_") as root:
        cfg = train_config(root).replace(device_data=True, steps_per_dispatch=DISPATCH_K, freq_gen=DISPATCH_STEPS,
                                         exp_name="chip_smoke_dispatch")
        data = SyntheticDataset(cfg, num_items=2 * DISPATCH_STEPS * cfg.batch_size)
        trainer = Trainer(cfg, data)
        imgs, conds = trainer._ensure_device_store()
        sizes = [DISPATCH_STEPS % DISPATCH_K, DISPATCH_K]
        t0 = time.time()
        for k in sizes:  # what train() captures at first use, captured before the counted run
            trainer._scan_step(k).prepare(trainer.state, imgs, conds)
        torch.cuda.synchronize()
        log(f"device store {tuple(imgs.shape)} {imgs.dtype}; graphs of {sizes} updates captured in "
            f"{time.time() - t0:.1f} s (each after one eager warm-up)")
        for k in sizes:
            held = trainer._scan_steps[k].graphed.launches
            want = {name: v * k for name, v in EXPECTED_TRAIN_LAUNCHES.items()}
            require(held == want, f"the {k}-update graph holds {held}, want {want}")
        graph_params = []
        for k in sizes:
            trainer._scan_steps[k] = _snapshotting(trainer._scan_steps[k], trainer.state.model, graph_params)
        counters = _counters(tuple(EXPECTED_TRAIN_LAUNCHES))
        for c in counters.values():
            c.reset()
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train()
            torch.cuda.synchronize()
        log(f"trained {DISPATCH_STEPS} steps in {len(graph_params)} graph replays in {time.time() - t0:.1f} s "
            f"(traced)")
        require(sorted(trainer._scan_steps) == sizes, f"the epoch used graphs of {sorted(trainer._scan_steps)}")
        launches = {k: c.value for k, c in counters.items()}
        traced = traced_launches(device_events(prof))
        want = {k: v * DISPATCH_STEPS for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
        require(launches == want, f"dispatch-run launches {launches}, want {want}")
        require(traced == want, f"the trace of the dispatch run saw the kernels of {traced} launches, want {want}")
        log(f"dispatch-run launches: {launches} ({DISPATCH_STEPS} steps); the same counted from the kernels "
            f"its trace saw run")
        record["traced_launches"] = traced
        scalars = read_scalars(os.path.join(cfg.result_dir, "log"))
        counts = {k: len(v) for k, v in scalars.items()}
        require(counts == {"loss/gen": DISPATCH_STEPS, "loss/disc": DISPATCH_STEPS, "loss/adj": DISPATCH_STEPS - 10},
                f"logged losses {counts}")
        require(all(np.isfinite(v) for series in scalars.values() for _, v in series), f"non-finite: {scalars}")
        image = os.path.join(cfg.result_dir, "train", "gen", f"1-{DISPATCH_STEPS}.jpg")
        ckpt = os.path.join(cfg.result_dir, "checkpoint", "ckpt-1.npz")
        require(os.path.isfile(image) and os.path.isfile(ckpt), (image, ckpt))
        again = Trainer(cfg, data)
        require((again.global_epoch, again.global_step) == (2, DISPATCH_STEPS), (again.global_epoch, again.global_step))
        live = dict(trainer.state.model.named_parameters())
        same = all(torch.equal(p, live[n]) for n, p in again.state.model.named_parameters())
        opts = all(getattr(again.state, o).count == getattr(trainer.state, o).count for o in ("opt_g", "opt_d", "opt_a"))
        require(same and opts, "the dispatch run's checkpoint did not restore its state")
        del again
        log("dispatch run: 20/20/10 finite losses, image, checkpoint and its restore")

        # (ii) the same epoch from the same init, one eager gather step per call
        gcfg = cfg.replace(steps_per_dispatch=1, exp_name="chip_smoke_gather")
        gather = Trainer(gcfg, data)
        gather_params = []
        real_gather = gather._gather_step

        def gather_step(*a, **k):
            out = real_gather(*a, **k)
            if gather.global_step in (8, 16, 20):
                gather_params.append(_flat_params(gather.state.model))
            return out

        gather._gather_step = gather_step
        gather.train()
        torch.cuda.synchronize()
        def per_step(c):  # [gen, disc(, adj)] per step, as logged
            sc = read_scalars(os.path.join(c.result_dir, "log"))
            adj = dict(sc["loss/adj"])
            return [[g, d] + ([adj[i]] if i in adj else []) for (i, g), (_, d) in zip(sc["loss/gen"], sc["loss/disc"])]

        record["graph_vs_gather"] = _hold(f"graph (K = {DISPATCH_K}) vs gather steps, {DISPATCH_STEPS} updates",
                                          per_step(cfg), per_step(gcfg), graph_params, gather_params)
        del gather, gather_params, graph_params

        record["accum"] = check_accum_dispatch(trainer)
        record["timing"] = time_dispatch(trainer)
    return launches, record


def _update_draws(cfg, global_step, m, device):
    """The trainer's draws of one update (``Trainer.update_draws``) for M
    micro-steps, without a trainer."""
    import torch

    from littlegan_tpu_torch.training.step import draw_step, stack_draws
    from littlegan_tpu_torch.training.trainer import step_seed

    gen = torch.Generator(device=device)

    def one(micro):
        gen.manual_seed(step_seed(cfg.seed, global_step, micro))
        return draw_step(gen, cfg, cfg.batch_size, device)

    return stack_draws([one(j) for j in range(m)])


def check_accum_dispatch(trainer):
    """(iii) ACCUM_UPDATES updates of ACCUM_M micro-pairs from the card's
    store: ACCUM_K per graph replay on one fresh state, one eager
    ``accum_train_step`` per update on another from the same init."""
    import numpy as np
    import torch

    from littlegan_tpu_torch.data.celeba import epoch_batch_order
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import LOSS_KEYS, accum_train_step, make_scan_accum_train_step, stack_draws

    cfg = trainer.cfg.replace(grad_accum=ACCUM_M)
    dev = trainer.device
    imgs, conds = trainer._device_store
    ids = epoch_batch_order(cfg.seed, 1, imgs.shape[0])[: 2 * ACCUM_M * ACCUM_UPDATES].reshape(ACCUM_UPDATES,
                                                                                                 ACCUM_M, 2)
    draws = [_update_draws(cfg, 1 + u, ACCUM_M, dev) for u in range(ACCUM_UPDATES)]
    graph_state, eager_state = create_train_state(cfg, dev), create_train_state(cfg, dev)
    step = make_scan_accum_train_step(cfg, graph_state, ACCUM_K)
    step.prepare(graph_state, imgs, conds)
    want = {k: v * ACCUM_K * ACCUM_M for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
    require(step.graphed.launches == want, f"the accumulation graph holds {step.graphed.launches}, want {want}")
    graph_losses, graph_params = [], []
    for g in range(ACCUM_UPDATES // ACCUM_K):
        sl = slice(g * ACCUM_K, (g + 1) * ACCUM_K)
        out = step(graph_state, imgs, conds, ids[sl, :, 0], ids[sl, :, 1], stack_draws(draws[sl]), 1 + g * ACCUM_K)
        graph_losses += torch.stack([out.metrics[k] for k in LOSS_KEYS], 1).tolist()
        graph_params.append(_flat_params(graph_state.model))
    eager_losses, eager_params = [], []
    for u in range(ACCUM_UPDATES):
        pick = lambda col: (imgs[torch.from_numpy(ids[u, :, col]).to(dev)],  # noqa: E731
                            conds[torch.from_numpy(ids[u, :, col]).to(dev)])
        out = accum_train_step(eager_state, pick(0), pick(1), draws[u], 1 + u, cfg)
        eager_losses.append([float(out.metrics[k]) for k in LOSS_KEYS])
        if (u + 1) % ACCUM_K == 0:
            eager_params.append(_flat_params(eager_state.model))
    require(all(np.isfinite(graph_losses).flatten()), graph_losses)
    for o in ("opt_g", "opt_d", "opt_a"):
        require(getattr(graph_state, o).count == getattr(eager_state, o).count, f"{o} counts differ")
    return _hold(f"grad_accum {ACCUM_M}, {ACCUM_K} updates per replay vs eager accumulation steps",
                 graph_losses, eager_losses, graph_params, eager_params)


def time_dispatch(trainer, rounds: int = 2, updates: int = 3 * DISPATCH_K):
    """(iv) Per update: host wall ms (synchronous, draws included), the
    device's busy ms (sum of device-side events in torch.profiler, as
    ``time_engine``) and device ops, the idle share and images/s (2 x
    batch per update), for the host-fed step (batches copied from host
    memory), the gather step over the store and the DISPATCH_K-update graph,
    each on its own fresh state, in turns: host-fed, gather, graph, then
    the reverse. For the graph also the device span of one replay by CUDA
    events."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import (
        make_gather_train_step, make_scan_train_step, make_train_step, stack_draws,
    )

    cfg, dev = trainer.cfg, trainer.device
    imgs, conds = trainer._device_store
    host_imgs, host_conds = imgs.cpu().numpy(), conds.cpu().numpy()
    n = imgs.shape[0]
    states = {name: create_train_state(cfg, dev) for name in ("host-fed", "gather", "graph")}
    host_step = make_train_step(cfg, states["host-fed"])
    gather_step = make_gather_train_step(cfg, states["gather"])
    scan_step = make_scan_train_step(cfg, states["graph"], DISPATCH_K)
    scan_step.prepare(states["graph"], imgs, conds)
    counter = {"i": 0}

    def host_fed():
        i = counter["i"] = counter["i"] + 1
        b1, b2 = (_put((host_imgs[j], host_conds[j]), dev) for j in ((2 * i) % n, (2 * i + 1) % n))
        host_step(states["host-fed"], b1, b2, trainer.draws(i), 1 + i % 20)
        return 1

    def gather():
        i = counter["i"] = counter["i"] + 1
        gather_step(states["gather"], imgs, conds, (2 * i) % n, (2 * i + 1) % n, trainer.draws(i), 1 + i % 20)
        return 1

    def graph():
        i = counter["i"] = counter["i"] + DISPATCH_K
        ids = (np.arange(2 * DISPATCH_K) + 2 * i) % n
        draws = stack_draws([trainer.draws(i + u) for u in range(DISPATCH_K)])
        scan_step(states["graph"], imgs, conds, ids[0::2], ids[1::2], draws, 1 + i % 20)
        return DISPATCH_K

    variants = {"host-fed": host_fed, "gather": gather, "graph": graph}
    out = {name: [] for name in variants}
    order = list(variants)
    for rnd in range(rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            fn = variants[name]
            done = 0
            while done < DISPATCH_K:  # warm-up
                done += fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            done = 0
            while done < updates:
                done += fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / done
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                done = 0
                while done < DISPATCH_K:
                    done += fn()
                torch.cuda.synchronize()
            device = device_events(prof)
            traced = traced_launches(device)
            want = {k: v * done for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
            require(traced == want, f"{name}: the trace saw the kernels of {traced} launches, want {want}")
            busy = sum(e.self_device_time_total for e in device) / done / 1e3
            ops = sum(e.count for e in device) / done
            r = {"update_ms": wall, "device_busy_ms": busy, "device_ops": ops, "idle_share": 1 - busy / wall,
                 "images_per_s": 2 * cfg.batch_size / (wall / 1e3)}
            if name == "graph":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                r["replay_span_ms"] = start.elapsed_time(end) / DISPATCH_K
            log(f"{name} (round {rnd + 1}): {wall:.3f} ms per update (host wall, {updates} updates); device busy "
                f"{busy:.3f} ms ({ops:.0f} device ops) per update; idle share {r['idle_share']:.1%}; "
                f"{r['images_per_s']:.1f} images/s"
                + (f"; replay device span {r['replay_span_ms']:.3f} ms per update" if name == "graph" else ""))
            out[name].append(r)
    return out


# phase (f): evaluate-sample of EVAL_SAMPLES images at batch 32 (32 calls of
# sample_u8), condition-sample cut to EVAL_CONDITION_BATCH grids
EVAL_SAMPLES = 1024
EVAL_CONDITION_BATCH = 2
FEATURE_BATCH = 100
# K1, K1' and K3 per sample_u8 call: one generate, two discriminate (the real
# and the generated batch), two adjust (both), at phase (c)'s per-call counts
SAMPLE_LAUNCHES = {k: EXPECTED_LAUNCHES["generate"][k] + 2 * EXPECTED_LAUNCHES["discriminate"][k]
                   + 2 * EXPECTED_LAUNCHES["adjust"][k] for k in EXPECTED_LAUNCHES["generate"]}
# sample_u8 with the kernels vs the same weights through the plain versions,
# bf16: images in uint8 levels (ENGINE_TOL's 0.1 and 5e-3 of the [-1, 1]
# range, times 127.5), D's scores in the payload's rounded percentage points
# (ENGINE_TOL's 0.02, plus one for the rounding)
SAMPLE_TOL = {"max_levels": 13, "mean_levels": 0.64, "score_points": 3}
# Inception features on the card vs the CPU, both float32 (no TF32): sums in
# another order through 94 convolutions; |card - cpu| <= atol + rtol*|cpu|
FEATURE_TOL = (1e-4, 1e-4)
# Newton–Schulz FID (float32 on the card) vs the exact value and scipy's
# (float64 on the host), the latter at NS_SCIPY_DIM
NS_RTOL = 1e-3
NS_SCIPY_DIM = 512


def eval_config(root):
    """Phase (f)'s configuration file: the defaults at full width with both
    kernels on, batch 32, one short synthetic train epoch, random-init
    Inception allowed, all four metrics."""
    return {
        "use_pallas": True, "use_pallas_boundary": True, "seed": 0, "batch_size": TRAIN_BATCH, "epoch": 1,
        "freq_gen": 0, "freq_test": 0, "debug": True, "all_result_dir": os.path.join(root, "result"),
        "test_data_dir": os.path.join(root, "test-data"), "evaluate_sample_size": EVAL_SAMPLES,
        "condition_sample_batch": EVAL_CONDITION_BATCH, "allow_random_fid": True,
        "eval_metrics": ["fid", "is", "kid", "prdc"],
    }


def _mode(*argv) -> float:
    """One CLI mode on the card; returns its host wall in seconds."""
    from littlegan_tpu_torch import cli

    import torch

    t0 = time.perf_counter()
    rc = cli.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(rc == 0, f"{argv[0]} exited {rc}")
    log(f"  {argv[0]}: {wall:.2f} s")
    return wall


def _count(path, pattern) -> int:
    return sum(1 for f in os.listdir(path) if re.fullmatch(pattern, f))


def check_eval():
    """Phase (f): the sampling and evaluation modes at full width through
    the CLI. Returns (each kernel's launches in the evaluate-sample run, the
    record); raises on any miss."""
    import tempfile

    import torch

    from littlegan_tpu_torch.config import load_config

    record = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as root:
        cwd = os.getcwd()
        os.chdir(root)  # the CLI reads sample.config.json from the current directory
        try:
            with open("sample.config.json", "w") as f:
                json.dump(eval_config(root), f)
            cfg = load_config("sample", {"exp_name": "eval"})
            require((cfg.image_dim, cfg.conv_filter, cfg.compute_dtype, cfg.use_s2d, cfg.train_adj) == (
                128, [384, 256, 128, 64, 32], "bfloat16", True, True), "the defaults are no longer full width")
            rd = cfg.result_dir
            log("phase (f) modes, host wall:")
            _mode("train", "eval", "--synthetic-data")
            require(os.path.isfile(os.path.join(rd, "checkpoint", "ckpt-1.npz")), "no train checkpoint")
            _mode("export-model", "eval")
            require(os.path.isfile(os.path.join(rd, "model", "ckpt-model.npz")), "no exported model")
            _mode("plot", "eval")
            for net in ("Encoder", "Decoder", "Discriminator", "Generator", "Adjuster"):
                require(os.path.isfile(os.path.join(rd, f"{net}.dot")), f"no {net}.dot")
            with open(os.path.join(rd, "models.txt")) as f:
                require(f.read().count("total parameters") == 5, "models.txt")
            _mode("random-sample", "eval", "--synthetic-data")
            _mode("condition-sample", "eval")
            _mode("interpolate", "eval")
            sample = os.path.join(rd, "sample")
            for pattern, n in ((r"generator-\d+-\d\.jpg", cfg.random_sample_batch),
                               (r"discriminator-\d+-\d\.json", cfg.random_sample_batch),
                               (r"adjuster-\d+-\d\.jpg", cfg.random_sample_batch),
                               (r"condition-gen-\d\.jpg", EVAL_CONDITION_BATCH),
                               (r"interpolate-(z|attr)-\d+\.jpg", 2)):
                require(_count(sample, pattern) == n, f"sample/{pattern}: {sorted(os.listdir(sample))}")

            counters = _counters()
            for c in counters.values():
                c.reset()
            wall = _mode("evaluate-sample", "eval", "--synthetic-data")
            launches = {k: c.value for k, c in counters.items()}
            calls = EVAL_SAMPLES // cfg.batch_size
            want = {k: v * calls for k, v in SAMPLE_LAUNCHES.items()}
            require(launches == want, f"evaluate-sample launches {launches}, want {want}")
            ev = os.path.join(rd, "evaluate")
            counts = {"gen": _count(os.path.join(ev, "gen"), r"\d+\.jpg"),
                      "adj": _count(os.path.join(ev, "adj"), r"(real|fake)_\d+\.jpg"),
                      "disc": _count(os.path.join(ev, "disc"), r"\d+\.json")}
            require(counts == {"gen": EVAL_SAMPLES, "adj": 2 * EVAL_SAMPLES, "disc": calls}, counts)
            record["evaluate_sample"] = {"wall_s": wall, "images_per_s": EVAL_SAMPLES / wall, "launches": launches}
            log(f"evaluate-sample: {EVAL_SAMPLES} images ({calls} sample_u8 calls) in {wall:.2f} s host wall, "
                f"{EVAL_SAMPLES / wall:.1f} images/s; launches {launches} ({calls} x {SAMPLE_LAUNCHES}); files {counts}")
            record["sample_u8"] = check_sample_u8(cfg)

            record["evaluate"] = check_evaluate(cfg)
        finally:
            os.chdir(cwd)
    record["inception"] = check_inception()
    record["newton_schulz"] = check_newton_schulz()
    return launches, record


def check_sample_u8(cfg):
    """One sample_u8 batch: host wall and device busy (torch.profiler), and
    the kernels' result against the same weights through the plain
    versions. Both trainers are dropped before returning."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from littlegan_tpu_torch.data import SyntheticDataset
    from littlegan_tpu_torch.training.trainer import Trainer

    image, cond = next(SyntheticDataset(cfg, num_items=cfg.batch_size).epoch_iterator(7))
    noise = np.random.default_rng(7).standard_normal((cfg.batch_size, cfg.noise_dim)).astype(np.float32)
    trainer = Trainer(cfg.replace(reuse=True, restore=True), None)
    for _ in range(3):
        trainer.sample_u8(noise, cond, image)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        got = trainer.sample_u8(noise, cond, image)
    wall = (time.perf_counter() - t0) * 1e3 / 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            trainer.sample_u8(noise, cond, image)
    device = device_events(prof)
    busy = sum(e.self_device_time_total for e in device) / 5 / 1e3
    ops = sum(e.count for e in device) / 5
    log(f"sample_u8, batch {cfg.batch_size}: {wall:.3f} ms per call (host wall, mean of 10, uint8 in and out); "
        f"device busy {busy:.3f} ms ({ops:.0f} device ops); idle share {1 - busy / wall:.1%}; "
        f"{cfg.batch_size / wall * 1e3:.1f} images/s")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 5 / 1e3:.4f} ms  x{e.count / 5:g}  {e.key[:90]}")

    counters = _counters()
    before = {k: c.value for k, c in counters.items()}
    plain = Trainer(cfg.replace(reuse=True, restore=True, use_pallas=False, use_pallas_boundary=False), None)
    want = plain.sample_u8(noise, cond, image)
    require({k: c.value for k, c in counters.items()} == before, "the plain sample_u8 launched a kernel")
    errs = {}
    for name, g, w in zip(("gen", "adj_real", "adj_fake"), (got[0], got[2], got[3]), (want[0], want[2], want[3])):
        d = np.abs(g.astype(np.int32) - w.astype(np.int32))
        errs[name] = {"max_levels": int(d.max()), "mean_levels": float(d.mean())}
        require(d.max() <= SAMPLE_TOL["max_levels"] and d.mean() <= SAMPLE_TOL["mean_levels"],
                f"sample_u8 {name} vs plain: {errs[name]}")
    score_err = max(int(np.abs(np.asarray(got[1][k]) - np.asarray(want[1][k])).max())
                    for k in ("real_pr", "real_c", "fake_pr", "fake_c"))
    require(score_err <= SAMPLE_TOL["score_points"], f"sample_u8 scores vs plain: {score_err} points")
    log(f"sample_u8 with the kernels vs the plain versions (bf16, same weights and inputs): {errs}; "
        f"scores within {score_err} percentage points (tolerance {SAMPLE_TOL})")
    del trainer, plain
    gc.collect()
    torch.cuda.empty_cache()
    return {"wall_ms": wall, "device_busy_ms": busy, "device_ops": ops, "idle_share": 1 - busy / wall,
            "vs_plain": errs, "score_points": score_err}


def check_evaluate(cfg):
    """Real-side statistics from EVAL_SAMPLES synthetic JPEGs (with raw
    features for KID and PRDC), then the evaluate mode on gen and adj."""
    import numpy as np

    from littlegan_tpu_torch.data import SyntheticDataset
    from littlegan_tpu_torch.eval import evaluate as ev
    from littlegan_tpu_torch.utils.image import BatchImageWriter

    real = os.path.join(os.getcwd(), "real")
    os.makedirs(real)
    with BatchImageWriter() as w:
        i = 0
        for image, _ in SyntheticDataset(cfg, num_items=EVAL_SAMPLES).epoch_iterator(11):
            for row in image:
                w.save(row, os.path.join(real, f"{i}.jpg"))
                i += 1
    stats = os.path.join(cfg.test_data_dir, cfg.evaluate_pre_calculated)
    t0 = time.perf_counter()
    require(ev.main(["pre-calculate", real, stats, "--save-features", str(EVAL_SAMPLES)]) == 0, "pre-calculate")
    pre = time.perf_counter() - t0
    log(f"pre-calculate: {i} JPEGs in {pre:.2f} s host wall ({i / pre:.1f} images/s, decode included)")
    wall = _mode("evaluate", "eval")
    lines = {}
    for sub in ("gen", "adj"):
        with open(os.path.join(cfg.result_dir, "evaluate", f"fid-{sub}.log")) as f:
            text = f.read()
        for tag in ("FID", "IS", "KID", "PRDC"):
            require(f"{tag}[RANDOM-INIT Inception, NOT comparable]" in text, f"fid-{sub}.log lacks {tag}: {text}")
        lines[sub] = [line.split(" ", 2)[2] for line in text.strip().splitlines()]  # without the time stamp
        nums = [float(x) for x in re.findall(r"-?(?:\d+(?:\.\d*)?(?:e[+-]?\d+)?|nan|inf)", " ".join(lines[sub]))]
        # FID 1, IS 2, KID 2, PRDC k and 4
        require(len(lines[sub]) == 4 and len(nums) == 10 and all(np.isfinite(nums)), f"fid-{sub}.log: {text}")
        log(f"  fid-{sub}.log: " + " | ".join(lines[sub]))
    log(f"evaluate ({EVAL_SAMPLES} gen + {2 * EVAL_SAMPLES} adj images, FID/IS/KID/PRDC): {wall:.2f} s host wall")
    return {"precalculate_s": pre, "wall_s": wall, "logs": lines}


def check_inception():
    """Inception features of 16 images on the card against the CPU's, both
    float32; the same with TF32 allowed, for its error; featurisation time
    at batch FEATURE_BATCH, without and with TF32."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch

    from littlegan_tpu_torch.eval import inception as inc

    host = inc.init_inception_params("", seed=0)
    dev, cpu = inc.device_params(host, "cuda"), inc.device_params(host, "cpu")
    imgs = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (16, 128, 128, 3), dtype=np.uint8))
    want = inc.inception_features(cpu, imgs)
    got = inc.inception_features(dev, imgs.cuda()).cpu()
    atol, rtol = FEATURE_TOL
    err = _max_err(got, want)
    require(_within(got, want, atol, rtol), f"Inception features card vs CPU: max_abs_err {err:.3g}")
    batch = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (FEATURE_BATCH, 128, 128, 3), dtype=np.uint8))
    batch = batch.cuda()
    f32_ms = eager_ms(lambda: inc.inception_features(dev, batch), reps=10)

    @contextlib.contextmanager
    def tf32():
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    with mock.patch.object(inc, "exact_float32", tf32):
        tf32_err = _max_err(inc.inception_features(dev, imgs.cuda()).cpu(), want)
        tf32_ms = eager_ms(lambda: inc.inception_features(dev, batch), reps=10)
    scale = float(want.abs().max())
    log(f"Inception features, 16 images 128->299, card vs CPU (float32, no TF32): max_abs_err {err:.3g} "
        f"(|features| up to {scale:.3g}; tolerance atol {atol} + rtol {rtol}); with TF32 allowed: {tf32_err:.3g}")
    log(f"Inception featurisation, batch {FEATURE_BATCH} uint8 128x128 on the card: {f32_ms:.2f} ms per call, "
        f"{FEATURE_BATCH / f32_ms * 1e3:.1f} images/s (float32); with TF32 {tf32_ms:.2f} ms, "
        f"{FEATURE_BATCH / tf32_ms * 1e3:.1f} images/s")
    return {"max_abs_err": err, "tf32_max_abs_err": tf32_err, "scale": scale, "ms_per_100": f32_ms,
            "images_per_s": FEATURE_BATCH / f32_ms * 1e3, "tf32_ms_per_100": tf32_ms}


def ns_pair(dim, seed):
    """A well-conditioned (mu1, S1, mu2, S2) at ``dim`` with its exact
    Fréchet distance: S1 = Q diag(a) Q^T and S2 = S1^-1/2 M S1^-1/2 with
    M = P diag(m) P^T (Q, P random orthogonal, a and m in [0.5, 2]), so
    S1 S2 = S1^1/2 M S1^-1/2 is similar to M, Tr sqrt(S1 S2) = sum sqrt(m),
    and the two do not commute."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.normal(size=(dim, dim)))[0]
    p = np.linalg.qr(rng.normal(size=(dim, dim)))[0]
    a, m = rng.uniform(0.5, 2.0, dim), rng.uniform(0.5, 2.0, dim)
    s1 = (q * a) @ q.T
    r = (q * a ** -0.5) @ q.T
    s2 = r @ ((p * m) @ p.T) @ r
    s2 = (s2 + s2.T) / 2
    mu1, mu2 = rng.normal(size=dim), rng.normal(size=dim) * 0.1
    exact = float((mu1 - mu2) @ (mu1 - mu2) + a.sum() + np.trace(s2) - 2 * np.sqrt(m).sum())
    return (mu1, s1, mu2, s2), exact


def check_newton_schulz():
    """Newton–Schulz FID on the card against the exact value of a 2048-d
    pair (``ns_pair``), and against scipy's ``frechet_distance`` on a
    ``NS_SCIPY_DIM``-d one: scipy's sqrtm of a 2048² product takes 10-30 s
    on the host, which ``evaluate`` already spends twice."""
    from littlegan_tpu_torch.eval import fid

    stats, exact = ns_pair(2048, 0)
    fid.frechet_distance_newton_schulz(*stats)  # warm-up
    t0 = time.perf_counter()
    ns = fid.frechet_distance_newton_schulz(*stats)
    ns_s = time.perf_counter() - t0
    rel = abs(ns - exact) / abs(exact)
    require(rel <= NS_RTOL, f"Newton–Schulz FID {ns} vs exact {exact} at 2048-d: rel {rel:.3g}")
    small, _ = ns_pair(NS_SCIPY_DIM, 1)
    t0 = time.perf_counter()
    host = fid.frechet_distance(*small)
    host_s = time.perf_counter() - t0
    ns_small = fid.frechet_distance_newton_schulz(*small)
    rel_small = abs(ns_small - host) / abs(host)
    require(rel_small <= NS_RTOL, f"Newton–Schulz FID {ns_small} vs scipy {host} at {NS_SCIPY_DIM}-d: "
            f"rel {rel_small:.3g}")
    log(f"FID, 2048-d: Newton–Schulz on the card {ns:.6f} ({ns_s * 1e3:.1f} ms host wall) vs exact {exact:.6f}: "
        f"rel err {rel:.3g}; {NS_SCIPY_DIM}-d: {ns_small:.6f} vs scipy {host:.6f} ({host_s:.2f} s): "
        f"rel err {rel_small:.3g} (tolerance {NS_RTOL})")
    return {"ns": ns, "exact": exact, "rel_err": rel, "ns_s": ns_s, "scipy_dim": NS_SCIPY_DIM,
            "ns_small": ns_small, "scipy": host, "scipy_rel_err": rel_small, "scipy_s": host_s}


# phase (g): the single-card trainer's remaining options at full width.
# GP_K updates of the gradient penalty (both kernel flags off, the
# reference's only GP) as one CUDA graph replay against the same updates run
# eagerly, bit for bit; REMAT_STEPS steps with both kernel flags on with and
# without remat, to JAX's test_remat_step_equivalence bounds (REMAT_TOL); one
# K = GP_K replay over an s2d-layout store against the raw store, bit for
# bit (the networks see the same values in either layout: the augmentation's
# contrast mean is summed in float64, ops/augment.py); a FEED_STEPS-step
# Trainer epoch with profile_steps PROFILE_STEPS, then host-fed epochs with
# and without the prefetch and the gather path's, in turns; LOADER_IMAGES
# JPEGs per size through the CelebA pipeline with the native loader and with
# PIL.
GP_K = 8
STORE_BATCHES = 16
REMAT_STEPS = 3
REMAT_TOL = {"loss_rtol": 1e-4, "rtol": 2e-4, "atol": 1e-6}
PROFILE_STEPS = 2
FEED_STEPS = 16
LOADER_IMAGES = 256
# remat recomputes each network in every backward that crosses it: the disc
# loss's D on the real batch and on fake, the gen loss's D on fake and G, the
# adj loss's D on the adjuster's output (D passes: K1 x3, K1' and K3 x1 each)
# and the adjuster (K1 x7, K1' and K3 x1); the backwards are unchanged
REMAT_EXTRA = {"fused_instance_norm_lrelu": 4 * 3 + 4 + 7, "norm_lrelu_from_stats": 4 + 1,
               "conv3x3_same_stats": 4 + 1}
EXPECTED_REMAT_LAUNCHES = {k: v + REMAT_EXTRA.get(k, 0) for k, v in EXPECTED_TRAIN_LAUNCHES.items()}


def _store(cfg, device, seed=0):
    """A uint8 (STORE_BATCHES, B, H, W, 3) image store and its f32 softened
    conditions, made on the card from a seed."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (STORE_BATCHES, cfg.batch_size, cfg.image_dim, cfg.image_dim, cfg.image_channel)
    imgs = torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)
    bits = torch.rand((STORE_BATCHES, cfg.batch_size, cfg.cond_dim), generator=gen, device=device) < 0.5
    return imgs, torch.where(bits, 0.98, -0.94).float()


def _draws_k(cfg, first_step, k, device):
    """The trainer's draws of updates first_step .. first_step + k - 1,
    stacked, and as a list."""
    from littlegan_tpu_torch.training.step import map_draws, stack_draws

    one = [map_draws(lambda x: x[0], _update_draws(cfg, first_step + u, 1, device)) for u in range(k)]
    return stack_draws(one), one


def _equal_state(a, b) -> bool:
    import torch

    from littlegan_tpu_torch.training.step import state_tensors

    return all(torch.equal(x, y) for x, y in zip(state_tensors(a), state_tensors(b)))


def _losses(out):
    import torch

    from littlegan_tpu_torch.training.step import LOSS_KEYS

    return torch.stack([torch.atleast_1d(out.metrics[k]) for k in LOSS_KEYS], 1).tolist()


def _time_graph(step, state, imgs, conds, cfg, reps: int = 3):
    """Host wall per update over ``reps`` replays (synchronous), the device's
    busy ms per update over one profiled replay, images/s."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    k = GP_K
    n = imgs.shape[0]

    def replay(i):
        ids = (np.arange(2 * k) + 2 * k * i) % n
        draws = _draws_k(cfg, 100 + k * i, k, imgs.device)[0]
        step(state, imgs, conds, ids[0::2], ids[1::2], draws, 1 + (k * i) % 20)

    replay(0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(reps):
        replay(1 + i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / (reps * k)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replay(reps + 1)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in device_events(prof)) / k / 1e3
    return {"update_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "images_per_s": 2 * cfg.batch_size / (wall / 1e3)}


def _step_peak_mb(step_fn):
    """(peak allocated MB during one call of ``step_fn``, MB allocated
    before it)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 20, base / 2 ** 20


def check_gp(root, imgs, conds):
    """(i) The gradient penalty, both kernel flags off: GP_K updates as one
    graph replay against the same updates through the eager gather step,
    bit for bit; finite losses; a GP step with a kernel flag refused; time
    and peak memory per update against the same graph without GP."""
    import numpy as np
    import torch

    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import make_gather_train_step, make_scan_train_step, make_train_step

    plain = train_config(root).replace(use_pallas=False, use_pallas_boundary=False)
    cfg = plain.replace(use_gp=True)
    dev = imgs.device
    probe = create_train_state(cfg, dev)
    for flag in ("use_pallas", "use_pallas_boundary"):
        try:
            make_train_step(cfg.replace(**{flag: True}), probe)
        except ValueError as e:
            require("first order only" in str(e), str(e))
        else:
            raise AssertionError(f"a GP step with {flag} was built")
    graph_state, eager_state = probe, create_train_state(cfg, dev)
    n = imgs.shape[0]
    ids = np.arange(2 * GP_K) % n
    stacked, draws = _draws_k(cfg, 1, GP_K, dev)
    require(stacked.gp_eps is not None and tuple(stacked.gp_eps.shape) == (GP_K, cfg.batch_size, 1, 1, 1),
            "the GP draws carry no penalty mix")
    step = make_scan_train_step(cfg, graph_state, GP_K)
    t0 = time.time()
    step.prepare(graph_state, imgs, conds)
    torch.cuda.synchronize()
    log(f"GP graph of {GP_K} updates captured in {time.time() - t0:.1f} s")
    graph_losses = _losses(step(graph_state, imgs, conds, ids[0::2], ids[1::2], stacked, 1))
    gather = make_gather_train_step(cfg, eager_state)
    eager_losses = []
    for u in range(GP_K):
        eager_losses += _losses(gather(eager_state, imgs, conds, int(ids[2 * u]), int(ids[2 * u + 1]), draws[u], 1 + u))
    torch.cuda.synchronize()
    require(all(np.isfinite(graph_losses).flatten()), f"non-finite GP losses {graph_losses}")
    bitwise = graph_losses == eager_losses and _equal_state(graph_state, eager_state)
    log(f"GP, {GP_K} updates as one graph replay vs eager gather steps: bitwise {bitwise}; losses (gen, disc, adj) "
        + "; ".join(", ".join(f"{v:.4f}" for v in row) for row in graph_losses))
    require(bitwise, "the GP graph replay differs from the same updates run eagerly")
    record = {"bitwise": bitwise, "losses": graph_losses}

    # the same graph without GP, for the penalty's cost; peak memory of one eager update of each
    base_state = create_train_state(plain, dev)
    base_step = make_scan_train_step(plain, base_state, GP_K)
    base_step.prepare(base_state, imgs, conds)
    for name, (c, st, s, g) in (("gp", (cfg, graph_state, step, gather)),
                                ("no_gp", (plain, base_state, base_step, make_gather_train_step(plain, base_state)))):
        r = _time_graph(s, st, imgs, conds, c)
        d = _draws_k(c, 1, 1, dev)[1][0]
        g(st, imgs, conds, 0, 1, d, 12)  # this state's first eager update, outside the measurement
        peak, before = _step_peak_mb(lambda: g(st, imgs, conds, 2, 3, d, 13))
        r["eager_peak_mb"], r["eager_before_mb"] = peak, before
        log(f"graph (K = {GP_K}, kernel flags off), {name}: {r['update_ms']:.3f} ms per update (host wall); "
            f"device busy {r['device_busy_ms']:.3f} ms; idle share {r['idle_share']:.1%}; "
            f"{r['images_per_s']:.1f} images/s; one eager update's peak {peak:.0f} MB allocated "
            f"({before:.0f} MB before it)")
        record[name] = r
    return record


def check_remat(root, imgs, conds):
    """(ii) REMAT_STEPS steps with both kernel flags on, with and without
    remat, from one init: losses and weights to REMAT_TOL, the kernels'
    launches per step exactly, peak memory per step, step times. Returns
    (the remat run's launches, the record)."""
    import numpy as np
    import torch

    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import LOSS_KEYS, make_train_step, take_batch

    cfg = train_config(root)
    dev = imgs.device
    counters = _counters(tuple(EXPECTED_TRAIN_LAUNCHES))
    runs, record, launches_run = {}, {}, {}
    _, draws = _draws_k(cfg, 1, REMAT_STEPS, dev)
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        state = create_train_state(c, dev)
        step = make_train_step(c, state)
        losses, peaks, per_step = [], [], []
        for c_ in counters.values():
            c_.reset()
        for i in range(REMAT_STEPS):
            before = {k: v.value for k, v in counters.items()}
            b1 = (take_batch(imgs, 2 * i), take_batch(conds, 2 * i))
            b2 = (take_batch(imgs, 2 * i + 1), take_batch(conds, 2 * i + 1))
            box = {}
            peak, base = _step_peak_mb(lambda: box.setdefault("out", step(state, b1, b2, draws[i], 10 + i)))
            losses.append([float(box["out"].metrics[k]) for k in LOSS_KEYS])
            peaks.append({"peak": peak, "before": base})
            per_step.append({k: v.value - before[k] for k, v in counters.items()})
        want = EXPECTED_REMAT_LAUNCHES if remat else EXPECTED_TRAIN_LAUNCHES
        require(all(p == want for p in per_step), f"remat={remat}: launches per step {per_step}, want {want}")
        if remat:
            launches_run = {k: v.value for k, v in counters.items()}
        runs[remat] = (state, losses)
        record[f"remat_{remat}"] = {"losses": losses, "peak_mb": peaks, "launches_per_step": per_step[0]}
        log(f"remat={remat}: {REMAT_STEPS} steps, launches per step {per_step[0]}; peak allocated per step "
            + ", ".join(f"{p['peak']:.0f} MB" for p in peaks) + f" ({peaks[0]['before']:.0f} MB before each)")
    (s0, l0), (s1, l1) = runs[False], runs[True]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-12) for ra, rb in zip(l1, l0) for a, b in zip(ra, rb))
    worst = 0.0
    for (name, a), b in zip(s1.model.named_parameters(), s0.model.parameters()):
        excess = float(((a - b).abs() - (REMAT_TOL["atol"] + REMAT_TOL["rtol"] * b.abs())).max().detach())
        worst = max(worst, excess)
    bitwise = l0 == l1 and _equal_state(s0, s1)
    log(f"remat vs no remat, {REMAT_STEPS} steps: largest loss difference {loss_rel:.3g} (relative); weights "
        f"{'within' if worst <= 0 else 'OUTSIDE'} rtol {REMAT_TOL['rtol']} / atol {REMAT_TOL['atol']}; "
        f"bitwise {bitwise}")
    require(np.isfinite(l1).all() and loss_rel <= REMAT_TOL["loss_rtol"] and worst <= 0,
            f"remat changes the step: losses {loss_rel}, weights exceed the bound by {worst}")
    record.update({"loss_rel": loss_rel, "bitwise": bitwise})
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        state = runs[remat][0]
        step = make_train_step(c, state)
        b1 = (take_batch(imgs, 0), take_batch(conds, 0))
        b2 = (take_batch(imgs, 1), take_batch(conds, 1))
        r = _time_steps(lambda i: step(state, b1, b2, draws[0], 11 + i % 5), 5, cfg.batch_size)
        log(f"train step, batch {cfg.batch_size}, kernels on, remat={remat}: {r['step_ms']:.3f} ms (host wall); "
            f"device busy {r['device_busy_ms']:.3f} ms ({r['device_ops']:.0f} ops); idle share "
            f"{r['idle_share']:.1%}; {r['images_per_s']:.1f} images/s")
        record.setdefault(f"time_remat_{remat}", []).append(r)
    return launches_run, record


def check_s2d_store(root, imgs, conds):
    """(iii) One K = GP_K replay over an s2d-layout store against the same
    updates over the raw store, both kernel flags on. Returns (the s2d
    replay's launches, the record)."""
    import numpy as np
    import torch

    from littlegan_tpu_torch.ops.s2d import space_to_depth
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import make_scan_train_step

    cfg = train_config(root)
    dev = imgs.device
    s2d = space_to_depth(imgs.flatten(0, 1)).reshape(imgs.shape[0], imgs.shape[1], *space_to_depth(imgs[0]).shape[1:])
    s2d = s2d.contiguous()
    ids = np.arange(2 * GP_K) % imgs.shape[0]
    stacked, _ = _draws_k(cfg, 1, GP_K, dev)
    counters = _counters(tuple(EXPECTED_TRAIN_LAUNCHES))
    out, launches = {}, {}
    for layout, store in (("raw", imgs), ("s2d", s2d)):
        state = create_train_state(cfg, dev)
        step = make_scan_train_step(cfg, state, GP_K, store_s2d=layout == "s2d")
        step.prepare(state, store, conds)
        for c in counters.values():
            c.reset()
        losses = _losses(step(state, store, conds, ids[0::2], ids[1::2], stacked, 1))
        torch.cuda.synchronize()
        launches[layout] = {k: c.value for k, c in counters.items()}
        out[layout] = (state, losses)
    want = {k: v * GP_K for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
    require(launches["raw"] == launches["s2d"] == want, f"s2d-store launches {launches}, want {want}")
    (sr, lr_), (ss, ls) = out["raw"], out["s2d"]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-12) for ra, rb in zip(ls, lr_) for a, b in zip(ra, rb))
    param_max = max(float((a - b).abs().max().detach()) for a, b in zip(ss.model.parameters(), sr.model.parameters()))
    bitwise = ls == lr_ and _equal_state(sr, ss)
    log(f"s2d-layout store vs raw store, {GP_K} updates in one replay each: largest loss difference {loss_rel:.3g} "
        f"(relative), largest weight difference {param_max:.3g} = {param_max / cfg.lr:.3f} x lr; bitwise {bitwise}; "
        f"launches {launches['s2d']}")
    require(np.isfinite(ls).all() and bitwise,
            f"the s2d store's updates differ from the raw store's: losses {loss_rel}, weights {param_max}")
    return launches["s2d"], {"loss_rel": loss_rel, "param_max_over_lr": param_max / cfg.lr, "bitwise": bitwise}


def _trace_idle(path):
    """(device busy s, window s) of a torch.profiler trace file: the
    device's kernels, copies and sets against the span of all its events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    busy = sum(e["dur"] for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e6
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e6
    return busy, span


def check_profile_and_feed(root):
    """(iv) A host-fed Trainer epoch of FEED_STEPS steps with profile_steps
    PROFILE_STEPS: one trace, holding K1's and K3's kernels, whose window
    gives the host-fed path's idle share. (v) FEED_STEPS-step host-fed
    epochs through the prefetch and through a synchronous copy of each
    batch, and the gather path's epoch, in turns: images/s."""
    import glob

    import torch

    from littlegan_tpu_torch.data import SyntheticDataset
    from littlegan_tpu_torch.training.trainer import Trainer

    cfg = train_config(root).replace(exp_name="chip_smoke_feed", profile_steps=PROFILE_STEPS, freq_gen=0)
    data = SyntheticDataset(cfg, num_items=2 * FEED_STEPS * cfg.batch_size)
    feeds = {}
    for name, kw in (("prefetch", {}), ("synchronous", {}), ("gather", {"device_data": True})):
        tr = Trainer(cfg.replace(exp_name=f"chip_smoke_feed_{name}", **kw), data)
        tr._save_epoch_checkpoint = lambda epoch: None  # epochs for the clock only
        if name == "synchronous":  # the feed before the prefetch: each batch copied when its step starts
            tr._prefetch = lambda items, dev=tr.device: ((_put(b1, dev), _put(b2, dev)) for b1, b2 in items)
        feeds[name] = tr

    def epoch(tr):
        tr.global_epoch = 1
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    prof = feeds["prefetch"]
    epoch(prof)  # profile_steps: steps 10 and 11 of this first epoch are traced
    traces = glob.glob(os.path.join(prof.cfg.result_dir, "log", "profile", "*.pt.trace.json"))
    require(len(traces) == 1, f"profile traces {traces}")
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
    k1 = sorted(n for n in names if re.search(r"::(cluster_kernel|stats_kernel)", n))
    k3 = sorted(n for n in names if "conv3x3_mma_kernel" in n or "conv3x3_stats_kernel" in n)
    busy, span = _trace_idle(traces[0])
    out = {"trace_mb": os.path.getsize(traces[0]) / 1e6, "trace_kernel_names": len(names),
           "trace_device_busy_s": busy, "trace_window_s": span, "prefetch_idle_share": 1 - busy / span}
    log(f"profile_steps {PROFILE_STEPS}: one trace of {out['trace_mb']:.1f} MB, {len(names)} kernel names, "
        f"K1's {len(k1)}, K3's {len(k3)}; host-fed with prefetch in its window: device busy {busy * 1e3:.2f} of "
        f"{span * 1e3:.2f} ms, idle share {1 - busy / span:.1%}")
    require(k1 and k3, f"the profiler trace holds no K1 or K3 kernel: {sorted(names)[:20]}")
    for tr in feeds.values():  # one trace per run: the timed epochs run unprofiled
        tr.cfg = tr.cfg.replace(profile_steps=0)
    for name in ("synchronous", "gather"):
        epoch(feeds[name])  # warm-up (and the gather path's upload)
    for name in list(feeds) + list(feeds)[::-1]:
        wall = epoch(feeds[name])
        out.setdefault(f"{name}_images_per_s", []).append(2 * cfg.batch_size * FEED_STEPS / wall)
        log(f"{name} Trainer epoch of {FEED_STEPS} steps: {out[f'{name}_images_per_s'][-1]:.1f} images/s "
            f"({wall:.3f} s, the synthetic batches' host generation included)")
    return out


def check_native_loader(root):
    """(vi) The CelebA pipeline (its thread pool, cfg.threads) on the host
    over LOADER_IMAGES synthetic JPEGs at 128x128 and at CelebA's 178x218,
    with the native loader and with PIL: images/s and the decoder that ran.
    A host without libjpeg (or g++) decodes with PIL, and the pipeline says
    so."""
    from littlegan_tpu_torch.data import native_loader

    status = native_loader.available()
    log(f"native loader on this host: {status}")
    rates = native_loader.pipeline_rates(root, train_config(root), LOADER_IMAGES)
    want = {"native", "PIL"} if status == "ok" else {"PIL"}
    require({k.split()[1] for k in rates} == want, f"decoders that ran: {sorted(rates)} ({status})")
    for key, vals in rates.items():
        log(f"CelebA pipeline, {key} decoder, 8 threads: " + ", ".join(f"{v:.1f}" for v in vals)
            + " images/s on the host")
    return {"native": status, "rates": rates}


def check_trainer_options():
    """Phase (g): the gradient penalty, remat, the s2d-layout store,
    profile_steps, the prefetched host feed and the native loader. Returns
    (launches on the remat path, on the s2d-store path, the record)."""
    import tempfile

    import torch

    record, walls = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_options_") as root:
        imgs, conds = _store(train_config(root), torch.device("cuda"))
        t0 = time.time()
        record["gp"] = check_gp(root, imgs, conds)
        walls["gp"], t0 = time.time() - t0, time.time()
        remat_launches, record["remat"] = check_remat(root, imgs, conds)
        walls["remat"], t0 = time.time() - t0, time.time()
        s2d_launches, record["s2d_store"] = check_s2d_store(root, imgs, conds)
        walls["s2d_store"], t0 = time.time() - t0, time.time()
        del imgs, conds
        record["profile_feed"] = check_profile_and_feed(root)
        walls["profile_feed"], t0 = time.time() - t0, time.time()
        record["loader"] = check_native_loader(root)
        walls["loader"] = time.time() - t0
    log("phase (g) walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return remat_launches, s2d_launches, record


def summarize(records, serve_launches, train_launches, dispatch_launches, eval_launches, remat_launches,
              s2d_launches):
    """One JSON record per kernel, bf16 (the working dtype): summed over the
    launches of one train step where phase (b) timed the train shapes, else
    over the shapes one /adjust call gives it ("per" says which; a kernel
    timed on both paths adds the /adjust sums as "serve_ms",
    "serve_plain_ms", "serve_bound_ms"); per-shape numbers under "shapes".
    "launches" counts the six paths' runs (serve, host-fed train,
    CUDA-graph dispatch, evaluate-sample, the remat steps, the s2d-store
    replay), split in "launches_by_path"."""
    meta = {
        "fused_instance_norm_lrelu": ("littlegan_tpu_torch/csrc/norm_lrelu.cu",
                                      "littlegan_tpu/ops/pallas/norm_lrelu.py:111"),
        "norm_lrelu_from_stats": ("littlegan_tpu_torch/csrc/norm_lrelu.cu",
                                  "littlegan_tpu/ops/norm.py:59"),
        "conv3x3_same_stats": ("littlegan_tpu_torch/csrc/boundary_conv.cu",
                               "littlegan_tpu/ops/pallas/boundary_conv.py:132"),
        "fused_instance_norm_lrelu_bwd": ("littlegan_tpu_torch/csrc/norm_lrelu_bwd.cu",
                                          "littlegan_tpu/ops/pallas/norm_lrelu.py:198"),
        "norm_lrelu_from_stats_bwd": ("littlegan_tpu_torch/csrc/norm_lrelu_bwd.cu",
                                      "littlegan_tpu/ops/norm.py:59"),
        "conv3x3_bwd_fold": ("littlegan_tpu_torch/csrc/boundary_conv_bwd.cu",
                             "littlegan_tpu/ops/pallas/boundary_conv.py:179"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        bf16 = [s for s in records[name]["shapes"] if s["dtype"] == "bfloat16"]
        train = [s for s in bf16 if "per_step" in s]
        serve = [s for s in bf16 if "per_step" not in s]

        def tot(k, shapes):
            return sum(s[k] * s.get("per_step", 1) for s in shapes)

        shapes = train or serve
        lib = None if shapes[0]["library_ms"] is None else tot("library_ms", shapes)
        by_path = {"serve": serve_launches.get(name, 0), "train": train_launches.get(name, 0),
                   "dispatch": dispatch_launches.get(name, 0), "eval": eval_launches.get(name, 0),
                   "remat": remat_launches.get(name, 0), "s2d_store": s2d_launches.get(name, 0)}
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(s["max_abs_err"] for s in bf16),
            "ms": tot("ms", shapes), "plain_ms": tot("plain_ms", shapes), "bound_ms": tot("bound_ms", shapes),
            "bound_by": shapes[0]["bound_by"], "library_ms": lib,
            "per": "train step" if train else "/adjust call",
        }
        if train and serve:
            entry.update({f"serve_{k}": tot(k, serve) for k in ("ms", "plain_ms", "bound_ms")})
        routes = {s["dtype"]: s["kernel_route"] for s in records[name]["shapes"] if "kernel_route" in s}
        if routes:
            entry["kernel_route"] = routes
        entry["shapes"] = records[name]["shapes"]
        out.append(entry)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from littlegan_tpu_torch.ops.cuda import _build

    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    so = _build.build()
    _build.lib()
    log(f"kernels built and loaded in {time.time() - t0:.1f} s: {so}")
    with open(so + ".log") as f:  # each kernel's registers, shared memory and spills
        for line in f:
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                log(f"  {_kernel_name(entry.group(1))}")
            elif "registers" in line or "spill" in line or line.startswith("=="):
                log("    " + line.strip())
    check_tensor_cores(so)

    walls = {"build": time.time() - t0}
    t0 = time.time()
    records = check_kernels()
    records.update(check_backward_kernels())
    log("K1 routes: " + json.dumps(compare_fwd_routes()))
    log("backward routes: " + json.dumps(compare_bwd_routes()))
    walls["b"], t0 = time.time() - t0, time.time()
    serve_launches = check_serving(full_config())
    walls["c"], t0 = time.time() - t0, time.time()
    train_launches, train = check_training()
    log("train record: " + json.dumps(train))
    walls["d"], t0 = time.time() - t0, time.time()
    dispatch_launches, dispatch = check_dispatch()
    log("dispatch record: " + json.dumps(dispatch))
    walls["e"], t0 = time.time() - t0, time.time()
    eval_launches, evaluation = check_eval()
    log("eval record: " + json.dumps(evaluation))
    walls["f"], t0 = time.time() - t0, time.time()
    remat_launches, s2d_launches, options = check_trainer_options()
    log("trainer options record: " + json.dumps(options))
    walls["g"] = time.time() - t0
    log("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    log(json.dumps({"kernels": summarize(records, serve_launches, train_launches, dispatch_launches,
                                         eval_launches, remat_launches, s2d_launches)}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
