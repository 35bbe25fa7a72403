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
      conv_filter [384, 256, 128, 64, 32], bf16, s2d on, the kernels on
      the card as everywhere, seeded random weights, batch 8), start ``serve()`` on an ephemeral
      port, answer HTTP requests to /generate, /adjust, /discriminate and
      /metrics, check the kernels' launch counts per engine call, and compare
      the engine's outputs with the same weights run through the plain
      versions on the card (under ``_build.plain_versions()``, as every
      plain side below);
  (d) trains the full-width model (128x128, batch 32, bf16, s2d, adjuster,
      partition schedule, clipping) through
      ``Trainer`` on the synthetic dataset for 12 steps in a temporary
      result directory: checks the losses, the kernels' launches per step,
      the train image and the epoch checkpoint, and that the checkpoint
      restores in a new ``Trainer``; then one step's losses and gradients
      with the kernels against the same step through the plain versions,
      and the step's host and device times through each;
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
      width: ``GP_K`` updates with the gradient penalty (on the plain ops,
      the model's route under it) as one CUDA graph replay against the same
      updates run eagerly, bit for bit, with the update's time and peak
      memory against the same graph without the penalty on the plain ops;
      ``REMAT_STEPS`` steps through the kernels with and without
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
      host without libjpeg decodes with PIL);
  (h) data parallelism (``littlegan_tpu_torch/parallel/``): every kernel
      against its plain version at one rank's shapes (the train step's rows
      split over ``DP_RANKS``); (i) NCCL at world size 1: a ``Trainer``
      with the process group trains ``DP_STEPS`` updates over the device
      store in ``DP_K``-update CUDA graph replays, the all-reduce captured
      in each (launches per replay and per run counted), bit for bit with
      the same run without a group, and the graph update's device busy
      with and without the group, with the bytes reduced per update; then
      ZeRO-1's reduce-scatter and all-gather over NCCL, eager and captured,
      bit for bit with the run without a group;
      (ii) ``DP_RANKS`` gloo ranks sharing the card, started by this
      script (``--dp-rank``): ``DP_UPDATES`` updates of the global batch
      (host-fed, host-fed, gather, ``grad_accum`` 2) through the kernels,
      in float32 and in bf16, replicated and with ZeRO-1, against one
      process on the global batch (losses to ``TRAIN_TOL["loss_rtol"]``,
      weights to ``DP_FLOOR_X`` times the gap that swapping the batch's
      halves makes in one process), ZeRO-1 against replicated, the ranks'
      losses equal, the K-update CUDA graph refused under gloo (its collectives
      cannot be captured), and one ``Trainer`` epoch per rank in which rank
      1 writes no file; (iii) an engine over ``[cuda:0, cuda:0]`` (two replicas on the
      card) against the one-card engine at ``DP_INFER_ROWS`` rows
      (``ENGINE_TOL``) and one ``--devices 1`` request through ``serve()``;
  (i) compat (``littlegan_tpu_torch/compat/``): a state trained
      ``COMPAT_STEPS`` updates with ``adam_tf_parity`` goes to the reference
      checkpoint's variables (``state_to_variables``) and back
      (``variables_to_train_state`` on the card), bit for bit; the
      converter's npz writer stores it and ``COMPAT_RESUMED`` updates (bf16,
      through the kernels) resumed by a ``Trainer`` from it match the same
      updates resumed from the unconverted state (``TRAIN_TOL["loss_rtol"]``,
      launch counts per update); the three ``torch.export`` programs
      (``compat/torch_export.py``) reloaded at ``PT2_BATCHES`` against the
      f32 plain-op forward with TF32 off (``PT2_TOL``), and the reloaded
      ``generate`` timed beside the ``InferenceEngine``. The card's host has
      no TensorFlow, so the SavedModel and the TF file read and write are
      left to tests/test_torch_compat.py;
  (j) the spatial ``('data', 'model')`` mesh (``parallel/spatial.py``) at
      full width (128², batch 32, s2d): ``SP_RANKS`` gloo ranks sharing the
      card as a [1, ``SP_RANKS``] mesh (``--sp-rank``), each on its image
      rows, run phase (h) (ii)'s updates in float32 and bf16, replicated,
      with ZeRO-1, with ``shard_dense`` and both, on the plain ops as the
      model runs under a mesh (no kernel may launch), against one process
      on the plain ops (losses to ``TRAIN_TOL["loss_rtol"]``,
      weights to ``DP_FLOOR_X`` times that process's halves-swapped gap);
      the ``shard_dense`` state through rank 0's npz and back, bit for
      bit; the K-update graph refused under gloo; a ``Trainer`` epoch over
      the mesh (rank 1 writes nothing) with each rank's peak memory beside
      one process's;
  (k) the port's last modules at full width: a two-epoch ``Trainer`` run
      over the card store at K = ``PARITY_K`` on the orbax backend
      (``training/checkpoint.py::OrbaxCheckpointer``, DCP underneath)
      against the same run on the npz backend, and a run resumed from the
      orbax run's epoch-1 checkpoint (saved asynchronously while epoch 2
      trained) against the unbroken run, both bit for bit, with each
      save's blocking host time; ``memory_report --measure``
      (one update's peak beside the analytic state bytes); the doctor on
      the card (its tiny step must launch the kernels); the conditioning
      check on the orbax run's checkpoint over a synthetic structured set
      of JPEGs (finite deltas, K1, K1' and K3 launched); ``C2_RANKS`` gloo
      ranks with ``device_data`` (``--c2-rank``), each decoding only its
      half of every batch;
  (l) kernel coverage, the shapes the JAX package's Pallas kernels take
      beyond the reference's widths: K3 on both routes and its fold at
      every Cout of ``COVER_K3_COUTS`` (one or two padded Cout tiles, the
      fold's 16-byte and element layouts) over block1's 128² s2d input at
      ``COVER_K3_BATCHES`` and at 256 x 256 x 12 (``COVER_K3_WIDE``), with
      the host's plan held to the library's shared memory and partial
      counts; K1 (the three-launch two-pass route), K2 and K1' bwd at the
      whole-sample maps beyond 16 blocks' shared memory (``COVER_K1``);
      each against its plain version with phase (b)'s tolerances, once
      launched, timed beside its bound; then the doctor's tiny train step
      at the JAX doctor's block1 width 6, every kernel launched;
  (m) the measurement and campaign tools as a user runs them:
      ``python -m littlegan_tpu_torch.bench`` at 128², batch 32 (its line
      parsed: 0 < mfu <= 1, the card's name, and each wrapper's launches
      over the timed windows equal to ``EXPECTED_GRAPH_LAUNCHES`` per
      update: its updates run as CUDA-graph replays, so the SAME-border
      counters count too);
      autotune over K 8, 16 and 64 (every point measured, with its graph
      capture seconds and peak memory); serve_bench with a hot-reload
      drill (0 requests dropped); scaling_curve over one card;
      a one-epoch campaign at 32² (7 generator and 7
      adjuster effects, finite trends, every kernel launched). Each tool's
      wall is printed beside the card's ``nvidia-smi`` line;
  (n) the JAX repo's last entry points as a user runs them: ``fit_frontier``
      over 128² at batch 32 and 256, parity and remat (every point fits),
      and over a point past the card (``ENTRY_OOM``: ``oom``, not an error);
      ``python -m littlegan_tpu_torch.dryrun 1`` over NCCL (each regime OK
      or skipped as at one rank, the kernels launched);
      ``bench_step_variants`` (the concat-D step against the current one:
      host ms per eager step, device ms per update of a K = 8 graph) with a
      trace of one graph replay; ``trace_top_ops`` on
      phase (g)'s ``profile_steps`` trace and on that replay (K1, K2 and K3
      among the device ops); ``bench_boundary_conv`` (K3 within
      ``ENTRY_K3_REL`` of phase (b)'s time at (32, 64, 64, 12) bf16). Each
      tool's wall is printed;
  (o) StarGAN v2's kernels (``csrc/channel_norm_lrelu.cu``,
      ``csrc/resample.cu``, ``csrc/conv_epilogue.cu``) as its main path
      runs them: one eager iteration
      of the benchmark's configuration (``SG_CONFIG``: AFHQ 256², batch 8,
      bf16) under the profiler, the ``stargan_v2.*`` kernel counters set to
      0 just before it, must count ``SG_EXPECTED_CALLS`` and launch
      ``SG_KERNELS`` per call; at every (C, H) the iteration ran, batch 8,
      bf16 channels-last, the norm's forward and backward (IN's shared and
      AdaIN's per-sample affine), the pool and upsample (at both scales)
      and the conv epilogue's forms (bias; bias, shortcut and 1/sqrt(2);
      the double backward's scale; the backward's column sum with and
      without the scaled gradient) against their plain versions to one
      rounding (``SG_ROUNDING``, ``SG_SUMS_REL``; the column sum to
      ``SG_COLSUM_REL`` of float64's and the same bits twice), each timed
      beside its bytes' bound, its plain version and PyTorch's ops
      (``instance_norm``, the affine and ``leaky_relu`` over NCHW;
      ``avg_pool2d`` and ``interpolate`` over NHWC and NCHW; the parent's
      bias ``add_``, residual add and division, ``aten::sum``), and summed
      over the iteration's calls;
  (p) StyleGAN2's FIR resampling (``csrc/upfirdn2d.cu``, S4) at every
      shape of the ``stylegan2-ffhq-256`` cell's iteration (``SG2_FIR``,
      batch 64, channels-last), forward form and adjoint, against its plain
      version (``SG2_ROUNDING`` in bf16, ``SG2_F32_REL`` in float32), timed
      beside its bytes' bound, its plain version and a depthwise
      ``F.conv2d`` over the same padded map;
  (q) StyleGAN2's layer epilogue (``csrc/bias_act.cu``, S5) as the
      ``stylegan2-ffhq-256`` cell's iteration runs it: one lazy period (16
      eager iterations at batch 64, path length on 4, R1 on 1) with S5's
      calls recorded by kind and shape and its three launch counters read
      (``SG2_S5_LAUNCHES`` per period), one profiled iteration that must
      launch S5's kernels, as many as its counters count, and no S3 kernel;
      then at every recorded shape the kernel against its
      plain version (``SG2_ROUNDING`` of each element in bf16, one float32
      rounding in float32; the sums to ``SG2_S5_SUM_REL`` of their
      magnitudes), timed beside its bytes' bound, its plain version and the
      PyTorch ops the model ran before S5 (forward and backward), and the
      sums over an iteration;
  (r) StyleGAN3's launches over one lazy period of the
      ``stylegan3-t-afhqv2-512`` cell's training (16 eager iterations at
      batch 32, 512²: ``SG3_LAUNCHES``, S6's 28 forwards and 14 backwards
      an iteration), then its filtered LeakyReLU (``csrc/filtered_lrelu.cu``,
      S6) at every filtered layer of the cell (batch 32, bf16,
      channels-last, every tenth channel large enough to clamp), forward
      and backward against its plain version on two of the samples (the
      output and gy within ``SG3_ROUNDING`` of each value plus its channel
      group's RMS, the clamped tenth and the rest apart; the column sums to
      ``SG3_SUM_REL`` of the largest; both backwards read the kernel's mask, whose
      bits may differ from the plain version's at ``SG3_MASK_DIFFER`` of
      them), each timed beside its bound
      (``benchmark/roofline/stylegan3.py``), and the sums over an
      iteration. Each phase's wall after (r).

The last two lines of standard output are the card's ``nvidia-smi`` name
and power limit, then ``{"ok": true, "device": {...}}``; the line before them
is the kernels' JSON record. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result. ``--dp-rank RANK PORT
OUT`` runs one rank of phase (h) (ii), ``--sp-rank RANK PORT OUT`` one of
phase (j), ``--c2-rank RANK PORT OUT`` one of phase (k); those phases start
them.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
# engine (the kernels) vs the same weights through the plain versions, bf16
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
# a CUDA graph's launches per train step: the families above and the
# engagement counters of TF SAME's border (norm_lrelu.py's SAME_BORDER):
# encoder blocks 1-3 write inside the next conv's border in four passes and
# read its gradient in four backwards, decoder blocks 1-3 read out of the
# full output in two passes and write its gradient in two backwards
EXPECTED_GRAPH_LAUNCHES = {**EXPECTED_TRAIN_LAUNCHES, "same_border.write": 12, "same_border.grad_read": 12,
                           "same_border.crop_read": 6, "same_border.grad_write": 6}
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
            plan = nl.fwd_plan(shape[0], x[0].numel(), item, nl._sms(dev), nl.holds_whole_sample(shape, item))
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
            plan = nl.fwd_plan(shape[0], x[0].numel(), item, nl._sms(dev), nl.holds_whole_sample(shape, item))
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
        whole = nl.holds_whole_sample(shape, 2)
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
    [384, 256, 128, 64, 32], bf16, s2d on; the kernels run on the card),
    seeded fresh weights, batch 8."""
    from littlegan_tpu_torch.config import Config

    cfg = Config(restore=False, seed=0, batch_size=BATCH, exp_name="chip_smoke")
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
    from littlegan_tpu_torch.ops.cuda import _build
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
    plain = LittleGAN(cfg)
    plain.load_state_dict(engine.model.state_dict())
    plain = plain.to(engine.device).eval()
    noise = rng.normal(size=(BATCH, cfg.noise_dim)).astype(np.float32)
    cond = soft(rng.random((BATCH, cfg.cond_dim)) < 0.5)
    images = (images_u8[rng.integers(0, 3, BATCH)] / 127.5 - 1.0).astype(np.float32)
    dev = engine.device
    with torch.inference_mode(), _build.plain_versions():
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
    [384, 256, 128, 64, 32], bf16, s2d, train_adj, use_partition, use_clip;
    the kernels run on the card), batch 32, one epoch of TRAIN_STEPS steps,
    one train image at the last step, no fixture predict, in ``root``."""
    from littlegan_tpu_torch.config import Config

    cfg = Config(seed=0, batch_size=TRAIN_BATCH, epoch=1,
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

    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.training.state import A_KEYS, D_KEYS, G_KEYS, create_train_state, subtree
    from littlegan_tpu_torch.training.step import LOSS_KEYS, compute_grads

    cfg = trainer.cfg
    it = trainer.dataset.epoch_iterator(1)
    b1, b2 = _put(next(it), trainer.device), _put(next(it), trainer.device)
    draws = trainer.draws(10_000)
    batch_no = 12
    grads, aux = compute_grads(trainer.state, b1, b2, draws, batch_no, cfg)
    f32_cfg = cfg.replace(compute_dtype="float32")
    f32_model = type(trainer.state.model)(f32_cfg).to(trainer.device)
    f32_model.load_state_dict(trainer.state.model.state_dict())
    with _build.plain_versions():
        pgrads, paux = compute_grads(trainer.state, b1, b2, draws, batch_no, cfg)
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
    counts them (2 x batch per step); through the kernels (the trainer's
    state) and through the plain versions (a copy of it, under
    ``_build.plain_versions()``), measured kernels, plain, kernels, plain
    in this one run."""
    import contextlib

    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import make_train_step

    cfg = trainer.cfg
    it = trainer.dataset.epoch_iterator(2)
    b1, b2 = _put(next(it), trainer.device), _put(next(it), trainer.device)
    plain_model = type(trainer.state.model)(cfg).to(trainer.device)
    plain_model.load_state_dict(trainer.state.model.state_dict())
    plain_state = create_train_state(cfg, trainer.device, plain_model)
    runs = {
        "kernels": (trainer.state, trainer._train_step, contextlib.nullcontext),
        "plain": (plain_state, make_train_step(cfg, plain_state), _build.plain_versions),
    }
    out = {}
    for rnd in range(2):
        for name, (state, step_fn, route) in runs.items():

            def step(i, state=state, step_fn=step_fn, route=route):
                with route():
                    return step_fn(state, b1, b2, trainer.draws(20_000 + i), 11 + i % 5)

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


def _lr_steps(got, want, lr) -> str:
    """How two runs' flat weights differ in units of the learning rate."""
    d = (got.float() - want.float()).abs()
    return (f"{int((d > lr / 2).sum())} of {d.numel()} weights more than lr/2 apart, "
            f"largest {float(d.max()) / lr:.3g} lr")


def _hold(what, losses, want_losses, params, want_params, tol=(TRAIN_TOL["loss_rtol"], DISPATCH_PARAM_REL)):
    """Hold per-update losses (lists of (gen, disc, adj)) and per-group
    weights against a reference run's, to ``tol`` (the losses' relative
    difference, the weights' relative norm error); returns the record,
    raises on a miss."""
    import torch

    loss_rel = max(abs(a - b) / max(abs(b), 1e-12) for la, lb in zip(losses, want_losses) for a, b in zip(la, lb))
    param_rel = max(_rel_err(a, b) for a, b in zip(params, want_params))
    bitwise = losses == want_losses and all(torch.equal(a, b) for a, b in zip(params, want_params))
    log(f"{what}: largest loss difference {loss_rel:.3g} (relative), weights at the groups' ends "
        f"{param_rel:.3g} (relative norm); bitwise: {bitwise}")
    require(len(losses) == len(want_losses) and len(params) == len(want_params), (what, len(losses), len(params)))
    if not loss_rel <= tol[0] or not param_rel <= tol[1]:
        raise AssertionError(f"{what}: the runs disagree (losses {loss_rel}, weights {param_rel}; tolerance {tol})")
    return {"loss_rel": loss_rel, "param_rel": param_rel, "bitwise": bitwise, "tol": list(tol)}


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
            want = {name: v * k for name, v in EXPECTED_GRAPH_LAUNCHES.items()}
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
    want = {k: v * ACCUM_K * ACCUM_M for k, v in EXPECTED_GRAPH_LAUNCHES.items()}
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
    """Phase (f)'s configuration file: the defaults at full width (the
    kernels run on the card), batch 32, one short synthetic train epoch,
    random-init Inception allowed, all four metrics."""
    return {
        "seed": 0, "batch_size": TRAIN_BATCH, "epoch": 1,
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
    from littlegan_tpu_torch.ops.cuda import _build
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
    with _build.plain_versions():
        plain = Trainer(cfg.replace(reuse=True, restore=True), None)
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
# GP_K updates of the gradient penalty (on the plain ops, as the penalty
# takes them) as one CUDA graph replay against the same updates run
# eagerly, bit for bit; REMAT_STEPS steps through the kernels with and
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
# the profile_steps trace, kept past phase (g)'s temporary directory for phase (n)
PROFILE_TRACE_COPY = os.path.join(tempfile.gettempdir(), f"chip_smoke_{os.getpid()}_profile.pt.trace.json")
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
    """(i) The gradient penalty, on the plain ops (the model's route under
    use_gp): GP_K updates as one graph replay against the same updates
    through the eager gather step, bit for bit; finite losses; time and
    peak memory per update against the same graph without GP, on the plain
    ops too (``_build.plain_versions()``)."""
    import contextlib

    import numpy as np
    import torch

    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import make_gather_train_step, make_scan_train_step

    plain = train_config(root)
    cfg = plain.replace(use_gp=True)
    dev = imgs.device
    graph_state, eager_state = create_train_state(cfg, dev), create_train_state(cfg, dev)
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

    # the same graph without GP on the plain ops, for the penalty's cost; peak memory of one eager update of each
    base_state = create_train_state(plain, dev)
    base_step = make_scan_train_step(plain, base_state, GP_K)
    with _build.plain_versions():
        base_step.prepare(base_state, imgs, conds)
    for name, (c, st, s, g, route) in (
            ("gp", (cfg, graph_state, step, gather, contextlib.nullcontext)),
            ("no_gp", (plain, base_state, base_step, make_gather_train_step(plain, base_state),
                       _build.plain_versions))):
        with route():
            r = _time_graph(s, st, imgs, conds, c)
            d = _draws_k(c, 1, 1, dev)[1][0]
            g(st, imgs, conds, 0, 1, d, 12)  # this state's first eager update, outside the measurement
            peak, before = _step_peak_mb(lambda: g(st, imgs, conds, 2, 3, d, 13))
        r["eager_peak_mb"], r["eager_before_mb"] = peak, before
        log(f"graph (K = {GP_K}, plain ops), {name}: {r['update_ms']:.3f} ms per update (host wall); "
            f"device busy {r['device_busy_ms']:.3f} ms; idle share {r['idle_share']:.1%}; "
            f"{r['images_per_s']:.1f} images/s; one eager update's peak {peak:.0f} MB allocated "
            f"({before:.0f} MB before it)")
        record[name] = r
    return record


def check_remat(root, imgs, conds):
    """(ii) REMAT_STEPS steps through the kernels, with and without
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
        log(f"train step, batch {cfg.batch_size}, kernels, remat={remat}: {r['step_ms']:.3f} ms (host wall); "
            f"device busy {r['device_busy_ms']:.3f} ms ({r['device_ops']:.0f} ops); idle share "
            f"{r['idle_share']:.1%}; {r['images_per_s']:.1f} images/s")
        record.setdefault(f"time_remat_{remat}", []).append(r)
    return launches_run, record


def check_s2d_store(root, imgs, conds):
    """(iii) One K = GP_K replay over an s2d-layout store against the same
    updates over the raw store, through the kernels. Returns (the s2d
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
    import shutil

    shutil.copyfile(traces[0], PROFILE_TRACE_COPY)  # phase (n) summarizes it with trace_top_ops
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


# phase (h): data parallelism. (i) NCCL at world size 1 on the card: a
# Trainer with the process group trains DP_STEPS updates over the device
# store in DP_K-update CUDA graph replays, the all-reduce captured in each,
# against the same run without a group (bit for bit); then ZeRO-1's
# reduce-scatter and all-gather over NCCL, eager and captured, with every
# leaf DP_RANKS ranks would shard sent through them (bit for bit);
# (ii) DP_RANKS ranks sharing the card over gloo, spawned by this script,
# run DP_UPDATES updates of the global batch (host-fed, host-fed, gather,
# grad_accum 2) through the kernels, in float32 and in bf16, replicated and
# with ZeRO-1, against one process on the global batch; and one Trainer
# epoch each (rank 1 writes no file); (iii) an engine over [cuda:0, cuda:0]
# (two replicas on the card) against the one-card engine at DP_INFER_ROWS
# rows (ENGINE_TOL), and one `--devices 1` request through serve().
DP_K = 8
DP_STEPS = 16
DP_RANKS = 2
DP_UPDATES = 4
DP_INFER_ROWS = (BATCH, BATCH - 1)
# (ii)'s tolerance. The ranks' updates differ from one process's only in the
# order of the batch's sums, and Adam's first steps turn every gradient
# element that is no more than rounding noise into a whole +-lr step, so any
# change of order moves some weights by 2 lr. Its floor, measured in the
# run in each dtype: one process with the batch's two halves swapped against
# the same process in order. The DP weights must lie within DP_FLOOR_X times
# it (relative norm), the losses within TRAIN_TOL["loss_rtol"]
DP_FLOOR_X = 3.0


def _rank_shapes(shapes):
    """One rank's shapes of train-step shapes at DP_RANKS ranks: the rows split."""
    return sorted({(s[0] // DP_RANKS,) + tuple(s[1:]) for s, _ in shapes})


def _rows_of(draws, rows, lead: int = 0):
    """``draws`` of a global batch with its per-sample draws (those
    ``local_draws`` slices) taken in the order ``rows`` (None: as they are)."""
    if rows is None:
        return draws
    pick = lambda x: None if x is None else x[(slice(None),) * lead + (rows,)]  # noqa: E731
    aug = draws.augment._replace(flip=pick(draws.augment.flip), noise=pick(draws.augment.noise))
    return draws._replace(noise=pick(draws.noise), augment=aug, gp_eps=pick(draws.gp_eps))


def _dp_updates(cfg, state, dg, imgs, conds, sync, rows=None):
    """The DP_UPDATES updates phase (h) (ii) runs from ``state``, each on this
    rank's rows (all of them without ``dg``): two host-fed steps, one
    gather step and one accumulation step of two micro-pairs; the global
    batch's draws of each update, as the trainer makes them. ``rows``
    (one process only): every batch's rows, and their draws, in this
    order, which changes only the order of the batch's sums. Returns the
    losses of each update."""
    from littlegan_tpu_torch.parallel.train import local_draws, shard_local_batch
    from littlegan_tpu_torch.training import step as tstep

    if rows is not None:
        imgs, conds = imgs[:, rows], conds[:, rows]
    limgs, lconds = shard_local_batch(imgs, dg, 1), shard_local_batch(conds, dg, 1)

    def draws(u):  # update u's draws, this rank's rows
        one = tstep.map_draws(lambda x: x[0], _update_draws(cfg, u, 1, imgs.device))
        return local_draws(_rows_of(one, rows), dg)

    losses = []
    train = tstep.make_train_step(cfg, state, sync)
    for u in range(2):
        out = train(state, (limgs[2 * u], lconds[2 * u]), (limgs[2 * u + 1], lconds[2 * u + 1]), draws(u + 1), 11 + u)
        losses.append(_losses(out)[0])
    out = tstep.make_gather_train_step(cfg, state, sync=sync)(state, limgs, lconds, 4, 5, draws(3), 13)
    losses.append(_losses(out)[0])
    acfg = cfg.replace(grad_accum=2)
    pick = lambda ids: (limgs[list(ids)], lconds[list(ids)])  # noqa: E731
    out = tstep.make_accum_train_step(acfg, state, sync)(
        state, pick((6, 8)), pick((7, 9)), local_draws(_rows_of(_update_draws(acfg, 4, 2, imgs.device), rows, 1), dg, 1), 14)
    losses.append(_losses(out)[0])
    return losses


def dp_rank_main(rank: int, port: int, out_path: str) -> int:
    """One gloo rank of phase (h) (ii), on the one card: the DP updates
    from the seeded init in float32, and in bf16 replicated (its launches
    counted) and with ZeRO-1, the K-update graph refused under gloo, then
    one Trainer epoch in ``<out_path>.r<rank>``; writes its record."""
    import pickle

    import torch
    import torch.distributed as dist

    from littlegan_tpu_torch.data import SyntheticDataset
    from littlegan_tpu_torch.models.littlegan import init_params
    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.parallel.mesh import data_group
    from littlegan_tpu_torch.parallel.train import GradSync
    from littlegan_tpu_torch.parallel.zero import Zero1
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import make_scan_train_step
    from littlegan_tpu_torch.training.trainer import Trainer

    _build.lib()
    torch.backends.cudnn.allow_tf32 = False  # as in the one-process run it is held against
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=DP_RANKS, rank=rank)
    try:
        dg = data_group(dev)
        record = {}
        root = out_path + f".r{rank}"
        cfg = train_config(root).replace(exp_name="chip_smoke_dp_gloo")
        imgs, conds = _store(cfg, dev)
        counters = _counters(tuple(EXPECTED_TRAIN_LAUNCHES))
        for name, zero, dtype in (("f32", False, "float32"), ("replicated", False, "bfloat16"),
                                  ("zero1", True, "bfloat16")):
            run_cfg = cfg.replace(shard_opt_state=zero, compute_dtype=dtype)
            state = create_train_state(run_cfg, dev, init_params(cfg, cfg.seed))
            sync = Zero1(dg, state) if zero else GradSync(dg)
            for c in counters.values():
                c.reset()
            losses = _dp_updates(run_cfg, state, dg, imgs, conds, sync)
            torch.cuda.synchronize()
            record[name] = {"losses": losses, "weights": _flat_params(state.model).cpu(),
                            "launches": {k: c.value for k, c in counters.items()},
                            "reduced_bytes": sync.reduced_bytes}
            del state, sync
        state = create_train_state(cfg, dev, init_params(cfg, cfg.seed))
        try:  # gloo collectives cannot be captured: the K-update path must refuse, never run eagerly
            make_scan_train_step(cfg, state, DP_K, sync=GradSync(dg)).prepare(state, imgs, conds)
            record["graph_refused"] = None
        except RuntimeError as e:
            record["graph_refused"] = str(e)
        del state
        data = SyntheticDataset(cfg, num_items=4 * cfg.batch_size)
        tr = Trainer(cfg.replace(freq_gen=2, epoch=1), data, device=dev, group=dg)
        tr.train()
        record["trainer_files"] = sorted(os.path.relpath(os.path.join(d, f), root)
                                         for d, _, fs in os.walk(root) for f in fs)
        record["trainer_weights"] = _flat_params(tr.state.model).cpu()
        with open(out_path + f".{rank}.pkl", "wb") as f:
            pickle.dump(record, f)
    finally:
        dist.destroy_process_group()
    return 0


def check_dp_nccl(root, port: int):
    """Phase (h) (i). Returns (each kernel's launches in the DP run, the record)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from littlegan_tpu_torch.data import SyntheticDataset
    from littlegan_tpu_torch.parallel.mesh import data_group
    from littlegan_tpu_torch.training.trainer import Trainer
    from littlegan_tpu_torch.utils.tensorboard import read_scalars

    cfg = train_config(root).replace(device_data=True, steps_per_dispatch=DP_K, freq_gen=DP_STEPS,
                                     exp_name="chip_smoke_dp")
    pcfg = cfg.replace(exp_name="chip_smoke_dp_plain")
    data = SyntheticDataset(cfg, num_items=2 * DP_STEPS * cfg.batch_size)
    plain = Trainer(pcfg, data)  # before the group exists: no group
    require(plain.dp is None, "the plain trainer found a process group")
    plain.train()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        trainer = Trainer(cfg, data, group=data_group())
        require(trainer.dp is not None and trainer.dp.backend == "nccl", "no NCCL group")
        imgs, conds = trainer._ensure_device_store()
        t0 = time.time()
        trainer._scan_step(DP_K).prepare(trainer.state, imgs, conds)
        torch.cuda.synchronize()
        held = trainer._scan_steps[DP_K].graphed.launches
        want = {k: v * DP_K for k, v in EXPECTED_GRAPH_LAUNCHES.items()}
        require(held == want, f"the {DP_K}-update DP graph holds {held}, want {want}")
        log(f"DP graph of {DP_K} updates (NCCL all-reduce inside) captured in {time.time() - t0:.1f} s; "
            f"launches per replay {held}")
        counters = _counters(tuple(EXPECTED_TRAIN_LAUNCHES))
        for c in counters.values():
            c.reset()
        t0 = time.time()
        trainer.train()
        torch.cuda.synchronize()
        launches = {k: c.value for k, c in counters.items()}
        want = {k: v * DP_STEPS for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
        require(launches == want, f"NCCL DP run launches {launches}, want {want}")
        log(f"NCCL world-1 DP run: {DP_STEPS} updates in {DP_STEPS // DP_K} replays, {time.time() - t0:.1f} s, "
            f"launches {launches}")
        bitwise = _equal_state(trainer.state, plain.state)
        got, ref = (read_scalars(os.path.join(c.result_dir, "log")) for c in (cfg, pcfg))
        same_losses = got == ref
        log(f"NCCL world-1 DP vs no group: state bit for bit {bitwise}, logged losses equal {same_losses}")
        require(bitwise and same_losses, "the world-1 NCCL DP run differs from the run without a group")
        require(all(np.isfinite(v) for series in got.values() for _, v in series), "non-finite DP losses")
        reduced = trainer._sync.reduced_bytes
        timing = {"dp": _time_graph(trainer._scan_steps[DP_K], trainer.state, imgs, conds, cfg),
                  "plain": _time_graph(plain._scan_steps[DP_K], plain.state, *plain._ensure_device_store(), cfg)}
        log(f"graph update with the NCCL group vs without: {json.dumps(timing)}; all-reduced per update "
            f"{reduced} bytes")
        record = {"bitwise": bitwise, "reduced_bytes_per_update": reduced, "timing": timing,
                  "launches_per_replay": held}
        del trainer
        record["zero1"] = check_zero1_nccl(cfg, data_group())
    finally:
        dist.destroy_process_group()
    return launches, record


def check_zero1_nccl(cfg, dg):
    """Phase (h) (i), ZeRO-1 on NCCL. One rank shards nothing (no axis of a
    leaf is split by 1), so the moment axes are set to those of DP_RANKS
    ranks: every leaf they would shard goes through the reduce-scatter, the
    Adam update of its (here whole) shard and the all-gather, in the
    DP_UPDATES eager updates of (ii) and one DP_K-update CUDA graph replay,
    against the same updates without a group, bit for bit. Returns the
    record."""
    import numpy as np
    import torch

    from littlegan_tpu_torch.models.littlegan import init_params
    from littlegan_tpu_torch.parallel.zero import Zero1, moment_axis
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import make_scan_train_step

    imgs, conds = _store(cfg, dg.device)
    states = [create_train_state(cfg, dg.device, init_params(cfg, cfg.seed)) for _ in range(2)]
    zero = Zero1(dg, states[1])
    zero.axes = {k: moment_axis(shape, DP_RANKS) for k, shape in zero.shapes.items()}
    sharded = len(zero._sharded(zero.axes))
    require(sharded > 0, f"no moment leaf shards over {DP_RANKS} ranks")
    ids = np.arange(2 * DP_K) % imgs.shape[0]
    draws = _draws_k(cfg, 1 + DP_UPDATES, DP_K, dg.device)[0]
    losses = []
    for state, sync, group in ((states[0], None, None), (states[1], zero, dg)):
        losses.append(_dp_updates(cfg, state, group, imgs, conds, sync))
        scan = make_scan_train_step(cfg, state, DP_K, sync=sync)
        scan.prepare(state, imgs, conds)
        out = scan(state, imgs, conds, ids[0::2], ids[1::2], draws, 1 + DP_UPDATES)
        losses[-1] += _losses(out)
    torch.cuda.synchronize()
    bitwise = _equal_state(*states) and losses[0] == losses[1]
    log(f"ZeRO-1 over NCCL at world size 1 ({sharded} leaves through the reduce-scatter and all-gather, "
        f"{DP_UPDATES} eager updates and one {DP_K}-update graph replay) vs no group: bit for bit {bitwise}")
    require(bitwise, "ZeRO-1 over NCCL differs from the run without a group")
    return {"bitwise": bitwise, "sharded_leaves": sharded, "reduced_bytes_per_update": zero.reduced_bytes}


def check_dp_gloo(root, port: int):
    """Phase (h) (ii). Returns (the ranks' launches in their DP updates, the record)."""
    import pickle

    import torch

    from littlegan_tpu_torch.models.littlegan import init_params
    from littlegan_tpu_torch.training.state import create_train_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = train_config(os.path.join(root, "single")).replace(exp_name="chip_smoke_dp_single")
    imgs, conds = _store(cfg, dev)
    # dtype -> (losses, weights) of one process on the global batch, in its
    # row order and with its two halves swapped
    single, swapped = {}, {}
    halves = list(range(cfg.batch_size // 2, cfg.batch_size)) + list(range(cfg.batch_size // 2))
    for dtype in ("float32", "bfloat16"):
        for box, rows in ((single, None), (swapped, halves)):
            state = create_train_state(cfg.replace(compute_dtype=dtype), dev, init_params(cfg, cfg.seed))
            box[dtype] = (_dp_updates(cfg.replace(compute_dtype=dtype), state, None, imgs, conds, None, rows),
                          _flat_params(state.model).cpu())
            del state
    del imgs, conds
    torch.cuda.empty_cache()
    floor = {dtype: _rel_err(swapped[dtype][1], single[dtype][1]) for dtype in single}
    for dtype in single:
        log(f"one process, {DP_UPDATES} updates, {dtype}, the batch's halves swapped vs in order: "
            f"weights {floor[dtype]:.3g} (relative norm); {_lr_steps(swapped[dtype][1], single[dtype][1], cfg.lr)}")
    log(f"one process, bf16 vs float32: weights {_rel_err(single['bfloat16'][1], single['float32'][1]):.3g} "
        f"(relative norm); {_lr_steps(single['bfloat16'][1], single['float32'][1], cfg.lr)}")
    out = os.path.join(root, "gloo")
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    env.pop("LOCAL_RANK", None)
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", str(r), str(port), out],
                              env=env) for r in range(DP_RANKS)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(codes == [0] * DP_RANKS, f"gloo ranks exited {codes}")
    recs = []
    for r in range(DP_RANKS):
        with open(out + f".{r}.pkl", "rb") as f:
            recs.append(pickle.load(f))
    log(f"{DP_RANKS} gloo ranks on one card ran in {time.time() - t0:.1f} s")
    rep = recs[0]["replicated"]
    require(all(r[k]["losses"] == recs[0][k]["losses"] for r in recs for k in ("f32", "replicated")),
            f"the ranks' losses differ: {[r['replicated']['losses'] for r in recs]}")
    record = {"order_floor": floor}
    for key, dtype in (("f32", "float32"), ("replicated", "bfloat16")):
        run = recs[0][key]
        log(f"{DP_RANKS} gloo ranks vs one process, {dtype}: "
            f"{_lr_steps(run['weights'], single[dtype][1], cfg.lr)}")
        record[f"vs_single_{dtype}"] = _hold(
            f"{DP_RANKS} gloo ranks vs one process, {DP_UPDATES} updates, {dtype}", run["losses"],
            single[dtype][0], [run["weights"]], [single[dtype][1]],
            tol=(TRAIN_TOL["loss_rtol"], DP_FLOOR_X * floor[dtype]))
    z = recs[0]["zero1"]
    zero_rel = _rel_err(z["weights"], rep["weights"])
    zero_bitwise = bool(torch.equal(z["weights"], rep["weights"])) and z["losses"] == rep["losses"]
    log(f"ZeRO-1 vs replicated DP: weights {zero_rel:.3g} (relative norm), bitwise {zero_bitwise}; "
        f"reduced per update {z['reduced_bytes']} vs {rep['reduced_bytes']} bytes")
    require(bool(torch.allclose(z["weights"], rep["weights"], rtol=2e-4, atol=2e-5)), "ZeRO-1 != replicated DP")
    refused = [r["graph_refused"] for r in recs]
    require(all(m is not None and "cannot be captured" in m for m in refused),
            f"the K-update path under gloo on the card did not refuse: {refused}")
    log(f"K-update graph under gloo on the card refused on every rank: {refused[0]}")
    files = [r["trainer_files"] for r in recs]
    require(files[1] == [] and any(f.endswith("ckpt-1.npz") for f in files[0]),
            f"rank 0 wrote {len(files[0])} files, rank 1 {files[1]}")
    require(torch.equal(recs[0]["trainer_weights"], recs[1]["trainer_weights"]), "the ranks' trainer weights differ")
    log(f"gloo Trainer epoch: rank 0 wrote {len(files[0])} files, rank 1 none; the ranks' weights equal")
    launches = {k: sum(r["replicated"]["launches"][k] for r in recs) for k in rep["launches"]}
    want_l = {k: v * (DP_UPDATES + 1) * DP_RANKS for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
    require(launches == want_l, f"gloo DP launches {launches}, want {want_l}")
    record.update(zero_rel=zero_rel, zero_bitwise=zero_bitwise, rank_launches=launches)
    return launches, record


def check_dp_infer(root):
    """Phase (h) (iii). Returns (each kernel's launches in the two-replica
    engine's calls, the record)."""
    import threading

    import numpy as np
    import torch

    from littlegan_tpu_torch.serving import InferenceEngine, serve

    cfg = full_config()
    one = InferenceEngine(cfg, batch_size=BATCH)
    two = InferenceEngine(cfg, batch_size=BATCH, devices=["cuda:0", "cuda:0"])
    rng = np.random.default_rng(5)
    counters = _counters()
    errs, launches, bitwise = {}, {k: 0 for k in counters}, True
    for rows in DP_INFER_ROWS:
        noise = rng.normal(size=(rows, cfg.noise_dim)).astype(np.float32)
        cond = np.where(rng.random((rows, cfg.cond_dim)) < 0.5, 0.98, -0.94).astype(np.float32)
        image = rng.uniform(-1, 1, (rows, cfg.image_dim, cfg.image_dim, 3)).astype(np.float32)
        outs = {}
        for name, eng in (("one", one), ("two", two)):
            for c in counters.values():
                c.reset()
            outs[name] = [eng.generate(cond, noise), eng.adjust(image, cond), *eng.discriminate(image).values()]
            if name == "two":
                launches = {k: launches[k] + c.value for k, c in counters.items()}
        for i, (a, b) in enumerate(zip(outs["two"], outs["one"])):
            d = np.abs(a - b)
            errs[f"{rows}:{i}"] = (float(d.max()), float(d.mean()))
            bitwise &= bool((a == b).all())
            lim = ENGINE_TOL["image_max"] if i < 2 else ENGINE_TOL["prob_max"]
            require(a.shape == b.shape and d.max() <= lim and (i >= 2 or d.mean() <= ENGINE_TOL["image_mean"]),
                    f"two replicas vs one card, {rows} rows, output {i}: max {d.max()}, mean {d.mean()}")
    log(f"engine over [cuda:0, cuda:0] vs one card at {DP_INFER_ROWS} rows: bitwise {bitwise}; "
        f"(max, mean) abs diff {errs}")
    started, box = threading.Event(), {}

    def on_start(server):
        box["server"] = server
        started.set()

    thread = threading.Thread(target=serve, args=(cfg,), daemon=True, kwargs=dict(
        host="127.0.0.1", port=0, batch_size=BATCH, max_wait_ms=0.0, devices=1, on_start=on_start))
    thread.start()
    require(started.wait(120), "serve(devices=1) did not start")
    try:
        status, body = _http(f"http://127.0.0.1:{box['server'].server_address[1]}/generate",
                             {"cond": [[0.98] * cfg.cond_dim], "seed": 0})
        require(status == 200 and len(json.loads(body)["images"]) == 1, body[:200])
    finally:
        box["server"].shutdown()
        thread.join(60)
    log("serve(devices=1): one /generate request answered")
    del one, two
    torch.cuda.empty_cache()
    return launches, {"max_mean_abs": errs, "bitwise": bitwise}


def check_rank_shapes():
    """The kernels against their plain versions at one DP rank's shapes
    (the train step's rows split over DP_RANKS), bf16, with phase (b)'s
    tolerances; K2 leaves out the elements at LeakyReLU's kink as (b) does."""
    import torch

    from littlegan_tpu_torch.ops.cuda import boundary_conv as bc
    from littlegan_tpu_torch.ops.cuda import norm_lrelu as nl

    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    gamma, beta = torch.tensor([1.3], device=dev), torch.tensor([-0.2], device=dev)
    atol, rtol = TOL["bfloat16"]
    batol, brtol = BWD_TOL["bfloat16"]
    errs, failures = {}, []
    for shape in _rank_shapes(K1_STEP):
        x = (torch.randn(shape, device=dev, generator=gen) * 2.0 + 0.5).to(dt)
        got = nl.fused_instance_norm_lrelu(x, gamma, beta, 0.3)
        want = nl.fused_instance_norm_lrelu_plain(x, gamma, beta, 0.3)
        errs[f"K1 {shape}"] = _max_err(got, want)
        if not _within(got, want, atol, rtol):
            failures.append(f"K1 {shape}")
    for shape in _rank_shapes(K2_STEP):
        x = (torch.randn(shape, device=dev, generator=gen) * 2.0 + 0.5).to(dt)
        dy = torch.randn(shape, device=dev, generator=gen).to(dt)
        got = nl.fused_instance_norm_lrelu_bwd(x, dy, gamma, beta, 0.3, 1e-3)
        want = nl.fused_instance_norm_lrelu_bwd_plain(x, dy, gamma, beta, 0.3)
        xf = x.float()
        nrm = (xf - xf.mean((1, 2, 3), keepdim=True)) / (xf.var((1, 2, 3), unbiased=False, keepdim=True).sqrt() + 1e-3)
        away = (nrm * gamma + beta).abs() > KINK
        errs[f"K2 {shape}"] = _max_err(got[0][away], want[0][away])
        if not _within(got[0][away], want[0][away], batol, brtol):
            failures.append(f"K2 {shape}")
    for xshape in _rank_shapes(K3_STEP + BLOCK1_STEP):
        x = torch.randn(xshape, device=dev, generator=gen).to(dt)
        w = (torch.randn((3, 3, xshape[3], 64), device=dev, generator=gen) * 0.2).to(dt)
        b = (torch.randn((64,), device=dev, generator=gen) * 0.1).to(dt)
        y, s1, s2 = bc.conv3x3_same_stats(x, w, b)
        py, _, _ = bc.conv3x3_same_stats_plain(x, w, b)
        errs[f"K3 {xshape}"] = _max_err(y, py)
        if not _within(y, py, atol, rtol):
            failures.append(f"K3 {xshape}")
        got = nl.norm_lrelu_from_stats(y, s1, s2, gamma, beta, 0.3)
        want = nl.norm_lrelu_from_stats_plain(y, s1, s2, gamma, beta, 0.3)
        errs[f"K1' {xshape}"] = _max_err(got, want)
        if not _within(got, want, atol, rtol):
            failures.append(f"K1' {xshape}")
        gy = torch.randn(y.shape, device=dev, generator=gen).to(dt)
        gs1 = torch.randn((xshape[0],), device=dev, generator=gen) * 1e-3
        gs2 = torch.randn((xshape[0],), device=dev, generator=gen) * 1e-4
        fy, fdb = bc.conv3x3_bwd_fold(y, gy, gs1, gs2)
        py, pdb = bc.conv3x3_bwd_fold_plain(y, gy, gs1, gs2)
        errs[f"K3 fold {xshape}"] = _max_err(fy, py)
        if not _within(fy, py, batol, brtol):
            failures.append(f"K3 fold {xshape}")
        yf = y.float()
        s1, s2 = yf.sum((1, 2, 3)), yf.square().sum((1, 2, 3))
        dout = torch.randn(y.shape, device=dev, generator=gen).to(dt)
        got = nl.norm_lrelu_from_stats_bwd(y, s1, s2, gamma, beta, dout, 0.3)
        want = nl.norm_lrelu_from_stats_bwd_plain(y, s1, s2, gamma, beta, dout, 0.3)
        mean = (s1 / yf[0].numel()).reshape(-1, 1, 1, 1)
        std = (s2 / yf[0].numel()).reshape(-1, 1, 1, 1) - mean.square()
        away = (((yf - mean) / (std.clamp_min(0).sqrt() + 1e-3)) * gamma + beta).abs() > KINK
        errs[f"K1' bwd {xshape}"] = _max_err(got[0][away], want[0][away])
        if not _within(got[0][away], want[0][away], batol, brtol):
            failures.append(f"K1' bwd {xshape}")
    torch.cuda.synchronize()
    log("kernels vs plain at one DP rank's shapes (bf16): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    if failures:
        raise AssertionError("kernel/plain mismatch at the DP rank's shapes: " + ", ".join(failures))
    return errs


def check_data_parallel():
    """Phase (h). Returns (each kernel's launches in (h)'s main paths, the record)."""
    import tempfile

    record, walls = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as root:
        t0 = time.time()
        record["rank_shapes"] = check_rank_shapes()
        walls["rank_shapes"], t0 = time.time() - t0, time.time()
        nccl_launches, record["nccl"] = check_dp_nccl(root, _free_port())
        walls["nccl"], t0 = time.time() - t0, time.time()
        gloo_launches, record["gloo"] = check_dp_gloo(root, _free_port())
        walls["gloo"], t0 = time.time() - t0, time.time()
        infer_launches, record["infer"] = check_dp_infer(root)
        walls["infer"] = time.time() - t0
    log("phase (h) walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    launches = {k: nccl_launches.get(k, 0) + gloo_launches.get(k, 0) + infer_launches.get(k, 0)
                for k in set(nccl_launches) | set(gloo_launches) | set(infer_launches)}
    return launches, record


# phase (i): compat (ROADMAP A12) at full width. A state trained COMPAT_STEPS
# updates (adam_tf_parity: one apply count per optimizer, v1's shared beta
# powers, so the reference format holds the state exactly) goes through the
# reference-checkpoint mapping and back on the card; the converter's npz
# writer stores it, and COMPAT_RESUMED updates resumed from it must match the
# same updates resumed from the unconverted state (losses to
# TRAIN_TOL["loss_rtol"]). The card's host has no TensorFlow: the SavedModel
# export and the TF read and write of reference checkpoints run in
# tests/test_torch_compat.py on a CPU host; here runs the numpy mapping both
# ways, which is all of the conversion but the file format. Then the three
# torch.export programs at PT2_BATCHES against the f32 plain-op forward with
# TF32 off, within PT2_TOL (rtol, atol: tests/test_savedmodel.py's
# same-package f32 bound), and the reloaded generate timed beside the engine.
COMPAT_STEPS = 3
COMPAT_RESUMED = 2
PT2_BATCHES = (1, 7, 8)
PT2_TOL = (1e-5, 1e-5)


def _same_state(a, b) -> bool:
    """Weights and moments bit for bit, and the same apply counts."""
    from littlegan_tpu_torch.training.step import state_tensors

    ta, tb = state_tensors(a), state_tensors(b)
    counts = all(getattr(a, o).count == getattr(b, o).count for o in ("opt_g", "opt_d", "opt_a"))
    return counts and len(ta) == len(tb) and _equal_state(a, b)


def _resume(cfg, data):
    """A Trainer for ``cfg`` restored from its checkpoint, trained through
    ``cfg.epoch``. Returns (each kernel's launches, the logged (gen, disc)
    losses per update)."""
    import numpy as np
    import torch

    from littlegan_tpu_torch.training.trainer import Trainer
    from littlegan_tpu_torch.utils.tensorboard import read_scalars

    trainer = Trainer(cfg, data)
    require((trainer.global_epoch, trainer.global_step) == (2, COMPAT_STEPS),
            ("restored at", trainer.global_epoch, trainer.global_step))
    counters = _counters(tuple(EXPECTED_TRAIN_LAUNCHES))
    for c in counters.values():
        c.reset()
    trainer.train()
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counters.items()}
    want = {k: v * COMPAT_RESUMED for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
    require(launches == want, f"resumed-run launches {launches}, want {want}")
    scalars = read_scalars(os.path.join(cfg.result_dir, "log"))
    losses = [(g, d) for (_, g), (_, d) in zip(scalars["loss/gen"], scalars["loss/disc"])]
    require(len(losses) == COMPAT_RESUMED and all(np.isfinite(losses).ravel()), f"resumed losses {scalars}")
    return launches, losses


def check_compat():
    """Phase (i). Returns (each kernel's launches in the two resumed runs,
    the record)."""
    import tempfile

    import numpy as np
    import torch

    from littlegan_tpu_torch.compat import reference_checkpoint as ref
    from littlegan_tpu_torch.compat import torch_export as te
    from littlegan_tpu_torch.compat.jax_params import jax_key
    from littlegan_tpu_torch.data import SyntheticDataset
    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.serving import InferenceEngine
    from littlegan_tpu_torch.training.checkpoint import Checkpointer, to_numpy
    from littlegan_tpu_torch.training.state import eval_params
    from littlegan_tpu_torch.training.trainer import Trainer

    record = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_compat_") as root:
        cfg = train_config(root).replace(adam_tf_parity=True, exp_name="chip_smoke_compat")
        trainer = Trainer(cfg, SyntheticDataset(cfg, num_items=2 * COMPAT_STEPS * cfg.batch_size))
        trainer.train()
        require(trainer.global_step == COMPAT_STEPS, trainer.global_step)
        t0 = time.time()
        variables, report = ref.state_to_variables(trainer.state, cfg.beta_1, cfg.beta_2)
        conv, inferred, back = ref.variables_to_train_state(variables, cfg.beta_1, cfg.beta_2, device="cuda")
        torch.cuda.synchronize()
        record["convert_s"] = time.time() - t0
        require(back == report, (report, back))
        require((inferred["image_dim"], inferred["conv_filter"]) == (cfg.image_dim, cfg.conv_filter), inferred)
        bitwise = _same_state(conv, trainer.state)
        require(bitwise, "state_to_variables -> variables_to_train_state changed the state")
        log(f"phase (i): {len(variables)} reference variables, counts {report}; the state converted there and "
            f"back on the card in {record['convert_s']:.2f} s, bit for bit")

        # the converted state through the converter's writer, the trained one through the same Checkpointer
        status = {"epoch": 2, "step": trainer.global_step}
        cfgs = {name: cfg.replace(epoch=2, all_result_dir=os.path.join(root, name)) for name in ("converted", "unconverted")}
        ref.save_converted(conv, back, os.path.join(cfgs["converted"].result_dir, "checkpoint"), "1", "state_to_variables")
        Checkpointer(os.path.join(cfgs["unconverted"].result_dir, "checkpoint")).save("1", trainer.state, status)
        del trainer
        data = SyntheticDataset(cfg, num_items=2 * COMPAT_RESUMED * cfg.batch_size)
        launches, losses = {}, {}
        for name, c in cfgs.items():
            got, losses[name] = _resume(c, data)
            launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        rel = max(abs(a - b) / max(abs(b), 1e-12) for la, lb in zip(losses["converted"], losses["unconverted"])
                  for a, b in zip(la, lb))
        log(f"resumed {COMPAT_RESUMED} updates (bf16, kernels): (gen, disc) losses converted "
            f"{losses['converted']}, unconverted {losses['unconverted']}; largest relative difference {rel:.3g} "
            f"(tolerance {TRAIN_TOL['loss_rtol']})")
        require(rel <= TRAIN_TOL["loss_rtol"], f"the resumed runs disagree: {rel}")
        record.update(resumed_losses=losses, resumed_loss_rel=rel, resumed_launches=launches)

        # torch.export of the converted weights on the card, against the f32 plain-op forward
        params = eval_params(conv)
        out_dir = os.path.join(root, "torch_export")
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            t0 = time.time()
            te.export_torch(cfg, params, out_dir, device="cuda")
            record["export_s"] = time.time() - t0
            progs = {n: torch.export.load(os.path.join(out_dir, f"{n}.pt2")).module() for n in te.ENTRY_POINTS}
            eager = te.export_model(cfg, params, "cuda")
            rng = np.random.default_rng(3)
            errs = {}
            for b in PT2_BATCHES:
                z = torch.from_numpy(rng.normal(size=(b, cfg.noise_dim)).astype(np.float32)).cuda()
                c = torch.from_numpy(rng.uniform(-1, 1, (b, cfg.cond_dim)).astype(np.float32)).cuda()
                x = torch.from_numpy(rng.uniform(-1, 1, (b, 128, 128, 3)).astype(np.float32)).cuda()
                with torch.no_grad(), _build.plain_versions():
                    pr, cd = eager.discriminator(x)
                    want = {"generate": eager.generator(z, c), "adjust": eager.adjuster(x, c), "pr": pr, "cond": cd}
                    d = progs["discriminate"](x)
                    got = {"generate": progs["generate"](z, c), "adjust": progs["adjust"](x, c),
                           "pr": d["pr"], "cond": d["cond"]}
                for k, w in want.items():
                    require(got[k].shape == w.shape and got[k].dtype == torch.float32, (b, k, got[k].shape))
                    require(_within(got[k], w, PT2_TOL[1], PT2_TOL[0]), f".pt2 {k} at batch {b}: {_max_err(got[k], w)}")
                    errs[f"{k}@{b}"] = _max_err(got[k], w)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        sizes = {n: os.path.getsize(os.path.join(out_dir, f"{n}.pt2")) for n in te.ENTRY_POINTS}
        log(f"torch.export: 3 programs in {record['export_s']:.1f} s ({sizes} bytes); reloaded vs the f32 "
            f"plain-op forward (TF32 off) at batches {PT2_BATCHES}: largest error {max(errs.values()):.3g} "
            f"(bound rtol {PT2_TOL[0]}, atol {PT2_TOL[1]})")
        record.update(pt2_max_err=errs, pt2_bytes=sizes)

        # the reloaded generate beside the engine (bf16, the kernels) at batch 8, host arrays in and out
        z8 = rng.normal(size=(BATCH, cfg.noise_dim)).astype(np.float32)
        c8 = rng.uniform(-1, 1, (BATCH, cfg.cond_dim)).astype(np.float32)
        engine = InferenceEngine(full_config(), params={jax_key(n): to_numpy(p) for n, p in params.items()},
                                 batch_size=BATCH)
        calls = {"pt2_generate": lambda: progs["generate"](torch.from_numpy(z8).cuda(), torch.from_numpy(c8).cuda()).cpu(),
                 "engine_generate": lambda: engine.generate(c8, z8)}
        times = {}
        for name, fn in calls.items():
            with torch.no_grad():
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t) * 1e3 / 20
        zd, cd8 = torch.from_numpy(z8).cuda(), torch.from_numpy(c8).cuda()
        with torch.no_grad():
            times["pt2_generate_device"] = eager_ms(lambda: progs["generate"](zd, cd8), reps=20)
        log(f"batch {BATCH} generate, host wall per call: reloaded .pt2 (f32, plain ops) "
            f"{times['pt2_generate']:.3f} ms (device tensors in/out: {times['pt2_generate_device']:.3f} ms); "
            f"InferenceEngine (bf16, kernels) {times['engine_generate']:.3f} ms ({nvidia_smi_line()})")
        record["generate_ms"] = times
    return launches, record


# phase (j): the spatial ('data', 'model') mesh (littlegan_tpu_torch/parallel/
# spatial.py) at full width: 128², Config() widths, batch 32, s2d on (block
# height 64 tiles the model axis). SP_RANKS gloo ranks share the card as a
# [1, SP_RANKS] mesh, spawned by this script (--sp-rank), each on its
# 128 / SP_RANKS image rows: (i) the DP_UPDATES updates of phase (h) (ii)
# (host-fed, host-fed, gather, grad_accum 2) in float32 and bf16, replicated
# and with ZeRO-1 (over both ranks), on the plain ops as the model runs
# under a mesh (no kernel may launch on a rank), against one process on the
# plain ops (_build.plain_versions()) on the same global batches and draws: the losses to
# TRAIN_TOL["loss_rtol"], the weights to DP_FLOOR_X times the gap that
# swapping the batch's halves makes in that process; the K-update graph
# refused under gloo; (ii) the same with shard_dense (bf16, replicated and
# ZeRO-1), then that state through rank 0's npz: gathered, written, read
# into a fresh whole state on rank 0, broadcast and sliced again, bit for
# bit the live parts; (iii) one host-fed Trainer epoch of SP_EPOCH_BATCHES
# batches over the mesh (rank 1 writes nothing), each rank's peak
# max_memory_allocated beside one process's epoch on the plain ops
# (each above what its process held before the epoch).
SP_RANKS = 2
SP_EPOCH_BATCHES = 4
SP_RUNS = (("f32", "float32", False, False), ("replicated", "bfloat16", False, False),
           ("zero1", "bfloat16", True, False), ("dense", "bfloat16", False, True),
           ("dense_zero1", "bfloat16", True, True))  # name, dtype, shard_opt_state, shard_dense


def _sp_config(root):
    """Phase (j)'s configuration: ``train_config``'s (the model takes its
    plain route under a mesh)."""
    return train_config(root).replace(exp_name="chip_smoke_spatial")


def sp_rank_main(rank: int, port: int, out_path: str) -> int:
    """One gloo rank of phase (j) on the one card: the runs of SP_RUNS, the
    npz round trip, the K-update refusal, a Trainer epoch; writes its
    record."""
    import pickle

    import torch
    import torch.distributed as dist

    from littlegan_tpu_torch.data import SyntheticDataset
    from littlegan_tpu_torch.models.littlegan import init_params
    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.parallel.mesh import data_group, spatial_group
    from littlegan_tpu_torch.parallel.train import GradSync, replicate_state
    from littlegan_tpu_torch.parallel.zero import Zero1, shard_dense_state
    from littlegan_tpu_torch.training.checkpoint import Checkpointer
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import make_scan_train_step
    from littlegan_tpu_torch.training.trainer import Trainer

    _build.lib()
    torch.backends.cudnn.allow_tf32 = False  # as in the one-process run it is held against
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=SP_RANKS, rank=rank)
    try:
        sg = spatial_group(data_group(dev), (1, SP_RANKS))
        root = out_path + f".r{rank}"
        cfg = _sp_config(root)
        imgs, conds = _store(cfg, dev)
        counters = _counters(tuple(EXPECTED_TRAIN_LAUNCHES))
        for c in counters.values():
            c.reset()
        record = {}
        for name, dtype, zero, dense in SP_RUNS:
            run_cfg = cfg.replace(compute_dtype=dtype, shard_opt_state=zero, shard_dense=dense)
            state = create_train_state(run_cfg, dev, init_params(cfg, cfg.seed))
            if dense:
                shard_dense_state(state, sg)
            sync = Zero1(sg, state, dense) if zero else GradSync(sg, dense)
            torch.cuda.synchronize()
            t0 = time.time()
            losses = _dp_updates(run_cfg, state, sg, imgs, conds, sync)
            torch.cuda.synchronize()
            wall = time.time() - t0
            full = sync.full_state(state)
            record[name] = {"losses": losses, "weights": _flat_params(full.model).cpu(), "wall_s": wall,
                            "reduced_bytes": sync.reduced_bytes,
                            "dense_shape": tuple(state.model.g_head.dense.kernel.shape)}
            if name == "dense_zero1":  # the state through rank 0's npz and back into the parts
                ckpt = Checkpointer(out_path + ".npz_dir")
                if rank == 0:
                    os.makedirs(ckpt.directory, exist_ok=True)
                    ckpt.save("1", full, {"epoch": 2})
                dist.barrier(group=sg.control)
                fresh = create_train_state(run_cfg, dev, init_params(cfg, cfg.seed + 1))
                if rank == 0:
                    ckpt.restore("1", fresh)
                replicate_state(fresh, sg)
                shard_dense_state(fresh, sg)
                Zero1(sg, fresh, True)
                record["npz_round_trip"] = _equal_state(fresh, state) and all(
                    getattr(fresh, o).count == getattr(state, o).count for o in ("opt_g", "opt_d", "opt_a"))
                del fresh
            del state, sync, full
        torch.cuda.synchronize()
        record["launches"] = {k: c.value for k, c in counters.items()}
        state = create_train_state(cfg, dev, init_params(cfg, cfg.seed))
        try:  # gloo collectives cannot be captured: the K-update path must refuse, never run eagerly
            make_scan_train_step(cfg, state, DP_K, sync=GradSync(sg)).prepare(state, imgs, conds)
            record["graph_refused"] = None
        except RuntimeError as e:
            record["graph_refused"] = str(e)
        del state, imgs, conds
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        data = SyntheticDataset(cfg, num_items=SP_EPOCH_BATCHES * cfg.batch_size)
        tr = Trainer(cfg.replace(mesh_axes=["data", "model"], freq_gen=2, epoch=1), data, device=dev,
                     group=data_group(dev))
        t0 = time.time()
        tr.train()
        torch.cuda.synchronize()
        record["trainer_wall_s"] = time.time() - t0
        record["trainer_peak_mb"] = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
        record["trainer_files"] = sorted(os.path.relpath(os.path.join(d, f), root)
                                         for d, _, fs in os.walk(root) for f in fs)
        record["trainer_weights"] = _flat_params(tr.state.model).cpu()
        with open(out_path + f".{rank}.pkl", "wb") as f:
            pickle.dump(record, f)
    finally:
        dist.destroy_process_group()
    return 0


def check_spatial():
    """Phase (j). Returns (each kernel's launches on the ranks: 0, the record)."""
    import pickle
    import tempfile

    import torch

    from littlegan_tpu_torch.data import SyntheticDataset
    from littlegan_tpu_torch.models.littlegan import init_params
    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_") as root:
        with _build.plain_versions():  # the one-process reference on the plain ops, as the mesh runs them
            cfg = _sp_config(os.path.join(root, "single"))
            imgs, conds = _store(cfg, dev)
            single, swapped = {}, {}
            halves = list(range(cfg.batch_size // 2, cfg.batch_size)) + list(range(cfg.batch_size // 2))
            for dtype in ("float32", "bfloat16"):
                for box, rows in ((single, None), (swapped, halves)):
                    run_cfg = cfg.replace(compute_dtype=dtype)
                    state = create_train_state(run_cfg, dev, init_params(cfg, cfg.seed))
                    losses = _dp_updates(run_cfg, state, None, imgs, conds, None, rows)
                    box[dtype] = (losses, _flat_params(state.model).cpu())
                    del state
            del imgs, conds
            floor = {dtype: _rel_err(swapped[dtype][1], single[dtype][1]) for dtype in single}
            for dtype in single:
                log(f"(j) one process, plain ops, {DP_UPDATES} updates, {dtype}, the batch's halves swapped vs "
                    f"in order: weights {floor[dtype]:.3g} (relative norm); "
                    f"{_lr_steps(swapped[dtype][1], single[dtype][1], cfg.lr)}")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)  # what earlier phases still hold
            data = SyntheticDataset(cfg, num_items=SP_EPOCH_BATCHES * cfg.batch_size)
            one = Trainer(cfg.replace(freq_gen=2, epoch=1), data, device=dev)
            t0 = time.time()
            one.train()
            torch.cuda.synchronize()
            one_wall, one_peak = time.time() - t0, (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
            del one
            torch.cuda.empty_cache()
        out = os.path.join(root, "sp")
        env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        env.pop("LOCAL_RANK", None)
        port = _free_port()
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sp-rank", str(r), str(port), out],
                                  env=env) for r in range(SP_RANKS)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        require(codes == [0] * SP_RANKS, f"spatial gloo ranks exited {codes}")
        recs = []
        for r in range(SP_RANKS):
            with open(out + f".{r}.pkl", "rb") as f:
                recs.append(pickle.load(f))
        ranks_wall = time.time() - t0
    log(f"(j) {SP_RANKS} gloo ranks of a [1, {SP_RANKS}] mesh on one card ran in {ranks_wall:.1f} s")
    record = {"order_floor": floor}
    for name, dtype, _, _ in SP_RUNS:
        run = recs[0][name]
        require(all(r[name]["losses"] == run["losses"] and torch.equal(r[name]["weights"], run["weights"])
                    for r in recs), f"the spatial ranks differ in {name}")
        log(f"(j) spatial {name} vs one process, {dtype}: {_lr_steps(run['weights'], single[dtype][1], cfg.lr)}; "
            f"{DP_UPDATES} updates in {run['wall_s']:.2f} s on rank 0 (gloo through the host), "
            f"{run['reduced_bytes']} bytes reduced per update, g_head kernel {run['dense_shape']} on a rank")
        record[name] = _hold(f"(j) [1, {SP_RANKS}] mesh, {name}, vs one process, {DP_UPDATES} updates, {dtype}",
                             run["losses"], single[dtype][0], [run["weights"]], [single[dtype][1]],
                             tol=(TRAIN_TOL["loss_rtol"], DP_FLOOR_X * floor[dtype]))
    rep = recs[0]["replicated"]
    for name in ("zero1", "dense", "dense_zero1"):  # the same sums in another layout: bit for bit expected
        run = recs[0][name]
        same = bool(torch.equal(run["weights"], rep["weights"])) and run["losses"] == rep["losses"]
        log(f"(j) {name} vs replicated under the mesh: weights {_rel_err(run['weights'], rep['weights']):.3g} "
            f"(relative norm), bitwise {same}")
        record[name]["vs_replicated_bitwise"] = same
        require(bool(torch.allclose(run["weights"], rep["weights"], rtol=2e-4, atol=2e-5)), f"{name} != replicated")
    require(recs[0]["dense"]["dense_shape"][1] * SP_RANKS == recs[0]["f32"]["dense_shape"][1],
            "shard_dense left the g_head kernel whole")
    require(all(r["npz_round_trip"] for r in recs), "the shard_dense state did not come back from rank 0's npz")
    log("(j) shard_dense + ZeRO-1 state -> rank 0's npz -> whole state -> parts: bit for bit on every rank")
    launches = {k: sum(r["launches"][k] for r in recs) for k in recs[0]["launches"]}
    require(all(v == 0 for v in launches.values()), f"a kernel launched under the spatial mesh: {launches}")
    refused = [r["graph_refused"] for r in recs]
    require(all(m is not None and "cannot be captured" in m for m in refused),
            f"the spatial K-update path under gloo did not refuse: {refused}")
    files = [r["trainer_files"] for r in recs]
    require(files[1] == [] and any(f.endswith("ckpt-1.npz") for f in files[0]),
            f"spatial Trainer: rank 0 wrote {len(files[0])} files, rank 1 {files[1]}")
    require(torch.equal(recs[0]["trainer_weights"], recs[1]["trainer_weights"]), "the ranks' trainer weights differ")
    peaks = [r["trainer_peak_mb"] for r in recs]
    log(f"(j) Trainer epoch of {SP_EPOCH_BATCHES} batches over the mesh: rank 0 wrote {len(files[0])} files, rank 1 "
        f"none; peak max_memory_allocated above what the process held before the epoch, per rank "
        f"{[round(p, 1) for p in peaks]} MiB vs one process {one_peak:.1f} MiB (plain ops); "
        f"wall {recs[0]['trainer_wall_s']:.1f} s vs {one_wall:.1f} s")
    record.update(launches=launches, trainer_peak_mb=peaks, one_process_peak_mb=one_peak,
                  trainer_wall_s=recs[0]["trainer_wall_s"], one_process_wall_s=one_wall, ranks_wall_s=ranks_wall)
    log(f"phase (j) wall: {time.time() - t_phase:.1f} s")
    return launches, record


PARITY_BATCHES = 16  # one epoch: 8 updates, one K = 8 replay
PARITY_K = 8
C2_RANKS = 2
C2_BATCHES = 4  # of the store each rank builds
CONDITIONING_IMAGES = 64  # one engine batch of the conditioning check


def _parity_config(root, backend):
    """Phase (k)'s run: ``train_config``'s full width over the card store,
    K = 8 updates per replay, two epochs, on ``backend``."""
    return train_config(root).replace(
        exp_name="chip_smoke_parity", device_data=True, steps_per_dispatch=PARITY_K, epoch=2, freq_gen=0,
        extra={"checkpoint_backend": backend})


def _timed(trainer, box):
    """The host wall of each call of the trainer's checkpointer ``save``
    and ``wait`` into ``box``: a save's own time without the wait for the
    save before it, which it makes first (listed under "wait")."""
    ck = trainer.checkpointer
    waits = box.setdefault("wait", [])
    for name in ("save", "wait"):
        fn = getattr(ck, name)

        def timed(*a, _fn=fn, _name=name, **k):
            n = len(waits)
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            box.setdefault(_name, []).append(time.perf_counter() - t0 - sum(waits[n:]))
            return out

        setattr(ck, name, timed)


def _parity_run(cfg, data, box=None):
    """A Trainer of ``cfg`` trained to its last epoch; (its state flat, the
    launches, the checkpointer's save/wait times)."""
    import torch

    from littlegan_tpu_torch.training.checkpoint import flatten_state
    from littlegan_tpu_torch.training.trainer import Trainer

    counters = _counters(tuple(EXPECTED_TRAIN_LAUNCHES))
    for c in counters.values():
        c.reset()
    tr = Trainer(cfg, data)
    times = {}
    _timed(tr, times)
    tr.train()
    torch.cuda.synchronize()
    flat = {k: v.copy() for k, v in flatten_state(tr.state).items()}
    return flat, {k: c.value for k, c in counters.items()}, times, tr.global_epoch


def _structured_jpegs(root, n, dim, attrs, seed=0):
    """A CelebA-shaped tree of ``n`` JPEGs in which each attribute bit
    brightens the region the conditioning check's ``stat`` reads, with its
    attribute file (the attributes ``attrs`` set, the others -1)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    d = dim
    regions = [(slice(None), slice(None), [0]), (slice(None), slice(d // 4, d // 2), [1]),
               (slice(d // 2, None), slice(None), [2]), (slice(d // 3, 2 * d // 3), slice(d // 3, 2 * d // 3), None),
               (slice(d // 8, d // 4), slice(None), None), (slice(0, d // 4), slice(0, d // 4), None)]
    lines = [str(n), " ".join(f"A{i}" for i in range(40))]
    for i in range(n):
        bits = np.where(rng.random(len(attrs)) < 0.5, -1, 1)
        img = rng.uniform(40, 120, (d, d, 3))
        for j, on in enumerate(bits):
            if on > 0:
                if j < len(regions):
                    rows, cols, ch = regions[j]
                    img[rows, cols, slice(None) if ch is None else ch] += 90
                else:
                    img += 40
        name = f"{i:06d}.jpg"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(root, "img", name), quality=95)
        row = np.full(40, -1, np.int64)
        row[list(attrs)] = bits
        lines.append(name + " " + " ".join(str(v) for v in row))
    with open(os.path.join(root, "attrs.txt"), "w") as f:
        f.write("\n".join(lines))


def _call_main(fn, argv, cwd):
    """``fn(argv)`` in ``cwd``: (its exit code, its standard output)."""
    import contextlib
    import io

    buf = io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            code = fn(argv)
    finally:
        os.chdir(here)
    return code, buf.getvalue()


def c2_rank_main(rank: int, port: int, out_path: str) -> int:
    """One gloo rank of phase (k)'s C2 check on the one card: a Trainer
    with ``device_data`` over a dataset that counts the rows it yields
    builds its store; writes the rows it decoded and the store's rows per
    batch."""
    import pickle

    import torch
    import torch.distributed as dist

    from littlegan_tpu_torch.data import SyntheticDataset
    from littlegan_tpu_torch.parallel.mesh import data_group
    from littlegan_tpu_torch.training.trainer import Trainer

    class Spy(SyntheticDataset):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.yielded = []

        def epoch_iterator(self, *a, **k):
            for img, cond in super().epoch_iterator(*a, **k):
                self.yielded.append(img.shape[0])
                yield img, cond

    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=C2_RANKS, rank=rank)
    try:
        cfg = train_config(out_path + f".r{rank}").replace(exp_name="chip_smoke_c2", device_data=True)
        data = Spy(cfg, num_items=C2_BATCHES * cfg.batch_size)
        tr = Trainer(cfg, data, device=dev, group=data_group(dev))
        data.yielded.clear()  # rank 0's fixture batch
        imgs, _ = tr._ensure_device_store()
        record = {"yielded": data.yielded, "store_rows": int(imgs.shape[1]), "store_batches": int(imgs.shape[0])}
        with open(out_path + f".{rank}.pkl", "wb") as f:
            pickle.dump(record, f)
    finally:
        dist.destroy_process_group()
    return 0


def check_parity():
    """Phase (k). Returns (each kernel's launches in the phase, the record)."""
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch

    from littlegan_tpu_torch.data import SyntheticDataset
    from littlegan_tpu_torch.scripts import doctor, memory_report, verify_conditioning

    t_phase = time.time()
    record, launches = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="chip_smoke_parity_") as root:
        # --- the orbax backend: unbroken, resumed from epoch 1's async save, and the npz backend's run
        runs = {}
        for name, backend in (("orbax", "orbax"), ("npz", "npz")):
            cfg = _parity_config(os.path.join(root, name), backend)
            data = SyntheticDataset(cfg, num_items=PARITY_BATCHES * cfg.batch_size)
            flat, counts, times, _ = _parity_run(cfg, data)
            runs[name] = (flat, times)
            add(counts)
            # 2 epochs of PARITY_BATCHES / 2 updates, and the graph's capture first runs its K updates eagerly
            want = {k: v * (PARITY_BATCHES + PARITY_K) for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
            require(counts == want, f"(k) {name} run launches {counts}, want {want}")
        src = os.path.join(_parity_config(os.path.join(root, "orbax"), "orbax").result_dir, "checkpoint")
        require(sorted(os.listdir(src)) == ["ocp-1", "ocp-2", "status.json"], f"(k) orbax tree {os.listdir(src)}")
        cfg = _parity_config(os.path.join(root, "resumed"), "orbax")
        dst = os.path.join(cfg.result_dir, "checkpoint")
        os.makedirs(dst)
        shutil.copytree(os.path.join(src, "ocp-1"), os.path.join(dst, "ocp-1"))
        with open(os.path.join(dst, "status.json"), "w") as f:
            json.dump({"epoch": 2, "step": PARITY_BATCHES // 2}, f)
        flat, counts, _, epoch = _parity_run(cfg, SyntheticDataset(cfg, num_items=PARITY_BATCHES * cfg.batch_size))
        add(counts)
        want = {k: v * (PARITY_BATCHES // 2 + PARITY_K) for k, v in EXPECTED_TRAIN_LAUNCHES.items()}  # epoch 2
        require(counts == want and epoch == 2, f"(k) resumed run launches {counts}, want {want}; epoch {epoch}")
        runs["resumed"] = (flat, None)
        for a, b in (("orbax", "npz"), ("resumed", "orbax")):
            fa, fb = runs[a][0], runs[b][0]
            same = fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)
            log(f"(k) {a} vs {b} after 2 epochs ({PARITY_BATCHES} updates, K = {PARITY_K}): bit for bit {same}")
            require(same, f"(k) {a} != {b}")
        save = {name: runs[name][1]["save"] for name in ("orbax", "npz")}
        wait = runs["orbax"][1]["wait"]
        state_mb = sum(v.nbytes for v in runs["npz"][0].values()) / 1e6
        log(f"(k) checkpoint save, host time blocking the loop per epoch save (s): orbax {save['orbax']} "
            f"(async; the loop's waits for a save in flight {wait}), npz {save['npz']}; state {state_mb:.1f} MB; "
            f"an epoch of {PARITY_BATCHES // 2} updates here is shorter than a save's write")
        record["orbax"] = {"bitwise_vs_npz": True, "resume_bitwise": True, "save_s": save["orbax"],
                           "wait_s": wait, "npz_save_s": save["npz"], "state_mb": state_mb,
                           "torch": torch.__version__}

        # --- memory report: one update's peak on the card beside the analytic bytes
        code, out = _call_main(memory_report.main, ["--dim", "128", "--batch", "32", "--measure"], root)
        require(code == 0, f"(k) memory_report --measure exited {code}: {out[-2000:]}")
        rep = json.loads(out.strip().splitlines()[-1])
        meas = rep["measured"]
        require(meas["losses_finite"] and meas["kernels"]
                and all(meas["launches"].get(k, 0) > 0 for k in EXPECTED_TRAIN_LAUNCHES), f"(k) --measure: {meas}")
        add(meas["launches"])
        log(f"(k) memory_report --measure (128², batch 32, kernels): peak {meas['peak_bytes'] / 2 ** 20:.1f} MiB, "
            f"{meas['before_bytes'] / 2 ** 20:.1f} MiB allocated before the update; analytic train state "
            f"{rep['total_per_chip_bytes'] / 2 ** 20:.1f} MiB; launches {meas['launches']}")
        record["memory"] = {"peak_bytes": meas["peak_bytes"], "before_bytes": meas["before_bytes"],
                            "analytic_state_bytes": rep["total_per_chip_bytes"], "launches": meas["launches"]}

        # --- the structured set, the doctor, the conditioning check
        struct = os.path.join(root, "struct")
        cfg = _parity_config(os.path.join(root, "orbax"), "orbax")
        _structured_jpegs(struct, CONDITIONING_IMAGES, cfg.image_dim, cfg.attr)
        cwd = os.path.join(root, "cwd")
        os.makedirs(cwd)
        base = {f: getattr(cfg, f) for f in ("all_result_dir", "test_data_dir", "extra", "image_dim", "init_dim",
                                              "noise_dim", "conv_filter", "compute_dtype", "attr")}
        with open(os.path.join(cwd, "sample.config.json"), "w") as f:
            json.dump({**base, "batch_size": CONDITIONING_IMAGES, "image_path": os.path.join(struct, "img"),
                       "attr_path": os.path.join(struct, "attrs.txt")}, f)
        code, out = _call_main(doctor.main, [], cwd)
        summary = json.loads(out.strip().splitlines()[-1])
        levels = {r["check"]: r["level"] for r in summary["results"]}
        log("(k) doctor on the card: " + "; ".join(f"{r['level']} {r['check']}: {r['detail']}"
                                                      for r in summary["results"]))
        require(code == 0 and all(levels[k] == "PASS" for k in ("devices", "cuda-build", "train-step",
                                                                 "image_path", "attr_path")),
                f"(k) doctor exited {code}: {levels}")
        step_launches = re.findall(r"(\w+) (\d+)", summary["results"][2]["detail"].split("launches", 1)[1])
        add({k: int(v) for k, v in step_launches})
        record["doctor"] = levels
        counters = _counters(tuple(EXPECTED_TRAIN_LAUNCHES))
        for c in counters.values():
            c.reset()
        code, out = _call_main(verify_conditioning.main, [cfg.exp_name], cwd)
        counts = {k: c.value for k, c in counters.items()}
        add(counts)
        deltas = [float(v) for v in re.findall(r"attr\d+: ([+-][0-9.]+)", out)]
        acc = re.search(r"accuracy on real images: ([0-9.]+)", out)
        require(code == 0 and len(deltas) == 2 * len(cfg.attr) and all(np.isfinite(deltas)) and acc,
                f"(k) verify_conditioning exited {code}: {out[-2000:]}")
        require(all(counts[k] > 0 for k in ("fused_instance_norm_lrelu", "norm_lrelu_from_stats",
                                            "conv3x3_same_stats")), f"(k) conditioning launches {counts}")
        log(f"(k) verify_conditioning on the orbax run's checkpoint (ocp-2): generator "
            f"deltas {deltas[:len(cfg.attr)]}, adjuster deltas {deltas[len(cfg.attr):]}, D cond-head accuracy "
            f"{acc.group(1)}; launches {counts}")
        record["conditioning"] = {"deltas": deltas, "accuracy": float(acc.group(1)), "launches": counts}

        # --- C2: two gloo ranks sharing the card, each decoding half the rows
        out_base = os.path.join(root, "c2")
        env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        env.pop("LOCAL_RANK", None)
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--c2-rank", str(r), str(port),
                                   out_base], env=env) for r in range(C2_RANKS)]
        try:
            codes = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        require(codes == [0] * C2_RANKS, f"(k) C2 gloo ranks exited {codes}")
        recs = []
        for r in range(C2_RANKS):
            with open(out_base + f".{r}.pkl", "rb") as f:
                recs.append(pickle.load(f))
        half = TRAIN_BATCH // C2_RANKS
        for r, rec in enumerate(recs):
            log(f"(k) C2 rank {r}: its dataset yielded {sum(rec['yielded'])} rows in {len(rec['yielded'])} batches "
                f"({rec['yielded']}); its store holds {rec['store_rows']} of each batch's {TRAIN_BATCH} rows, "
                f"{rec['store_batches']} batches")
            require(rec["yielded"] == [half] * C2_BATCHES and rec["store_rows"] == half
                    and rec["store_batches"] == C2_BATCHES, f"(k) C2 rank {r} decoded {rec['yielded']}")
        record["c2"] = [rec["yielded"] for rec in recs]
    record["launches"] = launches
    record["wall_s"] = time.time() - t_phase
    log(f"phase (k) wall: {record['wall_s']:.1f} s")
    return launches, record


# phase (l): kernel coverage. K3 (both routes) and its fold at every
# COVER_K3_COUTS width over block1's s2d input at 128² (64 x 64 x 12) at
# COVER_K3_BATCHES, and at 256 x 256 x 12 (512², the tightest shared memory
# the sweep's widths reach) at COVER_K3_WIDE; K1, K2 and K1' bwd at the
# whole-sample maps beyond 16 blocks' shared memory (heights not a multiple
# of 8, two-pass moments: the three-launch route); then the doctor's tiny
# step with the JAX doctor's block1 width 6 on the card
COVER_K3_COUTS = (6, 12, 24, 48, 96, 192, 256)
COVER_K3_BATCHES = (1, 8, 32)
COVER_K3_WIDE = [((n, 256, 256, 12), c) for c in (64, 256) for n in (1, 8)]
COVER_K1 = [((32, 92, 92, 128), "float32"), ((32, 124, 124, 128), "bfloat16"), ((8, 86, 86, 256), "bfloat16")]


def check_coverage():
    """Phase (l). Every new route on the card against its plain version with
    phase (b)'s tolerances, its device time beside its bound; K3's host
    plan (``conv_plan``) against the library's own shared memory and
    partial counts. Returns (each kernel's launches in the doctor's step,
    the record)."""
    import torch

    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.ops.cuda import boundary_conv as bc
    from littlegan_tpu_torch.ops.cuda import norm_lrelu as nl
    from littlegan_tpu_torch.scripts import doctor

    t_phase = time.time()
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    gamma = torch.tensor([1.3], device=dev)
    beta = torch.tensor([-0.2], device=dev)
    lib = _build.lib()
    counters = _counters(tuple(EXPECTED_TRAIN_LAUNCHES))
    failures, rows = [], []

    def launched(name, fn):
        """fn()'s result, and whether the wrapper ``name`` launched once."""
        before = counters[name].value
        out = fn()
        torch.cuda.synchronize()
        return out, counters[name].value - before == 1

    def row(name, dtype, shape, err, ok_launch, fn, bnd, reps=20, **extra):
        ms = time_ms(fn, reps)
        rows.append({"kernel": name, "shape": list(shape), "dtype": dtype, "max_abs_err": err,
                     "launched": ok_launch, "ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1], **extra})
        if not ok_launch:
            failures.append(f"{name} {dtype} {shape}: the wrapper did not launch its kernel once")
        log(f"  (l) {name} {dtype} {tuple(shape)}: max_abs_err {err:.3g}  launches 1: {ok_launch}  "
            f"kernel {ms:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]}, {bnd[0] / ms:.0%})"
            + "".join(f"  {k} {v}" for k, v in extra.items()))

    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        atol, rtol = TOL[dtype_name]
        srtol = GRAD_SUM_RTOL[dtype_name]
        item = torch.tensor([], dtype=dt).element_size()
        code = _build.dtype_code(torch.empty(0, dtype=dt))
        log(f"(l) K3 conv3x3_same_stats ({bc.kernel_route(dt)}) and its fold, {dtype_name}, "
            f"Cout {COVER_K3_COUTS} at batches {COVER_K3_BATCHES} of 64x64x12, and 256x256x12")
        cases = [((n, 64, 64, 12), c) for c in COVER_K3_COUTS for n in COVER_K3_BATCHES] + COVER_K3_WIDE
        for xshape, cout in cases:
            plan = bc.conv_plan(dt, xshape, cout)
            lib_plan = (lib.lg_conv3x3_smem_bytes(code, xshape[2], xshape[3], plan.cout_tile),
                        lib.lg_conv3x3_partials(code, xshape[1], xshape[2], cout, plan.cout_tile))
            if (plan.smem, plan.parts) != lib_plan or not bc.supports(xshape, cout, dt):
                failures.append(f"K3 {dtype_name} {xshape} -> {cout}: {plan} vs the library's (smem, parts) "
                                f"{lib_plan}, supports {bc.supports(xshape, cout, dt)}")
                continue
            x = torch.randn(xshape, device=dev, generator=gen).to(dt)
            w = (torch.randn((3, 3, xshape[3], cout), device=dev, generator=gen) * 0.2).to(dt)
            b = (torch.randn((cout,), device=dev, generator=gen) * 0.1).to(dt)
            (y, s1, s2), ok = launched("conv3x3_same_stats", lambda: bc.conv3x3_same_stats(x, w, b))
            py, ps1, ps2 = bc.conv3x3_same_stats_plain(x, w, b)
            scale = py.float().abs().sum((1, 2, 3))
            if not (_within(y, py, atol, rtol) and bool(((s1 - ps1).abs() <= STATS_RTOL * scale).all())
                    and bool(((s2 - ps2).abs() <= STATS_RTOL * ps2.abs()).all())):
                failures.append(f"K3 {dtype_name} {xshape} -> {cout}: max_abs_err {_max_err(y, py):.3g}, "
                                f"s1 {_max_err(s1, ps1):.3g}, s2 {_max_err(s2, ps2):.3g}")
            n_out = y.numel()
            reps = 20 if n_out * item <= 64 << 20 else 5
            row("conv3x3_same_stats", dtype_name, xshape + (cout,), _max_err(y, py), ok,
                lambda: bc.conv3x3_same_stats(x, w, b),
                bound((x.numel() + w.numel() + b.numel() + n_out) * item + 8 * xshape[0],
                      2 * n_out * 9 * xshape[3] + 3 * n_out, dtype_name), reps,
                route=plan.route, cout_tile=plan.cout_tile, cout_tiles=plan.cout_tiles, nbuf=plan.nbuf)
            del py, ps1, ps2, x
            gy = torch.randn(y.shape, device=dev, generator=gen).to(dt)
            gs1 = torch.randn((xshape[0],), device=dev, generator=gen) * 1e-3
            gs2 = torch.randn((xshape[0],), device=dev, generator=gen) * 1e-4
            (fy, fdb), ok = launched("conv3x3_bwd_fold", lambda: bc.conv3x3_bwd_fold(y, gy, gs1, gs2))
            py, pdb = bc.conv3x3_bwd_fold_plain(y, gy, gs1, gs2)
            if not (_within(fy, py, atol, rtol)
                    and bool(((fdb - pdb).abs() <= srtol * pdb.abs().max().clamp_min(1e-30)).all())):
                failures.append(f"K3 fold {dtype_name} {y.shape}: max_abs_err {_max_err(fy, py):.3g}, "
                                f"db {_max_err(fdb, pdb):.3g}")
            row("conv3x3_bwd_fold", dtype_name, tuple(y.shape), _max_err(fy, py), ok,
                lambda: bc.conv3x3_bwd_fold(y, gy, gs1, gs2),
                bound(3 * n_out * item + 8 * xshape[0] + 4 * cout, 4 * n_out, dtype_name), reps,
                layout="16-byte" if bc.fold_vectorised(cout, item) else "element")
            del y, gy, fy, py

    log(f"(l) K1, K2 and K1' bwd at whole-sample maps beyond 16 blocks' shared memory: {COVER_K1}")
    for shape, dtype_name in COVER_K1:
        dt = getattr(torch, dtype_name)
        atol, rtol = TOL[dtype_name]
        batol, brtol = BWD_TOL[dtype_name]
        srtol = GRAD_SUM_RTOL[dtype_name]
        item = torch.tensor([], dtype=dt).element_size()
        n, m = shape[0], math.prod(shape[1:])
        plan = nl.fwd_plan(n, m, item, nl._sms(dev), nl.holds_whole_sample(shape, item))
        if not (plan.two_pass and not plan.cluster):
            failures.append(f"K1 {dtype_name} {shape}: {plan} is not the three-launch two-pass route")
        reps = 5
        x = (torch.randn(shape, device=dev, generator=gen) * 2.0 + 0.5).to(dt)
        (y, stats), ok = launched("fused_instance_norm_lrelu", lambda: nl._fused_forward(x, gamma, beta, 0.3, 1e-3))
        want = nl.fused_instance_norm_lrelu_plain(x, gamma, beta, 0.3)
        mo = nl.instance_norm_moments_plain(x)
        if not (_within(y, want, atol, rtol)
                and bool(((stats[0] - mo[0]).abs() <= 1e-6 * (mo[0].abs() + mo[1])).all())
                and bool(((stats[1] - mo[1]).abs() <= 1e-5 * mo[1]).all())):
            failures.append(f"K1 {dtype_name} {shape}: max_abs_err {_max_err(y, want):.3g}, (mean, std) "
                            f"{stats[:, :2].tolist()} vs {mo[:, :2].tolist()}")
        row("fused_instance_norm_lrelu", dtype_name, shape, _max_err(y, want), ok,
            lambda: nl.fused_instance_norm_lrelu(x, gamma, beta, 0.3),
            bound(2 * x.numel() * item + 8 * n + 8, 7 * x.numel(), dtype_name), reps, plan=tuple(plan))
        del y, want
        dy = torch.randn(shape, device=dev, generator=gen).to(dt)
        got, ok = launched("fused_instance_norm_lrelu_bwd",
                           lambda: nl.fused_instance_norm_lrelu_bwd(x, dy, gamma, beta, 0.3, 1e-3, stats))
        want = nl.fused_instance_norm_lrelu_bwd_plain(x, dy, gamma, beta, 0.3, stats=mo)
        nrm = (x.float() - mo[0].reshape(-1, 1, 1, 1)) / (mo[1].reshape(-1, 1, 1, 1) + 1e-3)
        away = (nrm * gamma + beta).abs() > KINK
        scales = (float((dy.float() * nrm).abs().sum()), float(dy.float().abs().sum()))
        if not (_within(got[0][away], want[0][away], batol, brtol)
                and float((got[1] - want[1]).abs()) <= srtol * scales[0]
                and float((got[2] - want[2]).abs()) <= srtol * scales[1]):
            failures.append(f"K2 {dtype_name} {shape}: dx {_max_err(got[0][away], want[0][away]):.3g}, "
                            f"dgamma {float(got[1])} vs {float(want[1])}, dbeta {float(got[2])} vs {float(want[2])}")
        row("fused_instance_norm_lrelu_bwd", dtype_name, shape, _max_err(got[0][away], want[0][away]), ok,
            lambda: nl.fused_instance_norm_lrelu_bwd(x, dy, gamma, beta, 0.3, 1e-3, stats),
            bound(3 * x.numel() * item + 8 * n + 16, 14 * x.numel(), dtype_name), reps,
            plan=tuple(nl.bwd_plan(n, m, item, nl._sms(dev))), kink_elements=int((~away).sum()))
        del got, want, nrm, away
        yv = (x.float() + 0.3).to(dt)
        yf = yv.float()
        s1, s2 = yf.sum((1, 2, 3)), yf.square().sum((1, 2, 3))
        got, ok = launched("norm_lrelu_from_stats_bwd",
                           lambda: nl.norm_lrelu_from_stats_bwd(yv, s1, s2, gamma, beta, dy, 0.3))
        want = nl.norm_lrelu_from_stats_bwd_plain(yv, s1, s2, gamma, beta, dy, 0.3)
        mean = (s1 / m).reshape(-1, 1, 1, 1)
        std = ((s2 / m).reshape(-1, 1, 1, 1) - mean.square()).clamp_min(0).sqrt()
        away = (((yf - mean) / (std + 1e-3)) * gamma + beta).abs() > KINK
        sums_ok = all(bool(((got[i] - want[i]).abs() <= srtol * want[i].abs().max().clamp_min(1e-30)).all())
                      for i in (1, 2))
        nrm_scale = float((dy.float() * (yf - mean) / (std + 1e-3)).abs().sum())
        if not (_within(got[0][away], want[0][away], batol, brtol) and sums_ok
                and float((got[3] - want[3]).abs()) <= srtol * nrm_scale
                and float((got[4] - want[4]).abs()) <= srtol * float(dy.float().abs().sum())):
            failures.append(f"K1' bwd {dtype_name} {shape}: dy {_max_err(got[0][away], want[0][away]):.3g}, "
                            f"ds1 {_max_err(got[1], want[1]):.3g}, ds2 {_max_err(got[2], want[2]):.3g}")
        row("norm_lrelu_from_stats_bwd", dtype_name, shape, _max_err(got[0][away], want[0][away]), ok,
            lambda: nl.norm_lrelu_from_stats_bwd(yv, s1, s2, gamma, beta, dy, 0.3),
            bound(3 * yv.numel() * item + 16 * n + 16, 12 * yv.numel(), dtype_name), reps)
        del x, dy, yv, yf, got, want, away, mean, std
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("(l) kernel coverage:\n  " + "\n  ".join(failures))

    # --- the doctor's tiny step, block1 at the JAX doctor's width 6
    for c in counters.values():
        c.reset()
    detail = doctor.train_step("cuda")
    launches = {k: c.value for k, c in counters.items()}
    log(f"(l) doctor train-step (conv_filter [16, 12, 8, 6, 4]) on the card: PASS {detail}")
    require(all(v > 0 for v in launches.values()), f"(l) doctor step launches {launches}")
    record = {"rows": rows, "doctor": {"detail": detail, "launches": launches}, "wall_s": time.time() - t_phase}
    log(f"phase (l) wall: {record['wall_s']:.1f} s")
    return launches, record


# phase (m): the measurement and campaign tools (littlegan_tpu_torch/bench.py,
# littlegan_tpu_torch/scripts/) at the reference's 128², batch 32, each as a
# user runs it; a failure of any fails the run
TOOLS_BENCH_WINDOWS = 3 * 5  # bench.time_scan_dispatches: repeats x MEASURE_DISPATCHES
TOOLS_AUTOTUNE = ["--ks", "8,16,64", "--skip-adj-half", "--skip-moment-dtype", "--measure-dispatches", "1"]
TOOLS_SERVE = ["--calls", "16", "--threads", "8", "--reload"]
TOOLS_CAMPAIGN = ["--epochs", "1", "--eval-every", "1", "--dim", "32", "--n", "512", "--batch-size", "32",
                  "--fid-n", "128", "--eval-rows", "32"]  # 16 batches: one K = 8 replay


def _json_lines(out: str):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _run_module(argv, cwd, timeout=600):
    """``python -m <argv>`` from ``cwd``: (its standard output, host wall s);
    raises unless it exits 0."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=cwd, capture_output=True, text=True, timeout=timeout)
    require(proc.returncode == 0, f"python -m {' '.join(argv)}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
                                  f"{proc.stderr[-4000:]}")
    return proc.stdout, time.time() - t0


def check_tools():
    """Phase (m): ``python -m littlegan_tpu_torch.bench`` (0 < mfu <= 1,
    the card's name, the kernels' launches over the timed windows equal to
    EXPECTED_GRAPH_LAUNCHES per update), autotune over K 8, 16, 64 (every
    point measured, each K's graph capture s and peak memory), serve_bench
    with a reload drill (0 dropped), scaling_curve over one card, and a
    one-epoch campaign at 32² (7 + 7 effects, finite trends, every kernel launched).
    Returns (the kernels' launches: {"bench": ..., "campaign": ...}, the
    record)."""
    import tempfile

    import numpy as np
    import torch

    from littlegan_tpu_torch.scripts import autotune, campaign, serve_bench

    root = os.path.dirname(os.path.abspath(__file__))
    kind = torch.cuda.get_device_name(0)
    walls, record, launches = {}, {}, {}
    torch.cuda.empty_cache()

    out, walls["bench"] = _run_module(["littlegan_tpu_torch.bench"], root)
    lines = _json_lines(out)
    require(len(lines) == 1, f"bench: {len(lines)} JSON lines")
    line = lines[0]
    log("(m) bench: " + json.dumps(line))
    require(line["metric"] == "train_images_per_sec_per_chip_128px_b32_kernels", line["metric"])
    require(line["device_kind"] == kind and line["device"] == "cuda", (line["device_kind"], kind))
    require(line["mfu"] is not None and 0 < line["mfu"] <= 1, f"bench mfu {line['mfu']}")
    want = {k: v * TOOLS_BENCH_WINDOWS * line["steps_per_dispatch"] for k, v in EXPECTED_GRAPH_LAUNCHES.items()}
    require(line["kernel_launches"] == want, f"bench launches {line['kernel_launches']}, want {want}")
    launches["bench"] = line["kernel_launches"]
    record["bench"] = [line]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        t0 = time.time()
        code, out = _call_main(autotune.main, TOOLS_AUTOTUNE + ["--out", os.path.join(tmp, "rec.json")], tmp)
        walls["autotune"] = time.time() - t0
        points = _json_lines(out)
        rec = json.loads(next(ln for ln in out.splitlines() if ln.startswith("RECOMMEND "))[len("RECOMMEND "):])
        for pt in points:
            log(f"(m) autotune K {pt['steps_per_dispatch']}: " + json.dumps(pt))
        require(code == 0 and not rec["failed"] and [p["steps_per_dispatch"] for p in points] == [8, 16, 64],
                f"autotune: exit {code}, points {points}")
        require(all(p["graph_capture_s"] > 0 and p["peak_memory_mb"] > 0 for p in points), points)
        record["autotune"] = {"points": points, "recommend": {k: rec[k] for k in ("parity", "fastest", "device_kind")}}
        torch.cuda.empty_cache()

        t0 = time.time()
        code, out = _call_main(serve_bench.main, TOOLS_SERVE, tmp)
        walls["serve_bench"] = time.time() - t0
        lines = {ln["metric"]: ln for ln in _json_lines(out)}
        for ln in lines.values():
            log("(m) serve_bench: " + json.dumps(ln))
        drill = lines.get("serve_generate_latency_during_hot_reload", {})
        require(code == 0 and len(lines) == 6 and drill.get("dropped") == 0 and None not in drill["reloaded"],
                f"serve_bench: exit {code}, {sorted(lines)}, drill {drill}")
        record["serve_bench"] = list(lines.values())
        torch.cuda.empty_cache()

        out, walls["scaling_curve"] = _run_module(
            ["littlegan_tpu_torch.scripts.scaling_curve", "--devices", "1", "--out",
             os.path.join(tmp, "c.json")], root)
        curve = _json_lines(out)
        log("(m) scaling_curve: " + json.dumps(curve))
        require(len(curve) == 1 and curve[0]["regime"] == "dp" and curve[0]["efficiency"] == 1.0
                and curve[0]["device_kind"] == kind and curve[0]["img_s"] > 0, f"scaling_curve: {curve}")
        record["scaling_curve"] = curve

        counters = _counters(tuple(EXPECTED_TRAIN_LAUNCHES))
        for c in counters.values():
            c.reset()
        t0 = time.time()
        code, out = _call_main(campaign.main, ["tools"] + TOOLS_CAMPAIGN + [
            "--data", os.path.join(tmp, "data"), "--result-dir", os.path.join(tmp, "result")], tmp)
        walls["campaign"] = time.time() - t0
        launches["campaign"] = {k: c.value for k, c in counters.items()}
        with open(os.path.join(tmp, "result", "tools", "campaign_trajectory.json")) as f:
            traj = json.load(f)
        log("(m) campaign: " + json.dumps(traj) + f"; launches {launches['campaign']}")
        rec = traj[0] if len(traj) == 1 else {}
        trends = [rec.get(k) for k in ("fid_trend_random_init", "is_trend_random_init", "kid_trend_random_init")]
        require(code == 0 and len(rec.get("gen_effects", [])) == 7 and len(rec.get("adj_effects", [])) == 7
                and all(v is not None and np.isfinite(v) for v in trends) and rec["device_kind"] == kind,
                f"campaign: exit {code}, {traj}")
        require(all(v > 0 for v in launches["campaign"].values()), f"campaign launches {launches['campaign']}")
        record["campaign"] = rec
    record["walls"] = walls
    log("phase (m) walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + f" | {nvidia_smi_line()}")
    return launches, record


# phase (n): the JAX repo's last entry points, as a user runs them
ENTRY_FIT = ["--points", "128:32,128:256", "--flagsets", "parity,remat"]
# a step past 80 GB: the host-fed step through the kernels peaks at 63.2 GB at 1024², batch 32 on an
# H100 80GB (about 1.9 GB per image over a 2.3 GB state), so batch 56 asks for about 109 GB; its largest
# tensor stays under 2**31 elements (56 x 1024² x 32)
ENTRY_OOM = ["--points", "1024:56", "--flagsets", "parity"]
ENTRY_DRYRUN_TAGS = [("dp", "OK"), ("accum_x_dp", "OK"), ("spatial", "skipped"), ("zero1_x_dp", "OK"),
                     ("shard_dense", "skipped"), ("moment_bf16_x_zero1_x_dp", "OK"), ("accum_x_spatial", "skipped"),
                     ("shard_dense_x_zero1", "skipped"), ("infer_dp", "OK")]  # at one rank
ENTRY_K3_REL = 0.10  # bench_boundary_conv's K3 against phase (b)'s, same shape and dtype
ENTRY_PORT_KERNELS = ("K1 norm_lrelu.cu", "K2 norm_lrelu_bwd.cu", "K3 boundary_conv.cu")


def _top_ops(path, root, top_n=25):
    """``trace_top_ops <path> <top_n> --json``: its summary; it must name
    K1, K2 and K3 among the device ops."""
    out, wall = _run_module(["littlegan_tpu_torch.scripts.trace_top_ops", path, str(top_n), "--json"], root)
    summary = _json_lines(out)[-1]
    for line in out.splitlines()[:-1]:
        log(f"  {line}")
    cats = {c["category"] for c in summary["by_category"]}
    require(all(k in cats for k in ENTRY_PORT_KERNELS), f"trace_top_ops of {path}: categories {sorted(cats)}")
    summary["wall_s"] = wall
    return summary


def check_entry_points(records, profile_trace):
    """Phase (n): ``fit_frontier`` over ENTRY_FIT (every point fits) and
    ENTRY_OOM (``oom``, not ``error``), ``dryrun 1`` over NCCL
    (ENTRY_DRYRUN_TAGS), ``trace_top_ops`` on phase (g)'s ``profile_steps``
    trace and on a replay of the K = 8 graph (K1, K2 and K3 among the device
    ops), ``bench_boundary_conv`` (K3 within ENTRY_K3_REL of phase (b)'s
    ``records`` at (32, 64, 64, 12) bf16, within its tolerance at every
    row) and ``bench_step_variants`` (both forms).
    The dry run runs beside the fitting probes (not the OOM one), the rest
    one at a time. Returns (the kernels' launches of the dry run and the
    step variants, the record)."""
    import tempfile

    import numpy as np

    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.scripts import bench_step_variants

    root = os.path.dirname(os.path.abspath(__file__))
    walls, record = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp:
        # the dry run (a small model) shares the card with the fitting probes, whose peaks are each
        # process's own; the probe that runs out of memory and the timed tools run alone
        t_dry = time.time()
        with open(os.path.join(tmp, "dryrun.log"), "w+") as dry_log:
            dry_proc = subprocess.Popen([sys.executable, "-m", "littlegan_tpu_torch.dryrun", "1"],
                                        cwd=root, stdout=dry_log, stderr=subprocess.STDOUT, text=True)
            try:
                out, walls["fit_frontier"] = _run_module(
                    ["littlegan_tpu_torch.scripts.fit_frontier", *ENTRY_FIT, "--out", os.path.join(tmp, "fit.json")],
                    root)
                dry_proc.wait(timeout=600)
            finally:
                if dry_proc.poll() is None:
                    dry_proc.kill()
                    dry_proc.wait()
            dry_log.seek(0)
            dry_out = dry_log.read()
        walls["dryrun"] = time.time() - t_dry
        rows = [r for r in _json_lines(out) if "verdict" in r]
        for r in rows:
            log("(n) fit_frontier: " + json.dumps(r))
        require([(r["dim"], r["batch"], r["flags"], r["verdict"]) for r in rows]
                 == [(128, 32, "parity", "fits"), (128, 32, "remat", "fits"), (128, 256, "parity", "fits"),
                     (128, 256, "remat", "fits")], f"fit_frontier {ENTRY_FIT}: {rows}")
        require(dry_proc.returncode == 0, f"dryrun 1: exit {dry_proc.returncode}\n{dry_out[-4000:]}")
        out, walls["fit_frontier_oom"] = _run_module(["littlegan_tpu_torch.scripts.fit_frontier", *ENTRY_OOM], root)
        (oom,) = [r for r in _json_lines(out) if "verdict" in r]
        log("(n) fit_frontier past the card: " + json.dumps(oom))
        require(oom["verdict"] == "oom" and oom["oom_used_bytes"] > 0 and oom["n_images_headroom"] == 0,
                f"fit_frontier {ENTRY_OOM}: {oom}")
        record["fit_frontier"] = rows + [oom]

        lines = [ln for ln in dry_out.splitlines() if ln.startswith("dryrun_multichip(1) ")]
        for ln in lines:
            log(f"(n) {ln}")
        tags = [re.match(r"dryrun_multichip\(1\) \[(\w+)\] (OK|skipped)", ln) for ln in lines[:-1]]
        require([m.groups() if m else None for m in tags] == ENTRY_DRYRUN_TAGS, f"dryrun 1: {lines}")
        dry = json.loads(lines[-1].split("kernel launches (rank 0): ", 1)[1])
        require(all(dry.get(k, 0) > 0 for k in EXPECTED_TRAIN_LAUNCHES), f"dryrun 1 launches {dry}")

        for c in _build.COUNTERS.values():
            c.reset()
        t0 = time.time()
        code, out = _call_main(bench_step_variants.main, ["--trace", tmp], tmp)
        walls["bench_step_variants"] = time.time() - t0
        variants = _json_lines(out)[-1]
        for ln in out.splitlines()[:-1]:
            log(f"(n) bench_step_variants: {ln}")
        nums = [r[k] for r in variants["kernels_on"].values() for k in ("host_ms_per_step", "graph_busy_ms_per_update")]
        require(code == 0 and all(np.isfinite(v) and v > 0 for v in nums), f"bench_step_variants: {variants}")
        launches = {k: c.value + dry.get(k, 0) for k, c in _counters(tuple(EXPECTED_TRAIN_LAUNCHES)).items()}
        record["bench_step_variants"] = variants

        log("(n) trace_top_ops, phase (g)'s profile_steps trace (host-fed Trainer steps):")
        record["top_ops_profile"] = _top_ops(profile_trace, root)
        log("(n) trace_top_ops, one replay of the K = 8 graph (bench_step_variants --trace):")
        record["top_ops_graph"] = _top_ops(os.path.join(tmp, "graph_k8.json"), root)

        out, walls["bench_boundary_conv"] = _run_module(["littlegan_tpu_torch.scripts.bench_boundary_conv"], root)
        rows = _json_lines(out)
        for ln in out.splitlines():
            if not ln.startswith("{"):
                log(f"(n) bench_boundary_conv: {ln}")
        (k3,) = [r for r in rows if r["shape"] == [32, 64, 64, 12] and r["dtype"] == "bfloat16"]
        (b,) = [r for r in records["conv3x3_same_stats"]["shapes"]
                if r["shape"] == [32, 64, 64, 12, 64] and r["dtype"] == "bfloat16"]
        log(f"(n) K3 (32, 64, 64, 12) bf16: bench_boundary_conv {k3['k3_ms']:.4f} ms, phase (b) {b['ms']:.4f} ms")
        require(all(r["within_tol"] for r in rows) and abs(k3["k3_ms"] / b["ms"] - 1) <= ENTRY_K3_REL,
                f"bench_boundary_conv: {rows} against phase (b)'s {b['ms']}")
        record["bench_boundary_conv"] = rows
    if os.path.exists(PROFILE_TRACE_COPY):
        os.remove(PROFILE_TRACE_COPY)
    record["walls"] = walls
    log("phase (n) walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + f" | {nvidia_smi_line()}")
    return launches, record


# phase (o): StarGAN v2's kernels at the benchmark's configuration
# (benchmark/configs/stargan-v2-afhq-256.json: AFHQ 256², batch 8, bf16)
SG_CONFIG = os.path.join("benchmark", "configs", "stargan-v2-afhq-256.json")
# (C, H) of the generator's 25 norms a pass (base width 64, widths up to 512)
SG_NORM_SHAPES = [(64, 256), (64, 128), (128, 128), (128, 64), (256, 64), (256, 32), (512, 32), (512, 16)]
# calls an iteration: 25 norms in each of the 8 generator passes, 4 of them
# differentiated; the pools and upsamples of the four networks' passes,
# their backwards (each the other) and R1's double backward through D; the
# conv epilogue of the 26 / 14 / 15 biased convs of each G / E / D pass
# (396) and the 1/sqrt(2) of R1's double backward through D's 12 residual
# blocks, its backward in the 4 G, 3 E and 8 D passes gradients run through
SG_EXPECTED_CALLS = {"stargan_v2.channel_norm": 200, "stargan_v2.channel_norm_bwd": 100,
                     "stargan_v2.down2": 276, "stargan_v2.up2": 228,
                     "stargan_v2.conv_epilogue": 408, "stargan_v2.conv_epilogue_bwd": 266}
# the kernels each call launches (csrc/channel_norm_lrelu.cu: a partial-sums
# launch, then the apply; csrc/resample.cu: one; csrc/conv_epilogue.cu: one
# forward, the column sum's first launch backward, the second launch,
# epilogue_colsum_total_kernel, only where the plan splits the rows)
SG_KERNELS = {"stargan_v2.channel_norm": ("channel_instance_norm_lrelu_stats_kernel",
                                          "channel_instance_norm_lrelu_fwd_kernel"),
              "stargan_v2.channel_norm_bwd": ("channel_instance_norm_lrelu_bwd_stats_kernel",
                                              "channel_instance_norm_lrelu_bwd_kernel"),
              "stargan_v2.down2": ("resample_down2_kernel",), "stargan_v2.up2": ("resample_up2_kernel",),
              "stargan_v2.conv_epilogue": ("epilogue_kernel",),
              "stargan_v2.conv_epilogue_bwd": ("epilogue_colsum_kernel",)}
# |kernel - plain| <= SG_ROUNDING * max|plain|: one rounding of bf16 at the
# output (both round an f32 value once; the f32 values differ in the sums'
# order); the f32 moments and the (B, C) gradients of the affine to
# SG_SUMS_REL of their largest value; the epilogue's f32 bias gradient to
# SG_COLSUM_REL of float64's column sum
SG_ROUNDING = 2.0 ** -7
SG_SUMS_REL = 1e-4
SG_COLSUM_REL = 1e-5
SG_ALPHA = 0.2


def _rel_to_max(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30))


def _stargan_iteration_calls():
    """One eager iteration of the benchmark's StarGAN v2 configuration after
    one that meets every first use, under the profiler, with the
    ``stargan_v2.*`` kernel counters set to 0 just before it: (the
    counters, the kernels the trace saw launched by name, the calls by
    (kind, C, H), whether every loss term is finite)."""
    import collections
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from littlegan_tpu_torch.config import Config
    from littlegan_tpu_torch.data.domains import BalancedSampler
    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.ops.cuda import channel_norm_lrelu as cn
    from littlegan_tpu_torch.ops.cuda import conv_epilogue as ce
    from littlegan_tpu_torch.ops.cuda import resample as rs
    from littlegan_tpu_torch.training import stargan_v2 as ts
    from littlegan_tpu_torch.training.state import create_stargan_state

    dev = torch.device("cuda")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), SG_CONFIG)) as f:
        published = json.load(f)
    fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in published.items() if k in fields}).replace(device_data=True)
    state = create_stargan_state(cfg, dev)
    n_img = 8 * cfg.num_domains
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randint(0, 256, (n_img, cfg.image_dim, cfg.image_dim, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    domains = np.arange(n_img) % cfg.num_domains
    labels = torch.as_tensor(domains, device=dev)
    sampler, rng = BalancedSampler(domains, cfg.num_domains), np.random.default_rng(2)
    dgen = torch.Generator(device=dev).manual_seed(3)

    def one(it):
        ids = np.stack([sampler.draw(rng, cfg.batch_size)])
        draws = ts.stack_draws([ts.draw_iteration(dgen, cfg, dev)])
        return ts.eager_iterations(state, cfg, images, labels, ids, draws, it)

    one(0)
    torch.cuda.synchronize()
    calls = collections.Counter()
    # the kind of a call by its arguments after x: the epilogue's by its
    # form (bias, bias and shortcut, the double backward's scale alone) and
    # the backward's by whether it scales
    spies = {(cn, "channel_norm_lrelu_fwd"): lambda a: "norm", (cn, "channel_norm_lrelu_bwd"): lambda a: "norm_bwd",
             (rs, "resample2"): lambda a: "up2" if a[1] else "down2",
             (ce, "conv_epilogue_fwd"): lambda a: "epilogue_" + ("res" if a[1] is not None else
                                                                 "bias" if a[0] is not None else "scale"),
             (ce, "conv_epilogue_bwd"): lambda a: "epilogue_bwd_" + ("res" if a[0] != 1.0 else "bias")}
    kept = {key: getattr(*key) for key in spies}

    def spy(key, kind):
        fn = kept[key]

        def call(x, *args):
            calls[(kind(args), x.shape[1], x.shape[2])] += 1
            return fn(x, *args)
        return call

    for key, kind in spies.items():
        setattr(*key, spy(key, kind))
    try:
        for name in SG_EXPECTED_CALLS:
            _build.COUNTERS[name].reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            losses = one(1)
            torch.cuda.synchronize()
        counters = {name: _build.COUNTERS[name].value for name in SG_EXPECTED_CALLS}
    finally:
        for key, fn in kept.items():
            setattr(*key, fn)
    launched = collections.Counter()
    for e in device_events(prof):
        m = re.search(r"::(\w+)<", e.key)
        if m is not None:
            launched[m.group(1)] += e.count
    finite = bool(torch.isfinite(losses).all())
    del state, images
    torch.cuda.empty_cache()
    return counters, dict(launched), calls, finite


def check_stargan_v2():
    """Phase (o): StarGAN v2's kernels as its main path runs them. One eager
    iteration of the benchmark's configuration (AFHQ 256², batch 8, bf16):
    the kernel counters at ``SG_EXPECTED_CALLS`` and the kernels the
    profiler saw launched at ``SG_KERNELS`` per call (none of it on the
    plain versions), the calls' shapes recorded; then at each shape the
    iteration ran, batch 8, bf16 in channels-last memory, each kernel
    against its plain version (``SG_ROUNDING``, ``SG_SUMS_REL``,
    ``SG_COLSUM_REL``), timed beside the plain version, PyTorch's ops and
    its bytes at 3.35 TB/s.
    Returns (calls by counter, the record: per-shape rows and the sums over
    one iteration's calls) and raises on a miss."""
    import torch
    import torch.nn.functional as F

    from littlegan_tpu_torch.ops.cuda import channel_norm_lrelu as cn
    from littlegan_tpu_torch.ops.cuda import conv_epilogue as ce
    from littlegan_tpu_torch.ops.cuda import resample as rs

    def adain(x, gamma, beta):  # PyTorch's ops: F.instance_norm, then AdaIN's per-sample affine
        return F.instance_norm(x) * (1 + gamma[:, :, None, None]) + beta[:, :, None, None]

    counters, launched, calls, finite = _stargan_iteration_calls()
    log(f"StarGAN v2 eager iteration: counters {counters}, kernels launched {launched}")
    failures = []
    if not finite:
        failures.append("a loss term of the iteration is not finite")
    if counters != SG_EXPECTED_CALLS:
        failures.append(f"counters {counters}, want {SG_EXPECTED_CALLS}")
    for name, kernels in SG_KERNELS.items():
        for k in kernels:
            if launched.get(k, 0) != counters[name]:
                failures.append(f"{k} launched {launched.get(k, 0)} times for {counters[name]} {name} calls")
    norm_shapes = sorted({(c, h) for kind, c, h in calls if kind == "norm"}, key=lambda s: (-s[1], s[0]))
    if norm_shapes != sorted(SG_NORM_SHAPES, key=lambda s: (-s[1], s[0])):
        failures.append(f"the norms ran at (C, H) {norm_shapes}, want {SG_NORM_SHAPES}")

    dev = torch.device("cuda")
    cl, bf = torch.channels_last, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    norm_rows, kinks = [], 0
    for c, h in norm_shapes:
        x = randn(8, c, h, h).to(bf).contiguous(memory_format=cl)
        dy = randn(8, c, h, h).to(bf).contiguous(memory_format=cl)
        errs = {}
        # IN's (C,) weight shared by the samples, then AdaIN's (B, C) rows with offset 1
        for kind, scale, shift, offset in (("instance", 1 + 0.5 * randn(c), 0.5 * randn(c), 0.0),
                                           ("adain", 0.5 * randn(8, c), 0.5 * randn(8, c), 1.0)):
            y, mean, rstd = cn.channel_norm_lrelu_fwd(x, scale, shift, offset, SG_ALPHA, 1e-5)
            yp, mp, rp = cn.channel_norm_lrelu_plain(x, scale, shift, offset, SG_ALPHA, 1e-5)
            # where z lies at the LeakyReLU's kink, rounding picks its side
            # differently in the kernel (one fused multiply-add) and the
            # plain version: dy is 0 there, so the side does not matter
            a = ((offset + scale.expand(8, c)) * rp)[:, :, None, None]
            z = (x.float() - mp[:, :, None, None]) * a + shift.expand(8, c)[:, :, None, None]
            flips = (y > 0) != (z > 0)
            kinks += int(flips.sum())
            if bool(flips.any()) and float(z[flips].abs().max()) > KINK * float(z.abs().max()):
                failures.append(f"norm {kind} ({c}, {h}): a side differs away from the kink")
            dyk = dy.masked_fill(flips, 0)
            dx, ds, dh = cn.channel_norm_lrelu_bwd(x, dyk, scale, shift, offset, mean, rstd, SG_ALPHA)
            dxp, dsp, dhp = cn.channel_norm_lrelu_bwd_plain(x, dyk, scale, shift, offset, mean, rstd, SG_ALPHA)
            torch.cuda.synchronize()
            e = {"y": _rel_to_max(y, yp), "dx": _rel_to_max(dx, dxp), "mean": _rel_to_max(mean, mp),
                 "rstd": _rel_to_max(rstd, rp), "dscale": _rel_to_max(ds, dsp), "dshift": _rel_to_max(dh, dhp)}
            if not (y.is_contiguous(memory_format=cl) and dx.is_contiguous(memory_format=cl)):
                failures.append(f"norm {kind} ({c}, {h}): y or dx not channels-last")
            if max(e["y"], e["dx"]) > SG_ROUNDING or max(e["mean"], e["rstd"], e["dscale"], e["dshift"]) > SG_SUMS_REL:
                failures.append(f"norm {kind} ({c}, {h}): errors {e}")
            errs = {k: max(v, errs.get(k, 0.0)) for k, v in e.items()}
        # timed as AdaIN, the generator's decoder norms
        xn, dyn = x.contiguous(), dy.contiguous()
        gamma, beta = 0.5 * randn(8, c), 0.5 * randn(8, c)
        gb, bb = gamma.to(bf), beta.to(bf)
        xr, gr, br = (t.clone().requires_grad_(True) for t in (xn, gb, bb))
        y, mean, rstd = cn.channel_norm_lrelu_fwd(x, gamma, beta, 1.0, SG_ALPHA, 1e-5)

        def plain_fb():
            _, mp, rp = cn.channel_norm_lrelu_plain(x, gamma, beta, 1.0, SG_ALPHA, 1e-5)
            cn.channel_norm_lrelu_bwd_plain(x, dy, gamma, beta, 1.0, mp, rp, SG_ALPHA)

        def library_fb():
            torch.autograd.grad(F.leaky_relu(adain(xr, gr, br), SG_ALPHA), (xr, gr, br), dyn)

        n_el = x.numel()
        row = {"c": c, "h": h, "calls": calls[("norm", c, h)], "bwd_calls": calls[("norm_bwd", c, h)],
               "max_rel_err": errs,
               "ms": time_ms(lambda: cn.channel_norm_lrelu_fwd(x, gamma, beta, 1.0, SG_ALPHA, 1e-5)),
               "bwd_ms": time_ms(lambda: cn.channel_norm_lrelu_bwd(x, dy, gamma, beta, 1.0, mean, rstd, SG_ALPHA)),
               "bound_ms": bound(2 * n_el * 2, 0, "bfloat16")[0], "bwd_bound_ms": bound(3 * n_el * 2, 0, "bfloat16")[0],
               "plain_ms": time_ms(lambda: cn.channel_norm_lrelu_plain(x, gamma, beta, 1.0, SG_ALPHA, 1e-5)),
               "plain_fb_ms": time_ms(plain_fb),
               "library_ms": time_ms(lambda: F.leaky_relu(adain(xn, gb, bb), SG_ALPHA)),
               "library_fb_ms": time_ms(library_fb)}
        norm_rows.append(row)
        log(f"  channel_norm_lrelu bf16 (8, {c}, {h}, {h}) x{row['calls']} fwd / x{row['bwd_calls']} bwd an "
            f"iteration: kernel {row['ms']:.4f} / {row['bwd_ms']:.4f} ms, bound {row['bound_ms']:.4f} / "
            f"{row['bwd_bound_ms']:.4f} ms, plain {row['plain_ms']:.4f} / fwd+bwd {row['plain_fb_ms']:.4f} ms, "
            f"instance_norm + affine + leaky_relu (NCHW) {row['library_ms']:.4f} / fwd+bwd "
            f"{row['library_fb_ms']:.4f} ms; "
            "max rel err " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    log(f"  {kinks} elements at the LeakyReLU's kink took dy 0 in the backward checks")

    resample_rows = []
    for kind, c, h in sorted((k for k in calls if k[0] in ("down2", "up2")), key=lambda k: (k[0], -k[2], k[1])):
        up = kind == "up2"
        x = randn(8, c, h, h).to(bf).contiguous(memory_format=cl)
        xn = x.contiguous()
        err = 0.0
        for s in (0.25, 1.0):  # the forward's scale and the other Function's backward's
            got, want = rs.resample2(x, s, up), rs.resample2_plain(x, s, up)
            torch.cuda.synchronize()
            if not got.is_contiguous(memory_format=cl) or got.shape != want.shape:
                failures.append(f"{kind} ({c}, {h}): shape {tuple(got.shape)} or layout")
            elif up and not torch.equal(got, want):
                failures.append(f"{kind} ({c}, {h}) s {s}: not equal to the plain version")
            elif _rel_to_max(got, want) > SG_ROUNDING:
                failures.append(f"{kind} ({c}, {h}) s {s}: max rel err {_rel_to_max(got, want):.3g}")
            err = max(err, _rel_to_max(got, want))
        s = 1.0 if up else 0.25

        def torch_op(t):
            return F.interpolate(t, scale_factor=2, mode="nearest") if up else F.avg_pool2d(t, 2)

        n_el = x.numel()
        row = {"kind": kind, "c": c, "h": h, "calls": calls[(kind, c, h)], "max_rel_err": err,
               "ms": time_ms(lambda: rs.resample2(x, s, up)),
               "bound_ms": bound(n_el * 2 * (5 if up else 1.25), 0, "bfloat16")[0],
               "plain_ms": time_ms(lambda: rs.resample2_plain(x, s, up)),
               "torch_nhwc_ms": time_ms(lambda: torch_op(x)), "torch_nchw_ms": time_ms(lambda: torch_op(xn))}
        resample_rows.append(row)
        log(f"  resample2 {kind} bf16 (8, {c}, {h}, {h}) x{row['calls']} an iteration: kernel {row['ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, PyTorch NHWC "
            f"{row['torch_nhwc_ms']:.4f} / NCHW {row['torch_nchw_ms']:.4f} ms; max rel err {err:.2e}")

    # the conv epilogue at each (C, H) and form the iteration ran it: its
    # forward (bias; bias and shortcut at 1/sqrt(2); R1's double backward's
    # scale alone) against the plain version and PyTorch's ops of the parent
    # (the bias added to the conv's output in place, (sc + r) / sqrt(2));
    # its backward (db, and s g at 1/sqrt(2)) against the plain version,
    # float64's column sum and aten::sum of the parent's bf16 gradient
    sq = 1.0 / math.sqrt(2.0)
    fwd_forms = {"epilogue_bias": (True, False, 1.0), "epilogue_res": (True, True, sq),
                 "epilogue_scale": (False, False, sq)}
    bwd_forms = {"epilogue_bwd_bias": 1.0, "epilogue_bwd_res": sq}
    epilogue_rows = []
    for c, h in sorted({(c, h) for kind, c, h in calls if kind.startswith("epilogue")}, key=lambda s: (-s[1], s[0])):
        y, sc, g = (randn(8, c, h, h).to(bf).contiguous(memory_format=cl) for _ in range(3))
        b = randn(c)
        bb = b.to(bf).view(1, c, 1, 1)
        n_el = y.numel()
        row = {"c": c, "h": h}
        for kind, (has_b, has_sc, s) in fwd_forms.items():
            if not calls[(kind, c, h)]:
                continue
            bk, sck = (b if has_b else None), (sc if has_sc else None)
            out, want = ce.conv_epilogue_fwd(y, bk, sck, s), ce.conv_epilogue_plain(y, bk, sck, s)
            torch.cuda.synchronize()
            err = _rel_to_max(out, want)
            if not out.is_contiguous(memory_format=cl) or err > SG_ROUNDING:
                failures.append(f"{kind} ({c}, {h}): max rel err {err:.3g} or layout")
            yl = y.clone()

            def library(yl=yl, has_b=has_b, has_sc=has_sc, s=s):
                r = yl.add_(bb) if has_b else yl
                return (sc + r) / math.sqrt(2.0) if has_sc else (r / math.sqrt(2.0) if s != 1.0 else r)

            row[kind] = {"calls": calls[(kind, c, h)], "max_rel_err": err, "equal": bool(torch.equal(out, want)),
                         "ms": time_ms(lambda: ce.conv_epilogue_fwd(y, bk, sck, s)),
                         "bound_ms": bound((2 + has_sc) * n_el * 2, 0, "bfloat16")[0],
                         "plain_ms": time_ms(lambda: ce.conv_epilogue_plain(y, bk, sck, s)),
                         "library_ms": time_ms(library)}
        for kind, s in bwd_forms.items():
            if not calls[(kind, c, h)]:
                continue
            (gs, db), (_, db2) = ce.conv_epilogue_bwd(g, s), ce.conv_epilogue_bwd(g, s)
            gsp, _ = ce.conv_epilogue_bwd_plain(g, s)
            db64 = g.double().sum((0, 2, 3)) * s
            torch.cuda.synchronize()
            err = _rel_to_max(db, db64)
            if not torch.equal(gs, gsp) or err > SG_COLSUM_REL or not torch.equal(db, db2):
                failures.append(f"{kind} ({c}, {h}): s g equal {torch.equal(gs, gsp)}, db max rel err {err:.3g}, "
                                f"db the same bits twice {torch.equal(db, db2)}")
            row[kind] = {"calls": calls[(kind, c, h)], "db_max_rel_err": err,
                         "splits": ce.plan(8 * h * h, c, 8 if c % 8 == 0 else 1, ce._sms(dev)),
                         "ms": time_ms(lambda: ce.conv_epilogue_bwd(g, s)),
                         "bound_ms": bound((1 + (s != 1.0)) * n_el * 2, 0, "bfloat16")[0],
                         "plain_ms": time_ms(lambda: ce.conv_epilogue_bwd_plain(g, s)),
                         "library_ms": time_ms(lambda: (g if s == 1.0 else g / math.sqrt(2.0)).sum((0, 2, 3)).float())}
        epilogue_rows.append(row)
        log(f"  conv_epilogue bf16 (8, {c}, {h}, {h}): " + "; ".join(
            f"{k[9:]} x{v['calls']} kernel {v['ms']:.4f} bound {v['bound_ms']:.4f} plain {v['plain_ms']:.4f} "
            f"PyTorch {v['library_ms']:.4f} ms" for k, v in row.items() if k.startswith("epilogue")))

    def epilogue_sum(key, part):
        # part "": every form; "_fwd": the forward's; "_bwd": the backward's
        return sum(v["calls"] * v[key] for r in epilogue_rows for k, v in r.items()
                   if k.startswith("epilogue") and part != ("_fwd" if k.startswith("epilogue_bwd") else "_bwd"))

    def norm_sum(fwd, bwd, fb=None):
        # a differentiated call runs the forward and the backward (or fb, both)
        return sum((r["calls"] - r["bwd_calls"]) * r[fwd] + r["bwd_calls"] * (r[fb] if fb else r[fwd] + r[bwd])
                   for r in norm_rows)

    per_iteration = {
        "channel_norm_lrelu": {"ms": norm_sum("ms", "bwd_ms"), "bound_ms": norm_sum("bound_ms", "bwd_bound_ms"),
                               "plain_ms": norm_sum("plain_ms", None, "plain_fb_ms"),
                               "library_ms": norm_sum("library_ms", None, "library_fb_ms")},
        "resample2": {k: sum(r["calls"] * r[k] for r in resample_rows)
                      for k in ("ms", "bound_ms", "plain_ms", "torch_nhwc_ms", "torch_nchw_ms")},
        "conv_epilogue": {f"{k}{part}": epilogue_sum(k, part) for k in ("ms", "bound_ms", "plain_ms", "library_ms")
                          for part in ("", "_fwd", "_bwd")},
    }
    log("StarGAN v2 kernels, ms an iteration (their calls at the shapes above): " + json.dumps(per_iteration))
    require(not failures, "StarGAN v2 kernels:\n  " + "\n  ".join(failures))
    return counters, {"launched": launched, "norm": norm_rows, "resample": resample_rows,
                      "epilogue": epilogue_rows, "per_iteration": per_iteration}


def summarize_stargan(counters, record):
    """The kernels' records of phase (o), as :func:`summarize`'s: ms summed
    over one StarGAN v2 iteration's calls at their shapes, bf16."""
    it = record["per_iteration"]
    norm = {"name": "channel_norm_lrelu", "route": "cuda", "source": "littlegan_tpu_torch/csrc/channel_norm_lrelu.cu",
            "replaces": None, "launches": counters["stargan_v2.channel_norm"] + counters["stargan_v2.channel_norm_bwd"],
            "launches_by_path": {"stargan_v2_iteration": {k: counters[k] for k in
                                                          ("stargan_v2.channel_norm", "stargan_v2.channel_norm_bwd")}},
            "max_rel_err": max(max(r["max_rel_err"].values()) for r in record["norm"]),
            **it["channel_norm_lrelu"], "bound_by": "bytes", "per": "StarGAN v2 iteration",
            "shapes": record["norm"]}
    resample = {"name": "resample2", "route": "cuda", "source": "littlegan_tpu_torch/csrc/resample.cu",
                "replaces": None, "launches": counters["stargan_v2.down2"] + counters["stargan_v2.up2"],
                "launches_by_path": {"stargan_v2_iteration": {k: counters[k] for k in
                                                              ("stargan_v2.down2", "stargan_v2.up2")}},
                "max_rel_err": max(r["max_rel_err"] for r in record["resample"]),
                "ms": it["resample2"]["ms"], "bound_ms": it["resample2"]["bound_ms"],
                "plain_ms": it["resample2"]["plain_ms"], "library_ms": it["resample2"]["torch_nhwc_ms"],
                "library_nchw_ms": it["resample2"]["torch_nchw_ms"], "bound_by": "bytes",
                "per": "StarGAN v2 iteration", "shapes": record["resample"]}
    epilogue = {"name": "conv_epilogue", "route": "cuda", "source": "littlegan_tpu_torch/csrc/conv_epilogue.cu",
                "replaces": None,
                "launches": counters["stargan_v2.conv_epilogue"] + counters["stargan_v2.conv_epilogue_bwd"],
                "launches_by_path": {"stargan_v2_iteration": {k: counters[k] for k in (
                    "stargan_v2.conv_epilogue", "stargan_v2.conv_epilogue_bwd")}},
                "max_rel_err": max(v.get("max_rel_err", 0.0) for r in record["epilogue"] for k, v in r.items()
                                   if k.startswith("epilogue")),
                **it["conv_epilogue"], "bound_by": "bytes", "per": "StarGAN v2 iteration",
                "shapes": record["epilogue"]}
    return [norm, resample, epilogue]



# StyleGAN2's FIR resampling (S4) at the shapes of the stylegan2-ffhq-256 cell: (what, (up, down, p0, gain),
# channels, side of the input, dtype) at batch SG2_BATCH, each in the forward form and its adjoint
SG2_BATCH = 64
SG2_CH = {r: min(16384 // r, 512) for r in (4, 8, 16, 32, 64, 128, 256)}
SG2_FIR = ([("G conv0", (1, 1, 1, 1, 4.0), SG2_CH[r], 2 * r + 1, "bfloat16") for r in (8, 16, 32, 64, 128, 256)]
           + [("G image", (2, 1, 2, 1, 4.0), 3, r // 2, "float32") for r in (8, 16, 32, 64, 128, 256)]
           + [("D conv1", (1, 1, 2, 2, 1.0), SG2_CH[r], r, "bfloat16") for r in (256, 128, 64, 32, 16, 8)]
           + [("D skip", (1, 2, 1, 1, 1.0), SG2_CH[r], r, "bfloat16") for r in (256, 128, 64, 32, 16, 8)])
SG2_ROUNDING = 2.0 ** -8  # bf16: one rounding of the f32 sum, relative to the largest output
SG2_F32_REL = 1e-5  # f32: sums of 16 terms in another order


def check_stylegan2():
    """Phase (p): S4 (``ops/cuda/upfirdn2d.py``) against its plain version
    at every shape of the StyleGAN2 cell's iteration (batch 64, channels-last;
    the image in float32, the maps in bf16), forward form and adjoint, with
    its time (graph replays), its bound (input and output bytes at 3.35
    TB/s), the plain version's and a ``F.conv2d`` depthwise conv's over the
    same padded map (the library yardstick). Returns the rows; raises on a
    miss."""
    import torch
    import torch.nn.functional as F

    from littlegan_tpu_torch.ops.cuda import upfirdn2d as fir

    dev = torch.device("cuda", 0)
    rows, failures = [], []
    for what, (up, down, p0, p1, gain), c, h, dtype in SG2_FIR:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(c * 1000 + h)
        x = torch.randn((SG2_BATCH, c, h, h), generator=gen, device=dev).to(dt).contiguous(
            memory_format=torch.channels_last)
        oh = fir.out_size(h, up, down, p0, p1)
        for form, (u, d, q, n_in, n_out) in (("fwd", (up, down, p0, h, oh)), ("adj", (down, up, 3 - p0, oh, h))):
            xi = x if form == "fwd" else torch.randn((SG2_BATCH, c, n_in, n_in), generator=gen, device=dev).to(
                dt).contiguous(memory_format=torch.channels_last)
            got = fir.upfirdn2d_kernel(xi, u, d, q, n_out, n_out, gain)
            want = fir.upfirdn2d_plain(xi, u, d, q, n_out, n_out, gain)
            torch.cuda.synchronize(dev)
            scale = float(want.float().abs().max())
            err = _max_err(got, want) / max(scale, 1e-30)
            tol = SG2_ROUNDING if dt == torch.bfloat16 else SG2_F32_REL
            if not err <= tol:
                failures.append(f"{what} {form} C {c} H {h} {dtype}: error {err:.3g} > {tol:.3g}")
            nbytes = (xi.numel() + got.numel()) * xi.element_size()
            taps = 4 if u == 2 else 16
            b_ms, _ = bound(nbytes, 2.0 * taps * got.numel(), "bfloat16")
            k_ms = time_ms(lambda: fir.upfirdn2d_kernel(xi, u, d, q, n_out, n_out, gain))
            p_ms = time_ms(lambda: fir.upfirdn2d_plain(xi, u, d, q, n_out, n_out, gain), reps=5)
            xz = xi
            if u == 2:
                xz = torch.zeros((SG2_BATCH, c, 2 * n_in, 2 * n_in), dtype=dt, device=dev).contiguous(
                    memory_format=torch.channels_last)
                xz[:, :, ::2, ::2] = xi
            pad = (n_out - 1) * d + 4 - xz.shape[2] - q
            xp = F.pad(xz, [q, pad, q, pad]).contiguous(memory_format=torch.channels_last)
            f = torch.tensor([1.0, 3.0, 3.0, 1.0], device=dev) / 8
            wf = (f[:, None] * f[None, :] * gain).to(dt).expand(c, 1, 4, 4).contiguous()
            l_ms = time_ms(lambda: F.conv2d(xp, wf, stride=d, groups=c), reps=5)
            rows.append({"what": what, "form": form, "C": c, "H_in": n_in, "H_out": n_out, "dtype": dtype,
                         "kernel_ms": k_ms, "bound_ms": b_ms, "share": b_ms / k_ms, "plain_ms": p_ms,
                         "conv2d_ms": l_ms, "max_rel_err": err})
            log(f"  S4 {what} {form} C {c} H {n_in}->{n_out} {dtype}: {k_ms:.4f} ms, bound {b_ms:.4f} "
                f"({100 * b_ms / k_ms:.0f}%), plain {p_ms:.4f}, F.conv2d {l_ms:.4f}, error {err:.2g}")
            del xi, got, want, xz, xp
        del x
        torch.cuda.empty_cache()
    require(not failures, "; ".join(failures))
    return rows


# S5's launches in one lazy period of the stylegan2-ffhq-256 cell (16 iterations; a G pass runs 20 epilogues,
# 13 modulated layers and 7 ToRGBs, a D pass 14): every iteration 2 G and 3 D passes forward, 1 G and 3 D
# backward; path length (4 of 16) one G pass and its backward, 13 backwards more and 13 second orders (ToRGB's
# 7 have no output and launch nothing) in its double backward; R1 (1 of 16) one D pass and its backward, 13
# backwards more and 14 second orders (tests/test_torch_stylegan2_bias_act.py counts the calls on the CPU)
SG2_S5_LAUNCHES = {"stylegan2.bias_act": 16 * 82 + 4 * 20 + 14, "stylegan2.bias_act_bwd": 16 * 62 + 4 * 33 + 27,
                   "stylegan2.bias_act_bwd2": 4 * 13 + 14}
SG2_S5_KERNEL_OF = {"stylegan2.bias_act": "bias_act_kernel", "stylegan2.bias_act_bwd": "bias_act_bwd_kernel",
                    "stylegan2.bias_act_bwd2": "bias_act_bwd2_kernel"}
SG2_S5_SUM_REL = 1e-5  # f32 sums in another order, relative to the sum of the terms' magnitudes
SG2_S3_KERNELS = {"epilogue_kernel", "epilogue_colsum_kernel", "epilogue_colsum_total_kernel"}


def _sg2_period_calls():
    """One lazy period of the benchmark's StyleGAN2 configuration (16 eager
    iterations after one that meets every first use), with S5's three
    kernel wrappers recording each call's (kind, dtype, C, H, d, noise,
    slopes, wanted outputs) and the ``stylegan2.bias_act*`` launch counters
    reset just before; then one profiled iteration with both penalties.
    Returns (counters over the period, calls, the kernels the profile saw
    launched by name, the counters over the profiled iteration)."""
    import collections
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from littlegan_tpu_torch.config import Config
    from littlegan_tpu_torch.models import stylegan2 as sm
    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.ops.cuda import bias_act as ba
    from littlegan_tpu_torch.training import stylegan2 as ts
    from littlegan_tpu_torch.training.state import create_stylegan2_state

    dev = torch.device("cuda")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark", "configs",
                           "stylegan2-ffhq-256.json")) as f:
        published = json.load(f)
    fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in published.items() if k in fields}).replace(device_data=True)
    state = create_stylegan2_state(cfg, dev, sm.init_params(sm.StyleGAN2(cfg), 0))
    gen = torch.Generator(device=dev).manual_seed(1)
    n_store = 2 * cfg.batch_size
    images = torch.randint(0, 256, (n_store, cfg.image_dim, cfg.image_dim, 3), dtype=torch.uint8, device=dev,
                           generator=gen)

    def period(it0, n):
        draws = ts.stack_draws([ts.draw_iteration(gen, cfg, dev, i, n_store) for i in range(it0, it0 + n)])
        return ts.eager_iterations(state, cfg, images, draws, it0)

    period(0, 1)
    torch.cuda.synchronize()
    calls = collections.Counter()
    kept = {name: getattr(ba, name) for name in ("bias_act_kernel", "bias_act_bwd_kernel", "bias_act_bwd2_kernel")}

    def spy(name):
        fn = kept[name]

        def call(*a):
            if name == "bias_act_kernel":
                y, d, noise, _, _, k = a
                wants = ()
            elif name == "bias_act_bwd_kernel":
                _, y, d, noise, _, _, k, *wants = a
            else:
                _, y, d, noise, _, _, k, ggy, ggd, ggb, ggns, *wants = a
                wants = (ggy is not None, ggd is not None, ggb is not None, ggns is not None, *wants)
            calls[(name, str(y.dtype).split(".")[-1], y.shape[1], y.shape[2], d is not None, noise is not None,
                   tuple(k), tuple(bool(w) for w in wants))] += 1
            return fn(*a)
        return call

    for name in kept:
        setattr(ba, name, spy(name))
    try:
        for name in SG2_S5_LAUNCHES:
            _build.COUNTERS[name].reset()
        s3 = {n: _build.COUNTERS[n].value for n in ("stargan_v2.conv_epilogue", "stargan_v2.conv_epilogue_bwd")}
        terms = period(16, 16)
        torch.cuda.synchronize()
        counters = {name: _build.COUNTERS[name].value for name in SG2_S5_LAUNCHES}
        counters.update({n: _build.COUNTERS[n].value - v for n, v in s3.items()})
    finally:
        for name, fn in kept.items():
            setattr(ba, name, fn)
    require(bool(torch.isfinite(terms).all()), "S5 period: a loss term is not finite")
    for name in SG2_S5_LAUNCHES:
        _build.COUNTERS[name].reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        period(32, 1)
        torch.cuda.synchronize()
    profiled = {name: _build.COUNTERS[name].value for name in SG2_S5_LAUNCHES}
    launched = collections.Counter()
    for e in device_events(prof):
        m = re.search(r"::(\w+)[<(]", e.key)
        if m is not None:
            launched[m.group(1)] += e.count
    del state, images
    torch.cuda.empty_cache()
    return counters, calls, dict(launched), profiled


def _s5_composite(y, d, noise, ns, b, k, act):
    """The model's epilogue before S5, forward and backward, as the ops it
    ran (``y * d``, the noise's add, S3's bias, ``leaky_relu``, the gain,
    ``clamp``; their backwards as autograd ran them): (forward, backward)
    callables of g for the library yardstick."""
    import torch
    import torch.nn.functional as F

    from littlegan_tpu_torch.ops.cuda import conv_epilogue as ce

    dt = y.dtype
    cl = torch.channels_last
    x = y
    if d is not None:
        x = (y * d.to(dt)[:, :, None, None] + (noise.float() * ns).to(dt)).contiguous(memory_format=cl)
    pre = ce.conv_epilogue_fwd(x, b, None, 1.0)
    a = F.leaky_relu(pre, 0.2) if act else pre
    v = a * k.gain
    c = k.bound

    def fwd():
        x = y
        if d is not None:
            x = (y * d.to(dt)[:, :, None, None] + (noise.float() * ns).to(dt)).contiguous(memory_format=cl)
        z = ce.conv_epilogue_fwd(x, b, None, 1.0)
        z = (F.leaky_relu(z, 0.2) if act else z) * k.gain
        return z.clamp(-c, c)

    def bwd(g):
        g = torch.where((v >= -c) & (v <= c), g, 0)
        g = g * k.gain
        if act:
            g = torch.where(a > 0, g, g * 0.2)
        g, db = ce.conv_epilogue_bwd(g, 1.0)
        if d is None:
            return g, db
        gns = (g.float() * noise.float()).sum()
        return g * d.to(dt)[:, :, None, None], (g * y).sum((2, 3), dtype=torch.float32), db, gns

    return fwd, bwd


def _s5_magnitudes(name, args):
    """Per output of an S5 kernel call: None for a map, else the sum of its
    terms' magnitudes (the scale of a sum's rounding)."""
    from littlegan_tpu_torch.ops.cuda import bias_act as ba

    if name == "bias_act_kernel":
        return [None]
    g, y, d, noise, ns, b, k = args[:7]
    gp = (g.float() * ba._slope_kept(y, d, noise, ns, b, k)[1]).abs()
    if name == "bias_act_bwd_kernel":
        return [None, None if d is None else (gp * y.float().abs()).sum((2, 3)), gp.sum((0, 2, 3)),
                None if noise is None else (gp * noise.float().abs()).sum()]
    ggy = args[7]
    return [None, None, None if ggy is None or d is None else (gp * ggy.float().abs()).sum((2, 3))]


def check_stylegan2_bias_act():
    """Phase (q): S5 as the StyleGAN2 cell's iteration runs it. Returns
    (counters per period, kernels launched in one iteration, the per-shape
    rows, the sums over an iteration); raises on a miss."""
    import torch

    from littlegan_tpu_torch.ops.cuda import bias_act as ba

    counters, calls, launched, profiled = _sg2_period_calls()
    log("S5 launch counters over one 16-iteration period: " + json.dumps(counters))
    log("kernels launched in one iteration with both penalties: " + json.dumps(
        {k: v for k, v in launched.items() if "bias_act" in k or "epilogue" in k}) + "; S5's counters there: "
        + json.dumps(profiled))
    require(all(counters[n] == SG2_S5_LAUNCHES[n] for n in SG2_S5_LAUNCHES),
            f"S5 launches a period {counters}, want {SG2_S5_LAUNCHES}")
    require(all(profiled[n] == launched.get(kern, 0) for n, kern in SG2_S5_KERNEL_OF.items()),
            f"S5's counters {profiled} against the kernels the profile saw launched {launched}")
    require(counters["stargan_v2.conv_epilogue"] == counters["stargan_v2.conv_epilogue_bwd"] == 0,
            "StyleGAN2's iteration called S3")
    require(all(launched.get(n, 0) > 0 for n in ("bias_act_kernel", "bias_act_bwd_kernel", "bias_act_bwd2_kernel",
                                                  "bias_act_total_kernel"))
            and not set(launched) & SG2_S3_KERNELS, f"kernels launched: {launched}")
    dev = torch.device("cuda", 0)
    rows, failures = [], []
    total = dict.fromkeys(("kernel_ms", "bound_ms", "plain_ms", "pytorch_ms"), 0.0)
    for (name, dtype, c, h, has_d, has_noise, kk, wants), count in sorted(calls.items(), key=lambda kv: str(kv[0])):
        dt = getattr(torch, dtype)
        k = ba.Slopes(*kk)
        act = k.gain != k.again
        gen = torch.Generator(device=dev).manual_seed(c * 1000 + h)
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
        y = (rnd(SG2_BATCH, c, h, h) * 60).to(dt).contiguous(memory_format=torch.channels_last)
        g = rnd(SG2_BATCH, c, h, h).to(dt).contiguous(memory_format=torch.channels_last)
        d = rnd(SG2_BATCH, c).abs() + 0.5 if has_d else None
        noise = rnd(SG2_BATCH, 1, h, h).to(dt) if has_noise else None
        ns = rnd().abs() if has_noise else None
        b = rnd(c) * 0.3
        esize = y.element_size()
        if name == "bias_act_kernel":
            args = (y, d, noise, ns, b, k)
            kern, plain = (lambda: ba.bias_act_kernel(*args)), (lambda: ba.bias_act_plain(*args))
            maps_read, maps_written = 1, 1
            lib_fwd, _ = _s5_composite(y, d, noise, ns, b, k, act)
            lib = lib_fwd
        elif name == "bias_act_bwd_kernel":
            args = (g, y, d, noise, ns, b, k, *wants)
            kern, plain = (lambda: ba.bias_act_bwd_kernel(*args)), (lambda: ba.bias_act_bwd_plain(*args))
            maps_read, maps_written = 2, 1
            _, lib_bwd = _s5_composite(y, d, noise, ns, b, k, act)
            lib = lambda: lib_bwd(g)  # noqa: E731
        else:
            has_ggy, has_ggd, has_ggb, has_ggns, *want = wants
            ggy = rnd(SG2_BATCH, c, h, h).to(dt).contiguous(memory_format=torch.channels_last) if has_ggy else None
            ggd = rnd(SG2_BATCH, c) if has_ggd else None
            ggb = rnd(c) if has_ggb else None
            ggns = rnd() if has_ggns else None
            args = (g, y, d, noise, ns, b, k, ggy, ggd, ggb, ggns, *want)
            kern, plain = (lambda: ba.bias_act_bwd2_kernel(*args)), (lambda: ba.bias_act_bwd2_plain(*args))
            outs = kern()
            if all(o is None for o in outs):  # nothing reaches g, y or d (ToRGB's in path length): no launch
                log(f"  S5 bias_act_bwd2 C {c} H {h} {dtype} x{count / 16.0:g}/it: no output wanted, no launch")
                rows.append({"what": "bias_act_bwd2", "dtype": dtype, "C": c, "H": h, "wants": list(wants),
                             "per_iteration": count / 16.0, "launched": False})
                continue
            maps_read, maps_written = 2 + int(has_ggy), sum(o is not None for o in outs[:2])
            lib = None
        got, want = kern(), plain()
        torch.cuda.synchronize(dev)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        mags = _s5_magnitudes(name, args)
        err = 0.0
        for i, (a, r, m) in enumerate(zip(got, want, mags)):
            if (a is None) != (r is None):
                failures.append(f"{name} C {c} H {h}: output {i} present in one version only")
                continue
            if a is None:
                continue
            if a.dim() == 4:  # a map: one rounding of each element
                tol = SG2_ROUNDING if dt == torch.bfloat16 else 2.0 ** -23
                e = float(((a.float() - r.float()).abs() / r.float().abs().clamp_min(1e-30)).max())
                bad = bool(((a.float() - r.float()).abs() > tol * r.float().abs()).any())
            else:  # a sum: against the sum of its terms' magnitudes
                e = float(((a - r).abs() / m.clamp_min(1e-30)).max())
                bad = bool(((a - r).abs() > SG2_S5_SUM_REL * m).any())
            err = max(err, e)
            if bad:
                failures.append(f"{name} C {c} H {h} {dtype} output {i}: error {e:.3g}")
        per = count / 16.0
        nbytes = (maps_read + maps_written) * y.numel() * esize + (noise.numel() * esize if has_noise else 0)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        k_ms = time_ms(kern)
        p_ms = time_ms(plain, reps=5)
        l_ms = time_ms(lib, reps=5) if lib is not None else None
        row = {"what": name.replace("_kernel", ""), "dtype": dtype, "C": c, "H": h, "d": has_d, "noise": has_noise,
               "act": act, "wants": list(wants), "per_iteration": per, "kernel_ms": k_ms, "bound_ms": b_ms,
               "share": b_ms / k_ms, "plain_ms": p_ms, "pytorch_ms": l_ms, "max_rel_err": err}
        rows.append(row)
        total["kernel_ms"] += per * k_ms
        total["bound_ms"] += per * b_ms
        total["plain_ms"] += per * p_ms
        total["pytorch_ms"] += per * (l_ms or 0.0)
        log(f"  S5 {row['what']} C {c} H {h} {dtype} d {int(has_d)} act {int(act)} x{per:g}/it: {k_ms:.4f} ms, "
            f"bound {b_ms:.4f} ({100 * b_ms / k_ms:.0f}%), plain {p_ms:.4f}, "
            f"PyTorch {'-' if l_ms is None else f'{l_ms:.4f}'}, error {err:.2g}")
        del y, g, d, noise, args, got, want
        torch.cuda.empty_cache()
    log("S5 over an iteration (ms): " + json.dumps(total))
    require(not failures, "; ".join(failures[:10]))
    return counters, launched, rows, total


# phase (r): StyleGAN3's filtered LeakyReLU (S6) at every filtered layer of
# the stylegan3-t-afhqv2-512 cell (batch 32, bf16, channels-last); the plain
# version recomputes SG3_CHECKED samples of the batch
SG3_BATCH = 32
SG3_CHECKED = (0, 31)
SG3_ROUNDING = 2.0 ** -7  # bf16 outputs: a rounding of f32 sums in another order (see _rounding_err)
SG3_SUM_REL = 1e-3  # the f32 column sums, in another order, relative to the largest
SG3_LAUNCHES = {  # a 16-iteration period: 14 filtered layers in Gmain's and Dmain's G passes, Gmain's backward
    "stylegan3.filtered_lrelu": 16 * 2 * 14, "stylegan3.filtered_lrelu_bwd": 16 * 14,
    "stylegan3.mapping": 16 * 2, "stylegan3.synthesis": 16 * 2, "stylegan3.discriminator": 16 * 3 + 1,
    "stylegan3.r1": 1,
}
SG3_MASK_DIFFER = 1e-4  # the share of mask bits the two versions may set apart (a sum within rounding of 0 or the clamp)


def _rounding_err(got, want, groups) -> float:
    """The largest ``|got - want| / (|want| + rms(want))`` over each group
    of channels (dim 1) on its own: a bf16 rounding of either reads at
    most ``2 ** -7``, and a group of small values is not measured against
    a group that clamps at 256."""
    worst = 0.0
    for idx in groups:
        g, w = got[:, idx].float(), want[:, idx].float()
        rms = float(w.square().mean().sqrt())
        worst = max(worst, float(((g - w).abs() / (w.abs() + max(rms, 1e-30))).max()))
    return worst


def _sg3_period_counters():
    """One lazy period of the benchmark's StyleGAN3 configuration (16 eager
    iterations after one that meets every first use) over a 64-image
    store: the ``stylegan3.*`` launch counters' moves over the period."""
    import dataclasses

    import torch

    from littlegan_tpu_torch.config import Config
    from littlegan_tpu_torch.models import stylegan3 as m3
    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.training import stylegan2 as ts
    from littlegan_tpu_torch.training.state import create_stylegan2_state

    dev = torch.device("cuda")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark", "configs",
                           "stylegan3-t-afhqv2-512.json")) as f:
        published = json.load(f)
    fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in published.items() if k in fields}).replace(device_data=True)
    state = create_stylegan2_state(cfg, dev, m3.init_params(m3.StyleGAN3(cfg), 0))
    gen = torch.Generator(device=dev).manual_seed(1)
    n_store = 2 * cfg.batch_size
    images = torch.randint(0, 256, (n_store, cfg.image_dim, cfg.image_dim, 3), dtype=torch.uint8, device=dev,
                           generator=gen)

    def period(it0, n):
        draws = ts.stack_draws([ts.draw_iteration(gen, cfg, dev, i, n_store) for i in range(it0, it0 + n)])
        return ts.eager_iterations(state, cfg, images, draws, it0)

    period(0, 1)
    torch.cuda.synchronize()
    before = _build.launch_counts()
    terms = period(cfg.d_reg_interval, cfg.d_reg_interval)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    require(bool(torch.isfinite(terms).all()), f"StyleGAN3's period gave terms {terms}")
    del state, images
    torch.cuda.empty_cache()
    return {n: after[n] - before.get(n, 0) for n in after if n.startswith("stylegan3.")}


def check_stylegan3():
    """Phase (r): S6's launches over one lazy period of the StyleGAN3
    cell's training (``SG3_LAUNCHES``), then S6 (``ops/cuda/filtered_lrelu.py``)
    against its plain version at every filtered layer of the cell's
    synthesis (batch 32, bf16, channels-last; a tenth of the channels
    large enough for the clamp to cut, held to the plain version apart
    from the rest: ``_rounding_err``), forward and backward (gy, d's and
    b's gradients), with its times (graph replays) beside its bound
    (``benchmark/roofline/stylegan3.py``) and the sums over an iteration
    (two forwards and a backward a layer). Returns (counters over the
    period, rows, sums); raises on a miss."""
    import torch

    from benchmark.roofline import stylegan3 as roof
    from littlegan_tpu_torch.models.stylegan3 import schedule
    from littlegan_tpu_torch.ops.cuda import filtered_lrelu as fl

    counters = _sg3_period_counters()
    log("StyleGAN3 launch counters over one 16-iteration period: " + json.dumps(counters))
    require(all(counters.get(n, 0) == want for n, want in SG3_LAUNCHES.items()),
            f"StyleGAN3's launches a period {counters}, want {SG3_LAUNCHES}")
    dev = torch.device("cuda", 0)
    cl = torch.channels_last
    cells = {x["name"]: x for x in roof.layers({"image_dim": 512, "channel_base": 32768, "channel_max": 512})}
    rows, failures = [], []
    total = dict.fromkeys(("fwd_ms", "bwd_ms", "fwd_bound_ms", "bwd_bound_ms"), 0.0)
    sub = list(SG3_CHECKED)
    for layer in schedule(512, 32768, 512)[1][:-1]:
        hc, c = layer.in_size + 2, layer.cout
        lo, hi = layer.padding
        spec = fl.make_spec(hc, hc, layer.up_filter, layer.down_filter, layer.up, layer.down, (lo, hi, lo, hi),
                            math.sqrt(2.0), 0.2, 256.0)
        gen = torch.Generator(device=dev).manual_seed(c * 1000 + hc)
        scale = torch.ones(c, device=dev)
        scale[::10] = 100.0  # every tenth channel meets the clamp
        groups = ((torch.arange(c) % 10 != 0).nonzero().squeeze(1), torch.arange(0, c, 10))
        y = (torch.randn((SG3_BATCH, c, hc, hc), generator=gen, device=dev) * 3 * scale[:, None, None]).to(
            torch.bfloat16).contiguous(memory_format=cl)
        b = torch.randn((c,), generator=gen, device=dev) * 0.2
        d = torch.rand((SG3_BATCH, c), generator=gen, device=dev) + 0.5
        fu = torch.tensor(layer.up_filter, device=dev)
        fd = torch.tensor(layer.down_filter, device=dev)
        out, mask = fl.forward_kernel(y, b, d, spec)
        g = torch.randn(out.shape, generator=gen, device=dev).to(torch.bfloat16).contiguous(memory_format=cl)
        ys, ds, gs = y[sub].contiguous(memory_format=cl), d[sub].contiguous(), g[sub].contiguous(memory_format=cl)
        want, masks = fl.forward_plain(ys, b, ds, fu, fd, spec)
        kmask = fl.unpack_mask(mask[sub], c)  # the backwards both read the kernel's decisions
        differ = float(((kmask[0] != masks[0]) | (kmask[1] != masks[1])).float().mean())
        got_b = fl.backward_kernel(gs, mask[sub].contiguous(), ys, ds, spec, (ys.shape, ys.dtype))
        want_b = fl.backward_plain(gs, kmask, ys, ds, fu, fd, spec, True)
        torch.cuda.synchronize(dev)
        errs = {"out": _rounding_err(out[sub], want, groups), "gy": _rounding_err(got_b[0], want_b[0], groups)}
        for name, a, r in zip(("gd", "gb"), got_b[1:], want_b[1:]):
            errs[name] = _max_err(a, r) / max(float(r.float().abs().max()), 1e-30)
        cut = float(masks[1].float().mean())
        if differ > SG3_MASK_DIFFER:
            failures.append(f"{layer.name}: the kernel's mask differs from the plain version's at {differ:.3g}")
        for name, e in errs.items():
            tol = SG3_ROUNDING if name in ("out", "gy") else SG3_SUM_REL
            if not e <= tol:
                failures.append(f"{layer.name} {name}: error {e:.3g} > {tol:g}")
        del want, masks, got_b, want_b
        shape = (y.shape, y.dtype)
        f_ms = time_ms(lambda: fl.forward_kernel(y, b, d, spec), reps=5)
        b_ms = time_ms(lambda: fl.backward_kernel(g, mask, y, d, spec, shape), reps=5)
        cost = cells[layer.name]
        f_bound = roof.launch_bound_s(cost, SG3_BATCH, "bfloat16", False) * 1e3
        b_bound = roof.launch_bound_s(cost, SG3_BATCH, "bfloat16", True) * 1e3
        row = {"layer": layer.name, "C": c, "Hc": hc, "T": cost["T"], "O": layer.out_size, "up": layer.up,
               "fwd_ms": f_ms, "fwd_bound_ms": f_bound, "bwd_ms": b_ms, "bwd_bound_ms": b_bound,
               "clamped_share": cut, "mask_differs": differ, "max_rel_err": errs}
        rows.append(row)
        total["fwd_ms"] += 2 * f_ms
        total["bwd_ms"] += b_ms
        total["fwd_bound_ms"] += 2 * f_bound
        total["bwd_bound_ms"] += b_bound
        log(f"  S6 {layer.name} C {c} {hc}->{cost['T']}->{layer.out_size} up {layer.up}: fwd {f_ms:.3f} ms "
            f"(bound {f_bound:.3f}, {100 * f_bound / f_ms:.0f}%), bwd {b_ms:.3f} ms (bound {b_bound:.3f}, "
            f"{100 * b_bound / b_ms:.0f}%), mask bits apart {differ:.2g}, errors "
            + ", ".join(f"{k} {v:.2g}" for k, v in errs.items()))
        del y, out, mask, g, ys, gs
        torch.cuda.empty_cache()
    total["share"] = (total["fwd_bound_ms"] + total["bwd_bound_ms"]) / (total["fwd_ms"] + total["bwd_ms"])
    log("S6 over an iteration (ms): " + json.dumps(total))
    require(not failures, "; ".join(failures[:10]))
    return counters, rows, total


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def summarize(records, serve_launches, train_launches, dispatch_launches, eval_launches, remat_launches,
              s2d_launches, dp_launches, compat_launches, spatial_launches, parity_launches, coverage, tools,
              entry_launches):
    """One JSON record per kernel, bf16 (the working dtype): summed over the
    launches of one train step where phase (b) timed the train shapes, else
    over the shapes one /adjust call gives it ("per" says which; a kernel
    timed on both paths adds the /adjust sums as "serve_ms",
    "serve_plain_ms", "serve_bound_ms"); per-shape numbers under "shapes".
    "launches" counts the ten paths' runs (serve, host-fed train,
    CUDA-graph dispatch, evaluate-sample, the remat steps, the s2d-store
    replay, phase (h)'s data-parallel runs, phase (i)'s resumed runs,
    phase (j)'s spatial runs, where every kernel is off and reads 0, and
    phase (k)'s: the orbax and npz runs, ``--measure``'s update, the
    doctor's step and the conditioning check; phase (l)'s doctor step at
    block1 width 6; phase (m)'s ``bench`` timed windows and
    campaign; phase (n)'s dry run and step variants), split in
    "launches_by_path". Phase (l)'s rows, the
    kernel at the shapes the reference's widths do not reach, are under
    "coverage"."""
    coverage_launches, coverage_record = coverage
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
                   "remat": remat_launches.get(name, 0), "s2d_store": s2d_launches.get(name, 0),
                   "dp": dp_launches.get(name, 0), "compat": compat_launches.get(name, 0),
                   "spatial": spatial_launches.get(name, 0), "parity": parity_launches.get(name, 0),
                   "coverage": coverage_launches.get(name, 0), "bench": tools["bench"].get(name, 0),
                   "campaign": tools["campaign"].get(name, 0), "entry": entry_launches.get(name, 0)}
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
        entry["coverage"] = [{k: r[k] for k in ("shape", "dtype", "ms", "bound_ms", "max_abs_err")}
                             for r in coverage_record["rows"] if r["kernel"] == name]
        out.append(entry)
    return out


def main() -> int:
    import torch

    if len(sys.argv) == 5 and sys.argv[1] == "--dp-rank":  # a rank of phase (h) (ii), started by phase (h)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return dp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if len(sys.argv) == 5 and sys.argv[1] == "--sp-rank":  # a rank of phase (j), started by phase (j)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return sp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if len(sys.argv) == 5 and sys.argv[1] == "--c2-rank":  # a rank of phase (k)'s C2 check, started by phase (k)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return c2_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.scripts.trace_top_ops import kernel_name

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
                log(f"  {kernel_name(entry.group(1))}")
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
    walls["g"], t0 = time.time() - t0, time.time()
    dp_launches, dp = check_data_parallel()
    log("data-parallel record: " + json.dumps(dp))
    walls["h"], t0 = time.time() - t0, time.time()
    compat_launches, compat = check_compat()
    log("compat record: " + json.dumps(compat))
    walls["i"], t0 = time.time() - t0, time.time()
    spatial_launches, spatial = check_spatial()
    log("spatial record: " + json.dumps(spatial))
    walls["j"], t0 = time.time() - t0, time.time()
    parity_launches, parity = check_parity()
    log("parity record: " + json.dumps(parity))
    walls["k"], t0 = time.time() - t0, time.time()
    coverage = check_coverage()
    walls["l"], t0 = time.time() - t0, time.time()
    tools_launches, tools = check_tools()
    log("tools record: " + json.dumps(tools))
    walls["m"], t0 = time.time() - t0, time.time()
    entry_launches, entry = check_entry_points(records, PROFILE_TRACE_COPY)
    log("entry points record: " + json.dumps(entry))
    walls["n"], t0 = time.time() - t0, time.time()
    stargan_calls, stargan = check_stargan_v2()
    walls["o"], t0 = time.time() - t0, time.time()
    stylegan2 = check_stylegan2()
    walls["p"], t0 = time.time() - t0, time.time()
    s5_counters, _, s5_rows, s5_total = check_stylegan2_bias_act()
    walls["q"], t0 = time.time() - t0, time.time()
    s6_counters, s6_rows, s6_total = check_stylegan3()
    walls["r"] = time.time() - t0
    log("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    log(json.dumps({"kernels": summarize(records, serve_launches, train_launches, dispatch_launches,
                                         eval_launches, remat_launches, s2d_launches, dp_launches,
                                         compat_launches, spatial_launches, parity_launches, coverage,
                                         tools_launches, entry_launches)
                                 + summarize_stargan(stargan_calls, stargan)
                                 + [{"kernel": "upfirdn2d", "per": "S4 launch at the StyleGAN2 cell's shapes",
                                     "shapes": stylegan2},
                                    {"kernel": "bias_act", "per": "S5 call at the StyleGAN2 cell's shapes",
                                     "counters_per_period": s5_counters, "iteration_ms": s5_total,
                                     "shapes": s5_rows},
                                    {"kernel": "filtered_lrelu", "per": "S6 launch at the StyleGAN3 cell's layers",
                                     "counters_per_period": s6_counters, "iteration_ms": s6_total,
                                     "shapes": s6_rows}]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
