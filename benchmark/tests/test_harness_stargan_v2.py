"""The StarGAN v2 cell's pieces on the CPU: its three per-layer readers on
synthetic readings and a synthetic trace, the span reader of the driver,
the driver's change numbers on synthetic states, the reference's
operation count at the published size beside its parameter counts, the
driver once at a tiny size through ``benchmark/run.py``'s ``execute``,
and its check against the planted faults."""

from __future__ import annotations

import math

import pytest

from benchmark import harness
from benchmark import trace as tr
from benchmark.reference import stargan_v2 as ref
from conftest import run_cpu, tiny_cell

CELL = "stargan-v2-afhq-256.train-graph"
SG_TINY = {"batch_size": 4, "image_dim": 32, "base_dim": 8, "max_conv_dim": 32, "mapping_dim": 32, "style_dim": 16,
           "latent_dim": 8, "compute_dtype": "float32"}
TRAFFIC_TINY = {"k": 2, "store_images": 40, "domain_counts": [14, 13, 13], "trace_dispatches": 1,
                "check_replays": 2}


def _read(name, r):
    return harness.load_module("metrics", name).read(r)


def _trace():
    k = lambda name, ts, dur, cat="kernel": {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}  # noqa: E731
    return tr.Trace([
        {"ph": "X", "cat": "user_annotation", "name": "bench:traced_window", "ts": 0.0, "dur": 100.0},
        k("void at::native::batch_norm_collect_statistics_kernel<at::native::Var, c10::BFloat16>", 0.0, 4.0),
        k("void at::native::batch_norm_backward_kernel<c10::BFloat16>", 10.0, 6.0),
        k("(anonymous namespace)::cluster_kernel<__nv_bfloat16, false>(__nv_bfloat16 const*, float*)", 20.0, 2.0),
        k("sm90_xmma_fprop_implicit_gemm_bf16_cudnn", 30.0, 50.0),
        k("void at::native::vectorized_elementwise_kernel<leaky_relu_kernel>", 90.0, 5.0),
    ])


def test_norm_reader_counts_batch_norm_and_the_norm_kernels():
    r = {"kind": "train", "trace": _trace(), "traced_updates": 2}
    # batch_norm kernels 4 + 6 us and the K1 cluster kernel 2 us, over 2 iterations
    assert _read("norm_ms_per_update.stargan_v2", r) == pytest.approx(1e3 * 12e-6 / 2)
    assert _read("norm_ms_per_update.stargan_v2", {**r, "trace": None}) is None
    assert _read("norm_ms_per_update.stargan_v2", {**r, "trace": tr.Trace([])}) is None


def test_r1_reader_and_step_mfu():
    r = {"kind": "train", "span_device_ms": {"stargan_v2.r1": 6.0, "stargan_v2.d_latent": 40.0}, "span_iterations": 2}
    assert _read("r1_ms_per_update.stargan_v2", r) == 3.0
    assert _read("r1_ms_per_update.stargan_v2", {"kind": "train"}) is None  # the parent's readings: nothing
    cfg = {"model": "stargan_v2", "batch_size": 8, "image_dim": 256, "num_domains": 3, "latent_dim": 16,
           "style_dim": 64, "mapping_dim": 512, "max_conv_dim": 512}
    r = {"kind": "train", "window_s": 10.0, "updates": 100, "device_kind": "NVIDIA H100 80GB HBM3", "config": cfg}
    want = 100.0 * ref.iteration_flops(cfg) * 100 / 10.0 / 989.4e12
    assert _read("step_mfu.stargan_v2", r) == pytest.approx(want)
    assert _read("step_mfu.stargan_v2", {**r, "device_kind": "cpu"}) is None
    assert _read("step_mfu.stargan_v2", {**r, "config": {**cfg, "model": "littlegan"}}) is None


def test_span_device_ms_by_launch_time():
    from benchmark.drivers.train_stargan_v2 import span_device_ms

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "littlegan:stargan_v2.d_latent", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "littlegan:stargan_v2.r1", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "littlegan:step.schedule", "ts": 0, "dur": 200},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5, "dur": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20, "dur": 1, "tid": 9,
         "args": {"correlation": 2}},  # autograd's thread: counted by time
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 150, "dur": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 50, "dur": 7, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 60, "dur": 11, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "c", "ts": 160, "dur": 13, "args": {"correlation": 3}},
    ]
    got = span_device_ms({"traceEvents": ev})
    assert got == {"stargan_v2.d_latent": pytest.approx(0.018), "stargan_v2.r1": pytest.approx(0.011)}


def test_direction_numbers_see_what_the_norms_do_not():
    import torch

    from benchmark.drivers.train_stargan_v2 import state_numbers

    gen = torch.Generator().manual_seed(3)
    names = ["discriminator.a", "discriminator.b", "generator.a", "mapping_network.a", "style_encoder.a"]
    p0 = {k: torch.randn(50, generator=gen, dtype=torch.float64) for k in names}  # float64: exact to 1e-12
    step = {k: torch.sign(torch.randn(50, generator=gen, dtype=torch.float64)) * 1e-3 for k in names}  # Adam's sign-led steps
    ref_p = {k: p0[k] + step[k] for k in names}
    ema_keys = [k for k in names if not k.startswith("discriminator.")]
    ref_e = {k: p0[k] + 1e-3 * step[k] for k in ema_keys}
    norms = {k: 1.0 for k in names}
    same = state_numbers(p0, ref_p, ref_e, ref_p, ref_e, norms)
    assert same["change_gap"] == 0 and same["change_dir_gap"] == 0
    assert set(same) >= {f"change_dir_gap.{n}" for n in ("discriminator", "generator", "ema.generator")}
    # half of G's elements stepped the other way: the norms agree, the direction does not (sqrt(2) = 1.41)
    flip = dict(ref_p, **{"generator.a": p0["generator.a"] + step["generator.a"] * torch.tensor([1.0, -1.0] * 25, dtype=torch.float64)})
    got = state_numbers(p0, flip, ref_e, ref_p, ref_e, norms)
    assert got["change_gap"] < 1e-9 and got["change_dir_gap.generator"] == pytest.approx(2 ** 0.5, rel=1e-9)
    # an EMA left at its start reads 1 in both; one of decay 0.99 in place of 0.999, 10 times the change, 9
    still = state_numbers(p0, ref_p, {k: p0[k] for k in ema_keys}, ref_p, ref_e, norms)
    assert still["change_gap_ema"] == pytest.approx(1) and still["change_dir_gap"] == pytest.approx(1)
    fast = state_numbers(p0, ref_p, {k: p0[k] + 1e-2 * step[k] for k in ema_keys}, ref_p, ref_e, norms)
    assert fast["change_gap"] == pytest.approx(9, rel=1e-9) and fast["change_gap_params"] == 0


def test_operation_count_and_parameters_at_the_published_size():
    cfg = harness.Cell.load(CELL).config
    shapes = ref.Model.from_config(cfg).shapes()
    counts = {net: sum(math.prod(s) for k, s in shapes.items() if k.startswith(net + "."))
              for net in ref.NETS}
    assert counts == {"generator": 33892995, "mapping_network": 3259072, "style_encoder": 20949760,
                      "discriminator": 20852803}
    # 23.30 TFLOP per iteration at batch 8 (a count made apart from this code), to 0.1%
    assert ref.iteration_flops(cfg) == pytest.approx(23.30e12, rel=1e-3)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_the_driver_at_a_tiny_size(trace):
    cell = tiny_cell(CELL, TRAFFIC_TINY, config=SG_TINY)
    out = run_cpu(cell, trace=trace)
    assert out["correct"] and out["attempted"] >= 2 and out["failed"] == 0
    # float32 on both sides: the loss terms agree to rounding (measured 4e-7); the changes' norms and
    # directions to a few percent, Adam's steps taking the sign of gradients near zero, which rounding can
    # flip (measured 0.012 and 0.044)
    checked = {k: v["value"] for k, v in out["checked"].items()}
    assert checked["loss_gap_first"] < 1e-4 and checked["loss_gap_all"] < 1e-4
    assert checked["change_gap"] < 0.1 and checked["change_dir_gap"] < 0.2 and checked["change_dir_gap_d"] < 0.2
    if trace:
        assert out["breakdown"]["idle_gaps"] and "train_images_per_s" not in out["metrics"]
    else:
        assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}


def test_the_check_sees_each_planted_fault():
    """The faults in the phases after the first Adam step (a stale input in
    D's reference phase, the diversity term's sign in G's) leave the loss
    terms before any step as they are and move the changes' norms by less
    than their direction, which moves by a hundred times the program's."""
    import time

    import torch

    cell = tiny_cell(CELL, TRAFFIC_TINY, config=SG_TINY)
    ctx = harness.Context(cell, 271828, 0.2, False, torch.device("cpu"), time.perf_counter(), controls=True)
    r = cell.driver().run(ctx).readings
    prog = r["program"]
    # float32 on both sides: rounding alone (measured 5e-5; the faults 0.065-1.9)
    assert prog["change_dir_gap"] < 0.01
    assert r["no_r1"]["loss_gap_first"] == pytest.approx(1) and r["half_batch"]["loss_gap_first"] > 0.1
    for fault in ("ref_steps_fe", "d_ref_stale", "g_ref_ds_sign"):
        assert r[fault]["loss_gap_first"] < 1e-4 and r[fault]["change_dir_gap"] > 0.1, fault
    # the stale input changes D reference-guided's fake term (measured 0.083), and D's direction
    assert r["d_ref_stale"]["loss_gap_all"] > 0.01 and r["d_ref_stale"]["change_dir_gap_d"] > 0.1
    assert r["g_ref_ds_sign"]["change_dir_gap.generator"] > 0.1
