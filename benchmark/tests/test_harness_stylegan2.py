"""The StyleGAN2 cell's pieces on the CPU: its three per-layer readers on
synthetic readings and a synthetic trace, S4's roofline over the lazy
period, the reference's operation count at the published size,
``drivers/train_stylegan2.py`` once at a tiny size through ``benchmark/run.py``'s ``execute``, and its
check against the planted faults."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark import trace as tr
from benchmark.reference import stylegan2 as ref
from benchmark.roofline import stylegan2 as roof
from conftest import run_cpu, tiny_cell

CELL = "stylegan2-ffhq-256.train-graph"
SG2_TINY = {"image_dim": 16, "batch_size": 4, "channel_base": 64, "channel_max": 16, "z_dim": 8, "w_dim": 8,
            "mapping_layers": 2, "mbstd_group": 2, "compute_dtype": "float32", "g_reg_interval": 2,
            "d_reg_interval": 4}
TRAFFIC_TINY = {"k": 4, "store_images": 20, "trace_dispatches": 1, "check_replays": 2, "check_chunk": 2}


def _read(name, r):
    return harness.load_module("metrics", name).read(r)


def test_fir_roofline_reads_the_counted_launches_over_the_kernels_time():
    cfg = harness.Cell.load(CELL).config
    per = roof.period_bound(cfg)
    assert per["fwd"][1] == 16 * 60 + 4 * 18 + 24 and per["bwd"][1] == 16 * 48 + 4 * 18 + 24
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}  # noqa: E731
    trace = tr.Trace([
        {"ph": "X", "cat": "user_annotation", "name": "bench:traced_window", "ts": 0.0, "dur": 1e6},
        k("void (anonymous namespace)::upfirdn2d_kernel<__nv_bfloat16, 8, 1, 1>(__nv_bfloat16 const*)", 0.0, 4e5),
        k("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 4e5, 5e5),
    ])
    launched = {"stylegan2.upfirdn2d": per["fwd"][1], "stylegan2.upfirdn2d_bwd": per["bwd"][1]}
    r = {"kind": "train", "trace": trace, "traced_launches": launched, "config": cfg}
    assert _read("fir_roofline.stylegan2", r) == pytest.approx(100 * (per["fwd"][0] + per["bwd"][0]) / 0.4)
    assert _read("fir_roofline.stylegan2", {**r, "traced_launches": {}}) is None  # the parent: nothing launched
    assert _read("fir_roofline.stylegan2", {**r, "config": {**cfg, "model": "stargan_v2"}}) is None


def test_reg_reader_and_step_mfu():
    cfg = harness.Cell.load(CELL).config
    r = {"kind": "train", "span_device_ms": {"stylegan2.g_reg": 40.0, "stylegan2.d_reg": 160.0,
                                             "stylegan2.g_main": 90.0}, "span_iterations": 1, "config": cfg}
    assert _read("reg_ms_per_update.stylegan2", r) == pytest.approx(40 / 4 + 160 / 16)
    assert _read("reg_ms_per_update.stylegan2", {"kind": "train", "config": cfg}) is None
    r = {"kind": "train", "window_s": 10.0, "updates": 100, "device_kind": "NVIDIA H100 80GB HBM3", "config": cfg}
    want = 100.0 * ref.iteration_flops(cfg) * 100 / 10.0 / 989.4e12
    assert _read("step_mfu.stylegan2", r) == pytest.approx(want)
    assert _read("step_mfu.stylegan2", {**r, "device_kind": "cpu"}) is None


def test_operation_count_and_parameters_at_the_published_size():
    import math

    cfg = harness.Cell.load(CELL).config
    shapes = ref.Model.from_config(cfg).shapes()
    count = lambda pre: sum(math.prod(s) for k, s in shapes.items() if k.startswith(pre))  # noqa: E731
    assert (count("G."), count("G.mapping."), count("D.")) == (24767458, 2101248, 24001089)
    flops = ref.phase_flops(cfg)
    # Gmain + Dmain 23.63 T, path length 5.76 T every 4th, R1 11.96 T every 16th: 25.82 T averaged
    assert flops["iteration"] == pytest.approx(
        flops["main"] + flops["g_reg"] / 4 + flops["d_reg"] / 16) and flops["iteration"] == pytest.approx(
        25.816e12, rel=1e-3)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_the_driver_at_a_tiny_size(trace):
    cell = tiny_cell(CELL, TRAFFIC_TINY, config=SG2_TINY)
    out = run_cpu(cell, trace=trace)
    assert out["correct"] and out["attempted"] >= 4 and out["failed"] == 0
    # float32 on both sides, the reference in chunks of one minibatch-stddev group: rounding alone
    checked = {k: v["value"] for k, v in out["checked"].items()}
    assert checked["loss_gap_first"] < 1e-4 and checked["loss_gap_all"] < 1e-3
    assert checked["change_gap"] < 0.05 and set(checked) == {"loss_gap_first", "loss_gap_all", "change_gap"}
    if trace:
        assert out["breakdown"]["idle_gaps"] and "train_images_per_s" not in out["metrics"]
    else:
        assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}


def test_the_check_sees_each_planted_fault():
    import time

    import torch

    cell = tiny_cell(CELL, TRAFFIC_TINY, config=SG2_TINY)
    ctx = harness.Context(cell, 314159, 0.2, False, torch.device("cpu"), time.perf_counter(), controls=True)
    r = cell.driver().run(ctx).readings
    assert r["program"]["change_dir_gap"] < 0.01
    for fault in ("no_demod", "box_filter", "no_mbstd"):  # the forward itself: the first losses move
        assert r[fault]["loss_gap_first"] > 1e-3, fault
    for fault in ("pl_sign", "no_lazy_ratio"):  # the steps alone: the first losses stay, the changes move
        assert r[fault]["loss_gap_first"] < 1e-4 and r[fault]["change_gap"] > 0.1, fault
    assert r["pl_sign"]["change_dir_gap.G"] > 0.3
    from benchmark.calibrate_faults import reading_sets

    sets = reading_sets(r, cell.limits)  # what calibrate_faults.py prints of the run
    assert set(sets) == {"program", "control", *ref.FAULTS}
    assert all(set(v["fails"]) <= set(cell.limits) for v in sets.values())
    assert sets["no_demod"]["loss_gap_first"] == r["no_demod"]["loss_gap_first"]
