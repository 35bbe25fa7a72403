"""The StyleGAN3 cell's pieces on the CPU: its configuration and traffic,
its three per-layer readers on synthetic readings (and nothing read in the
other cells), S6's roofline launch counts against the program's counters
over one lazy period, the reference's operation count at the published
size, ``drivers/train_stylegan3.py`` once at a tiny size through
``benchmark/run.py``'s ``execute``, and its check against the planted
faults."""

from __future__ import annotations

import math
import time

import pytest

from benchmark import harness
from benchmark import trace as tr
from benchmark.reference import stylegan3 as ref
from benchmark.roofline import stylegan3 as roof
from conftest import run_cpu, tiny_cell

CELL = "stylegan3-t-afhqv2-512.train-graph"
OTHERS = ("littlegan-128.train-graph", "stargan-v2-afhq-256.train-graph", "stylegan2-ffhq-256.train-graph")
METRICS = ("step_mfu.stylegan3", "filtered_lrelu_roofline.stylegan3", "filtered_lrelu_ms_per_update.stylegan3")
GENERIC = ("elementwise_ms_per_update.train", "adam_ms_per_update.train", "device_idle_share.train")
SG3_TINY = {"image_dim": 16, "batch_size": 4, "channel_base": 64, "channel_max": 8, "z_dim": 8, "w_dim": 8,
            "mapping_layers": 2, "mbstd_group": 2, "compute_dtype": "float32", "d_reg_interval": 2}
TRAFFIC_TINY = {"k": 2, "store_images": 12, "trace_dispatches": 1, "check_replays": 2, "check_chunk": 2}


def _read(name, r):
    return harness.load_module("metrics", name).read(r)


def _trace():
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}  # noqa: E731
    return tr.Trace([
        {"ph": "X", "cat": "user_annotation", "name": "bench:traced_window", "ts": 0.0, "dur": 1e6},
        k("void (anonymous namespace)::filtered_lrelu_kernel<__nv_bfloat16, 0, 2, 12, 2, 12>((anonymous "
          "namespace)::Params)", 0.0, 3e5),
        k("void (anonymous namespace)::filtered_lrelu_kernel<__nv_bfloat16, 1, 2, 12, 4, 24>((anonymous "
          "namespace)::Params)", 3e5, 1e5),
        k("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 4e5, 5e5),
    ])


def test_the_configuration_and_traffic_load():
    cell = harness.Cell.load(CELL)
    cfg = cell.config
    assert (cfg["model"], cfg["image_dim"], cfg["batch_size"], cfg["channel_base"], cfg["mbstd_group"]) == (
        "stylegan3", 512, 32, 32768, 4)
    assert cell.traffic["driver"] == "train_stylegan3" and cell.traffic["k"] == 16
    assert cell.traffic["store_images"] == 15803 and cell.chips == 1
    assert [m["name"] for m in cell.per_layer] == [*GENERIC, *METRICS]
    assert [m["name"] for m in cell.end_to_end] == ["train_images_per_s", "setup_s"]
    shapes = ref.Model.from_config(cfg).shapes()
    count = lambda pre: sum(math.prod(s) for k, s in shapes.items() if k.startswith(pre))  # noqa: E731
    assert (count("G."), count("G.mapping."), count("D.")) == (24873519, 525312, 28982849)
    assert set(cell.limits) <= {"loss_gap_first", "loss_gap_all", "change_gap", "magnitude_gap"}


def test_the_readers_read_the_cell_and_nothing_elsewhere():
    cfg = harness.Cell.load(CELL).config
    per = roof.iteration_bound(cfg)
    assert per["fwd"][1] == 28 and per["bwd"][1] == 14
    launched = {"stylegan3.filtered_lrelu": 16 * 28, "stylegan3.filtered_lrelu_bwd": 16 * 14}
    r = {"kind": "train", "trace": _trace(), "traced_launches": launched, "config": cfg, "traced_updates": 16,
         "window_s": 10.0, "updates": 32, "device_kind": "NVIDIA H100 80GB HBM3"}
    want = 100 * 16 * (per["fwd"][0] + per["bwd"][0]) / 0.4
    assert _read("filtered_lrelu_roofline.stylegan3", r) == pytest.approx(want)
    assert _read("filtered_lrelu_ms_per_update.stylegan3", r) == pytest.approx(400.0 / 16)
    assert _read("step_mfu.stylegan3", r) == pytest.approx(100 * ref.iteration_flops(cfg) * 32 / 10.0 / 989.4e12)
    assert _read("filtered_lrelu_roofline.stylegan3", {**r, "traced_launches": {}}) is None  # a program without S6
    for name in GENERIC:  # the trace's categories and idle share, read in every train cell that lists them
        assert _read(name, r) is not None, name
    for other in OTHERS:
        ocfg = harness.Cell.load(other).config
        for name in METRICS:
            assert _read(name, {**r, "config": ocfg}) is None, (name, other)


def test_roofline_launches_equal_the_counters_over_a_period():
    """One lazy period (16 iterations) of a tiny StyleGAN3 on the CPU: S6's
    two counters move as the roofline counts its launches."""
    import torch

    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.training import stylegan2 as sg
    from littlegan_tpu_torch.training.state import create_stylegan2_state
    from benchmark.drivers.train_graph import port_config

    cfgd = {**harness.Cell.load(CELL).config, **SG3_TINY, "d_reg_interval": 16}
    cfg = port_config(cfgd, device_data=True, steps_per_dispatch=16)
    state = create_stylegan2_state(cfg, "cpu")
    images = torch.randint(0, 256, (8, 16, 16, 3), dtype=torch.uint8)
    gen = torch.Generator().manual_seed(1)
    draws = sg.stack_draws([sg.draw_iteration(gen, cfg, "cpu", it, 8) for it in range(16)])
    before = _build.launch_counts()
    sg.make_stylegan2_scan_step(cfg, state, 16)(state, images, draws, 0)
    after = _build.launch_counts()
    per = roof.iteration_bound(cfgd)
    for form, counter in zip(("fwd", "bwd"), roof.COUNTERS):
        assert after[counter] - before.get(counter, 0) == 16 * per[form][1], counter


def test_operation_count_at_the_published_size():
    cfg = harness.Cell.load(CELL).config
    flops = ref.phase_flops(cfg)
    # Gmain + Dmain 101.69 T, R1 23.91 T every 16th: 103.19 T averaged
    assert flops["iteration"] == pytest.approx(flops["main"] + flops["d_reg"] / 16)
    assert flops["iteration"] == pytest.approx(103.186e12, rel=1e-3)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_the_driver_at_a_tiny_size(trace):
    cell = tiny_cell(CELL, TRAFFIC_TINY, config=SG3_TINY)
    out = run_cpu(cell, trace=trace)
    assert out["correct"] and out["attempted"] >= 2 and out["failed"] == 0
    checked = {k: v["value"] for k, v in out["checked"].items()}
    assert set(checked) == set(cell.limits)
    assert checked["loss_gap_first"] < 1e-4 and checked["loss_gap_all"] < 1e-3 and checked["change_gap"] < 0.05
    if trace:
        assert out["breakdown"]["idle_gaps"] and "train_images_per_s" not in out["metrics"]
    else:
        assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}


def test_the_check_sees_the_planted_faults():
    import torch

    cell = tiny_cell(CELL, TRAFFIC_TINY, config=SG3_TINY)
    ctx = harness.Context(cell, 314159, 0.2, False, torch.device("cpu"), time.perf_counter(), controls=True)
    r = cell.driver().run(ctx).readings
    assert r["program"]["change_dir_gap"] < 0.01 and r["program"]["magnitude_gap"] < 1e-3
    for fault in ("base_rate_lrelu", "pad_lo"):  # the forward itself: the first losses move
        assert r[fault]["loss_gap_first"] > 1e-4 and r[fault]["change_gap"] > 0.05, fault
    assert r["no_transform"]["change_gap"] > 0.5  # the input's affine starts at the identity: its leaves stay
    assert r["frozen_magnitude"]["magnitude_gap"] == pytest.approx(1.0)
    from benchmark.calibrate_faults import reading_sets

    sets = reading_sets(r, cell.limits)
    assert set(sets) == {"program", "control", *ref.FAULTS}
    assert all(not sets[f]["fails"] == [] for f in ref.FAULTS)  # each planted fault fails a limit
    assert sets["program"]["fails"] == []
