"""The port's last entry points against the JAX repo's scripts, on the CPU.

- ``fit_frontier``: ``flagset_args`` equal to the JAX script's for every
  flag set; the probe's verdicts from ``memory_report``'s last line (fits,
  oom with the reserved bytes and the card's capacity, error, timeout) and
  a real probe here (no card: ``error``); the store headroom; ``--search``'s
  bisection and ``--out`` over a stubbed probe, as
  ``tests/test_memory_report.py`` runs the JAX script's; the refusals.
- ``memory_report --measure``: an out-of-memory error in the measured (or
  warm-up) update is the verdict ``fits: false`` and exit 0 with "DOES NOT
  FIT"; any other error raises. The card's calls are stubbed and the
  update runs on the CPU.
- ``trace_top_ops``: a hand-made trace of known device events (totals,
  shares, counts, top order and categories exact, the port's kernels named
  K1, K2, K3 and K3's backward), the same events in a real CPU trace of
  ``torch.profiler``, and a CPU trace alone (no device event: exit 1); the
  ``littlegan:`` spans per name and the window's idle time in and between
  graph replays of a hand-made replay trace, none where a replay span has
  no launch or a launch no device event.
- ``bench_step_variants``: ``total_loss_concat``'s routed gradients equal
  ``jax.grad`` of the JAX script's ``total_loss_concat`` on the same weights
  (``params_from_jax``) and inputs (rtol 1e-3 / atol 1e-6, f32, as
  tests/test_torch_step.py holds the step's), and the port's
  ``total_loss_fn``'s (rtol 1e-4 / atol 1e-7: the same f32 math, D's
  batches concatenated); one ``step_concat`` update against the step's.
- ``bench_step_variants`` and ``bench_boundary_conv`` raise without a card.
- ``baseline_anchor``: the port's TF recipe's losses and first-step
  gradients against ``tests/test_tf_oracle.py::_tf_reference_step`` on the
  same weights (losses rtol 1e-5 / atol 1e-6, gradients rtol 5e-4 / atol
  5e-6: the oracle test's bound of JAX against TF); one run at 16², batch
  2, writes a record with the JAX keys under ``torch_``; without
  TensorFlow it raises, saying so.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from littlegan_tpu.models import init_params as jinit_params  # noqa: E402
from littlegan_tpu.training.checkpoint import _flatten  # noqa: E402
from littlegan_tpu.utils.image import soft  # noqa: E402
from littlegan_tpu_torch.compat.jax_params import params_from_jax  # noqa: E402
from littlegan_tpu_torch.compat.tf_reference_step import TFReferenceStep  # noqa: E402
from littlegan_tpu_torch.models.littlegan import LittleGAN  # noqa: E402
from littlegan_tpu_torch.ops.cuda import _build  # noqa: E402
from littlegan_tpu_torch.scripts import (  # noqa: E402
    baseline_anchor, bench_boundary_conv, bench_step_variants, fit_frontier, memory_report, trace_top_ops,
)
from littlegan_tpu_torch.training import step as tstep  # noqa: E402
from littlegan_tpu_torch.training.state import create_train_state  # noqa: E402
from test_tf_oracle import TFOracle, _ocfg, _tf_reference_step  # noqa: E402
from test_torch_train import tcfg_of  # noqa: E402
from torch_dp_common import REPO  # noqa: E402
from torch_dp_common import one_thread_per_process  # noqa: E402,F401 (an autouse fixture)

GRAD_TOL = dict(rtol=1e-3, atol=1e-6)  # port against JAX, f32 (tests/test_torch_step.py's)
SAME_MATH_TOL = dict(rtol=1e-4, atol=1e-7)  # port against port, the same f32 math in another batch layout
TF_GRAD_TOL = dict(rtol=5e-4, atol=5e-6)  # tests/test_tf_oracle.py's step bound


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}_under_test", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_lines(out: str):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def a_card(monkeypatch):
    """``torch.cuda.is_available`` says yes (for the parent of stubbed probes)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


# ------------------------------------------------------------ fit_frontier --

FLAGSETS = ["parity", "remat", "adjhalf", "mbf16", "ema", "zero", "sdense", "accum8", "remat+mbf16",
            "zero+sdense", "accum8+remat", "remat+adjhalf+mbf16+ema"]


@pytest.mark.parametrize("flagset", FLAGSETS)
def test_flagset_args_equal_jax(flagset):
    assert fit_frontier.flagset_args(flagset) == _script("fit_frontier").flagset_args(flagset)


@pytest.mark.parametrize("flagset", ["remat+nonsense", "accumx"])
def test_flagset_args_refuse_unknown_flags_as_jax(flagset):
    for mod in (fit_frontier, _script("fit_frontier")):
        with pytest.raises(SystemExit, match="unknown flag"):
            mod.flagset_args(flagset)


def _report(measured):
    rep = {"dim": 128, "batch": 32, "total_per_chip_bytes": 118_800_000}
    if measured is not None:
        rep["measured"] = measured
    return "train-state memory @ 128² b32:\n  ...\n" + json.dumps(rep) + "\n"


def test_probe_verdicts(monkeypatch):
    """The verdict from memory_report's last line and exit code: fits,
    oom (the reserved bytes at the failure, the card's capacity, and no
    store headroom: the step alone does not fit), error
    (no result line, or a non-zero exit), timeout; then one real probe
    here, which has no card: error, exit 1."""
    cap = 85_000_000_000
    runs = {
        "fits": (0, _report({"device": "card", "fits": True, "peak_bytes": 1_500_000_000, "hbm_capacity_bytes": cap})),
        "oom": (0, _report({"device": "card", "fits": False, "oom_used_bytes": 84_000_000_000,
                            "hbm_capacity_bytes": cap, "oom_error": "CUDA out of memory."})),
        "no_line": (1, "memory_report: --measure needs a CUDA device\n"),
        "no_measure": (0, _report(None)),
    }
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        if kw["env"].get("FAKE") == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        code, out = runs[kw["env"]["FAKE"]]
        return subprocess.CompletedProcess(cmd, code, out, "stderr text")

    monkeypatch.setattr(fit_frontier.subprocess, "run", fake_run)
    got = {}
    for name in list(runs) + ["timeout"]:
        monkeypatch.setenv("FAKE", name)
        got[name] = fit_frontier.probe(128, 32, "remat+accum2", 60)
    assert seen[0][1:] == ["-m", "littlegan_tpu_torch.scripts.memory_report", "--dim", "128", "--batch", "32",
                           "--measure", "--remat", "--grad-accum", "2"]
    point = {"dim": 128, "batch": 32, "flags": "remat+accum2"}
    assert got["fits"] == {**point, "device": "card", "n_chips": 1, "state_bytes": 118_800_000,
                           "hbm_capacity_bytes": cap, "verdict": "fits", "peak_bytes": 1_500_000_000}
    assert got["oom"] == {**point, "device": "card", "n_chips": 1, "state_bytes": 118_800_000,
                          "hbm_capacity_bytes": cap, "verdict": "oom", "oom_used_bytes": 84_000_000_000,
                          "oom_error": "CUDA out of memory."}
    assert got["no_line"] == {**point, "verdict": "error", "exit": 1, "stderr_tail": "stderr text"}
    assert got["no_measure"]["verdict"] == "error" and got["no_measure"]["exit"] == 0
    assert got["timeout"] == {**point, "verdict": "timeout", "note": "probe exceeded 60s"}
    assert fit_frontier.headroom_images(got["fits"], 128) == (cap - 1_500_000_000) // (128 * 128 * 3)
    assert fit_frontier.headroom_images(got["oom"], 128) == 0
    assert fit_frontier.headroom_images(got["no_line"], 128) is None

    monkeypatch.undo()
    real = fit_frontier.probe(16, 2, "parity", 120)
    assert real["verdict"] == "error" and real["exit"] == 1 and "needs a CUDA device" in real["stderr_tail"]


def test_headroom_as_jax():
    """JAX's headroom cases (tests/test_memory_report.py), the capacity
    taken from the probe instead of an argument."""
    hbm = 16 << 30
    res = {"dim": 1024, "peak_bytes": hbm - 10 * 1024 * 1024 * 3, "hbm_capacity_bytes": hbm}
    assert fit_frontier.headroom_images(res, 1024) == 10
    assert fit_frontier.headroom_images({**res, "n_chips": 8}, 1024) == 80
    assert fit_frontier.headroom_images({"dim": 1024, "hbm_capacity_bytes": hbm}, 1024) is None
    assert fit_frontier.headroom_images({"peak_bytes": hbm + 1, "hbm_capacity_bytes": hbm}, 1024) == 0
    jax_ff = _script("fit_frontier")
    assert fit_frontier.headroom_images(res, 1024) == jax_ff.headroom_images(res, 1024, hbm)


def test_search_and_out(a_card, tmp_path, monkeypatch, capsys):
    """Binary search over a stubbed probe: the largest fitting batch found
    with JAX's probe sequence, every probe recorded with its headroom,
    --out written."""
    calls = []

    def fake_probe(dim, batch, flagset, timeout_s):
        calls.append(batch)
        fits = batch <= 5
        res = {"dim": dim, "batch": batch, "flags": flagset, "verdict": "fits" if fits else "oom",
               "hbm_capacity_bytes": 80 << 30, ("peak_bytes" if fits else "oom_used_bytes"): batch * (1 << 20)}
        return res

    monkeypatch.setattr(fit_frontier, "probe", fake_probe)
    out = tmp_path / "fit.json"
    assert fit_frontier.main(["--search", "256", "--max-batch", "8", "--flagsets", "remat", "--out", str(out)]) == 0
    assert calls == [8, 4, 6, 5]  # the upper bound, then lo=0..hi=7 bisection
    rec = json.loads(out.read_text())
    assert rec["hbm_bytes"] == 80 << 30
    assert rec["results"][-1] == {"dim": 256, "flags": "remat", "max_fitting_batch": 5}
    lines = _json_lines(capsys.readouterr().out)
    assert lines[-1]["max_fitting_batch"] == 5
    assert all("n_images_headroom" in ln for ln in lines if "batch" in ln)

    calls.clear()
    assert fit_frontier.main(["--points", "128:32,128:256", "--flagsets", "parity,accum2"]) == 0
    assert calls == [32, 32, 256, 256]


def test_refusals_and_failed_probes(a_card, monkeypatch, capsys):
    assert fit_frontier.main(["--points", "128:32", "--topology", "v5e:2x4"]) == 2
    assert capsys.readouterr().err.strip() == memory_report.TOPOLOGY_REFUSAL
    assert fit_frontier.main(["--points", "128:32", "--mesh", "data=2"]) == 2
    assert capsys.readouterr().err.strip() == memory_report.MESH_REFUSAL
    with pytest.raises(SystemExit):
        fit_frontier.main(["--flagsets", "remat"])  # neither --points nor --search
    with pytest.raises(SystemExit, match="unknown flag"):
        fit_frontier.main(["--points", "128:32", "--flagsets", "remat+nonsense"])
    monkeypatch.setattr(fit_frontier, "probe", lambda d, b, fs, t: {"dim": d, "batch": b, "flags": fs,
                                                                    "verdict": "error", "exit": 1})
    assert fit_frontier.main(["--points", "128:32"]) == 1  # a probe without a verdict fails the run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    assert fit_frontier.main(["--points", "128:32"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


# ------------------------------------------------- memory_report --measure --

@pytest.fixture
def stub_card(monkeypatch):
    """The card's memory calls answered for a CPU run of the update."""
    for name, value in (("synchronize", None), ("memory_allocated", 1000), ("reset_peak_memory_stats", None),
                        ("max_memory_allocated", 5000), ("memory_reserved", 7000), ("get_device_name", "stub"),
                        ("mem_get_info", (1 << 30, 80 << 30))):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value, **k: _v)


def _failing_step(monkeypatch, fail_at: int, error: Exception):
    real = tstep.make_train_step
    calls = []

    def make(cfg, state, sync=None):
        step = real(cfg, state, sync)

        def run(*args):
            calls.append(len(calls))
            if len(calls) == fail_at:
                raise error
            return step(*args)

        return run

    monkeypatch.setattr(tstep, "make_train_step", make)
    return calls


@pytest.mark.parametrize("fail_at", [1, 2])  # the warm-up update, the measured one
def test_measure_reports_an_oom_as_a_verdict(stub_card, monkeypatch, fail_at):
    from littlegan_tpu_torch.config import Config

    cfg = Config(image_dim=16, init_dim=1, noise_dim=13, conv_filter=[24, 16, 12, 8, 4], batch_size=2,
                 compute_dtype="float32", debug=True)
    calls = _failing_step(monkeypatch, fail_at, torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 90 GiB"))
    meas = memory_report.measured_step_report(cfg, device="cpu")
    assert len(calls) == fail_at
    assert meas == {"device": "stub", "step": "train", "kernels": False, "hbm_capacity_bytes": 80 << 30,
                    "fits": False, "oom_used_bytes": 7000,
                    "oom_error": "CUDA out of memory. Tried to allocate 90 GiB"}


def test_measure_fits_and_other_errors_raise(stub_card, monkeypatch):
    from littlegan_tpu_torch.config import Config

    cfg = Config(image_dim=16, init_dim=1, noise_dim=13, conv_filter=[24, 16, 12, 8, 4], batch_size=2,
                 compute_dtype="float32", debug=True)
    meas = memory_report.measured_step_report(cfg, device="cpu")
    assert meas["fits"] is True and meas["peak_bytes"] == 5000 and meas["before_bytes"] == 1000
    assert meas["hbm_capacity_bytes"] == 80 << 30 and meas["losses_finite"] is True
    _failing_step(monkeypatch, 2, RuntimeError("cuDNN error"))
    with pytest.raises(RuntimeError, match="cuDNN error"):
        memory_report.measured_step_report(cfg, device="cpu")


def test_measure_oom_prints_does_not_fit_and_exits_0(stub_card, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(memory_report, "measured_step_report",
                        functools.partial(memory_report.measured_step_report, device="cpu"))
    _failing_step(monkeypatch, 2, torch.OutOfMemoryError("CUDA out of memory."))
    assert memory_report.main(["--dim", "16", "--batch", "2", "--measure"]) == 0
    out = capsys.readouterr().out
    assert "DOES NOT FIT" in out
    rep = _json_lines(out)[-1]
    assert rep["measured"]["fits"] is False and rep["measured"]["oom_used_bytes"] == 7000


# ------------------------------------------------------------ trace_top_ops --

K1 = ("void (anonymous namespace)::cluster_kernel<__nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16*, float*, "
      "float const*, float const*, long, float, float, int)")
K2 = ("void (anonymous namespace)::cluster_kernel<__nv_bfloat16, false>(__nv_bfloat16 const*, "
      "__nv_bfloat16 const*, __nv_bfloat16*, float const*, float const*, float const*, float*, float*, long, "
      "float, int)")
K3 = "void (anonymous namespace)::conv3x3_mma_kernel<64>(__nv_bfloat16 const*, __nv_bfloat16 const*, int)"
FOLD = "_ZN12_GLOBAL__N_111fold_kernelI13__nv_bfloat16EEvPKT_S4_PKfS6_PS2_Pfiii"
ELEM = "void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float>>(int, float*)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1"
# (name, cat, dur µs, count)
EVENTS = [(K1, "kernel", 30, 2), (K2, "kernel", 50, 1), (K3, "kernel", 20, 1), (FOLD, "kernel", 4, 2),
          (ELEM, "kernel", 10, 3), (GEMM, "kernel", 40, 1), ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 5, 1),
          ("Memset (Device)", "gpu_memset", 1, 1)]
WANT_TOP = [  # (printed name, category, total µs, count), by time
    ("cluster_kernel<__nv_bfloat16>", "K1 norm_lrelu.cu", 60, 2),
    ("cluster_kernel<__nv_bfloat16, false>", "K2 norm_lrelu_bwd.cu", 50, 1),
    (GEMM, "gemm", 40, 1),
    (ELEM, "elementwise", 30, 3),
    ("conv3x3_mma_kernel<64>", "K3 boundary_conv.cu", 20, 1),
    ("fold_kernel<13__nv_bfloat16>", "K3 bwd boundary_conv_bwd.cu", 8, 2),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 5, 1),
    ("Memset (Device)", "gpu_memset", 1, 1),
]


def _device_events():
    out, ts = [], 0
    for name, cat, dur, count in EVENTS:
        for _ in range(count):
            out.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur})
            ts += dur + 1
    return out


def _noise_events():
    """Host-side events and a device instant event: none of them counts."""
    return [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 1000},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 3},
            {"ph": "i", "cat": "kernel", "name": K1, "ts": 0, "s": "t"}]


def _check_summary(s, top_n=30):
    total = sum(us for _, _, us, _ in WANT_TOP)
    assert s["total_ms"] == pytest.approx(total / 1e3, abs=1e-12) and s["n_events"] == 12
    want = WANT_TOP[:top_n]
    assert [(t["name"], t["category"], t["count"]) for t in s["top"]] == [(n, c, k) for n, c, _, k in want]
    for t, (_, _, us, _) in zip(s["top"], want):
        assert t["ms"] == pytest.approx(us / 1e3, abs=1e-12) and t["share"] == pytest.approx(us / total, abs=1e-12)
    by_cat = {c["category"]: c["ms"] for c in s["by_category"]}
    assert by_cat == pytest.approx({c: us / 1e3 for _, c, us, _ in WANT_TOP}, abs=1e-12)
    assert [c["category"] for c in s["by_category"]][:2] == ["K1 norm_lrelu.cu", "K2 norm_lrelu_bwd.cu"]


def test_top_ops_of_a_hand_made_trace(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _noise_events() + _device_events()}))
    _check_summary(trace_top_ops.summarize(json.loads(path.read_text())["traceEvents"]))
    assert trace_top_ops.main([str(path), "3", "--json"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"# {path}"
    assert out[2] == "== device  total device time 0.214 ms over 12 events"
    assert out[3] == f"  [cat] {'K1 norm_lrelu.cu':30s}     0.060 ms   28.0%"
    rows = [ln for ln in out if " n=" in ln]
    assert rows == [f"      0.060 ms  28.0%  n=   2  [K1 norm_lrelu.cu] cluster_kernel<__nv_bfloat16>",
                    f"      0.050 ms  23.4%  n=   1  [K2 norm_lrelu_bwd.cu] cluster_kernel<__nv_bfloat16, false>",
                    f"      0.040 ms  18.7%  n=   1  [gemm] {GEMM}"]
    summary = json.loads(out[-1])
    assert summary["path"] == str(path)
    _check_summary(summary, top_n=3)


def test_top_ops_of_a_torch_profiler_trace(tmp_path, capsys):
    """A real CPU trace (``tensorboard_trace_handler``'s *.pt.trace.json, as
    ProfileWindow writes) holds no device event: exit 1; the same trace
    with the hand-made device events added gives their exact summary, and
    a directory is read through its newest trace."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    logdir = tmp_path / "profile"
    with profile(activities=[ProfilerActivity.CPU], on_trace_ready=tensorboard_trace_handler(str(logdir))):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (real,) = logdir.glob("*.pt.trace.json")
    assert trace_top_ops.main([str(logdir)]) == 1
    assert "no device event" in capsys.readouterr().err
    trace = json.loads(real.read_text())
    trace["traceEvents"] += _device_events()
    newer = logdir / "rank0.later.pt.trace.json"
    newer.write_text(json.dumps(trace))
    os.utime(real, (1, 1))
    assert trace_top_ops.main([str(logdir), "--json"]) == 0
    summary = _json_lines(capsys.readouterr().out)[-1]
    assert summary["path"] == str(newer)
    _check_summary(summary)
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no \\*.pt.trace.json"):
        trace_top_ops.main([str(tmp_path / "empty")])


def replay_events(launch2=True, kernels2=True):
    """A traced window [0, 100] µs over a lead replay (launched before it)
    and one replay in it, each with its spans, its ``cudaGraphLaunch`` and
    the device events of its correlation id, and a draws kernel between
    them. Idle: [10, 12] and [50, 53] inside the replays' extents, [20, 40],
    [70, 80] and [85, 100] between them."""
    x = lambda cat, name, ts, dur, **args: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,  # noqa: E731
                                            "pid": 0, "tid": 1, "args": args}
    sp = lambda name, ts, dur: x("user_annotation", "littlegan:" + name, ts, dur)  # noqa: E731
    out = [x("user_annotation", "bench:traced_window", 0, 100)]
    for t0, corr in ((-40, 1), (22, 2)):
        out += [sp("step.schedule", t0, 2), sp("dispatch.stage_wait", t0 + 2, 1), sp("dispatch.stage", t0 + 3, 2),
                sp("dispatch.inputs", t0 + 5, 3), sp("dispatch.replay", t0 + 8, 5), sp("dispatch.outputs", t0 + 13, 1)]
        if corr == 1 or launch2:
            out.append(x("cuda_runtime", "cudaGraphLaunch", t0 + 9, 3, correlation=corr))
    out += [x("kernel", ELEM, -5, 15, correlation=1), x("kernel", GEMM, 12, 8, correlation=1)]
    if kernels2:
        out += [x("kernel", K3, 40, 10, correlation=2), x("kernel", ELEM, 53, 7, correlation=2),
                x("gpu_memset", "Memset (Device)", 60, 10, correlation=2)]
    out.append(x("kernel", ELEM, 80, 5, correlation=9))  # the next replay's draws
    return out


def test_top_ops_host_spans_and_replay_split(tmp_path, capsys):
    events = replay_events()
    assert trace_top_ops.host_spans(events) == [
        {"name": "dispatch.replay", "count": 2, "ms": pytest.approx(0.010)},
        {"name": "dispatch.inputs", "count": 2, "ms": pytest.approx(0.006)},
        {"name": "dispatch.stage", "count": 2, "ms": pytest.approx(0.004)},
        {"name": "step.schedule", "count": 2, "ms": pytest.approx(0.004)},
        {"name": "dispatch.outputs", "count": 2, "ms": pytest.approx(0.002)},
        {"name": "dispatch.stage_wait", "count": 2, "ms": pytest.approx(0.002)},
    ]
    split = trace_top_ops.replay_split(events)
    assert split == pytest.approx({"window_ms": 0.1, "idle_ms": 0.050, "graph_gap_ms": 0.005, "host_gap_ms": 0.045,
                                   "replays": 2, "device_events_per_replay": 2.5,
                                   "host_ms_per_replay": 0.013}, abs=1e-12)  # the window's replay: 2 + 2 + 3 + 5 + 1 µs
    assert trace_top_ops.replay_split(replay_events(launch2=False)) is None  # a replay span without its launch
    assert trace_top_ops.replay_split(replay_events(kernels2=False)) is None  # a launch without device events
    assert trace_top_ops.replay_split([e for e in events if "dispatch.replay" not in e["name"]]) is None
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace_top_ops.main([str(path), "--json"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "== host spans (littlegan:)" in out
    assert "      0.010 ms      2 calls     0.005 ms each  dispatch.replay" in out
    assert ("== idle  0.050 ms of a 0.100 ms window (50.000%): in-graph 0.005 ms (5.000%), between replays "
            "0.045 ms (45.000%)") in out
    assert "  2 replays, 2.5 device events each, host ms per replay 0.013 ms" in out
    assert json.loads(out[-1])["idle_split"] == pytest.approx(split, abs=1e-12)
    path.write_text(json.dumps({"traceEvents": replay_events(launch2=False)}))
    assert trace_top_ops.main([str(path)]) == 0
    assert "no graph replay placed" in capsys.readouterr().out


def test_port_kernel_names():
    """Every kernel of littlegan_tpu_torch/csrc maps to its wrapper's file,
    and nothing else does."""
    import re

    csrc = os.path.join(REPO, "littlegan_tpu_torch", "csrc")
    want = {"norm_lrelu.cu": "K1", "norm_lrelu_bwd.cu": "K2", "boundary_conv.cu": "K3",
            "boundary_conv_bwd.cu": "K3 bwd"}
    for src, label in want.items():
        with open(os.path.join(csrc, src)) as f:
            names = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", f.read())
        assert names, src
        for name in names:
            second = "float const*" if src == "norm_lrelu_bwd.cu" else "float*"
            got = trace_top_ops.port_kernel(f"void (anonymous namespace)::{name}<float>(float const*, {second}, int)")
            assert got == (f"{label} {src}", f"{name}<float>"), (src, name, got)
    assert trace_top_ops.port_kernel(ELEM) is None and trace_top_ops.port_kernel("_ZN2at6native4copyEv") is None


# ---------------------------------------------------- bench_step_variants --

def _variant_inputs(cfg, seed=5):
    rng = np.random.default_rng(seed)
    n = cfg.batch_size
    img1, img2 = (rng.uniform(-1, 1, (n, cfg.image_dim, cfg.image_dim, 3)).astype(np.float32) for _ in range(2))
    cond1, cond2 = (soft(rng.choice([-1.0, 1.0], (n, cfg.cond_dim))).astype(np.float32) for _ in range(2))
    noise = rng.standard_normal((n, cfg.noise_dim)).astype(np.float32)
    new_image = (img1 + 0.05 * rng.standard_normal(img1.shape)).astype(np.float32)
    return img1, img2, cond1, cond2, noise, new_image


def test_total_loss_concat_grads_equal_jax_and_the_step(tiny_cfg, monkeypatch):
    # the JAX script imports ``make_batch`` from the root bench.py, which no longer has it; its
    # total_loss_concat does not use it
    monkeypatch.setitem(sys.modules, "bench", types.SimpleNamespace(make_batch=None))
    jmod = _script("bench_step_variants")
    monkeypatch.setattr(jmod, "cfg", tiny_cfg)
    params = jinit_params(tiny_cfg, jax.random.PRNGKey(4))
    img1, img2, cond1, cond2, noise, new_image = _variant_inputs(tiny_cfg)
    j = jnp.asarray
    grad = jax.jit(lambda *a: jax.grad(jmod.total_loss_concat, has_aux=True)(*a, tiny_cfg))
    jgrads, jaux = grad(params, (j(img1), j(cond1)), (j(img2), j(cond2)), j(noise), j(new_image))
    jgrads = _flatten(jgrads)

    tcfg = tcfg_of(tiny_cfg)
    model = params_from_jax(_flatten(params), LittleGAN(tcfg))
    t = torch.from_numpy
    args = ((t(img1), t(cond1)), (t(img2), t(cond2)), t(noise), t(new_image), tcfg)
    with _build.plain_versions():  # the plain ops, as JAX's side runs them
        losses, aux = bench_step_variants.total_loss_concat(model, *args)
        grads = tstep.route_grads(model, losses, tcfg)
        step_losses, _ = tstep.total_loss_fn(model, *args)
        step_grads = tstep.route_grads(model, step_losses, tcfg)
    for k in ("loss/gen", "loss/disc", "loss/adj"):
        np.testing.assert_allclose(float(losses[k].detach()), float(jaux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(aux["fake"].numpy(), np.asarray(jaux["fake"]), rtol=1e-4, atol=1e-5)
    assert sorted(k.replace("/", ".") for k in jgrads) == sorted(grads)
    for k, want in jgrads.items():
        np.testing.assert_allclose(grads[k.replace("/", ".")].numpy(), np.asarray(want), **GRAD_TOL, err_msg=k)

    for k in losses:
        np.testing.assert_allclose(float(losses[k]), float(step_losses[k]), rtol=1e-6, err_msg=k)
    for k, g in step_grads.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), **SAME_MATH_TOL, err_msg=k)
    assert max(float(g.abs().max()) for g in grads.values()) > 1e-3  # the gradients are not all ~0: it bites


def test_step_concat_updates_as_the_step(tiny_cfg):
    """One update of each form from one init and the same draws at batch
    12 (adjuster on): the same losses, and weights within 2 lr (a first
    Adam step moves a weight by about lr whatever its gradient's size)."""
    tcfg = tcfg_of(tiny_cfg).replace(use_clip=True, use_partition=True, train_adj=True)
    img1, img2, cond1, cond2, _, _ = _variant_inputs(tcfg, seed=6)
    t = torch.from_numpy
    b1, b2 = (t(img1), t(cond1)), (t(img2), t(cond2))
    draws = tstep.draw_step(torch.Generator().manual_seed(3), tcfg, tcfg.batch_size, "cpu")
    outs, states = [], []
    for make in (bench_step_variants.make_step_concat, tstep.make_train_step):
        state = create_train_state(tcfg, "cpu")
        outs.append(make(tcfg, state)(state, b1, b2, draws, 12))
        states.append(dict(state.model.named_parameters()))
    for k in tstep.LOSS_KEYS:
        np.testing.assert_allclose(float(outs[0].metrics[k]), float(outs[1].metrics[k]), rtol=1e-6, err_msg=k)
    init = dict(create_train_state(tcfg, "cpu").model.named_parameters())
    moved = 0
    for k, p in states[0].items():
        np.testing.assert_allclose(p.detach().numpy(), states[1][k].detach().numpy(), rtol=0,
                                   atol=2 * tcfg.lr + 1e-7, err_msg=k)
        moved += int((p.detach() != init[k].detach()).any())
    assert moved > 0  # the update moved weights (the partition schedule holds some groups at batch 12)
    with pytest.raises(ValueError, match="bench's config"):
        bench_step_variants.make_step_concat(tcfg.replace(use_gp=True), create_train_state(tcfg, "cpu"))


def test_card_benches_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_step_variants.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_boundary_conv.main([])
    with pytest.raises(RuntimeError, match="times the card"):
        bench_step_variants.bench(device="cpu")
    with pytest.raises(RuntimeError, match="on a card"):
        bench_boundary_conv.bench(device="cpu")


# -------------------------------------------------------- baseline_anchor --

ORACLE_ORDER = {  # tests/test_tf_oracle.py's variable order (TFOracle.d_vars, g_vars, a_vars) in port names
    "d": [f"encoder.block{i}.{p}" for i in range(1, 5) for p in ("conv.kernel", "conv.bias", "norm.gamma",
                                                                 "norm.beta")]
    + ["d_head.pr.kernel", "d_head.pr.bias", "d_head.cond.kernel", "d_head.cond.bias"],
    "g": ["g_head.dense.kernel", "g_head.dense.bias", "g_head.norm.gamma", "g_head.norm.beta"]
    + [f"decoder.block{i}.{p}" for i in range(1, 5) for p in ("conv.kernel", "conv.bias", "norm.gamma",
                                                              "norm.beta")]
    + ["out_conv.kernel", "out_conv.bias"],
    "a": ["adj_head.dense.kernel", "adj_head.dense.bias", "adj_head.norm.gamma", "adj_head.norm.beta"],
}


def test_tf_recipe_equals_the_oracle():
    cfg = _ocfg(use_clip=True)
    params = jinit_params(cfg, jax.random.PRNGKey(3))
    img1, img2, cond1, cond2, noise, new_image = _variant_inputs(cfg, seed=7)
    want = _tf_reference_step(TFOracle(cfg, params), cfg, img1, img2, cond1, cond2, noise, new_image)
    arrays = {k.replace("/", "."): np.asarray(v) for k, v in _flatten(params).items()}
    ref = TFReferenceStep(tcfg_of(cfg), arrays)
    assert {g: sorted(v) for g, v in ref.names.items()} == {g: sorted(v) for g, v in ORACLE_ORDER.items()}
    got = ref.grads(img1, img2, cond1, cond2, noise, new_image)
    for k in ("d_loss", "g_loss", "a_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["fake"].numpy(), want["fake"].numpy(), atol=5e-5)
    np.testing.assert_allclose(got["adj"].numpy(), want["adj"].numpy(), atol=5e-5)
    for g, names in ORACLE_ORDER.items():
        for name, w in zip(names, want[f"{g}_grads"]):
            np.testing.assert_allclose(got[f"{g}_grads"][name].numpy(), w.numpy(), **TF_GRAD_TOL, err_msg=name)
    before = {k: v.numpy().copy() for k, v in ref.vars.items()}
    ref.step(img1, img2, cond1, cond2, noise, new_image)
    assert all(not np.array_equal(before[k], v.numpy()) for k, v in ref.vars.items())  # three Adams applied


def test_baseline_anchor_record(tmp_path, capsys):
    out = tmp_path / "anchor.json"
    assert baseline_anchor.main(["--dim", "16", "--batch", "2", "--steps", "1", "--eager-steps", "0",
                                 "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    jax_keys = {"dim", "batch", "dtype", "host_cpu", "n_host_cores", "jax_step_ms", "tf_graph_ms", "tf_eager_ms",
                "jax_speedup_vs_tf_graph", "jax_speedup_vs_tf_eager", "timed_steps", "note"}
    assert {k.replace("jax_", "torch_") for k in jax_keys} <= set(rec)
    assert rec["device"] == "cpu" and rec["dtype"] == "float32" and (rec["dim"], rec["batch"]) == (16, 2)
    assert rec["torch_step_ms"] > 0 and rec["tf_graph_ms"] > 0 and rec["tf_eager_ms"] is None
    ratio = rec["tf_graph_ms"] / rec["torch_step_ms"]  # of the rounded times: 0.005 for its rounding, 2e-3 theirs
    assert abs(rec["torch_speedup_vs_tf_graph"] - ratio) <= 0.005 + 2e-3 * ratio
    assert _json_lines(capsys.readouterr().out)[-1]["tf_graph_ms"] == rec["tf_graph_ms"]


def test_baseline_anchor_without_tensorflow(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="needs tensorflow"):
        baseline_anchor.main(["--out", str(tmp_path / "a.json")])
    assert not (tmp_path / "a.json").exists()
