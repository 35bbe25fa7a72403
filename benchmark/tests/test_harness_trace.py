"""Reading a Chrome trace: categories, busy and idle time, gaps named by span."""

from __future__ import annotations

import json

import pytest

from benchmark import trace as tr


def _events():
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}  # noqa: E731
    span = lambda name, ts, dur: {"ph": "X", "cat": "user_annotation", "name": "bench:" + name,  # noqa: E731
                                  "ts": ts, "dur": dur}
    return [
        span("traced_window", 0.0, 100.0),
        span("dispatch", 0.0, 30.0),
        span("draws", 50.0, 20.0),
        k("void at::native::elementwise_kernel<direct_copy_kernel_cuda>", 10.0, 10.0),  # elementwise
        k("sm90_xmma_fprop_implicit_gemm_bf16_cudnn", 20.0, 20.0),  # conv, overlaps nothing
        k("void multi_tensor_apply_kernel<AdamFunctor>", 60.0, 5.0),  # foreach
        k("(anonymous namespace)::cluster_kernel<__nv_bfloat16, false>(__nv_bfloat16 const*, float*)", 80.0, 10.0),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 85.0, "dur": 10.0},  # overlaps the kernel
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 100.0},  # host: not device time
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5.0},
    ]


def test_categories():
    t = tr.Trace(_events())
    cats = t.by_category()
    assert cats["elementwise"] == pytest.approx(10e-6)
    assert cats["conv"] == pytest.approx(20e-6)
    assert cats["foreach"] == pytest.approx(5e-6)
    assert cats["K1 norm_lrelu.cu"] == pytest.approx(10e-6)
    assert cats["gpu_memcpy"] == pytest.approx(10e-6)
    assert set(cats) == {"elementwise", "conv", "foreach", "K1 norm_lrelu.cu", "gpu_memcpy"}


def test_busy_and_idle_share():
    t = tr.Trace(_events())
    assert t.window_s == pytest.approx(100e-6)
    # busy: [10, 40] + [60, 65] + [80, 95] = 30 + 5 + 15
    assert t.busy_s() == pytest.approx(50e-6)


def test_idle_gaps_named_by_span():
    t = tr.Trace(_events())
    gaps = dict(t.idle_gaps(("dispatch", "draws"), "host"))
    # idle: [0, 10] in dispatch, [40, 60] (middle 50: draws), [65, 80] (middle 72.5: nothing), [95, 100]
    assert gaps["dispatch"] == pytest.approx(10e-6)
    assert gaps["draws"] == pytest.approx(20e-6)
    assert gaps["host"] == pytest.approx(20e-6)


def test_load_and_demangle(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    assert tr.Trace.load(str(path)).busy_s() == pytest.approx(50e-6)
    assert tr.kernel_name("_ZN12_GLOBAL__N_114cluster_kernelIfEEvPKT_") == "cluster_kernel<f>"
    assert tr.categorize("_ZN12_GLOBAL__N_111fold_kernelIfEEvPKT_", "kernel")[0] == "K3 bwd boundary_conv_bwd.cu"
