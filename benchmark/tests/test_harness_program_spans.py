"""The program's ``littlegan:`` spans and the runtime's ``cudaGraphLaunch``
events in a trace move none of the benchmark's readings, and the program's
trace summary splits the same idle time the benchmark reads.

A trace of the program now holds ``littlegan:<name>`` user-annotation
ranges (``littlegan_tpu_torch/utils/spans.py``) beside the harness's
``bench:`` ones, and a traced replay's device events carry its launch's
correlation id. ``test_harness_trace.py``'s events with both added give the
same device events, spans, window, categories, busy time, idle gaps and top
operations, bit for bit; ``scripts/trace_top_ops.py``'s split of the idle
time into in-graph and between-replay parts adds up to
``device_idle_share.train`` to 1e-9.
"""

from __future__ import annotations

import copy

import pytest

from benchmark import harness
from benchmark import trace as tr
from test_harness_trace import _events

SPANS = ("dispatch", "draws")


def _with_program(events):
    """``events`` with the program's spans, two graph launches (one before
    the window, one in it) and their correlation ids on the device events."""
    out = copy.deepcopy(events)
    corr = {10.0: 1, 20.0: 1, 60.0: 2, 80.0: 2, 85.0: 2}  # device events by start: the replay they belong to
    for e in out:
        if e.get("cat") in tr.DEVICE_CATS and e.get("ph") == "X":
            e["args"] = {"correlation": corr[e["ts"]], "stream": 7}
    x = lambda cat, name, ts, dur, **args: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,  # noqa: E731
                                            "args": args}
    for t0, c in ((-8.0, 1), (44.0, 2)):
        out += [x("user_annotation", "littlegan:step.schedule", t0, 1.0),
                x("user_annotation", "littlegan:dispatch.stage", t0 + 1, 1.0),
                x("user_annotation", "littlegan:dispatch.replay", t0 + 2, 3.0),
                x("cuda_runtime", "cudaGraphLaunch", t0 + 2.5, 2.0, correlation=c),
                x("user_annotation", "littlegan:dispatch.outputs", t0 + 5, 1.0)]
    return out


def _readings(t: tr.Trace):
    return (t.device, t.spans, t.window, t.by_category(), t.busy_s(), t.busy_intervals(), t.idle_gaps(SPANS, "host"),
            t.top_ops(10), t.window_s)


def test_program_spans_move_no_reading():
    assert _readings(tr.Trace(_with_program(_events()))) == _readings(tr.Trace(_events()))


def test_trace_summary_splits_the_benchmarks_idle_share():
    from littlegan_tpu_torch.scripts import trace_top_ops

    events = _with_program(_events())
    idle = harness.load_module("metrics", "device_idle_share.train").read({"kind": "train", "trace": tr.Trace(events)})
    split = trace_top_ops.replay_split(events)
    # replay 1 spans [10, 40], replay 2 [60, 95]; idle [0, 10], [40, 60], [95, 100] between them, [65, 80] inside
    assert split["graph_gap_ms"] == pytest.approx(15e-3, abs=1e-12)
    assert split["host_gap_ms"] == pytest.approx(35e-3, abs=1e-12)
    shares = [100.0 * split[k] / split["window_ms"] for k in ("graph_gap_ms", "host_gap_ms")]
    assert sum(shares) == pytest.approx(idle, abs=1e-9)
