"""The port's host spans (``utils/spans.py``) on the profiler's clock.

- With no profiler running, ``span`` enters no ``record_function`` range:
  the range's entry is patched to raise, and a span and a whole K-update
  scan step on a CPU state run through.
- Under a CPU ``torch.profiler``, a scan step on a CPU state emits
  ``littlegan:step.schedule`` (its updates run eagerly there: no graph, no
  dispatch spans).
- On a card (marked ``card``; skips without one): each ``GraphedUpdates``
  call emits the five ``dispatch.*`` spans inside the caller's range, and
  the ``cudaGraphLaunch`` inside ``dispatch.replay`` has device events with
  its correlation id, each starting after that launch. On the card's host,
  which has no JAX: ``python -m pytest --noconftest -p no:cacheprovider
  tests/test_torch_spans.py -m card``.
"""

import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from littlegan_tpu_torch.config import Config as TConfig
from littlegan_tpu_torch.training.state import create_train_state
from littlegan_tpu_torch.training.step import draw_step, make_scan_train_step, stack_draws
from littlegan_tpu_torch.utils.spans import PREFIX, span
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

DISPATCH = ("dispatch.stage_wait", "dispatch.stage", "dispatch.inputs", "dispatch.replay", "dispatch.outputs")
TINY = dict(batch_size=4, image_dim=16, init_dim=1, noise_dim=13, attr=[0, 1, 2, 3, 4, 5, 6],
            conv_filter=[24, 16, 12, 8, 4], kernel_size=5, compute_dtype="float32", debug=True)


def _scan_case(cfg: TConfig, device, k: int = 2, n_batches: int = 6):
    """(step, call): a K-update scan step over a small seeded store, and a
    function that runs it once on fresh draws."""
    cfg = cfg.replace(device_data=True, steps_per_dispatch=k)
    state = create_train_state(cfg, device)
    gen = torch.Generator(device=device).manual_seed(0)
    b, d = cfg.batch_size, cfg.image_dim
    images = torch.randint(0, 256, (n_batches, b, d, d, cfg.image_channel), dtype=torch.uint8, generator=gen,
                           device=device)
    conds = torch.where(torch.rand((n_batches, b, len(cfg.attr)), generator=gen, device=device) < 0.5, 0.9, -0.9)
    step = make_scan_train_step(cfg, state, k)

    def call(batch_no0: int = 1):
        draws = stack_draws([draw_step(gen, cfg, b, device) for _ in range(k)])
        ids = [i % n_batches for i in range(2 * k)]
        return step(state, images, conds, ids[0::2], ids[1::2], draws, batch_no0)

    return step, state, images, conds, call


def _trace(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def _annotations(events, prefix=PREFIX):
    return [e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith(prefix)]


def _torch_cfg(tiny_cfg) -> TConfig:
    return TConfig(**{f.name: getattr(tiny_cfg, f.name) for f in dataclasses.fields(tiny_cfg)})


def test_no_profiler_enters_no_range(tiny_cfg, monkeypatch):
    def refuse(self):
        raise AssertionError("a record_function range was entered")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", refuse)
    with span("dispatch.replay"):
        pass
    *_, call = _scan_case(_torch_cfg(tiny_cfg), "cpu")
    call()
    with profile(activities=[ProfilerActivity.CPU]), pytest.raises(AssertionError, match="was entered"):
        with span("dispatch.replay"):  # the same entry, reached once a profiler runs
            pass


def test_scan_step_emits_step_schedule(tiny_cfg, tmp_path):
    *_, call = _scan_case(_torch_cfg(tiny_cfg), "cpu")
    call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(3)
    names = [e["name"] for e in _annotations(_trace(prof, tmp_path))]
    assert names == [PREFIX + "step.schedule"]  # a CPU state: the updates run eagerly, no dispatch spans


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def check_dispatch_spans(device, tmp_path, calls: int = 2):
    """``calls`` traced ``GraphedUpdates`` calls after the capture: returns
    the number of device events each replay's launch correlates with."""
    step, state, images, conds, call = _scan_case(TConfig(**TINY), device)
    step.prepare(state, images, conds)
    call()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            with record_function(f"caller{i}"):
                call(3 + 2 * i)
        torch.cuda.synchronize(device)
    events = _trace(prof, tmp_path)
    per_call = []
    for i in range(calls):
        (caller,) = [e for e in _annotations(events, f"caller{i}")]
        lo, hi = caller["ts"], caller["ts"] + caller["dur"]
        inside = [e for e in _annotations(events) if lo <= e["ts"] and e["ts"] + e["dur"] <= hi]
        assert [e["name"][len(PREFIX):] for e in sorted(inside, key=lambda e: e["ts"])] == ["step.schedule", *DISPATCH]
        (replay,) = [e for e in inside if e["name"] == PREFIX + "dispatch.replay"]
        r0, r1 = replay["ts"], replay["ts"] + replay["dur"]
        (launch,) = [e for e in events if e.get("cat") == "cuda_runtime" and e["name"].startswith("cudaGraphLaunch")
                     and r0 <= e["ts"] <= r1]
        corr = launch["args"]["correlation"]
        device_events = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                         and (e.get("args") or {}).get("correlation") == corr]
        assert device_events, "no device event carries the graph launch's correlation id"
        assert all(e["ts"] >= launch["ts"] for e in device_events)
        per_call.append(len(device_events))
    assert len(set(per_call)) == 1, per_call  # every replay runs the same graph
    return per_call


@pytest.mark.card
def test_dispatch_spans_and_graph_launch_on_the_card(card, tmp_path):
    assert check_dispatch_spans(card, tmp_path)[0] > 0
