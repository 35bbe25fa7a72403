"""Shared pieces of the benchmark's tests: the ``card`` marker, and small
cells that run the whole harness on the CPU."""

from __future__ import annotations

import copy
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


TINY = {"batch_size": 4, "image_dim": 16, "init_dim": 1, "noise_dim": 13, "attr": [0, 1, 2, 3, 4, 5, 6],
        "conv_filter": [24, 16, 12, 8, 4], "kernel_size": 5, "compute_dtype": "float32", "debug": True,
        "use_pallas": True, "use_pallas_boundary": True}


# serving mixes whose files are kept though no cell of BENCHMARK.json runs them: (configuration, mix)
UNLISTED = {"littlegan-128.serve-generate": ("littlegan-128", "serve-generate"),
            "littlegan-128.serve-mixed": ("littlegan-128", "serve-mixed")}


def load_cell(name: str):
    """A cell of ``BENCHMARK.json``, or one of the kept serving mixes."""
    from benchmark import harness

    if name not in UNLISTED:
        return harness.Cell.load(name)
    config, mix = UNLISTED[name]
    bench = os.path.join(ROOT, "benchmark")
    return harness.Cell(name, 1, harness.load_json(harness.bench_file("configs", config, ".json")),
                        harness.load_json(harness.bench_file("traffic", mix, ".json")),
                        harness.load_json(harness.bench_file("limits", name, ".json")), [], [], bench)


def tiny_cell(name: str, traffic: dict, limits=None, config=None):
    """The named cell at the tiny size, with ``traffic`` merged over its own mix."""
    cell = load_cell(name)
    cell.config = {**copy.deepcopy(cell.config), **(config or TINY)}
    cell.traffic = {**cell.traffic, **traffic}
    if limits is not None:
        cell.limits = limits
    return cell


def run_cpu(cell, seed: int = 12345678901, seconds: float = 0.5, trace: bool = False) -> dict:
    import torch

    from benchmark import run

    return run.execute(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())


TRAIN_TINY = {"k": 3, "store_images": 40, "trace_dispatches": 1}
SERVE_TINY = {"rate": 200, "senders": 8, "image_pool": 8, "check_requests": 24, "trace_seconds": 0.3}
