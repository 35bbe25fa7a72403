"""The command exits non-zero and prints no result without a card, and in a
checkout that holds only the benchmark."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

ARGS = ["--workload", "littlegan-128.train-graph", "--seed", "4294967311", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_result_with_only_the_benchmark(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_unknown_cell_is_refused():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "nope", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
