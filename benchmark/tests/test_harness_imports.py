"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module names; the reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "littlegan_tpu"}


def _top_level(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_a_whole_run_load_no_jax():
    code = """
import glob, os, sys, time
sys.path.insert(0, 'benchmark/tests')
import torch
from benchmark import harness, run, calibrate, roofline, trace, metrics_common
from benchmark.reference import littlegan
for path in glob.glob('benchmark/drivers/*.py') + glob.glob('benchmark/metrics/*.py'):
    name = os.path.basename(path)[:-3]
    if name != '__init__':
        harness.load_module(os.path.basename(os.path.dirname(path)), name)
from conftest import tiny_cell, run_cpu, TRAIN_TINY, SERVE_TINY
assert run_cpu(tiny_cell('littlegan-128.train-graph', TRAIN_TINY), seconds=0.2)['correct']
assert run_cpu(tiny_cell('littlegan-128.serve-mixed', SERVE_TINY), seconds=0.3)['correct']
"""
    names = _top_level(code)
    assert "littlegan_tpu_torch" in names and "benchmark" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level("import benchmark.reference.littlegan, benchmark.roofline, benchmark.trace")
    assert not names & (FORBIDDEN | {"littlegan_tpu_torch"})


def test_forbidden_names_are_whole_words():
    from benchmark import harness

    sys.modules.setdefault("littlegan_tpu_torch_fake", sys)  # a name that only begins with the JAX package's
    try:
        assert "littlegan_tpu_torch_fake" not in harness.forbidden_modules()
    finally:
        del sys.modules["littlegan_tpu_torch_fake"]
