"""The kernels' bounds worked out from a configuration's shapes."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import roofline
from conftest import ROOT

# PERF.md's kernel table, bound column: ms per train step at 128x128, batch 32, bf16
KERNEL_TABLE_BOUND_MS = {"K1": 0.1634, "K1p": 0.0601, "K2": 0.2324, "K1p_bwd": 0.0751, "K3": 0.0357, "fold": 0.0751}
# launches per train step (chip_smoke.py's EXPECTED_TRAIN_LAUNCHES)
LAUNCHES = {"K1": 20, "K1p": 4, "K3": 4, "K2": 20, "K1p_bwd": 4, "fold": 4}


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("family", sorted(KERNEL_TABLE_BOUND_MS))
def test_bound_reproduces_the_kernel_table(family):
    cfg = _config("littlegan-128")
    assert round(roofline.update_bound_s(cfg)[family] * 1e3, 4) == KERNEL_TABLE_BOUND_MS[family]
    assert sum(k for _, k in roofline.update_launches(cfg)[family]) == LAUNCHES[family]


def test_256_moves_four_times_the_bytes():
    small, large = roofline.update_bound_s(_config("littlegan-128")), roofline.update_bound_s(_config("littlegan-256"))
    for family in small:
        assert large[family] == pytest.approx(4 * small[family], rel=0.01)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 1.0, "bfloat16") == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 2 * 989.4e12, "bfloat16") == pytest.approx(2.0)
