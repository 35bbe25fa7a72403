"""The control on the card: the plain reference in float8 in the program's
place fails the check, and the program passes it, at each cell's widths
with a smaller dataset, window and sample. Run on a card with
``python -m pytest benchmark/tests -m card``; skips without one."""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from conftest import load_cell

CELLS = {
    "littlegan-128.train-graph": {"k": 8, "store_images": 2048},
    "littlegan-256.train-graph": {"k": 8, "store_images": 1024},
    "littlegan-128.serve-generate": {"check_requests": 64},
    "littlegan-128.serve-mixed": {"check_requests": 96},
}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_and_program_passes(name, card):
    cell = load_cell(name)
    cell.traffic = {**cell.traffic, **CELLS[name]}
    ctx = harness.Context(cell, 4294967311, 1.0, False, card, time.perf_counter(), controls=True)
    out = cell.driver().run(ctx)
    assert harness.correct(out.checks), out.checks
    control = out.readings["control"]
    assert any(control[n] > lim for n, lim in cell.limits.items()), control
