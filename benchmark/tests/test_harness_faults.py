"""A whole run on the CPU at a small size, past the look for a card, with
the timed path broken underneath: ``correct`` comes out false for each
fault the cell can have, under the cell's own limits. (One card: no
exchange between chips to leave out.)"""

from __future__ import annotations

import numpy as np
import pytest

from conftest import SERVE_TINY, TRAIN_TINY, run_cpu, tiny_cell

TRAIN_CELLS = ["littlegan-128.train-graph", "littlegan-256.train-graph"]
SERVE_CELLS = ["littlegan-128.serve-generate", "littlegan-128.serve-mixed"]


@pytest.mark.parametrize("cell", TRAIN_CELLS + SERVE_CELLS)
def test_sound_run_is_correct(cell):
    traffic = TRAIN_TINY if cell in TRAIN_CELLS else SERVE_TINY
    assert run_cpu(tiny_cell(cell, traffic))["correct"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_state_left_unchanged(cell, monkeypatch):
    from littlegan_tpu_torch.training import step

    monkeypatch.setattr(step, "masked_adam_update_rows", lambda *a, **k: None)
    out = run_cpu(tiny_cell(cell, TRAIN_TINY))
    assert not out["correct"] and out["checked"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_of_the_batch_left_out(cell, monkeypatch):
    from littlegan_tpu_torch.training import step

    whole = step.total_loss_fn

    def half(model, batch1, batch2, noise, new_image, cfg, *args, **kw):
        n = noise.shape[0] // 2
        cut = lambda b: (b[0][:n], b[1][:n])  # noqa: E731
        return whole(model, cut(batch1), cut(batch2), noise[:n], new_image[:n], cfg, *args, **kw)

    monkeypatch.setattr(step, "total_loss_fn", half)
    out = run_cpu(tiny_cell(cell, TRAIN_TINY))
    assert not out["correct"]
    assert out["checked"]["loss_gap_first"]["value"] > out["checked"]["loss_gap_first"]["limit"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_answer_altered_where_it_is_produced(cell, monkeypatch):
    from littlegan_tpu_torch.serving import InferenceEngine

    out_rows = InferenceEngine._out
    monkeypatch.setattr(InferenceEngine, "_out", staticmethod(lambda t, n: out_rows(t, n) * 0.5))
    assert not run_cpu(tiny_cell(cell, SERVE_TINY))["correct"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_half_of_the_batch_left_out_serving(cell, monkeypatch):
    from littlegan_tpu_torch.serving import InferenceEngine

    pad = InferenceEngine._pad

    def half(self, arr):
        arr = np.array(arr, np.float32)
        arr[(arr.shape[0] + 1) // 2:] = 0.0  # the later half of the rows never reaches the model
        return pad(self, arr)

    monkeypatch.setattr(InferenceEngine, "_pad", half)
    assert not run_cpu(tiny_cell(cell, SERVE_TINY))["correct"]
