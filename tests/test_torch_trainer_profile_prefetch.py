"""The port's Trainer with ``profile_steps`` and with the prefetched host
feed, on the CPU (``device="cpu"``).

- ``profile_steps`` = n writes one ``torch.profiler`` trace under
  ``result/<exp>/log/profile``: steps [10, 10 + n) of the first epoch on
  the one-update path; on the K-update path whole groups from the second
  until n steps are covered, an epoch whose groups end before that (its
  second group the remainder, or only one group) traced to its end, as the
  JAX trainer (``trainer.py:916-925``, ``:1047-1059``);
- the host-fed and host-fed accumulation epochs, whose batches go through
  :class:`~littlegan_tpu_torch.training.trainer.Prefetcher`, end where a
  hand loop of ``train_step`` / ``accum_train_step`` over the same batches
  and draws does: losses and weights bit for bit.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from littlegan_tpu_torch.data import SyntheticDataset
from littlegan_tpu_torch.training.state import create_train_state
from littlegan_tpu_torch.training.step import accum_train_step, train_step
from littlegan_tpu_torch.training.trainer import Trainer, _accum_groups, _pairwise
from littlegan_tpu_torch.utils.tensorboard import read_scalars
from test_torch_train import tcfg_of
from test_torch_trainer_device import _cfg
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)


def _profiled_run(tiny_cfg, tmp_path, monkeypatch, updates, **kw):
    """Train one epoch of ``updates`` updates with profile_steps 2; returns
    (the batch numbers of the updates run while the window was open, the
    trace files)."""
    traced = []
    real = Trainer._after_dispatch

    def after_dispatch(self, out, epoch, prev_batch, batch_no):
        if self._profile.active:
            traced.extend(range(prev_batch + 1, batch_no + 1))
        return real(self, out, epoch, prev_batch, batch_no)

    monkeypatch.setattr(Trainer, "_after_dispatch", after_dispatch)
    cfg = tcfg_of(_cfg(tiny_cfg, tmp_path, profile_steps=2, **kw))
    tr = Trainer(cfg, SyntheticDataset(cfg, num_items=2 * updates * cfg.batch_size), device="cpu")
    tr.train()
    assert tr.global_step == updates and not tr._profile.active
    return traced, glob.glob(os.path.join(cfg.result_dir, "log", "profile", "*.pt.trace.json"))


@pytest.mark.parametrize("kw,updates,window", [
    (dict(), 12, [10, 11]),
    (dict(device_data=True, steps_per_dispatch=3), 7, [4, 5, 6]),  # the second group
    (dict(device_data=True, steps_per_dispatch=3), 4, [4]),  # the second group is the remainder
    (dict(device_data=True, steps_per_dispatch=3), 2, [1, 2]),  # one group, the remainder
], ids=["step", "scan", "scan-remainder", "scan-one-group"])
def test_profile_steps_writes_one_trace(tiny_cfg, tmp_path, monkeypatch, capsys, kw, updates, window):
    """The updates run inside the window, and one trace file holding their
    host ops."""
    traced, traces = _profiled_run(tiny_cfg, tmp_path, monkeypatch, updates, **kw)
    assert traced == window
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(str(n).startswith("aten::convolution") for n in names)
    out = capsys.readouterr().out
    assert out.count("profiler trace written to") == 1 and os.path.join("log", "profile") in out


def _hand_loop(cfg, data, m):
    """The host-fed epoch 1 by hand: each update's batches from the
    dataset's epoch order, the trainer's draws, train_step or
    accum_train_step at batch_no 1, 2, ..."""
    state = create_train_state(cfg, "cpu")
    tr = Trainer(cfg.replace(exp_name="draws"), None, device="cpu")  # for its draws only
    pairs = _pairwise(data.epoch_iterator(1))
    updates = _accum_groups(pairs, m) if m > 1 else pairs
    losses = []
    for i, (b1, b2) in enumerate(updates):
        put = lambda b: (torch.from_numpy(b[0]), torch.from_numpy(b[1]))  # noqa: E731
        step = accum_train_step if m > 1 else train_step
        out = step(state, put(b1), put(b2), tr.update_draws(i + 1), i + 1, cfg)
        losses.append([float(out.metrics[k]) for k in ("loss/gen", "loss/disc")])
    return state, losses


@pytest.mark.parametrize("m", [1, 2], ids=["host-fed", "host-fed-accum"])
def test_prefetched_epoch_equals_a_hand_loop(tiny_cfg, tmp_path, m):
    cfg = tcfg_of(_cfg(tiny_cfg, tmp_path, grad_accum=m))
    data = SyntheticDataset(cfg, num_items=2 * m * 3 * cfg.batch_size)
    tr = Trainer(cfg, data, device="cpu")
    tr.train()
    state, losses = _hand_loop(cfg, data, m)
    scalars = read_scalars(os.path.join(cfg.result_dir, "log"))
    logged = [[g, d] for (_, g), (_, d) in zip(scalars["loss/gen"], scalars["loss/disc"])]
    assert len(logged) == len(losses) == 3
    np.testing.assert_array_equal(np.float32(logged), np.float32(losses))
    for (name, a), b in zip(tr.state.model.named_parameters(), state.model.parameters()):
        assert torch.equal(a, b), name
    assert tr.state.opt_g.count == state.opt_g.count
