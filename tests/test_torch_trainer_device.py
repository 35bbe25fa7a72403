"""The port's Trainer over the device-resident dataset and with gradient
accumulation, on the CPU (``device="cpu"``), mirroring the JAX package's
tests/test_trainer.py:

- K updates per dispatch end where K one-update steps do (:598);
- ``grad_accum`` over the device store equals the host-fed accumulation
  path (:738), on a file-backed dataset (the synthetic set draws other
  images every epoch, the store holds epoch 0's);
- the trailing remainder group covers the epoch and fires its cadences
  (:890, :905); per-step scalars from a K-update dispatch (:636);
- mid-epoch resume on the scan path and on the host-fed accumulation path
  (:198, :236);
- the ``steps_per_dispatch`` warning without ``device_data`` (:578), and the
  one for an epoch that would apply no update;
- a port ``device_data`` checkpoint restores in the JAX ``Trainer``;
- ``python -m littlegan_tpu_torch train --synthetic-data --device cpu``
  with ``device_data`` + ``steps_per_dispatch`` and with ``grad_accum``.

Tolerance: the port against itself, bit for bit (the K-update path runs the
same updates eagerly on a CPU state; its row form of Adam agrees with the
host form bit for bit, tests/test_torch_dispatch.py). Checkpoints against
the JAX Trainer's restore: exact.
"""

import json
import os

import numpy as np
import pytest

from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch import cli
from littlegan_tpu_torch.data import CelebA, SyntheticDataset
from littlegan_tpu_torch.training.checkpoint import flatten_state
from littlegan_tpu_torch.training.trainer import Trainer
from littlegan_tpu_torch.utils.tensorboard import read_scalars
from test_torch_train import tcfg_of
from test_torch_trainer import _same_flat
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)


def _cfg(tiny_cfg, tmp_path, name="exp", **kw):
    kw = {"epoch": 1, "freq_gen": 0, "freq_test": 0, **kw}
    return tiny_cfg.replace(all_result_dir=str(tmp_path / "result"), test_data_dir=str(tmp_path / f"td-{name}"),
                            exp_name=name, **kw)


def _run(cfg, data, **kw):
    tr = Trainer(cfg, data, device="cpu", **kw)
    tr.train()
    return tr


def _synthetic(cfg, batches):
    return SyntheticDataset(cfg, num_items=batches * cfg.batch_size)


def _jpeg_dataset(tmp_path, cfg, n_images):
    """A CelebA directory of ``n_images`` 16x16 JPEGs and an attribute file."""
    from PIL import Image

    img_dir = tmp_path / "img"
    img_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(7)
    lines = [str(n_images), " ".join(f"A{i}" for i in range(40))]
    for i in range(n_images):
        name = f"{i:06d}.jpg"
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(img_dir / name, quality=95)
        lines.append(name + " " + " ".join(str(v) for v in rng.choice([-1, 1], size=40)))
    (tmp_path / "attrs.txt").write_text("\n".join(lines))
    return cfg.replace(image_path=str(img_dir), attr_path=str(tmp_path / "attrs.txt"), use_native_loader=False)


@pytest.mark.parametrize("flags", [dict(use_s2d=True), dict(use_s2d=True, use_pallas=True, use_pallas_boundary=True,
                                                            adj_half_batch=True, ema_decay=0.9)])
def test_dispatched_steps_equal_sequential_steps(tiny_cfg, tmp_path, flags):
    """16 batches = 8 steps as two 4-update dispatches, against eight gather
    steps: the same state, bit for bit, and the same logged losses."""
    one = tcfg_of(_cfg(tiny_cfg, tmp_path, name="one", device_data=True, **flags))
    four = tcfg_of(_cfg(tiny_cfg, tmp_path, name="four", device_data=True, steps_per_dispatch=4, **flags))
    a, b = _run(one, _synthetic(one, 16)), _run(four, _synthetic(four, 16))
    assert a.global_step == b.global_step == 8 and sorted(b._scan_steps) == [4]
    _same_flat(flatten_state(b.state), flatten_state(a.state))
    assert read_scalars(os.path.join(four.result_dir, "log")) == read_scalars(os.path.join(one.result_dir, "log"))


def test_grad_accum_device_data_equals_host_fed(tiny_cfg, tmp_path):
    """12 batches = 6 pairs = 3 updates of M = 2: host-fed accumulation
    against the device store with K = 2 (one full dispatch and a 1-update
    remainder): the same state, bit for bit."""
    base = _jpeg_dataset(tmp_path, tiny_cfg, 48).replace(batch_size=4)
    host = tcfg_of(_cfg(base, tmp_path, name="host", grad_accum=2))
    dev = tcfg_of(_cfg(base, tmp_path, name="dev", grad_accum=2, device_data=True, steps_per_dispatch=2))
    a, b = _run(host, CelebA(host)), _run(dev, CelebA(dev))
    assert a.global_step == b.global_step == 3 and sorted(b._scan_steps) == [1, 2]
    _same_flat(flatten_state(b.state), flatten_state(a.state))


def test_remainder_dispatch_covers_the_epoch_and_fires_cadences(tiny_cfg, tmp_path):
    """10 batches with K = 3: a full group (steps 1-3) and a remainder
    (steps 4-5); batch_no 3 -> 5 crosses freq_gen = 4 inside the remainder."""
    cfg = tcfg_of(_cfg(tiny_cfg, tmp_path, device_data=True, steps_per_dispatch=3, freq_gen=4))
    tr = _run(cfg, _synthetic(cfg, 10))
    assert tr.global_step == 5 and sorted(tr._scan_steps) == [2, 3]
    assert os.listdir(os.path.join(cfg.result_dir, "train", "gen")) == ["1-5.jpg"]


def test_scan_dispatch_logs_every_step(tiny_cfg, tmp_path, capsys):
    """A K-update dispatch logs one scalar per step, the adjuster's only
    after batch 10, and the "Time usage" line counts 2 x B x K x M images
    per dispatch (M = 2 here, K = 2: 24 batches = 6 updates)."""
    cfg = tcfg_of(_cfg(tiny_cfg, tmp_path, device_data=True, steps_per_dispatch=2, freq_test=4))
    tr = _run(cfg, _synthetic(cfg, 24))
    logged = read_scalars(os.path.join(cfg.result_dir, "log"))
    assert [s for s, _ in logged["loss/gen"]] == list(range(1, 13)) and [s for s, _ in logged["loss/adj"]] == [11, 12]
    assert sorted(os.listdir(os.path.join(cfg.result_dir, "test", "disc"))) == ["1-12.json", "1-4.json", "1-8.json"]
    acc = tcfg_of(_cfg(tiny_cfg, tmp_path, name="acc", device_data=True, steps_per_dispatch=2, grad_accum=2))
    capsys.readouterr()
    tr = _run(acc, _synthetic(acc, 24))
    assert tr.global_step == 6 and "device_data x grad_accum: 2 micro-pairs per update" in capsys.readouterr().out
    again = Trainer(acc.replace(exp_name="acc2"), _synthetic(acc, 24), device="cpu")
    assert again._scan_epoch(1, 0) == (2 * acc.batch_size * 2 * 6, 0)  # (images, dropped batches)


def test_mid_epoch_resume_on_the_scan_path(tiny_cfg, tmp_path):
    """Epochs of 3 groups of K = 2 (12 batches); run B is interrupted at
    epoch 2, batch 2 (a group boundary), restarted, and ends where run A
    does, bit for bit."""
    def cfg(name):
        return tcfg_of(_cfg(tiny_cfg, tmp_path, name=name, epoch=2, device_data=True, steps_per_dispatch=2,
                            freq_test=2))

    a = _run(cfg("a"), _synthetic(cfg("a"), 12))
    b = Trainer(cfg("b"), _synthetic(cfg("b"), 12), device="cpu")
    real_predict, calls = b.predict, []

    def predict_and_flag(*args, **kw):
        out = real_predict(*args, **kw)
        calls.append(1)
        if len(calls) == 4:
            b._interrupt_requested = True
        return out

    b.predict = predict_and_flag
    with pytest.raises(SystemExit):
        b.train()
    with open(os.path.join(cfg("b").result_dir, "checkpoint", "status.json")) as f:
        status = json.load(f)
    assert (status["epoch"], status["step"], status["batch"]) == (2, 8, 2)
    resumed = Trainer(cfg("b"), _synthetic(cfg("b"), 12), device="cpu")
    assert resumed._resume_batch == 2
    resumed.train()
    assert resumed.global_step == a.global_step == 12
    _same_flat(flatten_state(resumed.state), flatten_state(a.state))


def test_mid_epoch_resume_with_host_fed_grad_accum(tiny_cfg, tmp_path):
    """Host-fed accumulation skips 2 x M batches per applied update on
    resume: 12 batches = 3 updates per epoch, interrupted after update 4."""
    def cfg(name):
        return tcfg_of(_cfg(tiny_cfg, tmp_path, name=name, epoch=2, grad_accum=2))

    a = _run(cfg("a"), _synthetic(cfg("a"), 12))
    b = Trainer(cfg("b"), _synthetic(cfg("b"), 12), device="cpu")
    real_step = b._accum_step

    def step_then_interrupt(*args, **kw):
        out = real_step(*args, **kw)
        if b.global_step == 4:
            b._interrupt_requested = True
        return out

    b._accum_step = step_then_interrupt
    with pytest.raises(SystemExit):
        b.train()
    resumed = Trainer(cfg("b"), _synthetic(cfg("b"), 12), device="cpu")
    assert (resumed.global_epoch, resumed.global_step, resumed._resume_batch) == (2, 4, 1)
    resumed.train()
    assert resumed.global_step == a.global_step == 6
    _same_flat(flatten_state(resumed.state), flatten_state(a.state))


def test_steps_per_dispatch_warns_without_device_data(tiny_cfg, tmp_path, capsys):
    cfg = tcfg_of(_cfg(tiny_cfg, tmp_path, steps_per_dispatch=4))
    tr = _run(cfg, _synthetic(cfg, 4))
    assert "steps_per_dispatch > 1 requires device_data=True" in capsys.readouterr().out
    assert tr.global_step == 2  # one step per dispatch, 4 batches -> 2 steps


def test_an_epoch_without_a_whole_accumulation_group_warns(tiny_cfg, tmp_path, capsys):
    cfg = tcfg_of(_cfg(tiny_cfg, tmp_path, grad_accum=3))
    tr = _run(cfg, _synthetic(cfg, 4))
    assert "every epoch would apply ZERO updates" in capsys.readouterr().out
    assert tr.global_step == 0


def test_device_data_checkpoint_restores_in_jax_trainer(tiny_cfg, tmp_path):
    """A port run over the device store with K = 2 and M = 2 (8 batches =
    2 updates, one dispatch) writes a checkpoint the JAX Trainer restores,
    array for array."""
    from littlegan_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
    from littlegan_tpu.training.trainer import Trainer as JTrainer

    jcfg = _cfg(tiny_cfg, tmp_path, device_data=True, steps_per_dispatch=2, grad_accum=2, ema_decay=0.5,
                moment_dtype="bfloat16")
    tcfg = tcfg_of(jcfg)
    tr = _run(tcfg, _synthetic(tcfg, 8))
    assert tr.global_step == 2
    jt = JTrainer(jcfg, JSyntheticDataset(jcfg, num_items=8 * jcfg.batch_size))
    assert (jt.global_epoch, jt.global_step) == (2, 2)
    _same_flat(flatten_state(tr.state), _flatten(jt.state))


@pytest.mark.parametrize("extra", ['"device_data": true, "steps_per_dispatch": 3', '"grad_accum": 2'])
def test_cli_trains_with_the_device_store_and_accumulation(tmp_path, monkeypatch, extra):
    """``train --synthetic-data --device cpu`` (64 items = 16 batches of 4):
    8 steps in dispatches of 3, 3 and 2, or 4 updates of 2 micro-pairs."""
    (tmp_path / "sample.config.json").write_text(
        '{"batch_size": 4, "image_dim": 16, "init_dim": 1, "noise_dim": 13, '
        '"conv_filter": [24, 16, 12, 8, 4], "epoch": 1, "freq_gen": 2, "freq_test": 4, '
        f'"all_result_dir": "{tmp_path}/result", "test_data_dir": "{tmp_path}/test-data", '
        f'"compute_dtype": "float32", {extra}}}'
    )
    monkeypatch.chdir(tmp_path)
    assert cli.main(["train", "exp1", "--debug", "--synthetic-data", "--device", "cpu"]) == 0
    root = tmp_path / "result" / "exp1"
    assert (root / "checkpoint" / "ckpt-1.npz").is_file()
    steps = 8 if "device_data" in extra else 4
    logged = read_scalars(str(root / "log"))
    assert [s for s, _ in logged["loss/gen"]] == list(range(1, steps + 1))
    assert all(np.isfinite(v) for series in logged.values() for _, v in series)
    assert os.listdir(root / "train" / "gen") and os.listdir(root / "test" / "disc")
