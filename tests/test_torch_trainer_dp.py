"""The port's ``Trainer`` over 2 gloo ranks on the CPU, and ``torchrun``.

Each case runs ``tests/torch_dp_common.py::train_epochs`` in 2 processes,
rank r writing under its own directory (``r<rank>``), so that what each
rank writes is seen apart, and once in this process on the whole batch:

- host-fed (each rank decodes its rows of every synthetic batch), the
  card-resident store with K = 2 updates per call (eager here), and
  host-fed accumulation of 2 micro-pairs: the ranks end equal, equal to
  the one-process run to rtol 2e-4 / atol 2e-5 (tests/test_parallel.py's
  DP bound), with the same logged losses to rtol 2e-4;
- rank 1 writes no file; rank 0's checkpoint restores in the JAX package's
  ``Trainer``; with ZeRO-1 the checkpoint holds the whole moments;
- a SIGINT on rank 1 stops both ranks at the same dispatch, rank 0 saving
  the interrupt checkpoint;
- ``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
  littlegan_tpu_torch train ... --device cpu`` trains data-parallel.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from littlegan_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu.training.trainer import Trainer as JTrainer
from test_torch_parallel import DP_TOL
from torch_dp_common import REPO, assert_states_close, run_ranks, train_epochs
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

ITEMS = 32  # 4 batches of 8: 2 updates, or 1 of 2 micro-pairs


def _case(tiny_cfg, root, **kw):
    cfg = tiny_cfg.replace(batch_size=8, epoch=1, freq_gen=2, freq_test=2, exp_name="dp", use_partition=True, **kw)
    return dict(cfg={f: getattr(cfg, f) for f in cfg.__dataclass_fields__}, root=str(root), items=ITEMS), cfg


def _files(root):
    """The files under ``root``, an event file's time and host left out of its name."""
    name = lambda f: "events.out.tfevents" if f.startswith("events.out.tfevents") else f  # noqa: E731
    return sorted(os.path.relpath(os.path.join(d, name(f)), root) for d, _, fs in os.walk(root) for f in fs)


EPOCHS = {"host-fed": dict(), "store-K2": dict(device_data=True, steps_per_dispatch=2),
          "accum2": dict(grad_accum=2)}


@pytest.fixture(scope="module")
def epochs(tiny_cfg, tmp_path_factory):
    """name -> (each rank's result, the one-process result, the root): the
    2-rank epochs of EPOCHS in one start of the ranks."""
    root = tmp_path_factory.mktemp("dp_epochs")
    cases = {name: _case(tiny_cfg, root / name / "dp", **kw)[0] for name, kw in EPOCHS.items()}
    ranks = dict(zip(EPOCHS, zip(*run_ranks("train_many", 2, list(cases.values())))))
    return {name: (ranks[name], train_epochs(None, dict(case, root=str(root / name / "single"))), root / name)
            for name, case in cases.items()}


@pytest.mark.parametrize("name", list(EPOCHS))
def test_two_rank_epoch_equals_one_process(epochs, name):
    ranks, single, root = epochs[name]
    (flat, logged, code), (flat1, logged1, code1) = ranks
    assert code == code1 == 0
    assert all(np.array_equal(flat[k], flat1[k]) for k in flat)
    assert [s for s, _ in logged] == [s for s, _ in logged1] == [s for s, _ in single[1]]
    for (_, a), (_, b), (_, c) in zip(logged, logged1, single[1]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_allclose(a[k], c[k], rtol=2e-4)
    assert_states_close(flat, single[0], **DP_TOL)
    assert not (root / "dp" / "r1").exists()  # rank 1 wrote nothing
    assert _files(root / "dp" / "r0") == _files(root / "single" / "r0")


@pytest.fixture(scope="module")
def restores(tiny_cfg, tmp_path_factory):
    """zero -> (rank 0's whole state, its config, root): 2-rank epochs with
    and without ZeRO-1 in one start of the ranks."""
    root = tmp_path_factory.mktemp("dp_restore")
    cases = {zero: _case(tiny_cfg, root / str(zero), shard_opt_state=zero, ema_decay=0.5) for zero in (False, True)}
    res = run_ranks("train_many", 2, [dict(case, min_shard_elems=0) for case, _ in cases.values()])[0]
    return {zero: (r[0], cases[zero][1], root / str(zero)) for zero, r in zip(cases, res)}


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero1"])
def test_checkpoint_restores_in_the_jax_trainer(restores, zero):
    flat, cfg, root = restores[zero]
    jcfg = cfg.replace(all_result_dir=str(root / "r0" / "result"), test_data_dir=str(root / "r0" / "test-data"))
    jt = JTrainer(jcfg, JSyntheticDataset(jcfg, num_items=ITEMS))
    assert (jt.global_epoch, jt.global_step) == (2, 2)
    want = _flatten(jt.state)
    assert sorted(want) == sorted(flat)
    for k, w in want.items():  # the whole moments, ZeRO-1's gathered from both ranks
        raw = lambda x: np.ascontiguousarray(x).reshape(-1).view(np.uint8)  # noqa: E731
        np.testing.assert_array_equal(raw(w), raw(flat[k]), err_msg=k)


def test_sigint_on_one_rank_stops_both(tiny_cfg, tmp_path):
    case, _ = _case(tiny_cfg, tmp_path, device_data=True, steps_per_dispatch=1)
    (flat, _, code), (flat1, _, code1) = run_ranks("train_epochs", 2, dict(case, interrupt_rank=1))
    assert code == code1 == 1
    assert all(np.array_equal(flat[k], flat1[k]) for k in flat)
    ckpt = tmp_path / "r0" / "result" / "dp" / "checkpoint"
    assert os.path.isfile(ckpt / "ckpt-interrupt.npz") and not (tmp_path / "r1").exists()
    with open(ckpt / "status.json") as f:
        assert json.load(f) == {"epoch": 1, "step": 1, "batch": 1}  # both stopped after the first update


def test_torchrun_trains_data_parallel(tmp_path):
    (tmp_path / "sample.config.json").write_text(
        '{"batch_size": 4, "image_dim": 16, "init_dim": 1, "noise_dim": 13, '
        '"conv_filter": [24, 16, 12, 8, 4], "epoch": 1, "freq_gen": 2, "freq_test": 4, '
        f'"all_result_dir": "{tmp_path}/result", "test_data_dir": "{tmp_path}/test-data", '
        '"compute_dtype": "float32"}'
    )
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "littlegan_tpu_torch", "train", "exp1", "--debug", "--synthetic-data", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("Data-parallel training over 2 devices") == 2
    root = tmp_path / "result" / "exp1"
    assert (root / "checkpoint" / "ckpt-1.npz").is_file() and (root / "train" / "gen" / "1-2.jpg").is_file()
