"""The orbax backend's counterpart (``training/checkpoint.py::OrbaxCheckpointer``,
``torch.distributed.checkpoint`` underneath), against the port's own npz
backend: neither package reads the other's files.

On the CPU in this process (JAX's ``tests/test_trainer.py`` orbax cases):

- save then restore gives the npz round trip's state, bit for bit (bf16
  moments and an EMA included); ``status.json`` appears only at ``wait()``;
- a ``Trainer`` on the orbax backend: a run resumed after epoch 1 ends
  bit for bit where the unbroken run does, and where the npz backend's
  does;
- a SIGINT saves a complete interrupt checkpoint before the exit, and
  the resumed run ends bit for bit where the unbroken one does;
- an ``ocp-4.tmp-*`` directory left by a killed save is skipped;
- a status one epoch behind the newest checkpoint is reconciled with the
  JAX package's warning;
- ``epoch_tags`` lists only committed epoch tags and does not wait for the
  save in flight; ``delete`` removes a tag.

On 2 and 4 gloo ranks (JAX's ``tests/test_multihost.py`` sharded-state
cases), with ZeRO-1 over the data ranks and ``shard_dense`` + ZeRO-1 over
a ('data', 'model') mesh, every rank writing its own parts into one
checkpoint: the state restored at the saved layout is bit for bit the one
saved, the resumed run ends bit for bit where the unbroken one does and
where the npz backend's does (whose file holds the gathered state), and
the checkpoint restores at another layout (one process; 2-rank
checkpoints at 4 ranks) to the same whole state.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from littlegan_tpu_torch.config import Config as TConfig
from littlegan_tpu_torch.training.checkpoint import (
    Checkpointer, OrbaxCheckpointer, flatten_state, make_checkpointer,
)
from littlegan_tpu_torch.training.state import create_train_state
from torch_dp_common import run_ranks
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)
from torch_rank_workers import ckpt_runs

ITEMS = 32  # 4 batches of 8: 2 updates an epoch


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _tcfg(tiny_cfg, **kw):
    return TConfig(**_fields(tiny_cfg.replace(**kw)))


def _state(cfg):
    """A train state with every leaf moved off its init, counts included."""
    st = create_train_state(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in st.model.parameters():
            p.add_(torch.randn(p.shape, generator=gen))
        for opt in (st.opt_g, st.opt_d, st.opt_a):
            for k in opt.mu:
                opt.mu[k].copy_(torch.randn(opt.mu[k].shape, generator=gen))
                opt.nu[k].copy_(torch.rand(opt.nu[k].shape, generator=gen))
                opt.count[k] = 5
        for e in (st.ema or {}).values():
            e.copy_(torch.randn(e.shape, generator=gen))
    return st


def _flat(state):
    return {k: np.array(v) for k, v in flatten_state(state).items()}


def _assert_flat_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture
def cfg(tiny_cfg):
    return _tcfg(tiny_cfg, moment_dtype="bfloat16", ema_decay=0.5)


def test_make_checkpointer_selects_orbax(cfg, tmp_path):
    orbax = cfg.replace(extra={"checkpoint_backend": "orbax"})
    assert isinstance(make_checkpointer(orbax, str(tmp_path)), OrbaxCheckpointer)
    assert isinstance(make_checkpointer(cfg, str(tmp_path)), Checkpointer)


def test_roundtrip_equals_npz_roundtrip(cfg, tmp_path):
    state = _state(cfg)
    want = _flat(state)
    npz = Checkpointer(str(tmp_path / "npz"))
    npz.save("3", state, {"epoch": 4, "step": 12})
    from_npz, _ = npz.restore_latest(create_train_state(cfg, "cpu"))
    ck = OrbaxCheckpointer(str(tmp_path / "ocp"))
    ck.save("3", state, {"epoch": 4, "step": 12})
    with torch.no_grad():  # the save holds the state as it was when save returned
        for p in state.model.parameters():
            p.zero_()
    assert not os.path.exists(tmp_path / "ocp" / "status.json")  # written at wait(), after the commit
    ck.wait()
    assert sorted(os.listdir(tmp_path / "ocp")) == ["ocp-3", "status.json"]
    restored, status = OrbaxCheckpointer(str(tmp_path / "ocp")).restore_latest(create_train_state(cfg, "cpu"))
    assert status == {"epoch": 4, "step": 12}
    _assert_flat_equal(_flat(restored), _flat(from_npz))
    _assert_flat_equal(_flat(restored), want)
    flat = OrbaxCheckpointer(str(tmp_path / "ocp")).restore_flat("3")  # what serving reads
    _assert_flat_equal({k: np.array(v) for k, v in flat.items()}, want)


def test_latest_tag_skips_partial_tmp_dirs(cfg, tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path / "ckpt"))
    state = _state(cfg)
    ck.save("3", state, {"epoch": 4})
    ck.wait()
    partial = tmp_path / "ckpt" / "ocp-4.tmp-99"  # a killed save's directory, newer than ocp-3
    os.makedirs(partial)
    (partial / "__0_0.distcp").write_bytes(b"torn")
    assert ck.latest_tag() == "3"
    restored, status = ck.restore_latest(create_train_state(cfg, "cpu"))
    assert status["epoch"] == 4
    _assert_flat_equal(_flat(restored), _flat(state))
    assert ck.epoch_tags() == [3]


def test_lagging_status_is_reconciled(cfg, tmp_path, capsys):
    ck = OrbaxCheckpointer(str(tmp_path / "ckpt"))
    ck.save("2", _state(cfg), {"epoch": 3, "step": 8})
    ck.wait()
    ck.save("3", _state(cfg), {"epoch": 4, "step": 12})
    # a kill after the commit, before the next wait(): the rename is done, the status not
    future, tmp, path, _ = ck._pending
    future.result()
    os.replace(tmp, path)
    ck._pending = None
    _, status = ck.restore_latest(create_train_state(cfg, "cpu"))
    assert status == {"epoch": 4, "step": 8, "batch": 0}
    assert ("WARNING: status.json lags checkpoint 3 (crash between async commit and status write); "
            "resuming at epoch 4 with the stale global_step 8") in capsys.readouterr().out


def test_epoch_tags_and_delete(cfg, tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path / "ckpt"))
    state = _state(cfg)
    for tag in ("1", "2", "interrupt"):
        ck.save(tag, state)
    ck.save("3", state)
    assert ck.epoch_tags() == [1, 2]  # no wait: the save of 3 is still in flight, and it is not prunable yet
    ck.wait()
    assert ck.epoch_tags() == [1, 2, 3]  # non-numeric tags are not prunable
    ck.delete(1)
    assert ck.epoch_tags() == [2, 3]
    assert not os.path.exists(tmp_path / "ckpt" / "ocp-1")
    assert ck.latest_tag() == "3"  # mtime-newest wins, as JAX's
    ck.delete(7)  # a missing tag is no error


# --------------------------------------------------------------- Trainer ----

def _run_case(tiny_cfg, root, backend, **kw):
    base = dict(batch_size=8, epoch=2, freq_gen=0, freq_test=0, exp_name="ocp", moment_dtype="bfloat16",
                ema_decay=0.5)
    base.update(kw)
    return dict(cfg=_fields(tiny_cfg.replace(**base)), root=str(root), items=ITEMS, backend=backend,
                min_shard_elems=0)


def _check_runs(runs, npz):
    """Orbax: the restored state is the one saved, the resumed run ends
    where the unbroken one does, and where the npz backend's run does."""
    flat_u, logged_u, _, start_u = runs["unbroken"]
    flat_1, _, _, _ = runs["first"]
    flat_r, logged_r, restored, start = runs["resumed"]
    assert start_u == 1 and start == 2
    _assert_flat_equal(restored, flat_1)
    _assert_flat_equal(flat_r, flat_u)
    _assert_flat_equal(flat_u, npz["unbroken"][0])
    assert [s for s, _ in logged_r] == [s for s, _ in logged_u][len(logged_u) - len(logged_r):]


def test_trainer_resume_equals_unbroken_and_npz(tiny_cfg, tmp_path):
    runs = ckpt_runs(None, _run_case(tiny_cfg, tmp_path / "orbax", "orbax"))
    npz = ckpt_runs(None, _run_case(tiny_cfg, tmp_path / "npz", "npz"))
    _check_runs(runs, npz)
    ckdir = tmp_path / "orbax" / "resumed" / "result" / "ocp" / "checkpoint"
    assert sorted(os.listdir(ckdir)) == ["ocp-1", "ocp-2", "status.json"]


def test_trainer_interrupt_resumes_bit_for_bit(tiny_cfg, tmp_path):
    """A SIGINT after the first update: the interrupt checkpoint is complete
    (with its status) when the process exits, and the resumed run ends
    where the unbroken one does."""
    from littlegan_tpu_torch.data.synthetic import SyntheticDataset
    from littlegan_tpu_torch.training.trainer import Trainer

    case = _run_case(tiny_cfg, tmp_path, "orbax")
    unbroken = ckpt_runs(None, case)["unbroken"][0]
    cfg = TConfig(**{**case["cfg"], "all_result_dir": str(tmp_path / "int" / "result"),
                     "test_data_dir": str(tmp_path / "int" / "test-data"), "extra": {"checkpoint_backend": "orbax"}})
    tr = Trainer(cfg, SyntheticDataset(cfg, ITEMS), device="cpu")
    after = tr._after_dispatch

    def interrupt(*args):
        tr._interrupt_requested = True
        after(*args)

    tr._after_dispatch = interrupt
    with pytest.raises(SystemExit) as e:
        tr.train()
    assert e.value.code == 1
    ckdir = tmp_path / "int" / "result" / "ocp" / "checkpoint"
    assert sorted(os.listdir(ckdir)) == ["ocp-interrupt", "status.json"]
    assert json.loads((ckdir / "status.json").read_text()) == {"epoch": 1, "step": 1, "batch": 1}
    tr = Trainer(cfg, SyntheticDataset(cfg, ITEMS), device="cpu")
    assert (tr.global_epoch, tr.global_step, tr._resume_batch) == (1, 1, 1)
    tr.train()
    _assert_flat_equal(_flat(tr.state), unbroken)


# sharded states: ZeRO-1 over the data ranks; shard_dense + ZeRO-1 over a
# (data, model) mesh, on the 32² init_dim 2 model (init_dim must divide the model axis)
LAYOUTS = {
    2: {"zero1": dict(shard_opt_state=True),
        "dense": dict(shard_opt_state=True, shard_dense=True, image_dim=32, init_dim=2,
                      mesh_axes=["data", "model"], mesh_shape=[1, 2])},
    4: {"zero1": dict(shard_opt_state=True),
        "dense": dict(shard_opt_state=True, shard_dense=True, image_dim=32, init_dim=2,
                      mesh_axes=["data", "model"], mesh_shape=[2, 2])},
}


@pytest.fixture(scope="module")
def ranked(tiny_cfg, tmp_path_factory):
    """world -> layout -> (each rank's orbax runs, rank 0's npz runs, the
    root); then 4 ranks restoring each 2-rank layout's epoch-1 checkpoint."""
    out = {}
    for world, layouts in LAYOUTS.items():
        root = tmp_path_factory.mktemp(f"ocp{world}")
        cases = []
        for name, kw in layouts.items():
            for backend in ("orbax", "npz"):
                cases.append(dict(_run_case(tiny_cfg, root / name / backend, backend, **kw), fn="ckpt_runs"))
        if world == 4:  # the 2-rank checkpoints after epoch 1, restored at 4 ranks
            for name, kw in layouts.items():
                src = out[2][name][2] / "orbax" / "resumed" / "result" / "ocp" / "checkpoint"
                dst = root / name / "from2" / "restore" / "result" / "ocp" / "checkpoint"
                shutil.copytree(src, dst)
                shutil.rmtree(dst / "ocp-2")
                (dst / "status.json").write_text(json.dumps({"epoch": 2, "step": 2}))  # as epoch 1 left it
                cases.append(dict(_run_case(tiny_cfg, root / name / "from2", "orbax", **kw), fn="ckpt_restore"))
        per_rank = run_ranks("torch_rank_workers:run_cases", world, cases, timeout=400)
        results = list(zip(*per_rank))
        out[world] = {name: (results[2 * i], results[2 * i + 1][0], root / name) for i, name in enumerate(layouts)}
        if world == 4:
            out["from2"] = dict(zip(layouts, results[2 * len(layouts):]))
    return out


@pytest.mark.parametrize("world,layout", [(w, n) for w in LAYOUTS for n in LAYOUTS[w]])
def test_ranks_save_their_parts_and_resume_bit_for_bit(ranked, world, layout):
    ranks, npz, root = ranked[world][layout]
    for runs in ranks:
        _check_runs(runs, npz)
        _assert_flat_equal(runs["unbroken"][0], ranks[0]["unbroken"][0])  # every rank gathers the same state
    ckdir = root / "orbax" / "unbroken" / "result" / "ocp" / "checkpoint"
    assert sorted(os.listdir(ckdir)) == ["ocp-1", "ocp-2", "status.json"]
    names = set(dcp.FileSystemReader(str(ckdir / "ocp-2")).read_metadata().state_dict_metadata)
    parts = {n for n in names if "#part" in n}
    assert parts, "no rank-qualified part was saved"
    if layout == "dense":
        assert any(n.startswith(".params/g_head/dense/kernel#part") for n in parts)
        assert ".params/g_head/dense/kernel" not in names
    assert any(n.startswith(".opt_g/.mu/") for n in parts)
    # the npz backend's file holds the gathered whole state
    npz_file = root / "npz" / "unbroken" / "result" / "ocp" / "checkpoint" / "ckpt-2.npz"
    with np.load(npz_file) as z:
        _assert_flat_equal({k: z[k] for k in z.files}, npz["unbroken"][0])


@pytest.mark.parametrize("world,layout", [(w, n) for w in LAYOUTS for n in LAYOUTS[w]])
def test_sharded_checkpoint_restores_in_one_process(ranked, tiny_cfg, world, layout):
    ranks, _, root = ranked[world][layout]
    kw = {k: v for k, v in LAYOUTS[world][layout].items()
          if k not in ("shard_opt_state", "shard_dense", "mesh_axes", "mesh_shape")}
    cfg = _tcfg(tiny_cfg, batch_size=8, moment_dtype="bfloat16", ema_decay=0.5, **kw)
    ckdir = root / "orbax" / "resumed" / "result" / "ocp" / "checkpoint"
    restored = OrbaxCheckpointer(str(ckdir)).restore("1", create_train_state(cfg, "cpu"))
    _assert_flat_equal(_flat(restored), ranks[0]["first"][0])


@pytest.mark.parametrize("layout", list(LAYOUTS[2]))
def test_two_rank_checkpoint_restores_at_four_ranks(ranked, layout):
    two = ranked[2][layout][0][0]["first"][0]
    for flat, epoch in ranked["from2"][layout]:
        assert epoch == 2
        _assert_flat_equal(flat, two)
