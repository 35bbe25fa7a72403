"""The port's Trainer, checkpoints and CLI on the CPU (``device="cpu"``).

- the checkpoint's flat keys, shapes and dtypes are those of the JAX
  package's ``_flatten`` of the same train state;
- a port checkpoint restores in the JAX ``Trainer`` and a JAX one in the
  port's, array for array (exact);
- an interrupted run resumed mid-epoch ends bit-identical to an
  uninterrupted one;
- a 1-epoch synthetic ``train`` through ``python -m littlegan_tpu_torch``'s
  ``main`` writes its artifacts; ``--devices`` above 1 exits 2; unported options raise
  (the device-store and accumulation paths: tests/test_torch_trainer_device.py).
"""

import os

import numpy as np
import pytest
import torch

import jax

from littlegan_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from littlegan_tpu.training import create_train_state as jcreate_train_state
from littlegan_tpu.training.checkpoint import Checkpointer as JCheckpointer
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu.training.optimizer import AdamState
from littlegan_tpu_torch import cli
from littlegan_tpu_torch.data import SyntheticDataset
from littlegan_tpu_torch.training.checkpoint import flatten_state
from littlegan_tpu_torch.training.state import create_train_state
from littlegan_tpu_torch.training.trainer import Trainer
from test_torch_train import tcfg_of


def _raw(a: np.ndarray) -> np.ndarray:
    """Bytes-level view for exact comparison (bf16 arrays come as ml_dtypes
    from JAX, as 2-byte void from an npz)."""
    a = np.ascontiguousarray(a).reshape(-1)
    return a.view(np.uint8)


def _same_flat(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype.itemsize == w.dtype.itemsize, k
        np.testing.assert_array_equal(_raw(g), _raw(w), err_msg=k)


def _cfg(tiny_cfg, tmp_path, name="exp", **kw):
    kw = {"epoch": 1, **kw}
    return tiny_cfg.replace(
        all_result_dir=str(tmp_path / "result"), test_data_dir=str(tmp_path / f"td-{name}"), exp_name=name,
        freq_gen=0, freq_test=0, **kw,
    )


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_checkpoint_keys_shapes_dtypes_match_jax(tiny_cfg, moments):
    jcfg = tiny_cfg.replace(ema_decay=0.5, moment_dtype=moments)
    want = _flatten(jcreate_train_state(jcfg, jax.random.PRNGKey(0)))
    got = flatten_state(create_train_state(tcfg_of(jcfg), "cpu"))
    assert sorted(got) == sorted(want)
    assert ".params/encoder/block1/conv/kernel" in got and ".opt_a/.count/adj_head/dense/kernel" in got
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype.itemsize == w.dtype.itemsize, k
        assert (g.dtype.kind == "V") == (w.dtype.name == "bfloat16"), k


def test_port_checkpoint_restores_in_jax_trainer(tiny_cfg, tmp_path):
    from littlegan_tpu.training.trainer import Trainer as JTrainer

    jcfg = _cfg(tiny_cfg, tmp_path, ema_decay=0.5, moment_dtype="bfloat16")
    tcfg = tcfg_of(jcfg)
    trainer = Trainer(tcfg, SyntheticDataset(tcfg, num_items=16), device="cpu")
    trainer.train()  # 2 steps, epoch checkpoint 1
    jt = JTrainer(jcfg, JSyntheticDataset(jcfg, num_items=16))
    assert (jt.global_epoch, jt.global_step) == (2, 2)
    _same_flat(flatten_state(trainer.state), _flatten(jt.state))


def test_jax_checkpoint_restores_in_port_trainer(tiny_cfg, tmp_path):
    jcfg = _cfg(tiny_cfg, tmp_path, ema_decay=0.5)
    state = jcreate_train_state(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    noisy = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda x: np.asarray(x) + rng.normal(size=np.shape(x)).astype(np.asarray(x).dtype), tree)
    counts = lambda tree: jax.tree_util.tree_map(lambda c: np.int32(7), tree)  # noqa: E731
    state = state._replace(**{
        o: AdamState(counts(getattr(state, o).count), noisy(getattr(state, o).mu), noisy(getattr(state, o).nu))
        for o in ("opt_g", "opt_d", "opt_a")
    }, ema=noisy(state.ema))
    JCheckpointer(os.path.join(jcfg.result_dir, "checkpoint")).save("3", state, {"epoch": 4, "step": 30})
    trainer = Trainer(tcfg_of(jcfg), None, device="cpu")
    assert (trainer.global_epoch, trainer.global_step) == (4, 30)
    _same_flat(flatten_state(trainer.state), _flatten(state))


def test_mid_epoch_resume_equals_an_uninterrupted_run(tiny_cfg, tmp_path):
    """Epochs of 4 steps; run B is interrupted after step 3 (the deferred
    SIGINT path), restarted, and must end where run A does."""
    def cfg(name):
        return tcfg_of(_cfg(tiny_cfg, tmp_path, name=name, epoch=2))

    data = lambda c: SyntheticDataset(c, num_items=32)  # noqa: E731
    a = Trainer(cfg("a"), data(cfg("a")), device="cpu")
    a.train()
    b = Trainer(cfg("b"), data(cfg("b")), device="cpu")
    real_step = b._train_step

    def step_then_interrupt(*args, **kw):
        out = real_step(*args, **kw)
        if b.global_step == 3:
            b._interrupt_requested = True
        return out

    b._train_step = step_then_interrupt
    with pytest.raises(SystemExit):
        b.train()
    status = os.path.join(cfg("b").result_dir, "checkpoint", "status.json")
    assert os.path.isfile(status)
    resumed = Trainer(cfg("b"), data(cfg("b")), device="cpu")
    assert (resumed.global_epoch, resumed.global_step, resumed._resume_batch) == (1, 3, 3)
    resumed.train()
    assert resumed.global_step == a.global_step == 8
    _same_flat(flatten_state(resumed.state), flatten_state(a.state))


def test_cli_trains_one_synthetic_epoch(tmp_path, monkeypatch):
    (tmp_path / "sample.config.json").write_text(
        '{"batch_size": 4, "image_dim": 16, "init_dim": 1, "noise_dim": 13, '
        '"conv_filter": [24, 16, 12, 8, 4], "epoch": 1, "freq_gen": 2, "freq_test": 4, '
        f'"all_result_dir": "{tmp_path}/result", "test_data_dir": "{tmp_path}/test-data", '
        '"compute_dtype": "float32"}'
    )
    monkeypatch.chdir(tmp_path)
    assert cli.main(["train", "exp1", "--debug", "--synthetic-data", "--device", "cpu"]) == 0
    root = tmp_path / "result" / "exp1"
    assert (root / "checkpoint" / "ckpt-1.npz").is_file() and (root / "checkpoint" / "status.json").is_file()
    assert (root / "train" / "gen" / "1-2.jpg").is_file() and (root / "train" / "adj" / "1-2.jpg").is_file()
    assert (root / "test" / "gen" / "1-4.jpg").is_file() and (root / "test" / "disc" / "1-4.json").is_file()
    from littlegan_tpu.utils.tensorboard import read_scalars

    logged = read_scalars(str(root / "log"))  # the JAX package's reader
    assert [s for s, _ in logged["loss/gen"]] == list(range(1, 9)) and "loss/adj" not in logged  # 64 items, 8 steps
    assert (tmp_path / "test-data" / "test_data_sample.npz").is_file()


@pytest.mark.parametrize("mode", ["plot", "serve", "evaluate-sample"])
def test_cli_other_modes_exit_2(mode, capsys):
    """Every mode is ported (tests/test_torch_cli.py runs them); what still
    exits 2 is a request for more than one card, in any mode."""
    assert cli.main([mode, "exp1", "--device", "cpu", "--devices", "2"]) == 2
    assert "multi-GPU is not ported yet (ROADMAP A13)" in capsys.readouterr().err


def test_trainer_raises_without_a_card(tiny_cfg, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tcfg_of(_cfg(tiny_cfg, tmp_path)), None)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(use_gp=True, use_pallas=True), ValueError, "use_gp needs use_pallas=False"),
    (dict(use_gp=True, use_pallas_boundary=True), ValueError, "use_gp needs use_pallas=False"),
    (dict(mesh_shape=[1]), NotImplementedError, "ROADMAP A13"),
    (dict(mesh_axes=["data", "model"]), NotImplementedError, "ROADMAP A13"),
    (dict(shard_opt_state=True), NotImplementedError, "ROADMAP A13"),
    (dict(shard_dense=True), NotImplementedError, "ROADMAP A13"),
])
def test_trainer_refuses_unported_options(tiny_cfg, tmp_path, kw, exc, match):
    """What the trainer still refuses: the gradient penalty with a kernel
    flag, and the multi-device options (meshes, sharded state)."""
    with pytest.raises(exc, match=match):
        Trainer(tcfg_of(_cfg(tiny_cfg, tmp_path, **kw)), None, device="cpu")


def test_synthetic_dataset_matches_jax(tiny_cfg):
    want = list(JSyntheticDataset(tiny_cfg, num_items=12).epoch_iterator(3, start_batch=1))
    got = list(SyntheticDataset(tcfg_of(tiny_cfg), num_items=12).epoch_iterator(3, start_batch=1))
    assert len(got) == len(want) == 2
    for (gi, gc), (wi, wc) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gc, wc)


def test_celeba_pipeline_matches_jax(tiny_cfg, tmp_path):
    """Non-square JPEGs (center crop and resize), a headered attribute file
    joined on file names, the epoch's batch order and a resumed tail: the
    same uint8 batches and softened labels as the JAX pipeline's PIL path."""
    from PIL import Image

    from littlegan_tpu.data.celeba import CelebA as JCelebA
    from littlegan_tpu_torch.data import CelebA

    rng = np.random.default_rng(0)
    names = [f"{i:06d}.jpg" for i in range(1, 13)]
    for n in names:
        Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)).save(tmp_path / n)
    rows = [f"{n} " + " ".join(str(v) for v in rng.choice([-1, 1], 40)) for n in names[::-1]]
    (tmp_path / "attr.txt").write_text(f"{len(names)}\nheader\n" + "\n".join(rows) + "\n")
    jcfg = tiny_cfg.replace(image_path=str(tmp_path), attr_path=str(tmp_path / "attr.txt"),
                            use_native_loader=False, batch_size=3, threads=2)
    tc = tcfg_of(jcfg)
    port, ref = CelebA(tc), JCelebA(jcfg)
    assert port.batches == ref.batches == 4 and port.label == ref.label
    for epoch, start in ((0, 0), (5, 2)):
        got = list(port.epoch_iterator(epoch, start_batch=start))
        want = list(ref.epoch_iterator(epoch, start_batch=start))
        assert len(got) == len(want) == 4 - start
        for (gi, gc), (wi, wc) in zip(got, want):
            assert gi.dtype == np.uint8 and gi.shape == (3, 16, 16, 3)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gc, wc)
