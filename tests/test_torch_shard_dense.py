"""The dense heads sharded over the spatial mesh's model axis
(``Config.shard_dense``, ``littlegan_tpu_torch/parallel/zero.py``) against
the JAX package's (tests/test_shard_dense.py), on the CPU in f32.

The configuration is JAX's test's: 32², ``init_dim`` 2, so a model axis
of 2 divides the 2-high head map and every stage tiles it (one row per
rank at the heads). The JAX spatial step with ``shard_dense`` and
``shard_opt_state`` runs on [1, 2] and [2, 2] meshes of the virtual
8-device CPU mesh; the port on 2 and 4 gloo ranks
(``tests/torch_dp_common.py``) on the same state, batches and draws.

- The update equals JAX's within its bounds (losses within 1e-3, weights
  within 2.5 lr per update), every rank holding this rank's part of each
  of the six ``DENSE_HEAD_SPECS`` leaves, its moments and EMA alike, and
  nothing else sharded by ``shard_dense``; with ZeRO-1's threshold lowered
  to 0 as well the moments of the other leaves shard over every rank (or
  the data ranks) and the update is unchanged.
- ``check_shard_dense`` raises where JAX's does, with its messages.
- A ``Trainer`` run over the mesh writes the npz of the unsharded run
  (rank 0, gathered), resumes from it, and runs the K-update scan over
  the H-sharded store.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from littlegan_tpu.parallel.mesh import make_mesh
from littlegan_tpu.parallel.spatial import make_spatial_train_step, shard_spatial_batch
from littlegan_tpu.parallel.zero import check_shard_dense as jcheck_shard_dense
from littlegan_tpu.training import create_train_state as jcreate_train_state
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.parallel import zero as tzero
from littlegan_tpu_torch.parallel.spatial import DENSE_AXES
from littlegan_tpu_torch.training import step as tstep
from test_torch_parallel import _cfg_dict
from test_torch_train import batch, jax_step_draws
from torch_dp_common import run_ranks, train_epochs
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

LR_TOL = 2.5
MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def sd_cfg(tiny_cfg):
    """JAX's test config (tests/test_shard_dense.py:23-33)."""
    return tiny_cfg.replace(batch_size=4, image_dim=32, init_dim=2, use_partition=False, donate_state=False,
                            shard_dense=True, shard_opt_state=True, ema_decay=0.9)


@pytest.fixture(scope="module")
def runs(sd_cfg):
    """mesh -> JAX outputs of two updates; the port case."""
    jstate = jcreate_train_state(sd_cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    inputs = [(batch(rng, sd_cfg), batch(rng, sd_cfg), jax.random.PRNGKey(7 + bn), bn) for bn in (11, 12)]
    out = {}
    for shape in MESHES:
        mesh = make_mesh(int(np.prod(shape)), axis_names=("data", "model"), shape=shape)
        step = make_spatial_train_step(sd_cfg, jstate.params, mesh, donate=False)
        state, jouts = jstate, []
        for b1, b2, key, bn in inputs:
            jout = step(state, shard_spatial_batch(b1, mesh), shard_spatial_batch(b2, mesh), key, jnp.int32(bn))
            state = jout.state
            jouts.append(jout)
        out[shape] = jouts
    steps = [("train", b1, b2, jax_step_draws(key, sd_cfg, b1[0].shape), bn) for b1, b2, key, bn in inputs]
    return out, dict(cfg=_cfg_dict(sd_cfg), flat=_flatten(jstate.params), steps=steps)


@pytest.fixture(scope="module")
def ranks(runs):
    """(mesh, ZeRO-1 threshold) -> each rank's result: one start of the ranks per world size."""
    _, case = runs
    out = {}
    for shape in MESHES:
        keys = [(shape, None), (shape, 0)]
        cases = [dict(case, mesh=shape, **({} if t is None else {"min_shard_elems": t})) for _, t in keys]
        out.update(dict(zip(keys, zip(*run_ranks("run_many", int(np.prod(shape)), cases)))))
    return out


@pytest.mark.parametrize("threshold", [None, 0], ids=["jax-threshold", "zero1-every-leaf"])
@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_shard_dense_step_matches_jax(runs, ranks, sd_cfg, mesh, threshold):
    jouts = runs[0][mesh]
    res = ranks[(mesh, threshold)]
    flat = res[0]["flat"]
    for r in res[1:]:  # every rank gathers the same whole state
        assert all(np.array_equal(r["flat"][k], flat[k]) for k in flat)
    for i, jout in enumerate(jouts):
        for k in tstep.LOSS_KEYS:
            np.testing.assert_allclose(res[0]["losses"][i][k], float(jout.metrics[k]), rtol=0, atol=1e-3, err_msg=k)
    want = _flatten(jouts[-1].state)
    assert sorted(flat) == sorted(want)
    for k, w in want.items():
        if k.startswith((".params/", ".ema/")):
            np.testing.assert_allclose(flat[k], np.asarray(w), rtol=0, atol=LR_TOL * sd_cfg.lr * len(jouts), err_msg=k)
        elif "/.count/" in k:
            assert int(flat[k]) == int(w), k
    if threshold == 0:
        assert res[0]["sharded"] > 0


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_dense_leaves_hold_this_ranks_part(runs, ranks, mesh):
    """The six dense-head leaves, their first moments and G's EMA hold
    1 / model of their axis on every rank; every other leaf is whole
    (ZeRO-1 at JAX's threshold shards nothing of this model)."""
    whole = ranks[(MESHES[0], None)][0]["flat"]
    for r in ranks[(mesh, None)]:
        for key, shape in r["local_shapes"].items():
            part, name = key.rsplit("/", 1)
            full = whole[f"{part}/{name.replace('.', '/')}"].shape
            if name in DENSE_AXES:
                axis = DENSE_AXES[name]
                assert shape[axis] * mesh[1] == full[axis] and shape[:axis] + shape[axis + 1:] == \
                    full[:axis] + full[axis + 1:], key
            else:
                assert shape == full, key


def test_check_shard_dense_matches_jax(sd_cfg, tiny_cfg):
    """Refused as JAX refuses, with its messages: no mesh, a data mesh
    without a 'model' axis, ``init_dim`` not divisible by the model axis;
    off, or on a [4, 2] mesh with ``init_dim`` 2, nothing to say."""
    jmesh2 = make_mesh(8, axis_names=("data", "model"))
    group = lambda d, m: SimpleNamespace(model=None, data_size=d, model_size=m, world=d * m)  # noqa: E731
    cases = [(sd_cfg, None, None), (sd_cfg, make_mesh(8), SimpleNamespace(world=8)),
             (tiny_cfg.replace(shard_dense=True), jmesh2, group(4, 2))]
    for cfg, jmesh, dg in cases:
        with pytest.raises(ValueError) as jerr:
            jcheck_shard_dense(cfg, jmesh)
        with pytest.raises(ValueError) as terr:
            tzero.check_shard_dense(Config(**_cfg_dict(cfg)), dg)
        assert str(terr.value) == str(jerr.value)
    jcheck_shard_dense(sd_cfg, jmesh2)
    tzero.check_shard_dense(Config(**_cfg_dict(sd_cfg)), group(4, 2))
    tzero.check_shard_dense(Config(**_cfg_dict(tiny_cfg)), None)


@pytest.fixture(scope="module")
def trainer_runs(sd_cfg, tmp_path_factory):
    """Two host-fed epochs of a [1, 2] spatial Trainer with shard_dense (the
    second resumed from the first's checkpoint), the same two epochs in one
    process unsharded, and a [2, 2] K = 2 scan epoch over the store."""
    root = tmp_path_factory.mktemp("sd")
    # no EMA: the predict cadence's gathered model then holds the live storage itself
    base = _cfg_dict(sd_cfg.replace(epoch=1, freq_gen=2, freq_test=2, exp_name="sd", restore=True,
                                    shard_opt_state=False, ema_decay=0.0))
    items = 8 * sd_cfg.batch_size
    mesh = {**base, "mesh_axes": ["data", "model"]}
    out = {"mesh": [run_ranks("train_many", 2, [dict(cfg={**mesh, "epoch": e}, root=str(root / "mesh"),
                                                     items=items)])[0][0] for e in (1, 2)]}
    one = {**base, "shard_dense": False}
    out["one"] = [train_epochs(None, dict(cfg={**one, "epoch": e}, root=str(root / "one"), items=items))
                  for e in (1, 2)]
    scan = {**mesh, "mesh_shape": [2, 2], "device_data": True, "steps_per_dispatch": 2, "freq_gen": 0,
            "freq_test": 0, "shard_opt_state": True, "ema_decay": 0.9}
    out["scan"] = run_ranks("train_many", 4, [dict(cfg=scan, root=str(root / "scan"), items=items)])[0][0]
    out["root"] = root
    return out


def test_trainer_checkpoint_is_the_unsharded_runs(trainer_runs, sd_cfg):
    """Rank 0's npz after each epoch holds the whole leaves, the keys and
    shapes of the one-process run's, within the bounds of its values;
    rank 1 writes nothing; the second epoch resumed from the first."""
    root = trainer_runs["root"]
    for epoch in (1, 2):
        got = dict(np.load(root / "mesh" / "r0" / "result" / "sd" / "checkpoint" / f"ckpt-{epoch}.npz"))
        want = dict(np.load(root / "one" / "r0" / "result" / "sd" / "checkpoint" / f"ckpt-{epoch}.npz"))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].shape == w.shape, k
            if k.startswith((".params/", ".ema/")):
                np.testing.assert_allclose(got[k], w, rtol=0, atol=LR_TOL * sd_cfg.lr * 4 * epoch, err_msg=k)
    assert not (root / "mesh" / "r1" / "result").exists()
    assert list((root / "mesh" / "r0" / "result" / "sd" / "test" / "gen").iterdir())  # predict on gathered heads
    (_, logged1, _), (_, logged2, _) = trainer_runs["mesh"]
    assert [s for s, _ in logged1] == [1, 2, 3, 4] and [s for s, _ in logged2] == [5, 6, 7, 8]


def test_trainer_store_scan_keeps_the_heads_sharded(trainer_runs):
    """shard_dense x device_data x steps_per_dispatch 2 x ZeRO-1 over a
    [2, 2] mesh: 8 batches -> 4 updates in 2 dispatches, the state whole in
    the checkpoint."""
    flat, logged, code = trainer_runs["scan"]
    assert code == 0 and [s for s, _ in logged] == [1, 3]
    assert flat[".params/g_head/dense/kernel"].shape == (20, 96)
    assert (trainer_runs["root"] / "scan" / "r0" / "result" / "sd" / "checkpoint" / "ckpt-1.npz").is_file()


def test_trainer_refuses_shard_dense_without_a_model_axis(tiny_cfg, tmp_path):
    """Over 2 ranks of a data mesh, or of a [1, 2] mesh whose model axis
    does not divide init_dim 1: JAX's errors, on every rank."""
    dp = _cfg_dict(tiny_cfg.replace(shard_dense=True))
    sp = {**dp, "mesh_axes": ["data", "model"]}
    errs = run_ranks("trainer_error", 2, dict(cfg=dp, root=str(tmp_path / "dp")))
    assert all(e.startswith("shard_dense=true needs a ('data','model') mesh") for e in errs)
    errs = run_ranks("trainer_error", 2, dict(cfg=sp, root=str(tmp_path / "sp")))
    assert all(e.startswith("shard_dense=true needs init_dim (1) divisible by the model-axis size (2)") for e in errs)
