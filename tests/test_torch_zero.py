"""ZeRO-1 (``shard_opt_state``, ``littlegan_tpu_torch/parallel/zero.py``)
and its memory report against the JAX package's ``parallel/zero.py``.

- ``_moment_spec`` leaf by leaf against JAX's, over every train-state leaf
  of the full default model and meshes of 1, 2, 4 and 8 data ranks (and
  the JAX rule's two-axis case), and ``state_bytes_report`` equal to JAX's
  for the same configurations, exactly: both are shape arithmetic.
- ZeRO-1 in 2 and 4 gloo processes (``tests/torch_dp_common.py``) against
  replicated DP on the same inputs: three host-fed updates crossing the
  adjuster gate and a partition batch, then a K = 2 update over the store,
  with f32 and with bf16 moments. The size threshold is lowered to 0 in
  the workers, as tests/test_zero.py does, since the tiny model's leaves
  all fall under the real one. Tolerance rtol 2e-4 / atol 2e-5 (JAX's:
  only the reductions' order differs); at 2 ranks, bit for bit (a sum of
  two is the same in every collective).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax

from littlegan_tpu.config import Config as JConfig
from littlegan_tpu.parallel import zero as jzero
from littlegan_tpu.training import create_train_state as jcreate_train_state
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.parallel import zero as tzero
from littlegan_tpu_torch.training import step as tstep
from test_torch_dispatch import N_BATCHES, make_store
from test_torch_parallel import DP_TOL, _cfg_dict
from test_torch_train import batch
from torch_dp_common import assert_states_close, run_ranks
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

MESHES = [{"data": 1}, {"data": 2}, {"data": 4}, {"data": 8}]


@pytest.fixture(scope="module")
def full_shapes():
    """Every parameter leaf of the default (128², full-width) model: path -> shape."""
    params = jax.eval_shape(lambda: jcreate_train_state(JConfig(), jax.random.PRNGKey(0))).params
    return {"/".join(str(p.key) for p in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}


@pytest.mark.parametrize("mesh", MESHES + [{"data": 4, "model": 2}], ids=str)
def test_moment_spec_matches_jax_leaf_by_leaf(full_shapes, mesh):
    jmesh = jzero._MeshShape(mesh)
    sharded = 0
    for key, shape in full_shapes.items():
        want = tuple(jzero._moment_spec(shape, jmesh))
        assert tzero._moment_spec(shape, mesh) == want, key
        sharded += want != ()
        if list(mesh) == ["data"]:
            axis = tzero.moment_axis(shape, mesh["data"])
            assert axis == (None if want == () else next(i for i, e in enumerate(want) if e is not None)), key
    assert (sharded > 0) == (mesh != {"data": 1})
    # the rules' edges: ties go to the last axis; nothing divisible, or too small, stays whole
    assert tzero._moment_spec((5, 5, 64, 128), {"data": 8}) == (None, None, None, "data")
    assert tzero._moment_spec((5, 5, 3, 33), {"data": 8}) == ()
    assert tzero._moment_spec((8, 8), {"data": 8}) == ()


@pytest.mark.parametrize("mesh", MESHES + [{"data": 4, "model": 2}, None], ids=str)
@pytest.mark.parametrize("flags", [
    dict(shard_opt_state=True), dict(shard_opt_state=True, moment_dtype="bfloat16", ema_decay=0.999),
    dict(shard_opt_state=False, ema_decay=0.9), dict(shard_opt_state=True, shard_dense=True),
], ids=["zero1", "zero1+bf16+ema", "replicated+ema", "zero1+dense"])
def test_state_bytes_report_equals_jax(mesh, flags):
    jcfg = JConfig(**flags)
    tcfg = Config(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    assert tzero.state_bytes_report(tcfg, mesh) == jzero.state_bytes_report(jcfg, mesh)


def test_shard_checks():
    """shard_opt_state needs ranks; shard_dense, as in the JAX package, a
    ('data', 'model') mesh (not a data mesh) whose model axis divides
    init_dim (8 at 128²). Against JAX's messages:
    tests/test_torch_shard_dense.py."""
    with pytest.raises(ValueError, match="needs a device mesh"):
        tzero.check_shard_opt_state(Config(shard_opt_state=True), None)
    tzero.check_shard_opt_state(Config(), None)
    spatial = lambda m: types.SimpleNamespace(model=None, model_size=m)  # noqa: E731
    for dg in (None, types.SimpleNamespace(world=2)):
        with pytest.raises(ValueError, match=r"needs a \('data','model'\) mesh"):
            tzero.check_shard_dense(Config(shard_dense=True), dg)
    with pytest.raises(ValueError, match=r"needs init_dim \(8\) divisible by the model-axis size \(16\)"):
        tzero.check_shard_dense(Config(shard_dense=True), spatial(16))
    tzero.check_shard_dense(Config(shard_dense=True), spatial(4))
    tzero.check_shard_dense(Config(), None)


@pytest.fixture(scope="module")
def zero_inputs(tiny_cfg):
    jcfg = tiny_cfg.replace(batch_size=8, use_partition=True, use_s2d=True)
    jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(9)
    gen = torch.Generator().manual_seed(9)
    tc = Config(**_cfg_dict(jcfg))
    draw = lambda: tstep.draw_step(gen, tc, 8, "cpu")  # noqa: E731
    steps = [("train", batch(rng, jcfg), batch(rng, jcfg), draw(), bn) for bn in (9, 10, 11)]
    imgs, conds = make_store(rng, jcfg)
    ids = rng.integers(0, N_BATCHES, (2, 2))
    steps.append(("scan", (imgs, conds), ids[0], ids[1], tstep.stack_draws([draw(), draw()]), 12))
    return jcfg, _flatten(jstate.params), steps


RUNS = {2: ("float32", "bfloat16"), 4: ("float32",)}  # world -> the moment dtypes run at that size


@pytest.fixture(scope="module")
def zero_runs(zero_inputs):
    """world -> (moments, sharded) -> each rank's result: one start of the ranks per world size."""
    jcfg, flat, steps = zero_inputs
    out = {}
    for world, dtypes in RUNS.items():
        keys = [(m, shard) for m in dtypes for shard in (False, True)]
        cases = [dict(cfg=_cfg_dict(jcfg.replace(moment_dtype=m, shard_opt_state=shard)), flat=flat, steps=steps,
                      min_shard_elems=0) for m, shard in keys]
        out[world] = dict(zip(keys, zip(*run_ranks("run_many", world, cases))))
    return out


@pytest.mark.parametrize("world,moments", [(2, "float32"), (4, "float32"), (2, "bfloat16")])
def test_zero1_equals_replicated_dp(zero_runs, world, moments):
    runs = zero_runs[world]
    rep, z = runs[(moments, False)][0], runs[(moments, True)][0]
    assert z["sharded"] > 20 and rep["sharded"] == 0  # most moment leaves held in shards
    assert all(r["flat"].keys() == z["flat"].keys() for r in runs[(moments, True)])
    assert_states_close(z["flat"], rep["flat"], **DP_TOL)
    for a, b in zip(z["losses"], rep["losses"]):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **DP_TOL)
    if world == 2:
        assert all(np.array_equal(z["flat"][k], rep["flat"][k]) for k in rep["flat"])
    assert z["reduced"] == rep["reduced"]  # reduce-scatter + all-gather move what one all-reduce moves
