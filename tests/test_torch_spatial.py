"""The port's spatial ('data', 'model') training against the JAX package's
``make_spatial_train_step`` (and its accumulation step and K-update scan
over an H-sharded store), on the CPU in f32.

The JAX side runs on the virtual 8-device CPU mesh (tests/conftest.py), on
meshes of [1, 2] and [2, 2] devices; the port over 2 and 4 gloo ranks
(``tests/torch_dp_common.py``) with the same shape, each rank on its rows
and H-slice of the same global batches and of the draws recomputed from
the JAX step's keys. Configurations: ``tiny_cfg`` (16², ``init_dim`` 1),
whose 1- and 2-high maps do not tile the model axis, so its heads and
deepest stages run replicated; with s2d, and with the gradient penalty
and the cond bias on the raw layout. (The 32² ``init_dim`` 2 config whose
stages all tile is in tests/test_torch_shard_dense.py.)

Bounds: the JAX spatial test's (tests/test_spatial.py:54-65): losses
within 1e-3, weights within 2.5 lr per update.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from littlegan_tpu.parallel.mesh import make_mesh
from littlegan_tpu.parallel.spatial import make_spatial_train_step, shard_spatial_batch
from littlegan_tpu.training import create_train_state as jcreate_train_state
from littlegan_tpu.training import step as jstep
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch.training import step as tstep
from test_torch_dispatch import N_BATCHES, jax_update_draws, make_store
from test_torch_parallel import _cfg_dict
from test_torch_train import batch, jax_step_draws
from torch_dp_common import run_ranks
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

LR_TOL = 2.5  # weights within 2.5 lr per update (tests/test_spatial.py)

# name: (config changes, meshes, batch_nos of the host-fed updates)
CASES = {
    "s2d": (dict(use_s2d=True), [(1, 2), (2, 2)], (11, 12)),
    "gp+raw+cond_bias": (dict(use_gp=True, use_s2d=False, cond_bias=True), [(2, 2)], (12,)),
}


def _jmesh(shape):
    return make_mesh(int(np.prod(shape)), axis_names=("data", "model"), shape=shape)


@pytest.fixture(scope="module")
def runs(tiny_cfg):
    """(case name, mesh) -> (JAX config, JAX outputs, port case), one
    compile of the JAX spatial step per pair."""
    out = {}
    for name, (flags, meshes, batch_nos) in CASES.items():
        jcfg = tiny_cfg.replace(batch_size=4, use_partition=False, donate_state=False, **flags)
        jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(len(name))
        inputs = [(batch(rng, jcfg), batch(rng, jcfg), jax.random.PRNGKey(100 + bn), bn) for bn in batch_nos]
        steps = [("train", b1, b2, jax_step_draws(key, jcfg, b1[0].shape), bn) for b1, b2, key, bn in inputs]
        for shape in meshes:
            mesh = _jmesh(shape)
            step = make_spatial_train_step(jcfg, jstate.params, mesh, donate=False)
            state, jouts = jstate, []
            for b1, b2, key, bn in inputs:
                jout = step(state, shard_spatial_batch(b1, mesh), shard_spatial_batch(b2, mesh), key, jnp.int32(bn))
                state = jout.state
                jouts.append(jout)
            out[(name, shape)] = (jcfg, jouts, dict(cfg=_cfg_dict(jcfg), flat=_flatten(jstate.params), steps=steps,
                                                    mesh=shape))
    return out


@pytest.fixture(scope="module")
def scan_run(tiny_cfg):
    """The JAX spatial K = 2 scan over a uint8 store sharded
    ``P(None, 'data', 'model')`` on a [2, 2] mesh, from batch 10 (the
    partition batch, the adjuster gate), and the port case."""
    jcfg = tiny_cfg.replace(batch_size=4, use_partition=True, donate_state=False, use_s2d=True, ema_decay=0.9)
    jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(6)
    imgs, conds = make_store(rng, jcfg)
    ids1, ids2 = rng.integers(0, N_BATCHES, 2), rng.integers(0, N_BATCHES, 2)
    mesh = _jmesh((2, 2))
    base, gs0 = jax.random.PRNGKey(5), 40
    scan = jstep.make_scan_train_step(jcfg, jstate.params, 2, donate=False, mesh=mesh)
    jout = scan(jstate, jax.device_put(imgs, NamedSharding(mesh, P(None, "data", "model"))),
                jax.device_put(conds, NamedSharding(mesh, P(None, "data"))),
                jnp.asarray(ids1, jnp.int32), jnp.asarray(ids2, jnp.int32), base, jnp.int32(gs0), jnp.int32(10))
    draws = [jax_update_draws(jax.random.fold_in(base, gs0 + i), jcfg, imgs.shape[1:]) for i in range(2)]
    steps = [("scan", (imgs, conds), ids1, ids2, tstep.stack_draws(draws), 10)]
    return jcfg, jout, dict(cfg=_cfg_dict(jcfg), flat=_flatten(jstate.params), steps=steps, mesh=(2, 2))


@pytest.fixture(scope="module")
def accum_run(tiny_cfg):
    """JAX's accumulation step (M = 2, raw layout) on a [1, 2] mesh, its
    stacked micro-batches sharded ``P(None, 'data', 'model')``, and the port
    case."""
    jcfg = tiny_cfg.replace(batch_size=4, use_partition=True, donate_state=False, use_s2d=False, grad_accum=2)
    jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(7)
    imgs, conds = make_store(rng, jcfg)
    ids1, ids2 = rng.integers(0, N_BATCHES, 2), rng.integers(0, N_BATCHES, 2)
    b1s, b2s = (imgs[ids1], conds[ids1]), (imgs[ids2], conds[ids2])
    mesh = _jmesh((1, 2))
    put = lambda b: (jax.device_put(b[0], NamedSharding(mesh, P(None, "data", "model"))),  # noqa: E731
                     jax.device_put(b[1], NamedSharding(mesh, P(None, "data"))))
    key = jax.random.PRNGKey(8)
    step = jstep.make_accum_train_step(jcfg, jstate.params, donate=False, mesh=mesh)
    jout = step(jstate, put(b1s), put(b2s), key, jnp.int32(12))
    draws = jax_update_draws(key, jcfg, imgs.shape[1:], 2)
    return jcfg, jout, dict(cfg=_cfg_dict(jcfg), flat=_flatten(jstate.params),
                            steps=[("accum", b1s, b2s, draws, 12)], mesh=(1, 2))


@pytest.fixture(scope="module")
def ranks(runs, scan_run, accum_run):
    """world -> case key -> each rank's result: one start of the ranks per world size."""
    keys = {2: [k for k in runs if k[1] == (1, 2)] + ["accum"], 4: [k for k in runs if k[1] == (2, 2)] + ["scan"]}
    case = lambda k: {"scan": scan_run, "accum": accum_run}[k][2] if isinstance(k, str) else runs[k][2]  # noqa: E731
    return {world: dict(zip(ks, zip(*run_ranks("run_many", world, [case(k) for k in ks]))))
            for world, ks in keys.items()}


def _check(res, jcfg, metrics, jstate, updates, first_only=False):
    """Every rank the same; the losses (``first_only``: the first update's)
    and the weights within JAX's bounds."""
    flat = res[0]["flat"]
    for r in res[1:]:
        assert all(np.array_equal(r["flat"][k], flat[k]) for k in flat)
    got = {k: np.concatenate([np.atleast_1d(u[k]) for u in res[0]["losses"]]) for k in tstep.LOSS_KEYS}
    for k in tstep.LOSS_KEYS:
        n = 1 if first_only else len(metrics[k])
        np.testing.assert_allclose(got[k][:n], metrics[k][:n], rtol=0, atol=1e-3, err_msg=k)
    want = _flatten(jstate)
    for k, w in want.items():
        if k.startswith((".params/", ".ema/")):
            np.testing.assert_allclose(flat[k], np.asarray(w), rtol=0, atol=LR_TOL * jcfg.lr * updates, err_msg=k)
        elif "/.count/" in k:
            assert int(flat[k]) == int(w), k


@pytest.mark.parametrize("key", [(n, m) for n, (_, meshes, _) in CASES.items() for m in meshes], ids=str)
def test_spatial_step_matches_jax(runs, ranks, key):
    """The host-fed spatial step of each case and mesh against JAX's."""
    jcfg, jouts, _ = runs[key]
    res = ranks[key[1][0] * key[1][1]][key]
    metrics = {k: np.asarray([float(j.metrics[k]) for j in jouts]) for k in tstep.LOSS_KEYS}
    _check(res, jcfg, metrics, jouts[-1].state, len(jouts))


def test_spatial_accum_matches_jax(accum_run, ranks):
    """One update of two accumulated micro-pairs over the mesh against
    JAX's spatial accumulation step."""
    jcfg, jout, _ = accum_run
    metrics = {k: np.atleast_1d(np.asarray(jout.metrics[k])) for k in tstep.LOSS_KEYS}
    _check(ranks[2]["accum"], jcfg, metrics, jout.state, 1)


def test_spatial_scan_matches_jax(scan_run, ranks):
    """The K = 2 update over the H-sharded store (eager here; one CUDA
    graph replay on the card over NCCL) against JAX's spatial scan: the
    weights after both updates, the first update's losses. (The second
    update's G loss of JAX's own spatial scan lies 6.7e-3 from its
    one-device scan, 2.1465 against 2.1398: the first update's Adam steps
    on near-zero gradients differ by up to a step between the two
    reduction orders. The port's, 2.1398, is the one-device value; the
    port's forms against one process over several updates are in
    tests/test_torch_spatial_ops.py.)"""
    jcfg, jout, _ = scan_run
    metrics = {k: np.asarray(jout.metrics[k]) for k in tstep.LOSS_KEYS}
    _check(ranks[4]["scan"], jcfg, metrics, jout.state, 2, first_only=True)
