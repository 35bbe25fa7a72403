"""The port's data-parallel device-store and accumulation steps against the
JAX package's DP steps, on the CPU in f32.

The JAX side runs on the virtual 8-device CPU mesh over a global batch of
8: the K = 2 scan over a uint8 store sharded ``P(None, 'data')``
(``make_scan_train_step(mesh=...)``, crossing the partition batch 10, the
adjuster gate and both parities of the half-batch adjuster), and the
accumulation step of M = 2 micro-pairs (``make_accum_train_step(mesh=...)``).
The port runs them in 2 and 4 gloo processes (``tests/torch_dp_common.py``),
each rank holding its rows of every batch of the store, the draws
recomputed from the JAX keys and cut to each rank's rows: the K-update
step, two gather steps, the accumulation step and the K = 1 scan of
accumulated updates. The K-update steps run eagerly here (a CPU state); on
the card they are one CUDA graph replay with the all-reduce captured
(``chip_smoke.py`` phase (h)).

Tolerances: as tests/test_torch_dispatch.py for the port against JAX (the
first update's losses rtol 1e-5, a later one's 1e-3; weights atol 3 x lr
per update; moments rtol 2e-3); the port's DP against the port on one
process rtol 2e-4 / atol 2e-5 (tests/test_parallel.py's DP bound).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from littlegan_tpu.parallel import make_mesh, replicate_state
from littlegan_tpu.training import create_train_state as jcreate_train_state
from littlegan_tpu.training import step as jstep
from littlegan_tpu.training.checkpoint import _flatten
from test_torch_dispatch import KERNELS, N_BATCHES, jax_update_draws, make_store
from test_torch_parallel import DP_TOL, _cfg_dict
from torch_dp_common import assert_state_matches_jax, assert_states_close, run_ranks, run_steps
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)
from littlegan_tpu_torch.training import step as tstep

GS0 = 40


@pytest.fixture(scope="module")
def scan_case(tiny_cfg):
    """The JAX DP scan of K = 2 from batch 10, and the port's inputs."""
    jcfg = tiny_cfg.replace(batch_size=8, use_partition=True, donate_state=False, use_s2d=True,
                            adj_half_batch=True, ema_decay=0.9)
    jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(6)
    imgs, conds = make_store(rng, jcfg)
    ids1, ids2 = rng.integers(0, N_BATCHES, 2), rng.integers(0, N_BATCHES, 2)
    mesh = make_mesh(8)
    sh = NamedSharding(mesh, P(None, "data"))
    base = jax.random.PRNGKey(5)
    scan = jstep.make_scan_train_step(jcfg, jstate.params, 2, donate=False, mesh=mesh)
    jout = scan(replicate_state(jstate, mesh), jax.device_put(imgs, sh), jax.device_put(conds, sh),
                jnp.asarray(ids1, jnp.int32), jnp.asarray(ids2, jnp.int32), base, jnp.int32(GS0), jnp.int32(10))
    draws = [jax_update_draws(jax.random.fold_in(base, GS0 + i), jcfg, imgs.shape[1:]) for i in range(2)]
    base_case = dict(cfg=_cfg_dict(jcfg, **KERNELS), flat=_flatten(jstate.params))
    scan_steps = [("scan", (imgs, conds), ids1, ids2, tstep.stack_draws(draws), 10)]
    gather_steps = [("gather", (imgs, conds), int(ids1[i]), int(ids2[i]), draws[i], 10 + i) for i in range(2)]
    return dict(jcfg=jcfg, jout=jout, scan=dict(base_case, steps=scan_steps),
                gather=dict(base_case, steps=gather_steps))


@pytest.fixture(scope="module")
def accum_case(tiny_cfg):
    """The JAX DP accumulation step (M = 2) at batch 12, and the port's inputs."""
    jcfg = tiny_cfg.replace(batch_size=8, use_partition=True, donate_state=False, use_s2d=False, grad_accum=2)
    jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(7)
    imgs, conds = make_store(rng, jcfg)
    ids1, ids2 = rng.integers(0, N_BATCHES, 2), rng.integers(0, N_BATCHES, 2)
    b1s, b2s = (imgs[ids1], conds[ids1]), (imgs[ids2], conds[ids2])
    mesh = make_mesh(8)
    sh = NamedSharding(mesh, P(None, "data"))
    key = jax.random.PRNGKey(8)
    dp = jstep.make_accum_train_step(jcfg, jstate.params, donate=False, mesh=mesh)
    jout = dp(replicate_state(jstate, mesh), jax.device_put(b1s, sh), jax.device_put(b2s, sh), key, jnp.int32(12))
    draws = jax_update_draws(key, jcfg, imgs.shape[1:], 2)
    base_case = dict(cfg=_cfg_dict(jcfg), flat=_flatten(jstate.params))
    return dict(jcfg=jcfg, jout=jout,
                accum=dict(base_case, steps=[("accum", b1s, b2s, draws, 12)]),
                scan_accum=dict(base_case, steps=[("scan", (imgs, conds), ids1[None], ids2[None],
                                                   tstep.stack_draws([draws]), 12)]))


RUNS = {2: ("scan", "gather", "accum", "scan_accum"), 4: ("scan", "accum")}  # world -> the runs at that size


@pytest.fixture(scope="module")
def ranks(scan_case, accum_case):
    """world -> run -> each rank's result: one start of the ranks per world size."""
    cases = {**{k: scan_case[k] for k in ("scan", "gather")}, **{k: accum_case[k] for k in ("accum", "scan_accum")}}
    return {world: dict(zip(names, zip(*run_ranks("run_many", world, [cases[n] for n in names]))))
            for world, names in RUNS.items()}


def _hold(res, jcfg, jout, single, k):
    """Every rank the same; rank 0 against JAX and against one process."""
    flat, losses = res[0]["flat"], res[0]["losses"]
    for r in res[1:]:
        assert all(np.array_equal(r["flat"][key], flat[key]) for key in flat)
    for key in tstep.LOSS_KEYS:
        want = np.atleast_1d(np.asarray(jout.metrics[key]))
        got = np.concatenate([x[key] for x in losses])
        assert got.shape == want.shape == (k,)
        np.testing.assert_allclose(got[:1], want[:1], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=key)
    assert_state_matches_jax(flat, _flatten(jout.state), 3 * k * jcfg.lr)
    assert_states_close(flat, single["flat"], **DP_TOL)


@pytest.mark.parametrize("kind,world", [("scan", 2), ("scan", 4), ("gather", 2)])
def test_store_steps_match_jax_dp_scan(scan_case, ranks, kind, world):
    """K = 2 updates over the rank-sharded store, as one K-update call or
    as two gather steps, against JAX's DP scan."""
    _hold(ranks[world][kind], scan_case["jcfg"], scan_case["jout"], run_steps(None, scan_case[kind]), 2)


def test_k_update_graph_refuses_gloo_on_a_card(tiny_cfg):
    """The K-update step captures its updates in one CUDA graph; gloo's
    collectives cannot be captured, so with a card's state under a gloo
    reduction the step raises (it never runs the updates eagerly instead)."""
    import types

    from littlegan_tpu_torch.parallel.train import GradSync
    from test_torch_train import port_state

    state, tc = port_state(jcreate_train_state(tiny_cfg, jax.random.PRNGKey(0)), tiny_cfg)
    gloo = GradSync(types.SimpleNamespace(backend="gloo"))
    step = tstep.make_scan_train_step(tc, state, 2, sync=gloo)
    card_weight = types.SimpleNamespace(is_cuda=True)
    on_card = state._replace(model=types.SimpleNamespace(parameters=lambda: iter([card_weight])))
    for call in (lambda: step.prepare(on_card, None, None), lambda: step(on_card, None, None, [0, 1], [1, 0], None, 1)):
        with pytest.raises(RuntimeError, match="gloo collectives cannot be captured"):
            call()
    assert not GradSync(types.SimpleNamespace(backend="gloo")).capturable
    assert GradSync(types.SimpleNamespace(backend="nccl")).capturable


@pytest.mark.parametrize("kind,world", [("accum", 2), ("accum", 4), ("scan_accum", 2)])
def test_accumulation_matches_jax_dp(accum_case, ranks, kind, world):
    """The mean over M = 2 micro-pairs meets the other ranks' once per
    update: the host-fed accumulation step and the K = 1 scan of
    accumulated updates against JAX's accumulating DP step."""
    _hold(ranks[world][kind], accum_case["jcfg"], accum_case["jout"], run_steps(None, accum_case[kind]), 1)
