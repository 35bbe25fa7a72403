"""The port's data-parallel host-fed step against the JAX package's DP
step, on the CPU in f32.

The JAX side is ``make_parallel_train_step`` on the virtual 8-device CPU
mesh (tests/conftest.py) over a global batch of 8, compiled once per
configuration for the module. The port side runs the same update in 2 and
4 gloo processes (``tests/torch_dp_common.py``), each rank on its rows of
the same global batch and of the draws recomputed from the JAX step's key
(``jax_step_draws``), and in one process on the whole batch.

Tolerances: port DP against JAX DP as tests/test_torch_step.py states for
one step (losses rtol 1e-5 for the first update, 1e-3 for a later one;
weights atol 3 x lr_t per update, moments rtol 2e-3); port DP against the
port on one process rtol 2e-4 / atol 2e-5, the bound tests/test_parallel.py
holds JAX's DP to.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from littlegan_tpu.parallel import make_mesh, make_parallel_train_step, replicate_state, shard_batch
from littlegan_tpu.training import create_train_state as jcreate_train_state
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch.parallel.train import local_draws
from littlegan_tpu_torch.training import optimizer as topt
from littlegan_tpu_torch.training import step as tstep
from test_torch_train import batch, jax_step_draws, port_state, t, tcfg_of
from torch_dp_common import assert_state_matches_jax, assert_states_close, run_ranks, run_steps
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

DP_TOL = dict(rtol=2e-4, atol=2e-5)
KERNELS = dict(use_pallas=True, use_pallas_boundary=True)
WORLDS = (2, 4)

# name: (config changes for both packages, port-only flags, batch_nos). "gp+clip":
# the penalty with a clamp small enough that most of D's gradients clip;
# "adj_half+kernels": the half-batch adjuster at both parities, the port with
# its kernels' Functions (plain versions here; JAX forces its kernels off under a mesh)
CASES = {
    "gp+clip": (dict(use_gp=True, use_s2d=True, clip_range=2e-4), {}, (12,)),
    "adj_half+kernels": (dict(use_s2d=True, adj_half_batch=True, ema_decay=0.9), KERNELS, (20, 21)),
}


def _cfg_dict(jcfg, **port_flags):
    tc = tcfg_of(jcfg.replace(**port_flags))
    return {f: getattr(tc, f) for f in tc.__dataclass_fields__}


@pytest.fixture(scope="module")
def runs(tiny_cfg):
    """Per case: the JAX DP result, the port case, its one-process result;
    the port's multi-rank results are made on demand (``ranks``)."""
    out = {}
    mesh = make_mesh(8)
    for name, (flags, port_flags, batch_nos) in CASES.items():
        jcfg = tiny_cfg.replace(batch_size=8, use_partition=True, donate_state=False, **flags)
        jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(len(name))
        steps, jouts = [], []
        dp = make_parallel_train_step(jcfg, jstate.params, mesh, donate=False)
        state = replicate_state(jstate, mesh)
        for bn in batch_nos:
            b1, b2 = batch(rng, jcfg), batch(rng, jcfg)
            key = jax.random.PRNGKey(100 + bn)
            jout = dp(state, shard_batch(b1, mesh), shard_batch(b2, mesh), key, jnp.int32(bn))
            state = jout.state
            jouts.append(jout)
            steps.append(("train", b1, b2, jax_step_draws(key, jcfg, b1[0].shape), bn))
        case = dict(cfg=_cfg_dict(jcfg, **port_flags), flat=_flatten(jstate.params), steps=steps)
        out[name] = dict(jcfg=jcfg, jstate=jstate, jouts=jouts, case=case, single=run_steps(None, case))
    return out


@pytest.fixture(scope="module")
def ranks(runs):
    """world -> case name -> each rank's result: one start of the ranks per world size."""
    return {world: dict(zip(CASES, zip(*run_ranks("run_many", world, [runs[n]["case"] for n in CASES]))))
            for world in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_jax_dp(runs, ranks, name, world):
    """Each rank ends with the JAX DP step's state and losses, every rank
    the same, and the port's one-process run on the global batch agrees
    to DP_TOL."""
    run = runs[name]
    res = ranks[world][name]
    jcfg, jouts = run["jcfg"], run["jouts"]
    flat, losses, reduced = res[0]["flat"], res[0]["losses"], res[0]["reduced"]
    for r in res[1:]:  # the ranks agree exactly: one average reaches them all
        assert all(np.array_equal(r["flat"][k], flat[k]) for k in flat)
        assert all(np.array_equal(a[k], b[k]) for a, b in zip(r["losses"], losses) for k in a)
    for i, jout in enumerate(jouts):
        for k in tstep.LOSS_KEYS:
            np.testing.assert_allclose(losses[i][k][0], float(jout.metrics[k]), rtol=1e-5 if i == 0 else 1e-3,
                                       err_msg=f"update {i} {k}")
    lr_t = topt.adam_lr_t(jcfg.lr, jcfg.beta_1, jcfg.beta_2, 1)
    assert_state_matches_jax(flat, _flatten(jouts[-1].state), 3 * len(jouts) * lr_t)
    assert_states_close(flat, run["single"]["flat"], **DP_TOL)
    n_grads = sum(int(np.prod(v.shape)) for k, v in flat.items() if k.startswith(".params/"))
    assert reduced == 4 * (n_grads + 3)  # every gradient and the three losses, f32, once per update


def test_clamp_follows_the_all_reduce(runs, ranks):
    """With ``clip_range`` 2e-4 the clamp of D's gradients decides the
    update: the port's DP first moments are (1 - b1) x clamp(mean of the
    ranks' gradients), JAX's, and not (1 - b1) x mean of each rank's clamped
    gradient, which differs from them by far more than the tolerance."""
    run = runs["gp+clip"]
    jcfg, world = run["jcfg"], 2
    flat = ranks[world]["gp+clip"][0]["flat"]
    _, b1, b2, draws, bn = run["case"]["steps"][0]
    rank_grads = []
    for r in range(world):
        state, tc = port_state(run["jstate"], jcfg)
        rows = slice(r * 4, (r + 1) * 4)
        dg = types.SimpleNamespace(rank=r, world=world)
        grads, _ = tstep.compute_grads(state, (t(b1[0][rows]), t(b1[1][rows])), (t(b2[0][rows]), t(b2[1][rows])),
                                       local_draws(draws, dg), bn, tc)
        rank_grads.append(grads)
    b1_ = 1 - jcfg.beta_1
    want = _flatten(run["jouts"][0].state)
    far = 0
    for name in rank_grads[0]:
        if not name.startswith(("encoder.", "d_head.")):
            continue
        key = f".opt_d/.mu/{name.replace('.', '/')}"
        per_rank = b1_ * np.mean([g[name].clamp(-jcfg.clip_range, jcfg.clip_range).numpy() for g in rank_grads], 0)
        np.testing.assert_allclose(flat[key], np.asarray(want[key]), rtol=2e-3, atol=1e-6, err_msg=key)
        far += int((np.abs(per_rank - flat[key]) > 10 * (2e-3 * np.abs(flat[key]) + 1e-6)).sum())
    assert far > 100, far
