"""The port's train step against the JAX package's, on the CPU in f32.

Each case runs one JAX program that returns the gradients, the losses and
the updated state of ``train_step`` (``_micro_grads`` then
``apply_updates``), and the port's ``compute_grads`` then ``train_step`` on
the same weights, batches and draws: the draws are recomputed from the JAX
step's key in its split order (torch cannot reproduce ``jax.random``).
Also the 3-step golden trajectory of tests/test_golden.py.

Tolerances: losses rtol 1e-5; gradients rtol 1e-3 / atol 1e-6 (one
backward through three networks); first moments rtol 2e-3 / atol 1e-6 and
second moments rtol 2e-3 / atol 1e-9 (they carry the gradients' error; a
gradient that cancels to ~1e-8 has no relative precision); bf16 moments two
ulps (2^-7); updated weights atol 3 x lr_t, since Adam's first steps move
each weight by about ±lr_t whatever the gradient's size, so a near-zero
gradient of the other sign moves it the other way; golden losses rtol 5e-4,
as tests/test_golden.py.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from littlegan_tpu.config import Config as JConfig
from littlegan_tpu.training import create_train_state as jcreate_train_state
from littlegan_tpu.training import step as jstep
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu.training.partition import build_partition_masks
from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.training import optimizer as topt
from littlegan_tpu_torch.training import step as tstep
from littlegan_tpu_torch.training.checkpoint import flatten_state
from test_torch_train import batch, jax_step_draws, port_state, t
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

GRAD_TOL = dict(rtol=1e-3, atol=1e-6)

# (JAX config changes, batch_no): the kernel flags choose the port's route
# (its kernels' Functions; without them its plain ops); partition batches (5: group 1, 10: group 2) with the adjuster gate
# off; the half-batch adjuster on an even step with a G-only EMA and bf16
# moments; no adjuster with v1's shared beta powers and no clipping
STEP_CASES = {
    "s2d+kernels": (dict(use_s2d=True, use_pallas=True, use_pallas_boundary=True), 12),
    "plain-partition": (dict(use_s2d=False), 5),
    "adj_half+ema": (dict(use_s2d=True, adj_half_batch=True, ema_decay=0.9, moment_dtype="bfloat16"), 12),
    "no_adj+tick_all": (dict(use_s2d=True, train_adj=False, adam_tf_parity=True, use_clip=False), 10),
}


def jax_step_with_grads(jcfg, params):
    """jit of (grads, losses, fake, updated state) for one JAX step."""
    part_masks = build_partition_masks(params)

    def fn(state, b1, b2, rng, batch_no):
        adj_sel = (batch_no % 2) if jcfg.adj_half_batch else None
        grads, aux = jstep._micro_grads(state, b1, b2, rng, jcfg, False, adj_sel)
        out = jstep.apply_updates(state, grads, aux, batch_no, jcfg, part_masks)
        return grads, out.metrics, aux["fake"], out.state

    return jax.jit(fn)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(tiny_cfg, case):
    """The JAX side runs without its Pallas kernels (they are held against
    the port's Functions in tests/test_torch_train.py); the port runs its
    kernels' Functions (their plain versions) in the "kernels" case and its
    plain ops (``_build.plain_versions()``) in the others."""
    flags, batch_no = STEP_CASES[case]
    jcfg = tiny_cfg.replace(donate_state=False, **flags)
    route = contextlib.nullcontext() if jcfg.use_pallas else _build.plain_versions()
    jcfg = jcfg.replace(use_pallas=False, use_pallas_boundary=False)
    jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(0))
    state, tc = port_state(jstate, jcfg)
    rng = np.random.default_rng(batch_no)
    b1, b2 = batch(rng, jcfg), batch(rng, jcfg)
    key = jax.random.PRNGKey(7 + batch_no)
    draws = jax_step_draws(key, jcfg, b1[0].shape)

    jgrads, jmetrics, jfake, jnew = jax_step_with_grads(jcfg, jstate.params)(
        jstate, b1, b2, key, jnp.int32(batch_no)
    )
    tb1, tb2 = (t(b1[0]), t(b1[1])), (t(b2[0]), t(b2[1]))
    with route:
        grads, aux = tstep.compute_grads(state, tb1, tb2, draws, batch_no, tc)
        out = tstep.train_step(state, tb1, tb2, draws, batch_no, tc)
    for k in tstep.LOSS_KEYS:
        np.testing.assert_allclose(float(aux[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    for k, want in _flatten(jgrads).items():
        np.testing.assert_allclose(grads[k.replace("/", ".")].numpy(), np.asarray(want), **GRAD_TOL, err_msg=k)
    np.testing.assert_allclose(aux["fake"].numpy(), np.asarray(jfake), rtol=1e-4, atol=1e-5)

    want, got = _flatten(jnew), flatten_state(out.state)
    assert sorted(got) == sorted(want)
    lr_t = topt.adam_lr_t(jcfg.lr, jcfg.beta_1, jcfg.beta_2, 1)
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        kind = k.split("/")[1]
        if kind == ".count":
            assert int(g) == int(w), k
        elif g.dtype.kind == "V":  # bf16 moments, stored as raw 2-byte words
            g = torch.from_numpy(g.view(np.int16).copy()).view(torch.bfloat16).float().numpy()
            np.testing.assert_allclose(g, w.astype(np.float32), rtol=2 ** -7, atol=1e-6, err_msg=k)
        elif k.startswith((".params/", ".ema/")):
            np.testing.assert_allclose(g, w, rtol=0, atol=3 * lr_t, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-6 if kind == ".mu" else 1e-9, err_msg=k)


def test_three_step_golden_trajectory():
    """tests/test_golden.py's three steps: JAX's init, batches and step keys,
    the draws recomputed from those keys, the port's train_step."""
    from test_golden import GOLDEN

    jcfg = JConfig(
        batch_size=4, image_dim=16, init_dim=1, noise_dim=13,
        conv_filter=[24, 16, 12, 8, 4], compute_dtype="float32",
        use_partition=True, train_adj=True, donate_state=False, debug=True,
    )
    state, tc = port_state(jcreate_train_state(jcfg, jax.random.PRNGKey(0)), jcfg)

    def mk(k):
        k1, k2 = jax.random.split(k)
        img = jax.random.uniform(k1, (4, 16, 16, 3), minval=-1, maxval=1)
        cond = jnp.where(jax.random.bernoulli(k2, 0.5, (4, 7)), 0.98, -0.94)
        return t(img), t(cond)

    ks = jax.random.split(jax.random.PRNGKey(42), 8)
    step = tstep.make_train_step(tc, state)
    for i, want in enumerate(GOLDEN):
        rng = jax.random.fold_in(jax.random.PRNGKey(7), i)
        out = step(state, mk(ks[2 * i]), mk(ks[2 * i + 1]), jax_step_draws(rng, jcfg, (4, 16, 16, 3)), i + 11)
        for key, val in want.items():
            np.testing.assert_allclose(float(out.metrics[key]), val, rtol=5e-4, err_msg=f"step {i} {key}")
