"""The gradient penalty (``use_gp``) and ``remat`` in the port's train step,
on the CPU in f32: against the JAX package's ``_micro_grads``, and the port
against itself.

Each JAX case runs one jitted JAX program (the GP step differentiates D
twice); the port gets the same weights, batches and draws, the draws
recomputed from the JAX key in ``_micro_grads``' split order, the penalty's
mix from its third key.

Tolerances: losses rtol 1e-5, gradients rtol 1e-3 / atol 1e-6, as
tests/test_torch_step.py (one backward through three networks, here with a
second-order term in D's). The port with and without ``remat``: the same
forwards recomputed on the CPU give the same gradients bit for bit. GP +
remat in bf16: finite, and within 5% (or 0.05 absolute) of the step without
remat, as the JAX package's ``test_remat_composes_with_gp_and_bf16``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from littlegan_tpu.training import create_train_state as jcreate_train_state
from littlegan_tpu.training import step as jstep
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch.ops.cuda import boundary_conv
from littlegan_tpu_torch.ops.cuda.norm_lrelu import FusedNormLReLU, NormLReLUFromStats
from littlegan_tpu_torch.training import step as tstep
from test_torch_dispatch import _clone_state, _same_state
from test_torch_same_border import KERNEL_FUNCTIONS, _Calls
from test_torch_step import GRAD_TOL
from test_torch_train import batch, jax_step_draws, port_state, t
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

KERNELS = dict(use_pallas=True, use_pallas_boundary=True)
BATCH_NO = 12  # past the adjuster gate; partition off


def _jax_grads(jcfg):
    """jit of (grads, losses) of JAX ``_micro_grads``."""

    def fn(state, b1, b2, rng, batch_no):
        adj_sel = (batch_no % 2) if jcfg.adj_half_batch else None
        grads, aux = jstep._micro_grads(state, b1, b2, rng, jcfg, False, adj_sel)
        return grads, {k: aux[k] for k in tstep.LOSS_KEYS}

    return jax.jit(fn)


def _against_jax(tiny_cfg, port_flags=None, **flags):
    """``port_flags``: set on the port's config only (the JAX side runs
    without them)."""
    jcfg = tiny_cfg.replace(donate_state=False, use_partition=False, **flags)
    jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(0))
    state, tc = port_state(jstate, jcfg.replace(**(port_flags or {})))
    rng = np.random.default_rng(3)
    b1, b2 = batch(rng, jcfg), batch(rng, jcfg)
    key = jax.random.PRNGKey(21)
    draws = jax_step_draws(key, jcfg, b1[0].shape)
    jgrads, jlosses = _jax_grads(jcfg)(jstate, b1, b2, key, jnp.int32(BATCH_NO))
    grads, aux = tstep.compute_grads(state, (t(b1[0]), t(b1[1])), (t(b2[0]), t(b2[1])), draws, BATCH_NO, tc)
    for k in tstep.LOSS_KEYS:
        np.testing.assert_allclose(float(aux[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    want = _flatten(jgrads)
    assert sorted(k.replace("/", ".") for k in want) == sorted(grads)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k.replace("/", ".")].numpy(), np.asarray(w), **GRAD_TOL, err_msg=k)
    return grads, aux


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "raw"])
def test_gp_step_matches_jax(tiny_cfg, s2d):
    """D's loss with the penalty on interpolates of the augmented real batch
    and fake, D's parameters taking its second-order gradient."""
    grads, aux = _against_jax(tiny_cfg, use_gp=True, use_s2d=s2d)
    assert float(grads["encoder.block1.conv.kernel"].abs().sum()) > 0


def test_remat_step_matches_jax(tiny_cfg):
    """JAX's ``jax.checkpoint`` step against the port's checkpointed one."""
    _against_jax(tiny_cfg, remat=True, use_s2d=True, adj_half_batch=False)


def _port_case(tiny_cfg, seed=5, **flags):
    jcfg = tiny_cfg.replace(use_partition=False, **flags)
    state, tc = port_state(jcreate_train_state(jcfg.replace(use_pallas=False, use_pallas_boundary=False),
                                               jax.random.PRNGKey(0)), jcfg)
    rng = np.random.default_rng(seed)
    b1, b2 = batch(rng, jcfg), batch(rng, jcfg)
    draws = jax_step_draws(jax.random.PRNGKey(seed), jcfg, b1[0].shape)
    return state, tc, (t(b1[0]), t(b1[1])), (t(b2[0]), t(b2[1])), draws


@pytest.mark.parametrize("flags", [dict(), KERNELS, dict(use_gp=True)], ids=["plain", "kernels", "gp"])
def test_remat_gives_the_same_gradients(tiny_cfg, flags):
    state, tc, b1, b2, draws = _port_case(tiny_cfg, use_s2d=True, **flags)
    want, want_aux = tstep.compute_grads(state, b1, b2, draws, BATCH_NO, tc)
    got, aux = tstep.compute_grads(state, b1, b2, draws, BATCH_NO, tc.replace(remat=True))
    for k in tstep.LOSS_KEYS:
        assert float(aux[k]) == float(want_aux[k]), k
    for k, g in want.items():
        assert torch.equal(got[k], g), k


def test_remat_recomputes_each_network_once_per_backward(tiny_cfg, monkeypatch):
    """The kernel Functions' forwards per step with both flags on: without
    remat K1 runs 20 times (G's decoder 4, D's encoder blocks 2-4 on the
    real batch, on fake and on the adjuster's output 3 each, the adjuster
    7), K1' and K3 4 times (encoder block1 of each encoder pass). With
    remat each backward recomputes the networks it crosses: the disc loss's
    D on the real batch and on fake, the gen loss's D on fake and G, the adj
    loss's D on the adjuster's output and the adjuster. The backwards run
    as often either way."""
    calls = {}

    def counting(fn, name):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return staticmethod(wrapped)

    for cls in (FusedNormLReLU, NormLReLUFromStats, boundary_conv.BoundaryConvS2D):
        for what in ("forward", "backward"):
            monkeypatch.setattr(cls, what, counting(getattr(cls, what), f"{cls.__name__}.{what}"))
    state, tc, b1, b2, draws = _port_case(tiny_cfg, use_s2d=True, **KERNELS)
    counts = {}
    for remat in (False, True):
        calls.clear()
        tstep.compute_grads(state, b1, b2, draws, BATCH_NO, tc.replace(remat=remat))
        counts[remat] = dict(calls)
    bwd = {"FusedNormLReLU.backward": 20, "NormLReLUFromStats.backward": 4, "BoundaryConvS2D.backward": 4}
    assert counts[False] == {"FusedNormLReLU.forward": 20, "NormLReLUFromStats.forward": 4,
                             "BoundaryConvS2D.forward": 4, **bwd}
    assert counts[True] == {"FusedNormLReLU.forward": 20 + 6 + 7 + 10, "NormLReLUFromStats.forward": 4 + 2 + 1 + 2,
                            "BoundaryConvS2D.forward": 4 + 2 + 1 + 2, **bwd}


def test_gp_remat_bf16_close_to_unremat(tiny_cfg):
    state, tc, b1, b2, draws = _port_case(tiny_cfg, use_gp=True, compute_dtype="bfloat16")
    vals = {}
    for remat in (False, True):
        out = tstep.train_step(_clone_state(state, tc), b1, b2, draws, 11, tc.replace(remat=remat))
        vals[remat] = {k: float(out.metrics[k]) for k in tstep.LOSS_KEYS}
    for k, a in vals[False].items():
        b = vals[True][k]
        assert np.isfinite(b), k
        assert abs(a - b) < 0.05 * max(1.0, abs(a)), (k, a, b)


def test_gp_in_a_k_update_scan_equals_eager_steps(tiny_cfg):
    """Two GP updates as one K = 2 step over a uint8 store (one CUDA graph
    on the card) against two gather steps: bit for bit."""
    state, tc, _, _, _ = _port_case(tiny_cfg, use_gp=True, use_s2d=True)
    rng = np.random.default_rng(8)
    imgs = torch.from_numpy(rng.integers(0, 256, (4, 4, 16, 16, 3), np.uint8))
    conds = torch.from_numpy(np.where(rng.random((4, 4, tc.cond_dim)) < 0.5, 0.98, -0.94).astype(np.float32))
    draws = [jax_step_draws(jax.random.PRNGKey(40 + i), tc, (4, 16, 16, 3)) for i in range(2)]
    assert draws[0].gp_eps.shape == (4, 1, 1, 1)
    eager = _clone_state(state, tc)
    gather = tstep.make_gather_train_step(tc, eager)
    want = [gather(eager, imgs, conds, b1, b2, d, 11 + i).metrics for i, (b1, b2, d) in
            enumerate(zip((0, 2), (1, 3), draws))]
    out = tstep.make_scan_train_step(tc, state, 2)(state, imgs, conds, np.array([0, 2]), np.array([1, 3]),
                                                  tstep.stack_draws(draws), 11)
    for i in range(2):
        for k in tstep.LOSS_KEYS:
            assert float(out.metrics[k][i]) == float(want[i][k]), (i, k)
    _same_state(state, eager)


@pytest.mark.parametrize("flags", [dict(use_pallas=True), KERNELS], ids=["use_pallas", "both"])
def test_gp_with_a_kernel_flag_matches_jax_on_the_plain_route(tiny_cfg, flags, monkeypatch):
    """The JAX package's kernel flags do not reach the port: its GP step
    takes the plain route by itself, calls no kernel Function, and matches
    the JAX GP step run without its kernels."""
    calls = _Calls(monkeypatch, KERNEL_FUNCTIONS)
    grads, _ = _against_jax(tiny_cfg, port_flags=flags, use_gp=True, use_s2d=True)
    assert calls.counts == {}
    assert float(grads["encoder.block1.conv.kernel"].abs().sum()) > 0


def _fused(x, g, b):
    return FusedNormLReLU.apply(x, g, b, 0.3)


def _from_stats(x, g, b):
    return NormLReLUFromStats.apply(x, x.float().sum((1, 2, 3)), x.float().square().sum((1, 2, 3)), g, b, 0.3)


def _boundary(x, g, b):
    w = g.reshape(1, 1, 1, 1).expand(3, 3, x.shape[-1], 8).contiguous()
    return boundary_conv.BoundaryConvS2D.apply(x, w, b.expand(8).contiguous())[0]


@pytest.mark.parametrize("fn", [_fused, _from_stats, _boundary], ids=["K1", "K1'", "K3"])
def test_grad_of_grad_through_a_kernel_function_raises(fn):
    """A penalty-shaped second differentiation: the first-order gradient
    with create_graph raises instead of returning a gradient whose terms
    through the kernel's backward would be missing. Without create_graph
    the first-order gradient is returned."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 12)).astype(np.float32)).requires_grad_(True)
    g, b = torch.ones(1, requires_grad=True), torch.full((1,), 0.1, requires_grad=True)
    with pytest.raises(RuntimeError, match="first order only"):
        torch.autograd.grad(fn(x, g, b).square().sum(), x, create_graph=True)
    (dx,) = torch.autograd.grad(fn(x, g, b).square().sum(), x)
    assert dx.shape == x.shape and bool(torch.isfinite(dx).all())
