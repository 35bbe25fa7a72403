"""Kernel coverage: every shape the JAX package sends to a Pallas kernel runs
on the port's Hopper counterpart, with the moments JAX takes there.

- The routing sweep: image_dim 32-1024 in steps of 16 (``init_dim`` =
  dim/16), the reference's, ``tiny_cfg``'s, the JAX doctor's and the e2e
  recipe's ``conv_filter``, f32 and bf16, batches 1, 8, 32 and 64. G, D and
  A run on the meta device with both kernel flags on and the kernels'
  autograd Functions replaced by recorders, so every norm epilogue and
  every encoder block1 the port's model routes is seen with its shape. On
  each shape JAX's ``supports`` sends to a Pallas kernel, the port routes
  it to its kernel, its host-side plans (``fwd_plan``, ``bwd_plan``,
  ``_check_plan``, K3's ``conv_plan``) take it without a ValueError, and
  the moments rule (two-pass or one-pass) is JAX's, on both sides of the
  Pallas op's 8 MiB.
- K1's plain version against the Pallas op in interpret mode, forward and
  VJP, at a map whose height is not a multiple of 8 above 512 KiB of f32
  (held whole, two-pass); and above the op's per-sample limit, where the
  JAX model runs its one-pass ``instance_norm``.
- K3's fold (through the boundary conv's backward) against JAX's custom VJP
  at Cout 6 and 256 (the forward's widths: tests/test_torch_kernels.py).
- One train step at the JAX doctor's config (``[16, 12, 8, 6, 4]``, 16²,
  f32, both kernel flags, so block1 runs K3 at Cout 6) against JAX's with
  its Pallas kernels in interpret mode.

Tolerances: y rtol/atol 1e-5 and the norm's gradients rtol 2e-4 / atol
2e-5 (tests/test_pallas.py:42, :138), at the 135k-element map dgamma and
dbeta to 1e-6 of the sum of their terms' magnitudes; the boundary conv's backward rtol
1e-4 / atol 1e-5, db atol 1e-4 (a sum over N*H*W f32 terms); the train
step as tests/test_torch_step.py holds it: losses rtol 1e-5, gradients
rtol 1e-3 / atol 1e-6, the fake images rtol 1e-4 / atol 1e-5.
"""

import inspect
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from littlegan_tpu.config import Config as JConfig
from littlegan_tpu.models import littlegan as jm
from littlegan_tpu.ops import norm as jnorm
from littlegan_tpu.ops.pallas import boundary_conv as jbc
from littlegan_tpu.ops.pallas import norm_lrelu as jnl
from littlegan_tpu.training import create_train_state as jcreate_train_state
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch.config import Config as TConfig
from littlegan_tpu_torch.models import littlegan as tm
from littlegan_tpu_torch.ops.cuda import boundary_conv as tbc
from littlegan_tpu_torch.ops.cuda import norm_lrelu as tnl
from littlegan_tpu_torch.training import step as tstep
from test_torch_kernels import _paired_sample
from test_torch_step import GRAD_TOL, jax_step_with_grads
from test_torch_train import batch, jax_step_draws, port_state, t
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

Y_TOL = dict(rtol=1e-5, atol=1e-5)
NORM_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
CONV_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SMS = 132  # the H100's SMs

SWEEP_DIMS = range(32, 1025, 16)
SWEEP_FILTERS = {
    "reference": [384, 256, 128, 64, 32],
    "tiny_cfg": [24, 16, 12, 8, 4],
    "jax_doctor": [16, 12, 8, 6, 4],
    "e2e": [48, 32, 24, 16, 8],
}
SWEEP_DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SWEEP_BATCHES = (1, 8, 32, 64)
DOCTOR_FILTERS = SWEEP_FILTERS["jax_doctor"]
SUPPORTS = tbc.supports  # the predicate itself, which the recorder wraps


class _Recorder:
    """What the port's model hands its kernels' Functions, on meta tensors:
    ``norms`` each norm epilogue (shape, whether it reached the fused
    kernel's Function), ``block1`` each encoder block1 (x shape, Cout,
    whether ``supports`` took it, whether it reached the boundary conv's
    Function)."""

    def __init__(self, monkeypatch):
        self.norms, self.block1 = [], []
        self._fused = 0
        rec = self
        orig_norm = tm._norm_lrelu

        def bordered(y, border):  # the Functions' (padded, map) where the model asks for a border
            return y if border is None else (tnl.pad_plain(y, border), y)

        class Fused:
            @staticmethod
            def apply(x, gamma, beta, alpha, eps=None, border=None, crop=None):
                rec._fused += 1
                if crop is not None:
                    top, left, rows, cols = crop
                    x = x[:, top:top + rows, left:left + cols]
                return bordered(x, border)

        class Conv:
            @staticmethod
            def apply(x, w, b):
                rec.block1[-1][3] = True
                n = x.shape[0]
                return x.new_empty(x.shape[:3] + (w.shape[3],)), x.new_empty(n), x.new_empty(n)

        class FromStats:
            @staticmethod
            def apply(y, s1, s2, gamma, beta, alpha, eps=None, border=None):
                return bordered(y, border)

        def norm_lrelu(x, norm, cfg, sp=None, height=0, border=None, crop=None):
            before = rec._fused
            out = orig_norm(x, norm, cfg, sp, height, border, crop)
            shape = tuple(x.shape) if crop is None else (x.shape[0], crop[2], crop[3], x.shape[3])  # the norm's map
            rec.norms.append((shape, rec._fused == before + 1))
            return out

        def supports(x_shape, cout=None, dtype=None):
            ok = SUPPORTS(x_shape, cout, dtype)
            rec.block1.append([tuple(x_shape), cout, ok, False])
            return ok

        monkeypatch.setattr(tm, "_norm_lrelu", norm_lrelu)
        monkeypatch.setattr(tm, "FusedNormLReLU", Fused)
        monkeypatch.setattr(tm, "NormLReLUFromStats", FromStats)
        monkeypatch.setattr(tbc, "BoundaryConvS2D", Conv)
        monkeypatch.setattr(tbc, "supports", supports)

    def run(self, dim: int, filters, dtype_name: str):
        """G, D and A of one config at batch 1 on the meta device; returns
        (norms, block1) of this run."""
        self.norms, self.block1 = [], []
        cfg = TConfig(image_dim=dim, init_dim=dim // 16, conv_filter=list(filters), compute_dtype=dtype_name,
                      batch_size=1, use_pallas=True, use_pallas_boundary=True)
        with torch.device("meta"):
            model = tm.LittleGAN(cfg)
            model.to("meta")
            noise, cond = torch.empty(1, cfg.noise_dim), torch.empty(1, cfg.cond_dim)
            image = torch.empty(1, dim, dim, cfg.image_channel)
            model.generator(noise, cond)
            model.discriminator(image)
            model.adjuster(image, cond)
        return list(self.norms), [tuple(b) for b in self.block1]


def _sweep(monkeypatch):
    rec = _Recorder(monkeypatch)
    for name, filters in SWEEP_FILTERS.items():
        for dim in SWEEP_DIMS:
            for dtype_name in SWEEP_DTYPES:
                yield (name, dim, dtype_name), *rec.run(dim, filters, dtype_name)


def _with_batch(shape, n):
    return (n,) + tuple(shape[1:])


def test_every_shape_jax_sends_to_pallas_runs_on_the_ports_kernel(monkeypatch):
    """The routing sweep (module docstring). Counts what it checked, so that
    a sweep that saw nothing fails."""
    checked = {"K1": 0, "K1 one-pass above 8 MiB": 0, "K3": 0, "K3 fits": 0}
    for where, norms, block1 in _sweep(monkeypatch):
        dtype_name = where[2]
        tdt, jdt = SWEEP_DTYPES[dtype_name]
        item = torch.tensor([], dtype=tdt).element_size()
        assert norms and len(block1) == 2, where  # D's and A's encoders
        for shape1, routed in norms:
            assert routed, (where, shape1)  # every 4-D norm reaches the fused kernel
            for n in SWEEP_BATCHES:
                shape = _with_batch(shape1, n)
                m = math.prod(shape[1:])
                jax_pallas = jnl.supports(shape, jdt)
                jax_two_pass = jax_pallas and jnl._pick_chunk(*shape[1:]) is None
                assert tnl.holds_whole_sample(shape, item) == jax_two_pass, (where, shape)
                fwd = tnl.fwd_plan(n, m, item, SMS, jax_two_pass)
                tnl._check_plan(fwd, m, "fwd")
                assert fwd.two_pass == jax_two_pass
                tnl._check_plan(tnl.bwd_plan(n, m, item, SMS), m, "bwd")
                checked["K1" if jax_pallas else "K1 one-pass above 8 MiB"] += 1
        for x1, cout, took, routed in block1:
            assert took == routed, (where, x1)
            for n in SWEEP_BATCHES:
                x_shape = _with_batch(x1, n)
                y_shape = x_shape[:3] + (cout,)
                plan = tbc.conv_plan(tdt, x_shape, cout)
                assert plan.cout_tile * plan.cout_tiles >= cout and plan.cout_tile in (8, 16, 32, 64, 128)
                assert SUPPORTS(x_shape, cout, tdt) == (SUPPORTS(x_shape) and plan.fits)
                checked["K3 fits"] += plan.fits
                if jbc.supports(x_shape):
                    assert took and plan.fits, (where, x_shape, cout, plan)
                    m = math.prod(y_shape[1:])
                    tnl._check_plan(tnl.bwd_plan(n, m, item, SMS), m, "K1' bwd")
                    checked["K3"] += 1
    assert all(v > 0 for v in checked.values()), checked


def test_the_sweep_sees_the_fault_shapes(monkeypatch):
    """The shapes that raised before the two-pass two-launch route, among
    the sweep's: a sample beyond 16 blocks' shared memory whose height is
    not a multiple of 8, which JAX holds whole (two-pass)."""
    rec = _Recorder(monkeypatch)
    for dim, dtype_name, shape in ((368, "float32", (92, 92, 128)), (480, "float32", (60, 60, 256)),
                                   (496, "bfloat16", (124, 124, 128)), (688, "bfloat16", (86, 86, 256))):
        norms, _ = rec.run(dim, SWEEP_FILTERS["reference"], dtype_name)
        assert (1,) + shape in [s for s, _ in norms]
        item = 4 if dtype_name == "float32" else 2
        n, m = 32, math.prod(shape)
        assert tnl.holds_whole_sample((n,) + shape, item)
        assert tnl.fwd_plan(n, m, item, SMS, True) == (*tnl.chunking(n, m, SMS), False, True)


@pytest.mark.parametrize("shape,dtype", [
    ((1, 92, 92, 128), jnp.float32), ((1, 60, 60, 256), jnp.float32), ((1, 124, 124, 128), jnp.bfloat16),
    ((1, 92, 92, 256), jnp.float32), ((1, 128, 128, 128), jnp.float32), ((1, 256, 256, 64), jnp.bfloat16),
    ((1, 260, 260, 64), jnp.bfloat16), ((1, 64, 64, 64), jnp.float32), ((1, 12, 12, 2048), jnp.float32),
])
def test_moments_rule_is_the_jax_models_on_both_sides_of_8_mib(shape, dtype):
    """Two-pass exactly where the JAX model's Pallas op takes the tensor and
    holds it whole; one-pass where the op chunks it, and above 8 MiB a
    sample, where ``_norm_lrelu`` runs ``instance_norm`` with its default,
    one-pass moments (shapes only: no 8 MiB tensor is made)."""
    item = jnp.dtype(dtype).itemsize
    jax_two_pass = jnl.supports(shape, dtype) and jnl._pick_chunk(*shape[1:]) is None
    assert tnl.holds_whole_sample(shape, item) == jax_two_pass
    assert inspect.signature(jnorm.instance_norm).parameters["two_pass"].default is False


def test_fused_norm_lrelu_above_the_pallas_limit_is_the_jax_models_one_pass(monkeypatch):
    """With the per-sample limit of both packages lowered to 16 KiB, a
    (2, 12, 12, 64) f32 map (36 KiB a sample, rows not a multiple of 8,
    which the Pallas op would hold whole) is above it: the JAX model's
    ``_norm_lrelu`` runs its one-pass ``instance_norm`` + LeakyReLU, and
    the port's FusedNormLReLU (its plain version, forward and backward)
    takes one-pass moments too."""
    monkeypatch.setattr(jnl, "_VMEM_SAMPLE_LIMIT", 16 << 10)
    monkeypatch.setattr(tnl, "_VMEM_SAMPLE_LIMIT", 16 << 10)
    shape = (2, 12, 12, 64)
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    gout = rng.normal(size=shape).astype(np.float32)
    g, b = np.array([1.3], np.float32), np.array([-0.2], np.float32)
    assert not tnl.holds_whole_sample(shape, 4) and jnl._pick_chunk(*shape[1:]) is None
    xt = torch.from_numpy(x)
    mean = xt.mean((1, 2, 3))
    one_pass = (xt.square().mean((1, 2, 3)) - mean.square()).clamp_min(0.0).sqrt()
    torch.testing.assert_close(tnl.instance_norm_moments_plain(xt), torch.stack([mean, one_pass]), rtol=0, atol=0)
    jcfg = JConfig(use_pallas=True)

    def f(x, g, b):
        y = jm._norm_lrelu(x, {"gamma": g, "beta": b}, jcfg)
        return jnp.sum(y * gout), y

    (_, want_y), want = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    y = tnl.FusedNormLReLU.apply(*ins, 0.3)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **Y_TOL)
    (y * torch.from_numpy(gout)).sum().backward()
    for name, got, w in zip(("dx", "dgamma", "dbeta"), ins, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), **NORM_GRAD_TOL, err_msg=name)


def test_fused_norm_lrelu_at_a_large_whole_sample_map_matches_pallas():
    """(1, 92, 92, 16) f32: 529 KiB a sample, above the 512 KiB the Pallas
    op holds whole by size, and 92 rows, not a multiple of 8: held whole,
    two-pass moments, at a mean 30 times the std (where one-pass rounds).
    The plain version against the Pallas op in interpret mode, forward and
    jax.grad through its custom VJP; dx leaves out the elements within 1e-5
    of LeakyReLU's kink."""
    shape = (1, 92, 92, 16)
    rng = np.random.default_rng(92)
    x = _paired_sample(rng, shape, 30.0)
    gout = rng.normal(size=shape).astype(np.float32)
    g, b = np.array([1.3], np.float32), np.array([-0.2], np.float32)
    assert math.prod(shape[1:]) * 4 > jnl._WHOLE_SAMPLE_F32_LIMIT and jnl._pick_chunk(*shape[1:]) is None
    assert tnl.holds_whole_sample(shape, 4)

    def f(x, g, b):
        y = jnl.fused_instance_norm_lrelu(x, g, b, 0.3)
        return jnp.sum(y * gout), y

    (_, want_y), want = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    y = tnl.FusedNormLReLU.apply(*ins, 0.3)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **Y_TOL)
    (y * torch.from_numpy(gout)).sum().backward()
    x64 = x.astype(np.float64).reshape(shape[0], -1)
    z = (x64 - x64.mean(1, keepdims=True)) / (x64.std(1, keepdims=True) + 1e-3) * g[0] + b[0]
    away = (np.abs(z) > 1e-5).reshape(shape)
    np.testing.assert_allclose(ins[0].grad.numpy()[away], np.asarray(want[0])[away], **NORM_GRAD_TOL)
    # dgamma = sum(dz * n), dbeta = sum(dz) over 135k terms that cancel to
    # well under their magnitudes: f32 sums in another order, held to 1e-6
    # of the sum of the terms' magnitudes
    nrm = ((z - b[0]) / g[0]).reshape(shape)
    for name, got, w, terms in (("dgamma", ins[1].grad, want[1], gout * nrm), ("dbeta", ins[2].grad, want[2], gout)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-6 * np.abs(terms).sum(),
                                   err_msg=name)


@pytest.mark.parametrize("cout", [6, 256])
def test_boundary_conv_backward_matches_jax_at_other_widths(cout):
    """The fold's plain version (stats cotangents into y's, db) and the conv
    gradients after it, through BoundaryConvS2D, against JAX's custom VJP
    ``boundary_conv_s2d`` (the Pallas forward in interpret mode) at a width
    the model's 64 is not."""
    rng = np.random.default_rng(cout)
    x = rng.normal(size=(2, 8, 8, 12)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 12, cout)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    gout = rng.normal(size=(2, 8, 8, cout)).astype(np.float32)

    def f(x, w, b):
        y, s1, s2 = jbc.boundary_conv_s2d(x, w, b, True)
        return jnp.sum(y * gout) + jnp.sum(s1 * 0.7) + jnp.sum(s2 * 0.01)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y, s1, s2 = tbc.BoundaryConvS2D.apply(*ins)
    ((y * torch.from_numpy(gout)).sum() + (s1 * 0.7).sum() + (s2 * 0.01).sum()).backward()
    for name, tv, wv in zip(("x", "w"), ins, want):
        np.testing.assert_allclose(tv.grad.numpy(), np.asarray(wv), **CONV_GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(ins[2].grad.numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-4, err_msg="b")
    yd = y.detach()
    gs1, gs2 = torch.full((2,), 0.7), torch.full((2,), 0.01)
    gy, db = tbc.conv3x3_bwd_fold(yd, torch.from_numpy(gout), gs1, gs2)
    assert gy.shape == yd.shape and db.shape == (cout,)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-4)


def test_train_step_at_the_jax_doctors_config_matches_jax():
    """One train step at the JAX doctor's tiny config (scripts/doctor.py:
    16², ``init_dim`` 1, ``conv_filter`` [16, 12, 8, 6, 4], f32, batch 2)
    with both kernel flags, so that encoder block1 runs the boundary conv
    at Cout 6: the port's Functions (plain versions on the CPU) against
    JAX's step with its Pallas kernels in interpret mode."""
    jcfg = JConfig(batch_size=2, image_dim=16, init_dim=1, noise_dim=8, conv_filter=DOCTOR_FILTERS,
                   compute_dtype="float32", debug=True, donate_state=False, use_pallas=True,
                   use_pallas_boundary=True)
    assert jbc.supports((2, 8, 8, 12)) and tbc.supports((2, 8, 8, 12), DOCTOR_FILTERS[3], torch.float32)
    jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(0))
    state, tc = port_state(jstate, jcfg)
    batch_no = 12
    rng = np.random.default_rng(batch_no)
    b1, b2 = batch(rng, jcfg), batch(rng, jcfg)
    key = jax.random.PRNGKey(7 + batch_no)
    draws = jax_step_draws(key, jcfg, b1[0].shape)
    jgrads, jmetrics, jfake, _ = jax_step_with_grads(jcfg, jstate.params)(jstate, b1, b2, key, jnp.int32(batch_no))
    tb1, tb2 = (t(b1[0]), t(b1[1])), (t(b2[0]), t(b2[1]))
    grads, aux = tstep.compute_grads(state, tb1, tb2, draws, batch_no, tc)
    for k in tstep.LOSS_KEYS:
        np.testing.assert_allclose(float(aux[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    for k, want in _flatten(jgrads).items():
        np.testing.assert_allclose(grads[k.replace("/", ".")].numpy(), np.asarray(want), **GRAD_TOL, err_msg=k)
    np.testing.assert_allclose(aux["fake"].numpy(), np.asarray(jfake), rtol=1e-4, atol=1e-5)
