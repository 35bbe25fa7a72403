"""The port's CUDA kernels' plain versions against the JAX package's Pallas kernels.

On a CPU tensor each wrapper runs its plain PyTorch version; the Pallas
kernels run in interpret mode, as tests/test_pallas.py runs them. The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``. Tolerances, f32: y 1e-5; stats rtol 1e-4; the norm
backwards rtol 2e-4 / atol 2e-5 and the boundary conv's rtol 1e-4 / atol
1e-5, as tests/test_pallas.py:42 and :138 hold the Pallas kernels."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from littlegan_tpu.ops.conv import leaky_relu as jleaky_relu
from littlegan_tpu.ops.norm import instance_norm_from_stats as jnorm_from_stats
from littlegan_tpu.ops.pallas import boundary_conv as jbc
from littlegan_tpu.ops.pallas import norm_lrelu as jnl
from littlegan_tpu.ops.pallas.norm_lrelu import fused_instance_norm_lrelu as jfused
from littlegan_tpu_torch.ops.cuda import boundary_conv as tbc
from littlegan_tpu_torch.ops.cuda import norm_lrelu as tnl

Y_TOL = dict(rtol=1e-5, atol=1e-5)
NORM_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
CONV_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _gb():
    return np.array([1.3], np.float32), np.array([-0.2], np.float32)


@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (3, 8, 8, 3), (2, 16, 16, 16)])
def test_fused_norm_lrelu_matches_pallas(shape):
    x = (np.random.default_rng(sum(shape)).normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    g, b = _gb()
    want = jfused(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 0.3)
    got = tnl.fused_instance_norm_lrelu(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **Y_TOL)


def test_fused_norm_lrelu_bf16_keeps_dtype():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 4, 4, 8)).astype(np.float32))
    g, b = (torch.from_numpy(a) for a in _gb())
    out = tnl.fused_instance_norm_lrelu(x.bfloat16(), g, b, 0.3)
    assert out.dtype == torch.bfloat16
    want = tnl.fused_instance_norm_lrelu(x.bfloat16().float(), g, b, 0.3)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=2e-2, atol=2e-2)


def test_norm_lrelu_from_stats_matches_jax():
    y = (np.random.default_rng(2).normal(size=(3, 8, 8, 16)) + 0.3).astype(np.float32)
    s1, s2 = y.sum((1, 2, 3)), (y * y).sum((1, 2, 3))
    g, b = _gb()
    want = jleaky_relu(jnorm_from_stats(*(jnp.asarray(a) for a in (y, s1, s2, g, b))), 0.3)
    got = tnl.norm_lrelu_from_stats(*(torch.from_numpy(a) for a in (y, s1, s2, g, b)), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **Y_TOL)


@pytest.mark.parametrize("shape,cout", [((3, 16, 16, 12), 24), ((2, 8, 8, 12), 64), ((2, 8, 16, 16), 8)])
def test_conv3x3_same_stats_matches_pallas(shape, cout):
    rng = np.random.default_rng(shape[0] + cout)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, shape[3], cout)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    jy, js1, js2 = jbc.conv3x3_same_stats(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    y, s1, s2 = tbc.conv3x3_same_stats(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **Y_TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), rtol=1e-4, atol=1e-4 * float(np.abs(jy).sum()) / shape[0])
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=1e-4)
    assert s1.dtype == s2.dtype == torch.float32


def test_conv3x3_same_stats_bf16_stats_come_from_f32():
    """In bf16 y is cast last; the stats are the f32 sums before the cast."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 12)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.normal(size=(3, 3, 12, 16)) * 0.2).astype(np.float32)).bfloat16()
    b = torch.from_numpy((rng.normal(size=(16,)) * 0.1).astype(np.float32))
    y, s1, s2 = tbc.conv3x3_same_stats(x, w, b)
    y32, t1, t2 = tbc.conv3x3_same_stats(x.float(), w.float(), b.bfloat16().float())
    assert y.dtype == torch.bfloat16 and s1.dtype == torch.float32
    np.testing.assert_array_equal(y.float().numpy(), y32.bfloat16().float().numpy())
    np.testing.assert_allclose(s1.numpy(), t1.numpy(), rtol=1e-6)
    np.testing.assert_allclose(s2.numpy(), t2.numpy(), rtol=1e-6)


@pytest.mark.parametrize(
    "shape", [(8, 64, 64, 12), (8, 64, 64, 16), (8, 64, 60, 12), (8, 64, 64, 17), (4, 8, 8, 3)]
)
def test_boundary_supports_matches_jax_predicate(shape):
    """The JAX predicate minus its TPU memory clause, which these shapes pass."""
    assert tbc.supports(shape) == jbc.supports(shape)


@pytest.mark.parametrize("n", [1, 3, 8, 32])
@pytest.mark.parametrize("m", [8, 24, 100, 24576, 65536, 524288, 3 * 5 * 7 * 11])
def test_norm_chunking_covers_each_sample(n, m):
    chunk, chunks = tnl.chunking(n, m, sms=132)
    assert chunk % 8 == 0 and chunk > 0
    assert (chunks - 1) * chunk < m <= chunks * chunk
    assert chunks <= max(1, math.ceil(m / 2048))


@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (3, 8, 8, 3), (2, 16, 16, 16)])
def test_fused_norm_lrelu_grads_match_pallas(shape):
    """FusedNormLReLU's backward (K2's plain version on the CPU) against
    jax.grad through the Pallas custom VJP (``_bwd_kernel``, interpret mode)."""
    rng = np.random.default_rng(sum(shape) + 7)
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    gout = rng.normal(size=shape).astype(np.float32)
    g, b = _gb()

    def f(x, g, b):
        return jnp.sum(jfused(x, g, b, 0.3) * gout)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    xt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    (tnl.FusedNormLReLU.apply(xt, gt, bt, 0.3) * torch.from_numpy(gout)).sum().backward()
    for got, w in zip((xt.grad, gt.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **NORM_GRAD_TOL)
    dx, dg, db = tnl.fused_instance_norm_lrelu_bwd(torch.from_numpy(x), torch.from_numpy(gout), *(
        torch.from_numpy(a) for a in (g, b)), 0.3)
    assert dx.dtype == torch.float32 and dg.shape == db.shape == (1,)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), **NORM_GRAD_TOL)


def _paired_sample(rng, shape, offset):
    """offset + d per sample, d on a 1/4 grid with every value paired with
    its negation: any order of f32 summation gives sum(x) = M*offset and
    sum((x - mean)^2) exactly, so two-pass moments are exact in both
    packages, while sum(x^2) (the one-pass variance) rounds at offset 30."""
    n, m = shape[0], math.prod(shape[1:])
    d = np.round(rng.normal(size=(n, m // 2)) * 4) / 4
    d = rng.permuted(np.concatenate([d, -d], axis=1), axis=1)
    return (offset + d).reshape(shape).astype(np.float32)


@pytest.mark.parametrize("shape,offset", [
    ((2, 8, 8, 384), 30.0), ((2, 16, 16, 256), 30.0), ((2, 32, 32, 128), 30.0), ((2, 64, 64, 64), 0.5),
])
def test_fused_norm_lrelu_takes_the_pallas_moments(shape, offset):
    """FusedNormLReLU (forward and backward, plain versions on the CPU)
    against the Pallas op in interpret mode and jax.grad through its custom
    VJP, at a mean large against the std: two-pass moments where the Pallas
    op holds the sample whole (the first three shapes), one-pass where it
    chunks it. dx leaves out the elements within 1e-5 of LeakyReLU's kink."""
    rng = np.random.default_rng(sum(shape))
    x = _paired_sample(rng, shape, offset)
    gout = rng.normal(size=shape).astype(np.float32)
    g, b = _gb()
    assert tnl.holds_whole_sample(shape) == (offset == 30.0)

    def f(x, g, b):
        y = jfused(x, g, b, 0.3)
        return jnp.sum(y * gout), y

    (_, want_y), want = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    xt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    y = tnl.FusedNormLReLU.apply(xt, gt, bt, 0.3)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **Y_TOL)
    (y * torch.from_numpy(gout)).sum().backward()
    x64 = x.astype(np.float64).reshape(shape[0], -1)
    mean, std = x64.mean(1, keepdims=True), x64.std(1, keepdims=True)
    away = (np.abs((x64 - mean) / (std + 1e-3) * g[0] + b[0]) > 1e-5).reshape(shape)
    np.testing.assert_allclose(xt.grad.numpy()[away], np.asarray(want[0])[away], **NORM_GRAD_TOL)
    for name, got, w in (("dgamma", gt.grad, want[1]), ("dbeta", bt.grad, want[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **NORM_GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("shape", [
    (8, 8, 8, 384), (8, 16, 16, 256), (8, 32, 32, 128), (8, 64, 64, 64), (8, 64, 64, 128),
    (2, 128, 128, 32), (2, 12, 12, 2048), (2, 60, 60, 64), (3, 8, 8, 3),
])
def test_whole_sample_rule_is_the_pallas_ops(shape):
    """The port's copy of ``_pick_chunk``'s rule: whole (two-pass moments)
    at 512 KiB of f32 or less, or where the rows do not split by 8."""
    assert tnl.holds_whole_sample(shape) == (jnl._pick_chunk(*shape[1:]) is None)


def test_backward_reads_the_forwards_moments():
    """The forward hands the backward its (2, N) f32 (mean, std); the
    backward given them equals the one that takes them afresh, and refuses
    stats of another shape."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.normal(size=(3, 8, 8, 16)) * 2.0 + 5.0).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    g, b = (torch.from_numpy(a) for a in _gb())
    y, stats = tnl._fused_forward(x, g, b, 0.3, 1e-3)
    assert stats.shape == (2, 3) and stats.dtype == torch.float32
    torch.testing.assert_close(stats, tnl.instance_norm_moments_plain(x), rtol=0, atol=0)
    torch.testing.assert_close(y, tnl.fused_instance_norm_lrelu_plain(x, g, b, 0.3), rtol=0, atol=0)
    with_stats = tnl.fused_instance_norm_lrelu_bwd(x, dy, g, b, 0.3, 1e-3, stats)
    for got, want in zip(with_stats, tnl.fused_instance_norm_lrelu_bwd(x, dy, g, b, 0.3)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"\(2, 3\)"):
        tnl.fused_instance_norm_lrelu_bwd(x, dy, g, b, 0.3, 1e-3, stats[:, :2].contiguous())


def test_norm_lrelu_from_stats_grads_match_jax():
    """The K1' backward against jax.grad of instance_norm_from_stats +
    leaky_relu with respect to y, s1, s2, gamma and beta (XLA in JAX)."""
    rng = np.random.default_rng(5)
    y = (rng.normal(size=(3, 8, 8, 16)) * 1.5 + 0.3).astype(np.float32)
    s1, s2 = y.sum((1, 2, 3)), (y * y).sum((1, 2, 3))
    gout = rng.normal(size=y.shape).astype(np.float32)
    g, b = _gb()

    def f(y, s1, s2, g, b):
        return jnp.sum(jleaky_relu(jnorm_from_stats(y, s1, s2, g, b), 0.3) * gout)

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (y, s1, s2, g, b)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (y, s1, s2, g, b)]
    (tnl.NormLReLUFromStats.apply(*ins, 0.3) * torch.from_numpy(gout)).sum().backward()
    for name, t, w in zip(("y", "s1", "s2", "gamma", "beta"), ins, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=2e-4, atol=2e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)


def _boundary_inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 8, 8, 12)).astype(dtype)
    w = (rng.normal(size=(3, 3, 12, 16)) * 0.3).astype(dtype)
    b = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
    gout = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    return x, w, b, gout


def test_boundary_conv_grads_match_jax():
    """BoundaryConvS2D's (x, w, b) grads, stats cotangents included, against
    the JAX custom VJP ``boundary_conv_s2d`` (tests/test_pallas.py:110)."""
    x, w, b, gout = _boundary_inputs(1)

    def f(x, w, b):
        y, s1, s2 = jbc.boundary_conv_s2d(x, w, b, True)
        return jnp.sum(y * gout) + jnp.sum(s1 * 0.7) + jnp.sum(s2 * 0.01)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y, s1, s2 = tbc.BoundaryConvS2D.apply(*ins)
    ((y * torch.from_numpy(gout)).sum() + (s1 * 0.7).sum() + (s2 * 0.01).sum()).backward()
    for name, t, wv in zip(("x", "w", "b"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wv), **CONV_GRAD_TOL, err_msg=name)


def test_boundary_conv_bf16_bias_grad_keeps_its_dtype():
    """Under bf16 compute x and w arrive bf16 and the bias f32: the bias
    cotangent stays f32 (tests/test_pallas.py:194-214), dx and dw bf16, and
    the fold and sums run in f32 from the cast y."""
    x, w, b, gout = _boundary_inputs(2)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).bfloat16().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y, s1, s2 = tbc.BoundaryConvS2D.apply(xt, wt, bt)
    ((y.float() * torch.from_numpy(gout)).sum() + (s2 * 0.01).sum()).backward()
    assert xt.grad.dtype == wt.grad.dtype == torch.bfloat16 and bt.grad.dtype == torch.float32
    # y's cotangent reaches the Function in y's dtype (bf16), then folds in f32
    gy = torch.from_numpy(gout).bfloat16().float() + 0.02 * y.detach().float()
    np.testing.assert_allclose(bt.grad.numpy(), gy.sum((0, 1, 2)).numpy(), rtol=1e-5, atol=1e-4)


def test_conv3x3_bwd_fold_plain_matches_jax_fold():
    rng = np.random.default_rng(4)
    y = rng.normal(size=(3, 4, 4, 8)).astype(np.float32)
    gy = rng.normal(size=y.shape).astype(np.float32)
    gs1, gs2 = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    want = gy + gs1[:, None, None, None] + 2.0 * y * gs2[:, None, None, None]
    got, db = tbc.conv3x3_bwd_fold(*(torch.from_numpy(a) for a in (y, gy, gs1, gs2)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(db.numpy(), want.sum((0, 1, 2)), rtol=1e-5, atol=1e-5)


def _meta_wrapper_calls(x, one, n):
    sums = (torch.zeros(n, device="meta"), torch.zeros(n, device="meta"))
    w, b = torch.zeros(3, 3, 12, 64, device="meta"), torch.zeros(64, device="meta")
    return {
        "fused_instance_norm_lrelu": lambda: tnl.fused_instance_norm_lrelu(x, one, one),
        "fused_instance_norm_lrelu_bwd": lambda: tnl.fused_instance_norm_lrelu_bwd(x, x, one, one),
        "norm_lrelu_from_stats": lambda: tnl.norm_lrelu_from_stats(x, *sums, one, one),
        "norm_lrelu_from_stats_bwd": lambda: tnl.norm_lrelu_from_stats_bwd(x, *sums, one, one, x),
        "conv3x3_same_stats": lambda: tbc.conv3x3_same_stats(x, w, b),
        "conv3x3_bwd_fold": lambda: tbc.conv3x3_bwd_fold(x, x, *sums),
    }


@pytest.mark.parametrize(
    "wrapper",
    ["fused_instance_norm_lrelu", "fused_instance_norm_lrelu_bwd", "norm_lrelu_from_stats",
     "norm_lrelu_from_stats_bwd", "conv3x3_same_stats", "conv3x3_bwd_fold"],
)
def test_raw_wrappers_refuse_a_gradient_outside_their_function(wrapper):
    """On a non-CPU tensor that requires grad, with grad mode on, a raw
    wrapper raises rather than hand back a result detached from autograd;
    under no_grad it goes on to its device checks."""
    x = torch.zeros(2, 8, 8, 12, device="meta", requires_grad=True)
    one = torch.ones(1, device="meta")
    with pytest.raises(RuntimeError, match="detached from autograd"):
        _meta_wrapper_calls(x, one, 2)[wrapper]()
    with torch.no_grad(), pytest.raises(ValueError):
        _meta_wrapper_calls(x, one, 2)[wrapper]()


def test_wrappers_raise_on_other_devices():
    """A tensor on neither the CPU nor a CUDA card gets an error, never the
    plain version: only a CPU tensor takes it."""
    x = torch.zeros(2, 8, 8, 12, device="meta")
    one = torch.ones(1, device="meta")
    with pytest.raises(ValueError):
        tnl.fused_instance_norm_lrelu(x, one, one)
    with pytest.raises(ValueError):
        tnl.norm_lrelu_from_stats(x, torch.zeros(2, device="meta"), torch.zeros(2, device="meta"), one, one)
    with pytest.raises(ValueError):
        tbc.conv3x3_same_stats(x, torch.zeros(3, 3, 12, 64, device="meta"), torch.zeros(64, device="meta"))


def test_launch_counters_start_at_zero_and_reset():
    for fn in (tnl.fused_instance_norm_lrelu, tnl.norm_lrelu_from_stats, tbc.conv3x3_same_stats,
               tnl.fused_instance_norm_lrelu_bwd, tnl.norm_lrelu_from_stats_bwd, tbc.conv3x3_bwd_fold):
        before = fn.launches.value
        fn.launches.add()
        assert fn.launches.value == before + 1
        fn.launches.reset()
        assert fn.launches.value == 0
    # the plain version on a CPU tensor launches nothing
    x = torch.zeros(2, 4, 4, 8)
    tnl.fused_instance_norm_lrelu(x, torch.ones(1), torch.zeros(1))
    assert tnl.fused_instance_norm_lrelu.launches.value == 0
