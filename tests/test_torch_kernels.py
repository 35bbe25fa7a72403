"""The port's CUDA kernels' plain versions against the JAX package's Pallas kernels.

On a CPU tensor each wrapper runs its plain PyTorch version; the Pallas
kernels run in interpret mode, as tests/test_pallas.py runs them. The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``. Tolerances, f32: y 1e-5; stats rtol 1e-4."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from littlegan_tpu.ops.conv import leaky_relu as jleaky_relu
from littlegan_tpu.ops.norm import instance_norm_from_stats as jnorm_from_stats
from littlegan_tpu.ops.pallas import boundary_conv as jbc
from littlegan_tpu.ops.pallas.norm_lrelu import fused_instance_norm_lrelu as jfused
from littlegan_tpu_torch.ops.cuda import boundary_conv as tbc
from littlegan_tpu_torch.ops.cuda import norm_lrelu as tnl

Y_TOL = dict(rtol=1e-5, atol=1e-5)


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
    for fn in (tnl.fused_instance_norm_lrelu, tnl.norm_lrelu_from_stats, tbc.conv3x3_same_stats):
        before = fn.launches.value
        fn.launches.add()
        assert fn.launches.value == before + 1
        fn.launches.reset()
        assert fn.launches.value == 0
    # the plain version on a CPU tensor launches nothing
    x = torch.zeros(2, 4, 4, 8)
    tnl.fused_instance_norm_lrelu(x, torch.ones(1), torch.zeros(1))
    assert tnl.fused_instance_norm_lrelu.launches.value == 0
