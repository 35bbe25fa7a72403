"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

The same inputs, drawn with numpy from a seed, go through each
``littlegan_tpu`` op and its ``littlegan_tpu_torch`` counterpart in f32.
Tolerance: rtol 1e-5 / atol 1e-5 (f32 sums in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from littlegan_tpu.ops import conv as jconv
from littlegan_tpu.ops import norm as jnorm
from littlegan_tpu.ops import s2d as js2d
from littlegan_tpu.utils import image as jimage
from littlegan_tpu_torch.ops import conv as tconv
from littlegan_tpu_torch.ops import norm as tnorm
from littlegan_tpu_torch.ops import s2d as ts2d
from littlegan_tpu_torch.utils import image as timage

TOL = dict(rtol=1e-5, atol=1e-5)


def _draw(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _check(got: torch.Tensor, want, **tol):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize(
    "stride,k,hw,cin,cout",
    [(1, 5, 8, 3, 4), (2, 5, 8, 3, 4), (2, 5, 7, 4, 6), (1, 3, 8, 12, 8), (2, 5, 16, 8, 12)],
)
def test_conv2d_matches_jax(stride, k, hw, cin, cout):
    rng = np.random.default_rng(stride * 100 + k * 10 + hw)
    x, w, b = _draw(rng, 2, hw, hw, cin), _draw(rng, k, k, cin, cout, scale=0.2), _draw(rng, cout)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride)
    _check(tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride=stride), want)


@pytest.mark.parametrize("stride,hw", [(1, 4), (2, 4), (2, 5), (1, 8)])
def test_deconv2d_matches_jax(stride, hw):
    rng = np.random.default_rng(stride * 10 + hw)
    x, w, b = _draw(rng, 2, hw, hw, 6), _draw(rng, 5, 5, 3, 6, scale=0.2), _draw(rng, 3)
    want = jconv.deconv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride)
    _check(tconv.deconv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride=stride), want)


def test_conv2d_without_bias_matches_jax():
    rng = np.random.default_rng(3)
    x, w = _draw(rng, 1, 6, 6, 2), _draw(rng, 5, 5, 2, 3)
    _check(tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w)), jconv.conv2d(jnp.asarray(x), jnp.asarray(w)))


def test_dense_and_leaky_relu_match_jax():
    rng = np.random.default_rng(4)
    x, w, b = _draw(rng, 5, 20), _draw(rng, 20, 9), _draw(rng, 9)
    want = jconv.leaky_relu(jconv.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), 0.3)
    got = tconv.leaky_relu(tconv.dense(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)), 0.3)
    _check(got, want)


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("shape", [(3, 4, 4, 8), (2, 1, 1, 24), (4, 30)])
def test_instance_norm_matches_jax(two_pass, shape):
    rng = np.random.default_rng(len(shape) + int(two_pass))
    x = _draw(rng, *shape, scale=2.0) + 0.5
    g, b = np.array([1.3], np.float32), np.array([-0.2], np.float32)
    want = jnorm.instance_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), two_pass=two_pass)
    got = tnorm.instance_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), two_pass=two_pass)
    _check(got, want)


def test_instance_norm_from_stats_matches_jax():
    rng = np.random.default_rng(5)
    x = _draw(rng, 3, 4, 4, 8) + 0.3
    s1, s2 = x.sum((1, 2, 3)), (x * x).sum((1, 2, 3))
    g, b = np.array([0.8], np.float32), np.array([0.1], np.float32)
    want = jnorm.instance_norm_from_stats(*(jnp.asarray(a) for a in (x, s1, s2, g, b)))
    got = tnorm.instance_norm_from_stats(*(torch.from_numpy(a) for a in (x, s1, s2, g, b)))
    _check(got, want)


def test_space_to_depth_roundtrip_matches_jax():
    x = _draw(np.random.default_rng(6), 2, 8, 6, 3)
    want = js2d.space_to_depth(jnp.asarray(x))
    got = ts2d.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ts2d.depth_to_space(got).numpy(), x)


@pytest.mark.parametrize(
    "name,shape",
    [("s2d_conv1_kernel", (5, 5, 3, 4)), ("s2d_deconv_kernel", (5, 5, 4, 6)), ("s2d_outconv_kernel", (5, 5, 3, 4))],
)
def test_s2d_kernel_rearrangements_match_jax(name, shape):
    w = _draw(np.random.default_rng(7), *shape)
    want = getattr(js2d, name)(jnp.asarray(w))
    got = getattr(ts2d, name)(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["s2d_conv1_kernel", "s2d_deconv_kernel", "s2d_outconv_kernel"])
def test_s2d_kernels_train_after_a_first_use_under_inference_mode(name):
    """The rearrangements' index tensors are made once per device; made first
    under ``inference_mode`` (a served model), they must still serve a
    backward (the model trained next, in the same process)."""
    ts2d._INDEX_CACHE.clear()
    w = torch.from_numpy(_draw(np.random.default_rng(11), 5, 5, 3, 4)).requires_grad_()
    with torch.inference_mode():
        getattr(ts2d, name)(w.detach())
    getattr(ts2d, name)(w).square().sum().backward()
    assert w.grad is not None and bool(w.grad.abs().sum() > 0)


def test_s2d_kernels_reject_other_sizes():
    with pytest.raises(ValueError):
        ts2d.s2d_conv1_kernel(torch.zeros(3, 3, 3, 4))


def test_tile_bias_matches_jax():
    b = _draw(np.random.default_rng(8), 5)
    np.testing.assert_array_equal(ts2d.tile_bias(torch.from_numpy(b)).numpy(), np.asarray(js2d.tile_bias(jnp.asarray(b))))


def test_s2d_conv_equals_plain_conv():
    """The s2d rewrite is exact: a stride-2 5x5 SAME conv equals the 3x3
    block-space conv on the s2d input (same check as tests/test_s2d.py)."""
    rng = np.random.default_rng(9)
    x, w = torch.from_numpy(_draw(rng, 2, 8, 8, 3)), torch.from_numpy(_draw(rng, 5, 5, 3, 4))
    plain = tconv.conv2d(x, w, stride=2)
    block = tconv.conv2d(ts2d.space_to_depth(x), ts2d.s2d_conv1_kernel(w), stride=1)
    _check(block, plain.numpy())


def test_image_helpers_match_jax():
    u8 = np.random.default_rng(10).integers(0, 256, size=(2, 4, 4, 3), dtype=np.uint8)
    np.testing.assert_array_equal(timage.ensure_pm1(u8), jimage.ensure_pm1(u8))
    pm1 = timage.data_rescale(u8.astype(np.float32))
    np.testing.assert_array_equal(pm1, jimage.data_rescale(u8.astype(np.float32)))
    np.testing.assert_array_equal(timage.inverse_rescale(pm1), jimage.inverse_rescale(pm1))
    np.testing.assert_array_equal(timage.inverse_rescale(pm1).astype(np.uint8), u8)
    f = pm1.astype(np.float32)
    assert timage.ensure_pm1(f) is f
