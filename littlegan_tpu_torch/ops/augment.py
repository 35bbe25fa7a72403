"""Data augmentation of the real images, the port of littlegan_tpu/ops/augment.py.

The reference's chain (random horizontal flip, brightness, contrast, hue,
additive gaussian noise) on NHWC images in [-1, 1], run on the device
inside the train step. The random draws are ARGUMENTS (:class:`AugmentDraws`),
so that a test can feed the JAX package's draws; :func:`draw_augment` draws
them from a ``torch.Generator`` with the JAX package's distributions:

- the flip is per image, p = 0.5;
- brightness delta ~ U(-0.02, 0.02), contrast factor ~ U(0.75, 1.003) and
  hue delta ~ U(-0.03, 0.03), one scalar each for the whole batch;
- noise ~ N(0, 1) in the raw image shape, added as ``0.1 * 0.2 * noise``.

Under a spatial mesh each rank holds its H-slice of the batch: the
contrast's per-image mean over (H, W) is then the sum over the model
ranks (``hw_mean``, ``parallel/spatial.py::Spatial.hw_mean``); the flip is
along W and every other op is per pixel.

``adjust_hue`` is TF's chroma kernel (hue from ``v - m``, rebuilt as
``chroma * ramp + m``), defined on any value range, with its tie order:
``v == r`` first, then ``v == g``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from littlegan_tpu_torch.ops.s2d import depth_to_space, space_to_depth


class AugmentDraws(NamedTuple):
    flip: torch.Tensor  # (N,) bool
    delta_b: torch.Tensor  # () f32
    factor: torch.Tensor  # () f32
    delta_h: torch.Tensor  # () f32
    noise: torch.Tensor  # (N, H, W, C) f32, raw image shape


def draw_augment(generator: torch.Generator, n: int, raw_shape: Sequence[int], device) -> AugmentDraws:
    """One batch's draws from ``generator`` (which lives on ``device``)."""
    u = lambda lo, hi: torch.rand((), generator=generator, device=device) * (hi - lo) + lo  # noqa: E731
    flip = torch.rand((n,), generator=generator, device=device) < 0.5
    delta_b, factor, delta_h = u(-0.02, 0.02), u(0.75, 1.003), u(-0.03, 0.03)
    noise = torch.randn(tuple(raw_shape), generator=generator, device=device)
    return AugmentDraws(flip, delta_b, factor, delta_h, noise)


def _select(i: torch.Tensor, choices, default: torch.Tensor) -> torch.Tensor:
    """``jnp.select([i == 0, ..., i == 4], choices, default)``: first match."""
    out = default
    for k in reversed(range(len(choices))):
        out = torch.where(i == k, choices[k], out)
    return out


def adjust_hue(x: torch.Tensor, delta) -> torch.Tensor:
    """Rotate hue by ``delta`` turns, TF's adjust_hue kernel math, on the
    trailing RGB axis; never divides by v."""
    xf = x.float()
    r, g, b = xf[..., 0], xf[..., 1], xf[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    m = torch.minimum(torch.minimum(r, g), b)
    c = v - m
    norm = 1.0 / (6.0 * torch.where(c != 0, c, torch.ones_like(c)))
    h = torch.where(
        v == r,
        norm * (g - b),
        torch.where(v == g, norm * (b - r) + 2.0 / 6.0, norm * (r - g) + 4.0 / 6.0),
    )
    h = torch.where(c == 0, torch.zeros_like(h), h)
    h = torch.where(h < 0, h + 1.0, h)
    h = torch.remainder(h + delta, 1.0)
    dh = h * 6.0
    x1 = c * (1.0 - (torch.remainder(dh, 2.0) - 1.0).abs())
    i = torch.floor(dh).to(torch.int32) % 6
    zero = torch.zeros_like(c)
    rr = _select(i, [c, x1, zero, zero, x1], c)
    gg = _select(i, [x1, c, c, x1, zero], zero)
    bb = _select(i, [zero, zero, x1, c, c], x1)
    return torch.stack([rr + m, gg + m, bb + m], dim=-1).to(x.dtype)


def adjust_brightness(x: torch.Tensor, delta) -> torch.Tensor:
    """tf.image.adjust_brightness: additive."""
    return x + delta


def adjust_contrast(x: torch.Tensor, factor, hw_mean=None) -> torch.Tensor:
    """tf.image.adjust_contrast: toward each image's per-channel mean over
    (H, W), or ``hw_mean(x)``'s."""
    mean = x.mean((1, 2), keepdim=True) if hw_mean is None else hw_mean(x)
    return (x - mean) * factor + mean


def augment(x: torch.Tensor, draws: AugmentDraws, hw_mean=None) -> torch.Tensor:
    """The full chain on an NHWC [-1, 1] batch; result in x's dtype."""
    dtype = x.dtype
    x = x.float()
    x = torch.where(draws.flip[:, None, None, None], x.flip(2), x)
    x = adjust_brightness(x, draws.delta_b)
    x = adjust_contrast(x, draws.factor, hw_mean)
    x = adjust_hue(x, draws.delta_h)
    return (x + 0.1 * (0.2 * draws.noise)).to(dtype)


def augment_s2d(x: torch.Tensor, draws: AugmentDraws, hw_mean=None) -> torch.Tensor:
    """:func:`augment` on a space-to-depth batch [N, H/2, W/2, 4C]: the same
    math and draws (the noise is drawn in raw shape and rearranged), so a
    raw pixel gets the same value in either layout, bit for bit."""
    n, h, w, c4 = x.shape
    c = c4 // 4
    dtype = x.dtype
    v = x.float().reshape(n, h, w, 2, 2, c)  # (N, hb, wb, pi, pj, c)
    # a raw-space flip of W reverses the column blocks and swaps the column phases
    v = torch.where(draws.flip.reshape(n, 1, 1, 1, 1, 1), v.flip((2, 4)), v)
    v = v + draws.delta_b
    # the mean over a raw-layout copy: the raw path's sum, in its order
    raw = depth_to_space(v.reshape(n, h, w, c4))
    mean = (raw.mean((1, 2)) if hw_mean is None else hw_mean(raw)).reshape(n, 1, 1, 1, 1, c)
    v = (v - mean) * draws.factor + mean
    v = adjust_hue(v, draws.delta_h)
    return (v.reshape(n, h, w, c4) + 0.1 * (0.2 * space_to_depth(draws.noise))).to(dtype)
