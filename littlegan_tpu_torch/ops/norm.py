"""Instance normalization with the reference's ``axis=None`` semantics.

The port's copy of littlegan_tpu/ops/norm.py: each sample is normalised
over ALL its non-batch axes, with scalar gamma/beta of shape ``(1,)``, eps
added to the population STD (not the variance), and stats in f32 whatever
the activation dtype. The default computes the variance in one pass
(E[x^2] - mean^2, clamped at 0); ``two_pass=True`` takes the mean of
squared deviations instead.

:func:`channel_instance_norm` and :func:`adain` normalise per (sample,
channel) instead, with ``torch.nn.InstanceNorm2d``'s arithmetic (eps 1e-5
added to the biased variance) and an affine that may differ per sample, as
AdaIN's does: one ``batch_norm`` over the (1, B*C, H, W) view of an NCHW
tensor, as ``torch.instance_norm`` itself does. The program no longer runs
them: StarGAN v2's norms go through ``ops/cuda/channel_norm_lrelu.py`` over
channels-last maps, and these serve only as the tests' and the card
smoke's PyTorch reference for it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def instance_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-3,
    two_pass: bool = False,
) -> torch.Tensor:
    red = tuple(range(1, x.ndim))
    xf = x.float()
    mean = xf.mean(red, keepdim=True)
    if two_pass:
        var = (xf - mean).square().mean(red, keepdim=True)
    else:
        var = (xf.square().mean(red, keepdim=True) - mean.square()).clamp_min(0.0)
    normed = (xf - mean) / (var.sqrt() + eps)
    return (normed * gamma.float() + beta.float()).to(x.dtype)


def instance_norm_from_stats(
    x: torch.Tensor,
    s1: torch.Tensor,
    s2: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-3,
) -> torch.Tensor:
    """One-pass ``instance_norm`` from the per-sample sum ``s1`` and sum of
    squares ``s2`` (shape ``(N,)``) that a fused conv epilogue hands over."""
    m = 1.0
    for d in x.shape[1:]:
        m *= d
    shape = (-1,) + (1,) * (x.ndim - 1)
    mean = (s1.float() / m).reshape(shape)
    var = ((s2.float() / m).reshape(shape) - mean.square()).clamp_min(0.0)
    normed = (x.float() - mean) / (var.sqrt() + eps)
    return (normed * gamma.float() + beta.float()).to(x.dtype)


def channel_instance_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
                          eps: float = 1e-5) -> torch.Tensor:
    """Instance norm of an NCHW ``x`` over H and W per (sample, channel),
    then ``scale * x + shift``: each (C,) (shared by the samples) or (B, C)
    (one per sample), or None (1 and 0)."""
    b, c = x.shape[:2]
    flat = lambda t: None if t is None else t.expand(b, c).reshape(b * c).to(x.dtype)  # noqa: E731
    y = F.batch_norm(x.reshape(1, b * c, *x.shape[2:]), None, None, flat(scale), flat(shift), True, 0.0, eps)
    return y.view_as(x)


def adain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """AdaIN: ``(1 + gamma) * IN(x) + beta``, gamma and beta (B, C) from the style."""
    return channel_instance_norm(x, 1.0 + gamma, beta, eps)
