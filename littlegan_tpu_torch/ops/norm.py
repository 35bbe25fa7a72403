"""Instance normalization with the reference's ``axis=None`` semantics.

The port's copy of littlegan_tpu/ops/norm.py: each sample is normalised
over ALL its non-batch axes, with scalar gamma/beta of shape ``(1,)``, eps
added to the population STD (not the variance), and stats in f32 whatever
the activation dtype. The default computes the variance in one pass
(E[x^2] - mean^2, clamped at 0); ``two_pass=True`` takes the mean of
squared deviations instead.
"""

from __future__ import annotations

import torch


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

