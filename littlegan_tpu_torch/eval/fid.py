"""FID: activation statistics and the Fréchet distance, the port of
littlegan_tpu/eval/fid.py.

- ``activation_statistics``: the features' mean and covariance (numpy);
- ``frechet_distance``: d^2 = |mu1-mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))
  with scipy's ``sqrtm`` on the host and the reference's fallbacks (on a
  singular product add ``eps`` to the diagonals and retry; drop a
  negligible imaginary part, refuse a large one);
- ``frechet_distance_newton_schulz``: the same distance with trace(sqrtm)
  by a Newton–Schulz iteration of float32 ``torch.matmul``s on the card
  (no TF32), the JAX package's on-device variant.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from littlegan_tpu_torch.eval.inception import exact_float32
from littlegan_tpu_torch.utils.device import resolve_device


def activation_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu (D,), sigma (D, D)), float64."""
    feats = np.asarray(features, np.float64)
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray, eps: float = 1e-6
) -> float:
    """Host-side Fréchet distance, scipy ``sqrtm`` with the fallbacks."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"mismatched statistics: {mu1.shape}/{mu2.shape}, {sigma1.shape}/{sigma2.shape}")
    diff = mu1 - mu2
    try:
        with warnings.catch_warnings():
            # a singular product is handled by the eps-offset retry below
            warnings.simplefilter("ignore")
            covmean = linalg.sqrtm(sigma1.dot(sigma2))
    except Exception:  # scipy signals a failed sqrtm by raising in some versions
        covmean = np.full_like(sigma1, np.nan)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def _trace_sqrtm_ns(a: torch.Tensor, num_iters: int = 30) -> torch.Tensor:
    """trace(sqrtm(a)) by the coupled Newton–Schulz iteration: matmuls only."""
    norm = torch.sqrt(torch.sum(a * a))
    y = a / norm
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    z = eye
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return torch.trace(y) * torch.sqrt(norm)


def frechet_distance_newton_schulz(mu1, sigma1, mu2, sigma2, device=None) -> float:
    """The Fréchet distance in float32 on ``device`` (default: the card;
    raises without one), about 1e-4 relative to :func:`frechet_distance` on
    well-conditioned covariances.

    sigma1 @ sigma2 is similar to the SPD matrix sqrt(S1) S2 sqrt(S1), so
    its eigenvalues are real and non-negative and Newton–Schulz converges on
    it directly."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    mu1, sigma1, mu2, sigma2 = t(mu1), t(sigma1), t(mu2), t(sigma2)
    with torch.inference_mode(), exact_float32():
        diff = mu1 - mu2
        d = torch.sum(diff * diff) + torch.trace(sigma1) + torch.trace(sigma2) - 2.0 * _trace_sqrtm_ns(sigma1 @ sigma2)
        return float(d)
