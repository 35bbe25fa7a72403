"""Kernel Inception Distance (Binkowski et al. 2018) — beyond-reference.
The port's numpy copy of littlegan_tpu/eval/kid.py.

KID is the unbiased alternative to FID (whose estimator is biased at small
sample counts): the squared MMD between real and generated Inception pool
features under the polynomial kernel ``k(x,y) = (x.y/d + 1)^3``, reported as
mean±std over random same-size subsets (the convention of the original
implementation and torchmetrics). Uses the SAME 2048-d features the FID
path computes; unlike FID it needs RAW real features, not just (mu, sigma) —
``precalculate(..., save_features=N)`` embeds them in the stats npz.

Same honesty gating as FID/IS: random-init Inception values are
self-consistent trend numbers only, and every label says so.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def polynomial_kernel(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(n, d) x (m, d) -> (n, m) with k(a,b) = (a.b/d + 1)^3 (KID kernel)."""
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def mmd2_unbiased(x: np.ndarray, y: np.ndarray) -> float:
    """Unbiased squared MMD for EQUAL-size samples (Gretton et al. lemma 6)."""
    m = x.shape[0]
    if y.shape[0] != m or m < 2:
        raise ValueError(f"need two same-size samples of >=2 rows, got {x.shape[0]}/{y.shape[0]}")
    kxx = polynomial_kernel(x, x)
    kyy = polynomial_kernel(y, y)
    kxy = polynomial_kernel(x, y)
    sum_off = lambda k: (k.sum() - np.trace(k)) / (m * (m - 1))
    return float(sum_off(kxx) + sum_off(kyy) - 2.0 * kxy.mean())


def kid(
    feats_real: np.ndarray,
    feats_gen: np.ndarray,
    subset_size: int = 1000,
    n_subsets: int = 100,
    seed: int = 0,
) -> Tuple[float, float]:
    """(mean, std) of unbiased MMD² over ``n_subsets`` random subsets.

    ``subset_size`` caps at the smaller sample (tiny smoke/e2e sets); with
    everything in one subset there is no sampling variance, so one exact
    subset is used.
    """
    feats_real = np.asarray(feats_real, np.float64)
    feats_gen = np.asarray(feats_gen, np.float64)
    m = min(subset_size, feats_real.shape[0], feats_gen.shape[0])
    if m < 2:
        raise ValueError(
            f"KID needs >=2 features per side, got {feats_real.shape[0]} real / "
            f"{feats_gen.shape[0]} generated"
        )
    if m == feats_real.shape[0] and m == feats_gen.shape[0]:
        return mmd2_unbiased(feats_real, feats_gen), 0.0
    rng = np.random.default_rng(seed)
    vals = [
        mmd2_unbiased(
            feats_real[rng.choice(feats_real.shape[0], m, replace=False)],
            feats_gen[rng.choice(feats_gen.shape[0], m, replace=False)],
        )
        for _ in range(n_subsets)
    ]
    return float(np.mean(vals)), float(np.std(vals))
