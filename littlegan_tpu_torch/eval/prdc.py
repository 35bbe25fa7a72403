"""Improved Precision/Recall + Density/Coverage — beyond-reference.
The port's numpy copy of littlegan_tpu/eval/prdc.py.

FID collapses fidelity and diversity into one number; the k-NN manifold
metrics split them:

- **Precision / Recall** (Kynkaanniemi et al. 2019, "Improved Precision and
  Recall Metric for Assessing Generative Models"): precision = fraction of
  generated samples that land inside the real manifold (fidelity), recall =
  fraction of real samples inside the generated manifold (diversity). Each
  manifold is the union of hyperspheres around the sample set, with per-point
  radius = distance to the k-th nearest neighbour within the same set.
- **Density / Coverage** (Naeem et al. 2020, "Reliable Fidelity and Diversity
  Metrics for Generative Models"): density counts HOW MANY real spheres hold
  each generated sample (robust to real-set outliers, can exceed 1);
  coverage asks whether each real sphere captures at least one generated
  sample (immune to generated-set outliers, unlike recall).

All four come from the SAME 2048-d Inception pool features the FID/IS/KID
stack computes (reference fid.py:73-106 is the feature source there); like
KID they need RAW real features, so the stats npz must be written with
``precalculate(..., save_features=N)``. Same honesty gating as FID: with a
random-init Inception the numbers are self-consistent trend values only and
every label says so (eval/evaluate.py).

Semantics match the authors' released ``prdc`` package: the k-th neighbour
radius is computed over the full within-set distance matrix INCLUDING the
zero self-distance, with k+1 compensating for it; membership tests use
``<=`` against the candidate set's radii.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def pairwise_distances(x: np.ndarray, y: np.ndarray, chunk: int = 2048) -> np.ndarray:
    """(n, d) x (m, d) -> (n, m) Euclidean distances, row-chunked so the
    n*d intermediate of the expanded form never materializes for big n."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    y_sq = (y * y).sum(1)
    out = np.empty((x.shape[0], y.shape[0]), np.float64)
    for i in range(0, x.shape[0], chunk):
        xs = x[i : i + chunk]
        d2 = (xs * xs).sum(1)[:, None] + y_sq[None, :] - 2.0 * (xs @ y.T)
        np.maximum(d2, 0.0, out=d2)  # clamp the float-cancellation negatives
        out[i : i + chunk] = np.sqrt(d2)
    return out


def kth_neighbour_radii(feats: np.ndarray, k: int) -> np.ndarray:
    """Per-point radius: distance to the k-th nearest OTHER point of the set.

    Computed as the (k+1)-th smallest entry of the self-inclusive distance
    row (the zero self-distance fills one slot) — the prdc package's
    ``compute_nearest_neighbour_distances``.
    """
    n = feats.shape[0]
    if not 1 <= k < n:
        raise ValueError(f"need 1 <= k < n_samples, got k={k}, n={n}")
    d = pairwise_distances(feats, feats)
    return np.partition(d, k, axis=1)[:, k]


def prdc(
    feats_real: np.ndarray,
    feats_gen: np.ndarray,
    k: int = 5,
) -> Dict[str, float]:
    """{'precision', 'recall', 'density', 'coverage'} for two feature sets.

    ``k=5`` is both papers' recommended setting. Needs ``k < len`` of each
    set; tiny smoke runs should lower k rather than skip the check.
    """
    feats_real = np.asarray(feats_real, np.float64)
    feats_gen = np.asarray(feats_gen, np.float64)
    r_real = kth_neighbour_radii(feats_real, k)  # validates k vs set sizes
    r_gen = kth_neighbour_radii(feats_gen, k)
    d_rg = pairwise_distances(feats_real, feats_gen)  # (n_real, n_gen)

    # precision: generated point inside ANY real sphere
    precision = (d_rg <= r_real[:, None]).any(axis=0).mean()
    # recall: real point inside ANY generated sphere
    recall = (d_rg <= r_gen[None, :]).any(axis=1).mean()
    # density: real spheres per generated point, normalized by k
    density = (d_rg <= r_real[:, None]).sum(axis=0).mean() / k
    # coverage: real point whose OWN sphere contains a generated point
    coverage = (d_rg.min(axis=1) <= r_real).mean()
    return {
        "precision": float(precision),
        "recall": float(recall),
        "density": float(density),
        "coverage": float(coverage),
    }
