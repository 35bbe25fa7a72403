"""Inception Score (Salimans et al. 2016) — beyond-reference eval metric.
The port's numpy copy of littlegan_tpu/eval/inception_score.py.

The reference evaluates only FID (evaluate.py:43-59); IS is the other
standard GAN sample-quality metric and falls out of the same InceptionV3
forward: ``IS = exp( E_x[ KL( p(y|x) || p(y) ) ] )`` over softmax class
probabilities, reported as mean±std across ``splits`` equal parts (the
convention from the original implementation and pytorch-IS).

Honesty gating mirrors FID: with random-init Inception weights the value is
a self-consistent trend metric ONLY and every label says so
(evaluate.py is_label / fid_label).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def inception_score(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """(N, C) softmax rows -> (mean, std) of per-split exp(mean KL).

    ``splits`` caps at N (tiny sample sets in tests/smoke runs); empty
    splits are impossible after the cap.
    """
    probs = np.asarray(probs, np.float64)
    if probs.ndim != 2 or probs.shape[0] == 0:
        raise ValueError(f"need (N, C) probabilities, got {probs.shape}")
    splits = max(1, min(int(splits), probs.shape[0]))
    scores = []
    for part in np.array_split(probs, splits):
        py = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + 1e-16) - np.log(py + 1e-16))).sum(axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))
