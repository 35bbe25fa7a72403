"""Latent-space helpers for the sampling tools, the port's copy of
littlegan_tpu/utils/latent.py (numpy, host side)."""

from __future__ import annotations

import numpy as np


def slerp(z0: np.ndarray, z1: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Spherical interpolation between latent rows.

    ``z0``/``z1``: (rows, dim); ``t``: (steps,) in [0, 1]. Returns
    (steps, rows, dim) with exact endpoints (t=0 -> z0, t=1 -> z1).

    Slerp, not lerp: a linear mix of Gaussian latents falls off the noise
    shell (the midpoint's norm shrinks to about 0.7x) into a region the
    generator never saw in training. Near-parallel pairs (sin(omega) ~ 0)
    fall back to lerp, the slerp limit there.
    """
    z0 = np.asarray(z0, np.float32)
    z1 = np.asarray(z1, np.float32)
    t = np.asarray(t, np.float32)[None]  # (1, steps)
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)  # noqa: E731
    omega = np.arccos(np.clip((unit(z0) * unit(z1)).sum(-1), -1.0, 1.0))[:, None]
    so = np.sin(omega)  # (rows, 1)
    safe = np.where(so > 1e-6, so, 1.0)
    w0 = np.where(so > 1e-6, np.sin((1.0 - t) * omega) / safe, 1.0 - t)  # (rows, steps)
    w1 = np.where(so > 1e-6, np.sin(t * omega) / safe, t)
    return w0.T[:, :, None] * z0[None] + w1.T[:, :, None] * z1[None]
