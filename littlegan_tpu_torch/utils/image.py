"""Host-side image helpers (numpy), the port's copy of littlegan_tpu/utils/image.py.

- ``data_rescale`` / ``inverse_rescale``: uint8 [0,255] <-> [-1,1]
  (inverse rounds before the cast, as the reference does).
- ``ensure_pm1``: uint8 -> f32 [-1,1]; [-1,1] floats pass through.
"""

from __future__ import annotations

import numpy as np


def data_rescale(x):
    """[0,255] -> [-1,1]."""
    return x / 127.5 - 1.0


def inverse_rescale(y):
    """[-1,1] -> rounded [0,255]."""
    return np.round((np.asarray(y, dtype=np.float32) + 1.0) * 127.5)


def ensure_pm1(images: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> f32 [-1,1]; [-1,1] floats pass through."""
    arr = np.asarray(images)
    if arr.dtype == np.uint8:
        return data_rescale(arr.astype(np.float32)).astype(np.float32)
    return arr
