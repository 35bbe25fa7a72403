"""Host-side image helpers (numpy), the port's copy of littlegan_tpu/utils/image.py.

- ``soft``: label smoothing ``0.96*x + 0.02`` ({-0.94, 0.98} on ±1 labels).
- ``data_rescale`` / ``inverse_rescale``: uint8 [0,255] <-> [-1,1]
  (inverse rounds before the cast, as the reference does).
- ``ensure_pm1``: uint8 -> f32 [-1,1]; [-1,1] floats pass through.
- ``to_grid`` / ``save_image``: a batch tiled into one image (index fills
  columns downward) and saved with PIL.
- ``BatchImageWriter``: ``save_image`` on a thread pool, for bulk writers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def soft(x):
    """Label smoothing (numpy, Python floats and tensors alike)."""
    return 0.96 * x + 0.02


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


def _grid_dims(n: int, shape: Tuple[Optional[int], Optional[int]]) -> Tuple[int, int]:
    """(rows, cols); None/None -> near-square."""
    rows, cols = shape
    if rows is None and cols is None:
        cols = int(np.ceil(np.sqrt(n)))
    if rows is None:
        rows = int(np.ceil(n / cols))
    if cols is None:
        cols = int(np.ceil(n / rows))
    return rows, cols


def to_grid(batch: np.ndarray, shape: Tuple[Optional[int], Optional[int]] = (None, None)) -> np.ndarray:
    """Tile an NHWC uint8 batch into one HWC image; image ``i`` lands at
    tile (row i % rows, column i // rows)."""
    n, h, w, c = batch.shape
    rows, cols = _grid_dims(n, shape)
    pad = rows * cols - n
    if pad:
        batch = np.concatenate([batch, np.zeros((pad, h, w, c), batch.dtype)])
    return batch.reshape(cols, rows, h, w, c).transpose(1, 2, 0, 3, 4).reshape(rows * h, cols * w, c)


def save_image(image, path: Optional[str] = None, shape: Tuple[Optional[int], Optional[int]] = (None, None)):
    """Save a [-1,1] image or batch (uint8 passes through as pixels) as one
    tiled JPEG; ``path=None`` shows it instead. Returns the PIL image."""
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = inverse_rescale(arr).astype(np.uint8)
    if arr.ndim == 4:
        arr = to_grid(arr, shape)
    img = Image.fromarray(arr[:, :, 0], "L") if arr.shape[2] == 1 else Image.fromarray(arr, "RGB")
    if path is None:
        img.show()
        return img
    img.save(path)
    return img


class BatchImageWriter:
    """Thread-pooled ``save_image`` for bulk writers (``evaluate-sample``).

    PIL's JPEG encoder releases the GIL, so a small pool overlaps encoding
    and disk writes with the card computing the next batch. At most
    ``max_pending`` writes wait at once, so a fast producer cannot pile
    unencoded batches in memory; a worker's error re-raises on a later
    ``save`` or on ``close``. As a context manager, a clean exit waits for
    every write.
    """

    def __init__(self, workers: int = 8, max_pending: Optional[int] = None):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="imgwrite")
        self._pending = deque()
        self._max = max_pending if max_pending is not None else workers * 4

    def save(self, image, path: str, shape: Tuple[Optional[int], Optional[int]] = (None, None)):
        self._drain(block=len(self._pending) >= self._max)
        self._pending.append(self._pool.submit(save_image, np.asarray(image), path, shape))

    def _drain(self, block: bool) -> None:
        while self._pending and (block or self._pending[0].done()):
            self._pending.popleft().result()  # re-raises a worker's error
            block = False

    def close(self) -> None:
        try:
            while self._pending:
                self._pending.popleft().result()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
        else:  # already unwinding: do not mask the original exception
            self._pending.clear()
            self._pool.shutdown(wait=True)
