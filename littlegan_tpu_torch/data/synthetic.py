"""Synthetic dataset (numpy only), the port's copy of littlegan_tpu/data/synthetic.py.

Deterministic random images in [-1, 1] (f32 NHWC) and softened ±1
attribute labels, the same contract and the same numbers as the JAX
package's ``SyntheticDataset`` for the same config: a run of either package
on ``--synthetic-data`` sees the same batches. Under data parallelism each
rank yields only its rows of every batch (:meth:`SyntheticDataset.set_rows_per_batch`).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.utils.image import soft


class SyntheticDataset:
    def __init__(self, cfg: Config, num_items: int = 256):
        self.cfg = cfg
        self.num_items = num_items
        self.batches = num_items // cfg.batch_size
        self.label = [f"attr{i}" for i in cfg.attr]
        self.rows = slice(0, cfg.batch_size)  # the rows of each batch this process yields

    def set_rows_per_batch(self, rows: int, index: int = 0) -> None:
        """Yield only rows ``[index * rows, (index + 1) * rows)`` of every
        batch: a data-parallel rank's part of the global batch. The batches
        are still drawn whole from the one (seed, epoch) stream, so the
        ranks' parts make up the single-process batches exactly (the JAX
        package gives each host a stream of its own instead)."""
        if self.cfg.batch_size % rows or not 0 <= index < self.cfg.batch_size // rows:
            raise ValueError(f"rows {rows} at index {index} do not split batch_size {self.cfg.batch_size}")
        self.rows = slice(index * rows, (index + 1) * rows)

    def epoch_iterator(
        self, epoch: int = 0, shuffle: bool = True, start_batch: int = 0
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """``batches`` IID batches from the (seed, epoch) stream. ``shuffle``
        is accepted for the CelebA interface and has nothing to do; the
        batches before ``start_batch`` are drawn and dropped, so a resumed
        epoch sees the same tail as a whole one."""
        c = self.cfg
        rng = np.random.default_rng(c.seed * 100003 + epoch)
        for i in range(self.batches):
            img = rng.uniform(-1.0, 1.0, (c.batch_size, c.image_dim, c.image_dim, c.image_channel)).astype(
                np.float32
            )
            cond = soft(np.where(rng.random((c.batch_size, c.cond_dim)) < 0.5, -1.0, 1.0)).astype(np.float32)
            if i >= start_batch:
                yield img[self.rows], cond[self.rows]
