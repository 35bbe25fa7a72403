"""Unlabelled images for StyleGAN2: every image file under a folder (FFHQ
ships 70 folders of 1,000 PNGs), decoded once into the card-resident
store.

:class:`ImageFolder` lists ``<image_path>/**`` (files sorted by path) and
decodes every image once, resized to ``image_dim`` square with PIL's
bilinear filter, into one (N, H, W, 3) uint8 array. :class:`SyntheticImages`
is the same contract on random images from the seed (``--synthetic-data``).
"""

from __future__ import annotations

import os

import numpy as np

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.data.domains import EXTS, decode


class ImageFolder:
    label: list = []  # no attributes or domains

    def __init__(self, cfg: Config):
        root = cfg.image_path
        if not os.path.isdir(root):
            raise FileNotFoundError(f"image_path {root!r} is not a directory of images")
        self.cfg = cfg
        self.files = sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.lower().endswith(EXTS))
        if not self.files:
            raise ValueError(f"no {'/'.join(EXTS)} images under {root!r}")

    def __len__(self) -> int:
        return len(self.files)

    def load(self) -> np.ndarray:
        """(N, H, W, 3) uint8, every image decoded once."""
        return decode(self.files, self.cfg.image_dim)


class SyntheticImages:
    """Random uint8 images from ``cfg.seed``, ``num_items`` of them."""

    label: list = []

    def __init__(self, cfg: Config, num_items: int = 64):
        self.cfg, self.num_items = cfg, num_items

    def __len__(self) -> int:
        return self.num_items

    def load(self) -> np.ndarray:
        d = self.cfg.image_dim
        return np.random.default_rng(self.cfg.seed).integers(0, 256, (self.num_items, d, d, 3), dtype=np.uint8)
