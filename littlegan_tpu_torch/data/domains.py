"""Images sorted into domains by folder, as AFHQ ships them
(``<root>/<domain>/*.jpg``), for StarGAN v2; and the published code's
domain-balanced sampling.

:class:`DomainFolder` lists ``<image_path>/<domain>/`` (domains in sorted
order, each a label 0, 1, ...; files sorted) and decodes every image once,
resized to ``image_dim`` square with PIL's bilinear filter, into one
(N, H, W, 3) uint8 array and its (N,) labels: the card-resident store.
:class:`SyntheticDomains` is the same contract on random images from the
seed (``--synthetic-data``).

:class:`BalancedSampler` draws what one iteration takes, as
``core/data_loader.py``'s ``make_balanced_sampler`` (sample weights one
over the domain's count, with replacement) and ``ReferenceDataset`` do:
the source images with a domain uniform over the domains and an image
uniform within it; the reference pairs with the target domain drawn the
same way and two distinct images of it.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from littlegan_tpu_torch.config import Config

EXTS = (".jpg", ".jpeg", ".png")


class DomainFolder:
    def __init__(self, cfg: Config):
        root = cfg.image_path
        if not os.path.isdir(root):
            raise FileNotFoundError(f"image_path {root!r} is not a directory of domain folders "
                                    "(<image_path>/<domain>/*.jpg, as AFHQ ships)")
        self.cfg = cfg
        self.label = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.files: List[Tuple[str, int]] = []
        for y, d in enumerate(self.label):
            names = sorted(f for f in os.listdir(os.path.join(root, d)) if f.lower().endswith(EXTS))
            self.files += [(os.path.join(root, d, f), y) for f in names]
        if len(self.label) != cfg.num_domains:
            raise ValueError(f"{root!r} holds {len(self.label)} domain folders {self.label}, "
                             f"num_domains is {cfg.num_domains}")
        if not self.files:
            raise ValueError(f"no {'/'.join(EXTS)} images under {root!r}")

    def __len__(self) -> int:
        return len(self.files)

    def load(self) -> Tuple[np.ndarray, np.ndarray]:
        """(images (N, H, W, 3) uint8, labels (N,) int64), every image decoded once."""
        return decode([path for path, _ in self.files], self.cfg.image_dim), np.array([y for _, y in self.files],
                                                                                      np.int64)


def decode(paths: List[str], d: int) -> np.ndarray:
    """(N, d, d, 3) uint8: each image decoded once as RGB, resized to d square
    with PIL's bilinear filter where it is not."""
    from PIL import Image

    images = np.empty((len(paths), d, d, 3), np.uint8)
    for i, path in enumerate(paths):
        with Image.open(path) as im:
            im = im.convert("RGB")
            if im.size != (d, d):
                im = im.resize((d, d), Image.BILINEAR)
            images[i] = np.asarray(im)
    return images


class SyntheticDomains:
    """Random uint8 images from ``cfg.seed``, ``num_items`` of them, the labels cycling over the domains."""

    def __init__(self, cfg: Config, num_items: int = 64):
        self.cfg, self.num_items = cfg, num_items
        self.label = [f"domain{i}" for i in range(cfg.num_domains)]

    def __len__(self) -> int:
        return self.num_items

    def load(self) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.cfg.seed)
        d = self.cfg.image_dim
        images = rng.integers(0, 256, (self.num_items, d, d, 3), dtype=np.uint8)
        return images, np.arange(self.num_items, dtype=np.int64) % self.cfg.num_domains


class BalancedSampler:
    """The ids one iteration takes from a store with these ``labels``."""

    def __init__(self, labels: np.ndarray, num_domains: int):
        labels = np.asarray(labels)
        self.by_domain = [np.flatnonzero(labels == d) for d in range(num_domains)]
        if any(len(ids) < 2 for ids in self.by_domain):
            raise ValueError("every domain needs at least two images (a reference pair is two distinct ones)")

    def draw(self, rng: np.random.Generator, b: int) -> np.ndarray:
        """(3b,) ids: b sources, b references, and b second references of
        the same domains, each distinct from its reference."""
        doms = self.by_domain
        src = rng.integers(0, len(doms), b)
        trg = rng.integers(0, len(doms), b)
        ids = np.empty(3 * b, np.int64)
        for i in range(b):
            pool, pool_t = doms[src[i]], doms[trg[i]]
            ids[i] = pool[rng.integers(len(pool))]
            j = rng.integers(len(pool_t))
            k = (j + 1 + rng.integers(len(pool_t) - 1)) % len(pool_t)  # any other image of the domain
            ids[b + i], ids[2 * b + i] = pool_t[j], pool_t[k]
        return ids
