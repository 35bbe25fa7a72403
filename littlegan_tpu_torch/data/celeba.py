"""CelebA input pipeline, the port's copy of littlegan_tpu/data/celeba.py.

- the file list is the sorted ``image_path/*.image_ext`` (or the sorted
  members of a ``.zip`` archive, read through thread-local handles);
- labels come from the CelebA attribute file filtered to ``cfg.attr``,
  joined on the file name when the file has the standard header, else
  paired by line order like the reference;
- each image is decoded into uint8 (center-cropped and resized when it is
  not ``image_dim`` square) by the native libjpeg loader
  (``data/native_loader.py``) when ``use_native_loader`` is set and the
  images are JPEGs, else by PIL; a loader that fails to build prints
  ``native loader unavailable (...); using PIL`` and PIL decodes, as in the
  JAX package (``celeba.py:214-233``). The train step rescales to [-1, 1]
  on the card (``host_rescale`` does it here instead);
- batch membership is fixed and batch ORDER is permuted per epoch by
  :func:`epoch_batch_order`, the (seed, epoch) stream the JAX package uses,
  so both packages see the same batch sequence;
- under data parallelism each rank decodes only its rows of every batch
  (:meth:`CelebA.set_rows_per_batch`).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.utils.image import data_rescale, soft

CELEBA_ATTR_NAMES = [
    "5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive", "Bags_Under_Eyes", "Bald",
    "Bangs", "Big_Lips", "Big_Nose", "Black_Hair", "Blond_Hair", "Blurry",
    "Brown_Hair", "Bushy_Eyebrows", "Chubby", "Double_Chin", "Eyeglasses",
    "Goatee", "Gray_Hair", "Heavy_Makeup", "High_Cheekbones", "Male",
    "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes", "No_Beard", "Oval_Face",
    "Pale_Skin", "Pointy_Nose", "Receding_Hairline", "Rosy_Cheeks", "Sideburns",
    "Smiling", "Straight_Hair", "Wavy_Hair", "Wearing_Earrings", "Wearing_Hat",
    "Wearing_Lipstick", "Wearing_Necklace", "Wearing_Necktie", "Young",
]


def epoch_batch_order(seed: int, epoch: int, n_batches: int) -> np.ndarray:
    """The per-epoch permutation of batch order."""
    return np.random.default_rng((seed, epoch)).permutation(n_batches)


def parse_attr_file(attr_path: str, attr_filter: Optional[Sequence[int]]) -> Tuple[dict, List[List[float]]]:
    """(file name -> values when the standard header is present, the values
    in line order); raw ±1 floats, softened later."""
    with open(attr_path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    by_name: dict = {}
    by_line: List[List[float]] = []
    start = 2 if lines and lines[0].strip().isdigit() else 0  # count line + name line
    for ln in lines[start:]:
        parts = ln.split()
        name, vals = parts[0], parts[1:]
        if attr_filter is not None:
            vals = [vals[i] for i in attr_filter]
        fvals = [float(v) for v in vals]
        by_name[name] = fvals
        by_line.append(fvals)
    return by_name, by_line


def _decode_pil(src, dim: int, channels: int) -> np.ndarray:
    """A JPEG path or its bytes -> (dim, dim, channels) uint8."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(src) if isinstance(src, (bytes, bytearray)) else src)
    img = img.convert("RGB" if channels == 3 else "L")
    if img.size != (dim, dim):
        w, h = img.size
        s = min(w, h)
        img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
        img = img.resize((dim, dim), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.uint8)
    if channels == 1 and arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


class CelebA:
    """File-backed dataset with threaded batch decode and prefetch."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        ext = f".{cfg.image_ext}".lower()
        if os.path.isfile(cfg.image_path) and cfg.image_path.lower().endswith(".zip"):
            import zipfile

            self._zip_path = cfg.image_path
            self._zip_local = threading.local()
            with zipfile.ZipFile(cfg.image_path) as z:
                files = sorted(n for n in z.namelist() if n.lower().endswith(ext) and not n.startswith("__MACOSX"))
            if not files:
                raise FileNotFoundError(f"no *{ext} members inside {cfg.image_path}")
        else:
            self._zip_path = None
            files = sorted(glob(os.path.join(cfg.image_path, f"*.{cfg.image_ext}")))
            if not files:
                raise FileNotFoundError(f"no *.{cfg.image_ext} under {cfg.image_path}")
        by_name, by_line = parse_attr_file(cfg.attr_path, cfg.attr)
        named = sum(1 for f in files if os.path.basename(f) in by_name)
        if by_name and named >= max(1, len(files) // 2):
            pairs = [(f, by_name[os.path.basename(f)]) for f in files if os.path.basename(f) in by_name]
            if named < len(files):
                print(f"CelebA: {len(files) - named} images missing from attr list; skipped")
        else:
            if len(files) != len(by_line):
                raise ValueError(
                    f"attr file has {len(by_line)} label lines for {len(files)} images and no "
                    "filename column to join on; counts must match exactly for line-order pairing"
                )
            pairs = list(zip(files, by_line))
        self._files = [p[0] for p in pairs]
        self._conds = np.asarray([p[1] for p in pairs], np.float32)
        self.num_items = len(self._files)
        self.batches = self.num_items // cfg.batch_size
        self.rows = slice(0, cfg.batch_size)  # the rows of each batch this process decodes
        self.all_label = list(CELEBA_ATTR_NAMES)
        self.label = [CELEBA_ATTR_NAMES[i] for i in cfg.attr]
        self._cache: Optional[dict] = {} if cfg.cache_decoded else None
        self._decoder = self._pick_decoder()

    def set_rows_per_batch(self, rows: int, index: int = 0) -> None:
        """Decode only rows ``[index * rows, (index + 1) * rows)`` of every
        batch: a data-parallel rank's part of the global batch, so the
        ranks' parts make up the single-process batches and each image is
        decoded once per epoch. The batch count stays that of the whole
        file list on every rank (the JAX package's multi-host pipeline
        gives each host a strided shard of the files instead)."""
        if self.cfg.batch_size % rows or not 0 <= index < self.cfg.batch_size // rows:
            raise ValueError(f"rows {rows} at index {index} do not split batch_size {self.cfg.batch_size}")
        self.rows = slice(index * rows, (index + 1) * rows)

    def _read(self, name: str):
        if self._zip_path is None:
            return name
        import zipfile

        z = getattr(self._zip_local, "zf", None)
        if z is None:
            z = self._zip_local.zf = zipfile.ZipFile(self._zip_path)
        return z.read(name)

    def _pick_decoder(self):
        """Batch decoder: callable(file paths or zip member names) ->
        (N, dim, dim, C) uint8."""
        dim, ch = self.cfg.image_dim, self.cfg.image_channel
        native = None
        if self.cfg.use_native_loader and self.cfg.image_ext.lower() in ("jpg", "jpeg"):
            try:
                from littlegan_tpu_torch.data.native_loader import NativeBatchLoader

                native = NativeBatchLoader(dim, ch, threads=self.cfg.threads)
            except Exception as e:  # no toolchain or no libjpeg: PIL
                print(f"native loader unavailable ({type(e).__name__}); using PIL")
        self.decoder_name = "PIL" if native is None else "native"
        if native is None:
            return lambda names: np.stack([_decode_pil(self._read(n), dim, ch) for n in names])
        if self._zip_path is not None:
            return lambda names: native.load_buffers([self._read(n) for n in names])
        return native.load

    def _decode(self, idx) -> np.ndarray:
        return self._decoder([self._files[int(i)] for i in idx])

    def _load_batch(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self._cache is not None:
            missing = [int(i) for i in idx if int(i) not in self._cache]
            if missing:
                for i, img in zip(missing, self._decode(missing)):
                    self._cache[i] = img
            imgs = np.stack([self._cache[int(i)] for i in idx])
        else:
            imgs = self._decode(idx)
        conds = soft(self._conds[idx]).astype(np.float32)
        if self.cfg.host_rescale:
            return data_rescale(imgs.astype(np.float32)).astype(np.float32), conds
        return imgs, conds

    def epoch_iterator(
        self, epoch: int = 0, shuffle: bool = True, start_batch: int = 0
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """``batches`` prefetched (image, cond) pairs in the epoch's order
        (canonical order with ``shuffle=False``); the first ``start_batch``
        are skipped without decoding them."""
        cfg = self.cfg
        order = epoch_batch_order(cfg.seed, epoch, self.batches) if shuffle else np.arange(self.batches)
        rows = cfg.batch_size
        batch_indices = [np.arange(b * rows, (b + 1) * rows)[self.rows] for b in order][start_batch:]
        depth = max(2, cfg.prefetch_batch)
        pool = ThreadPoolExecutor(max_workers=cfg.threads)
        try:
            futures = [pool.submit(self._load_batch, bi) for bi in batch_indices[:depth]]
            for nxt in range(depth, len(batch_indices) + depth):
                fut = futures.pop(0)
                if nxt < len(batch_indices):
                    futures.append(pool.submit(self._load_batch, batch_indices[nxt]))
                yield fut.result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
