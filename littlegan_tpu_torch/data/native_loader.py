"""ctypes bindings for the native (C++/libjpeg) batch decoder, the port's copy
of littlegan_tpu/data/native_loader.py.

The shared library (``littlegan_tpu_torch/native/loader.cc``) owns a
persistent worker pool and decodes whole batches in parallel without the
GIL: JPEG decode, then, for an image that is not ``dim`` square, a center
crop and a bilinear resize. It is built at first use with ``g++`` and
libjpeg into ``littlegan_tpu_torch/build/`` (listed in ``.gitignore``),
under a name that carries a hash of the source and flags, written to a
temporary name and renamed, so that a process that loads it never sees a
partial file. A failed build raises; ``data/celeba.py`` then decodes with
PIL and says so.

``python -m littlegan_tpu_torch.data.native_loader [--images N]`` times
the CelebA pipeline on this host with the native loader and with PIL, on
synthetic JPEGs at 128x128 and at CelebA's 178x218 (:func:`pipeline_rates`).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import tempfile
import threading
import time
from typing import Dict, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "loader.cc")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()


def build() -> str:
    """The library's path, compiled first unless this source and these
    flags were built already."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode() + f.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libloader-{digest}.so")
    with _lock:
        if not os.path.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = os.path.join(BUILD_DIR, f".libloader-{digest}.{os.getpid()}.so")
            try:
                subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS], check=True, capture_output=True,
                               timeout=300)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return path


def _load_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.lg_loader_create.restype = ctypes.c_void_p
    lib.lg_loader_create.argtypes = [ctypes.c_int]
    lib.lg_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.lg_loader_load.restype = ctypes.c_int
    lib.lg_loader_load.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
    ]
    lib.lg_decode_file.restype = ctypes.c_int
    lib.lg_decode_file.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, u8p]
    lib.lg_loader_load_buffers.restype = ctypes.c_int
    lib.lg_loader_load_buffers.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
    ]
    return lib


class NativeBatchLoader:
    """Parallel batch decode: JPEG paths, or their bytes, -> (N, dim, dim, C)
    uint8."""

    def __init__(self, dim: int, channels: int, threads: int = 8):
        self._lib = _load_lib()
        self.dim = dim
        self.channels = channels
        self._handle = self._lib.lg_loader_create(threads)
        if not self._handle:
            raise RuntimeError("lg_loader_create failed")

    def _out(self, n: int) -> np.ndarray:
        return np.empty((n, self.dim, self.dim, self.channels), np.uint8)

    def load(self, paths: Sequence[str]) -> np.ndarray:
        n = len(paths)
        out = self._out(n)
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        failures = self._lib.lg_loader_load(
            self._handle, c_paths, n, self.dim, self.channels, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if failures:
            raise IOError(f"native loader: {failures}/{n} images failed to decode")
        return out

    def load_buffers(self, buffers: Sequence[bytes]) -> np.ndarray:
        """In-memory JPEG byte strings (zip-archive members): Python reads
        the bytes, the C++ pool decodes them without the GIL. The lengths
        travel beside the buffers, so a NUL byte inside a stream is
        harmless."""
        n = len(buffers)
        out = self._out(n)
        c_bufs = (ctypes.c_char_p * n)(*buffers)
        c_lens = (ctypes.c_size_t * n)(*[len(b) for b in buffers])
        failures = self._lib.lg_loader_load_buffers(
            self._handle, c_bufs, c_lens, n, self.dim, self.channels,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if failures:
            raise IOError(f"native loader: {failures}/{n} buffers failed to decode")
        return out

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.lg_loader_destroy(handle)
            self._handle = None


def available() -> str:
    """Whether the loader builds and loads on this host: "ok", else why not."""
    try:
        NativeBatchLoader(8, 3, threads=1)
        return "ok"
    except Exception as e:
        detail = (getattr(e, "stderr", None) or b"").decode(errors="replace").strip().splitlines()
        return f"{type(e).__name__}: {e}" + (f" ({detail[0]})" if detail else "")


def pipeline_rates(root: str, cfg, images: int = 256, rounds: int = 2) -> Dict[str, list]:
    """Images/s of ``CelebA(cfg).epoch_iterator`` over ``images`` synthetic
    JPEGs written under ``root`` at 128x128 and at 178x218 (decoded to
    ``cfg.image_dim``), with ``use_native_loader`` on and off, in turns
    for ``rounds`` rounds. Keys name the size and the decoder that ran
    (PIL where the native loader is unavailable)."""
    from PIL import Image

    from littlegan_tpu_torch.data.celeba import CelebA

    rng = np.random.default_rng(0)
    out: Dict[str, list] = {}
    for w, h in ((128, 128), (178, 218)):
        d = os.path.join(root, f"jpeg_{w}x{h}")
        os.makedirs(d, exist_ok=True)
        names = [f"{i + 1:06d}.jpg" for i in range(images)]
        base = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
        for i, n in enumerate(names):  # smooth images, as photographs compress
            Image.fromarray(np.roll(base, i, axis=1)).resize((w, h), Image.BILINEAR).save(os.path.join(d, n),
                                                                                       quality=90)
        rows = [f"{n} " + " ".join(str(v) for v in rng.choice([-1, 1], 40)) for n in names]
        with open(os.path.join(d, "attr.txt"), "w") as f:
            f.write(f"{len(names)}\nheader\n" + "\n".join(rows) + "\n")
        for native in (True, False) * rounds:
            data = CelebA(cfg.replace(image_path=d, attr_path=os.path.join(d, "attr.txt"),
                                      use_native_loader=native, cache_decoded=False))
            t = time.perf_counter()
            n_img = sum(img.shape[0] for img, _ in data.epoch_iterator(1))
            out.setdefault(f"{w}x{h} {data.decoder_name}", []).append(n_img / (time.perf_counter() - t))
    return out


def main(argv=None) -> int:
    from littlegan_tpu_torch.config import Config

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--threads", type=int, default=Config().threads)
    args = ap.parse_args(argv)
    print(f"native loader on this host: {available()}")
    with tempfile.TemporaryDirectory(prefix="native_loader_") as root:
        rates = pipeline_rates(root, Config(threads=args.threads), args.images)
    for key, vals in rates.items():
        print(f"CelebA pipeline, {key}, {args.threads} threads: " + ", ".join(f"{v:.1f}" for v in vals)
              + " images/s on the host")
    print(json.dumps({"host_cpus": os.cpu_count(), "threads": args.threads, "images": args.images, "rates": rates}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
