"""The port's native JPEG loader (``littlegan_tpu_torch/native/loader.cc``,
built with g++ and libjpeg at first use) against the JAX package's, and the
CelebA pipeline's choice of decoder, on JPEGs the tests write.

The two loaders are one source compiled with the same flags: their batches
are compared byte for byte, square images (decode only) and CelebA's
178 x 218 (center crop and bilinear resize).
"""

import io
import zipfile

import numpy as np
import pytest
from PIL import Image

from littlegan_tpu.data.celeba import CelebA as JCelebA
from littlegan_tpu.data.native_loader import NativeBatchLoader as JNativeBatchLoader
from littlegan_tpu_torch.data import CelebA
from littlegan_tpu_torch.data import native_loader
from test_torch_train import tcfg_of
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

SIZES = [(16, 16), (218, 178), (16, 16), (218, 178), (20, 24)]


def _jpegs(tmp_path, sizes=SIZES, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i, (h, w) in enumerate(sizes):
        path = tmp_path / f"{i + 1:06d}.jpg"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path, quality=90)
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("method", ["load", "load_buffers"])
def test_native_loader_bytes_equal_jax(tmp_path, method):
    paths = _jpegs(tmp_path)
    port, ref = native_loader.NativeBatchLoader(16, 3, threads=2), JNativeBatchLoader(16, 3, threads=2)
    if method == "load":
        got, want = port.load(paths), ref.load(paths)
    else:  # as from a zip archive: member bytes
        with zipfile.ZipFile(tmp_path / "imgs.zip", "w") as z:
            for p in paths:
                z.write(p, arcname=p.rsplit("/", 1)[1])
        with zipfile.ZipFile(tmp_path / "imgs.zip") as z:
            bufs = [z.read(n) for n in sorted(z.namelist())]
        got, want = port.load_buffers(bufs), ref.load_buffers(bufs)
    assert got.dtype == np.uint8 and got.shape == (len(paths), 16, 16, 3)
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0
    with pytest.raises(IOError, match="failed to decode"):
        port.load_buffers([b"not a jpeg"]) if method == "load_buffers" else port.load([str(tmp_path / "none.jpg")])


def _celeba_cfg(tiny_cfg, tmp_path, image_path, **kw):
    names = [f"{i + 1:06d}.jpg" for i in range(len(SIZES))]
    rng = np.random.default_rng(1)
    rows = [f"{n} " + " ".join(str(v) for v in rng.choice([-1, 1], 40)) for n in names]
    (tmp_path / "attr.txt").write_text(f"{len(names)}\nheader\n" + "\n".join(rows) + "\n")
    return tiny_cfg.replace(image_path=str(image_path), attr_path=str(tmp_path / "attr.txt"), batch_size=2,
                            threads=2, **kw)


@pytest.mark.parametrize("archive", [False, True], ids=["dir", "zip"])
def test_celeba_uses_the_native_loader(tiny_cfg, tmp_path, archive, capsys):
    """``use_native_loader`` decodes with the native loader (paths, or zip
    member bytes), and the batches equal the JAX pipeline's native ones."""
    paths = _jpegs(tmp_path)
    image_path = tmp_path
    if archive:
        image_path = tmp_path / "celeba.zip"
        with zipfile.ZipFile(image_path, "w") as z:
            for p in paths:
                z.write(p, arcname=p.rsplit("/", 1)[1])
    jcfg = _celeba_cfg(tiny_cfg, tmp_path, image_path, use_native_loader=True)
    port, ref = CelebA(tcfg_of(jcfg)), JCelebA(jcfg)
    assert port.decoder_name == "native" and "using PIL" not in capsys.readouterr().out
    for (gi, gc), (wi, wc) in zip(port.epoch_iterator(2), ref.epoch_iterator(2), strict=True):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gc, wc)


def test_a_broken_build_falls_back_to_pil(tiny_cfg, tmp_path, monkeypatch, capsys):
    """A loader that does not compile: the pipeline says so and decodes with
    PIL, giving the PIL pipeline's batches."""
    _jpegs(tmp_path)
    broken = tmp_path / "loader.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", str(broken))
    jcfg = _celeba_cfg(tiny_cfg, tmp_path, tmp_path, use_native_loader=True)
    port = CelebA(tcfg_of(jcfg))
    assert "native loader unavailable (CalledProcessError); using PIL" in capsys.readouterr().out
    assert port.decoder_name == "PIL"
    pil = CelebA(tcfg_of(jcfg.replace(use_native_loader=False)))
    for (gi, _), (wi, _) in zip(port.epoch_iterator(1), pil.epoch_iterator(1), strict=True):
        np.testing.assert_array_equal(gi, wi)
    with pytest.raises(Exception):
        native_loader.build()
