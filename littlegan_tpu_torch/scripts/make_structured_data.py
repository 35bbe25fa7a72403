"""Generate the STRUCTURED synthetic dataset for conditioning campaigns:
the port's own copy of the JAX repo's ``scripts/make_structured_data.py``
(numpy and PIL only). For the same arguments it writes the same bytes.

A CelebA-shaped tree (JPEGs + standard attribute file) where each of the 7
selected attribute bits (sample.config.json attr = [8,15,20,22,26,36,39])
controls a VISIBLE image property, so generator/adjuster conditioning can be
measured mechanically (``scripts/verify_conditioning.py``'s ``stat``
regions, ``scripts/campaign.py``'s ``region_means``):

    bit 0: red tint (channel 0, global)
    bit 1: green stripe, rows [d/4, d/2)
    bit 2: blue bottom half
    bit 3: bright center square
    bit 4: bright band, rows [d/8, d/4)
    bit 5: bright corner block [0, d/4)^2
    bit 6: GLOBAL brightness, the structurally hard one (the reference's
           axis=None InstanceNorm removes per-sample global statistics;
           Config.cond_bias)

Usage: python -m littlegan_tpu_torch.scripts.make_structured_data <out_dir> [n_images] [dim]
       [--geometry celeba] [--zip] [--attr-rows 202599]

``--geometry celeba`` emits real-CelebA-shaped JPEGs, 178x218 (WxH,
img_align_celeba geometry) with the structured pattern occupying the
178x178 center-crop square, exercising the ingest crop+resize path exactly
as the real dataset would. ``--zip`` writes ``img_align.zip`` instead of an
img/ tree (the zip-ingest path), and ``--attr-rows N`` pads the attribute
file to N rows (the real file has 202,599) with entries for images that
don't exist locally, which the filename join must skip.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def make_image(rng: np.random.Generator, bits: np.ndarray, dim: int) -> np.ndarray:
    """One [0,255] uint8 image whose visible properties encode ``bits``."""
    # smooth low-frequency background so the model has texture to learn
    # (ceil-kron then crop: dims not divisible by 8 — e.g. the 178 celeba
    # square — must still come out EXACTLY dim x dim; a floor-kron
    # would emit 176x216 "celeba geometry" JPEGs)
    low = rng.uniform(0.25, 0.55, (8, 8, 3)).astype(np.float32)
    reps = -(-dim // 8)
    x = np.kron(low, np.ones((reps, reps, 1), np.float32))[:dim, :dim]
    d = dim
    if bits[0] > 0:
        x[:, :, 0] += 0.25
    if bits[1] > 0:
        x[d // 4 : d // 2, :, 1] += 0.3
    if bits[2] > 0:
        x[d // 2 :, :, 2] += 0.3
    if bits[3] > 0:
        x[d // 3 : 2 * d // 3, d // 3 : 2 * d // 3, :] += 0.25
    if bits[4] > 0:
        x[d // 8 : d // 4, :, :] += 0.3
    if bits[5] > 0:
        x[: d // 4, : d // 4, :] += 0.3
    if bits[6] > 0:
        x += 0.2
    x += rng.normal(0, 0.02, x.shape).astype(np.float32)
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def make_celeba_geometry_image(rng: np.random.Generator, bits: np.ndarray) -> np.ndarray:
    """A 218x178 (HxW) image — img_align_celeba's exact geometry — whose
    structured pattern fills the 178x178 CENTER-CROP square (rows 20..198),
    so the ingest pipeline's center-crop + resize recovers the full
    pattern. The 20-row bands above/below are edge-padding (cropped away)."""
    sq = make_image(rng, bits, 178)
    return np.pad(sq, ((20, 20), (0, 0), (0, 0)), mode="edge")


def generate(
    out_dir: str,
    n: int = 6400,
    dim: int = 128,
    attr_indices=(8, 15, 20, 22, 26, 36, 39),
    seed: int = 0,
    geometry: str = "square",
    as_zip: bool = False,
    attr_rows: int = 0,
) -> None:
    """``geometry='celeba'`` -> 178x218 JPEGs (``dim`` ignored for pixels;
    the TRAINING dim stays a config choice). ``as_zip`` -> img_align.zip
    instead of img/. ``attr_rows`` pads attrs.txt to that many rows (real
    CelebA: 202,599) with rows for files that don't exist locally."""
    import io
    import zipfile

    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    zf = None
    if as_zip:
        zf = zipfile.ZipFile(
            os.path.join(out_dir, "img_align.zip"), "w", zipfile.ZIP_STORED
        )
    else:
        os.makedirs(os.path.join(out_dir, "img"), exist_ok=True)

    total_rows = max(n, attr_rows)
    lines = [str(total_rows), " ".join(f"A{i}" for i in range(40))]
    for i in range(n):
        bits = np.where(rng.random(7) < 0.5, -1, 1)
        name = f"{i:06d}.jpg"
        arr = (
            make_celeba_geometry_image(rng, bits)
            if geometry == "celeba"
            else make_image(rng, bits, dim)
        )
        if zf is not None:
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=95)
            zf.writestr(name, buf.getvalue())
        else:
            Image.fromarray(arr).save(os.path.join(out_dir, "img", name), quality=95)
        row = np.full(40, -1, np.int64)
        row[list(attr_indices)] = bits
        lines.append(name + " " + " ".join(str(v) for v in row))
    if zf is not None:
        zf.close()
    # pad the attr file toward real-CelebA scale: rows for images this host
    # does NOT have — the filename join must skip them without shifting labels
    for i in range(n, total_rows):
        row = np.where(rng.random(40) < 0.5, -1, 1)
        lines.append(f"{900000 + i:06d}.jpg " + " ".join(str(v) for v in row))
    with open(os.path.join(out_dir, "attrs.txt"), "w") as f:
        f.write("\n".join(lines))
    shape = "178x218 (celeba)" if geometry == "celeba" else f"{dim}x{dim}"
    dest = "img_align.zip" if as_zip else "img/"
    print(
        f"structured dataset: {n} images ({shape}) -> {out_dir}/{dest}"
        + (f", attrs padded to {total_rows} rows" if total_rows > n else "")
    )


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Generate the structured synthetic CelebA-shaped dataset.")
    p.add_argument("out", nargs="?", default=os.path.join(tempfile.gettempdir(), "structured_celeba"),
                   help="output directory (default: structured_celeba in the temporary directory)")
    p.add_argument("n", nargs="?", type=int, default=6400, help="number of images")
    p.add_argument("dim", nargs="?", type=int, default=128, help="square image size")
    p.add_argument(
        "--geometry", choices=("square", "celeba"), default="square",
        help="celeba = 178x218 JPEGs (img_align geometry; pattern fills the center-crop square)",
    )
    p.add_argument("--zip", action="store_true", dest="as_zip", help="write img_align.zip instead of img/")
    p.add_argument(
        "--attr-rows", type=int, default=0,
        help="pad attrs.txt to this many rows (real CelebA: 202599); extra rows name absent files",
    )
    a = p.parse_args(argv)
    generate(a.out, a.n, a.dim, geometry=a.geometry, as_zip=a.as_zip, attr_rows=a.attr_rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
