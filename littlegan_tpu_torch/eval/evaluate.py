"""Two-mode FID evaluation, the port of littlegan_tpu/eval/evaluate.py.

``precalculate`` turns a dataset (a directory of images or a ``.zip``) into
a stats npz (``mu``, ``sigma`` and, with ``save_features``, raw feature
rows for KID and PRDC); ``evaluate_generated`` scores a directory of
generated images against it and appends FID (and IS, KID, PRDC on request)
to a log, in the JAX package's format. ``python -m
littlegan_tpu_torch.eval.evaluate {pre-calculate,calc} ...`` is the
reference's ``evaluate.py`` command line (any mode but ``pre-calculate``
is calc).

Features come from the port's InceptionV3 (eval/inception.py) on the card,
100 images per call, uint8 shipped and upcast there. Its weights are
loaded once per source and kept on the device for the process (one slot:
another source replaces them). Without ``fid_weights`` evaluation refuses
unless ``allow_random_fid``; the random-init numbers are then labelled
RANDOM-INIT in every line. ``eval_data_parallel`` has nothing to shard on
one card and is ignored. The device is ``cfg.extra["device"]`` when set
(the CLI's ``--device``), else the card.
"""

from __future__ import annotations

import os
import sys
import time
import zipfile
from glob import glob
from typing import Iterable, Optional

import numpy as np
import torch

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.eval.fid import activation_statistics, frechet_distance
from littlegan_tpu_torch.eval.inception import device_params, inception_features, init_inception_params
from littlegan_tpu_torch.utils.device import resolve_device


def _image_source(root: str, ext: str):
    """(names, open_fn) over a directory of images or a ``.zip`` archive
    (the ingestion contract of data/celeba.py)."""
    if os.path.isfile(root) and root.lower().endswith(".zip"):
        import io

        zf = zipfile.ZipFile(root)
        names = sorted(
            n for n in zf.namelist() if n.lower().endswith(f".{ext}".lower()) and not n.startswith("__MACOSX")
        )
        return names, lambda n: io.BytesIO(zf.read(n))
    return sorted(glob(os.path.join(root, f"*.{ext}"))), lambda p: p


def _load_images(paths: Iterable[str], dim: Optional[int] = None, open_fn=None) -> np.ndarray:
    """Decode to (N, H, W, 3) uint8; with ``dim``, center-crop to the short
    side, then bilinear-resize to dim x dim (data/celeba.py's geometry)."""
    from PIL import Image

    out = []
    for p in paths:
        img = Image.open(open_fn(p) if open_fn is not None else p).convert("RGB")
        if dim is not None and img.size != (dim, dim):
            w, h = img.size
            if w != h:
                s = min(w, h)
                img = img.crop(((w - s) // 2, (h - s) // 2, (w - s) // 2 + s, (h - s) // 2 + s))
            img = img.resize((dim, dim), Image.BILINEAR)
        arr = np.asarray(img, np.uint8)
        if out and arr.shape != out[0].shape:
            raise ValueError(
                f"mixed image sizes under evaluation dir ({arr.shape} vs "
                f"{out[0].shape} at {p}); pass image_dim to resize uniformly"
            )
        out.append(arr)
    return np.stack(out)


_STANDARD_CACHE: dict = {}


def weights_standard(path: str) -> str:
    """Which published standard a converted weights npz pins: 'pytorch-FID'
    (FIDInception pooling) or 'torchvision'. Values of the two are not
    comparable, so every metric line names its standard."""
    if path not in _STANDARD_CACHE:
        try:
            with np.load(path) as z:
                _STANDARD_CACHE[path] = (
                    "pytorch-FID standard" if "meta/fid2015_pool" in z.files else "torchvision standard"
                )
        except (OSError, ValueError, zipfile.BadZipFile):
            _STANDARD_CACHE[path] = "torchvision standard"
    return _STANDARD_CACHE[path]


def _tag(cfg: Config) -> str:
    return f"[{weights_standard(cfg.fid_weights)}]" if cfg.fid_weights else "[RANDOM-INIT Inception, NOT comparable]"


def fid_label(cfg: Config) -> str:
    """Names the standard when real weights are loaded; tagged otherwise."""
    return f"FID{_tag(cfg)}"


def is_label(cfg: Config) -> str:
    """The same contract for the Inception Score."""
    return f"IS{_tag(cfg)}"


# one slot: the key (source, device), host params and device params of the last weights used
_WEIGHTS: dict = {}


def _device(cfg: Config) -> torch.device:
    return resolve_device(cfg.extra.get("device"))


def _inception_params(cfg: Config):
    """(host params, device params) of ``cfg``'s Inception, loaded once per
    (source, device); the host set also holds the fc head for IS."""
    dev = _device(cfg)
    key = (cfg.fid_weights or "<random-init>", str(dev))
    if _WEIGHTS.get("key") != key:
        _WEIGHTS.clear()  # drop the old device copy before loading the new one
        host = init_inception_params(cfg.fid_weights, seed=0)
        _WEIGHTS.update(key=key, host=host, dev=device_params(host, dev))
    return _WEIGHTS["host"], _WEIGHTS["dev"]


def _featurizer(cfg: Config):
    """uint8 NHWC chunk (numpy) -> (n, 2048) float32 features on the host,
    with ``cfg``'s Inception (resident on the device)."""
    dev = _device(cfg)
    if not cfg.fid_weights:
        if not cfg.allow_random_fid:
            raise RuntimeError(
                "FID requested without Inception weights (Config.fid_weights is "
                "empty). The random-init fallback produces numbers that are NOT "
                "FID — not comparable to any published value. Convert weights "
                "with scripts/convert_inception.py and set fid_weights, or set "
                "allow_random_fid=true to opt into a self-consistent trend "
                "metric (logged as RANDOM-INIT, not FID)."
            )
        print(
            "=" * 70
            + "\nWARNING: computing 'FID' with RANDOM-INIT Inception weights "
            "(fid_weights unset).\nValues are self-consistent across runs of "
            "this build ONLY — not comparable\nto published FID numbers. "
            "Convert real weights with scripts/convert_inception.py.\n"
            + "=" * 70,
            file=sys.stderr,
        )
    params = _inception_params(cfg)[1]
    return lambda chunk: inception_features(params, torch.from_numpy(chunk).to(dev)).cpu().numpy()


def compute_features(images_u8: np.ndarray, cfg: Config, batch_size: int = 100) -> np.ndarray:
    """[0, 255] NHWC uint8 -> (N, 2048) pool features, ``batch_size`` images
    per device call."""
    feat = _featurizer(cfg)
    return np.concatenate([feat(images_u8[i : i + batch_size]) for i in range(0, images_u8.shape[0], batch_size)])


def compute_features_from_files(
    files, cfg: Config, batch_size: int = 100, dim: Optional[int] = None, open_fn=None
) -> np.ndarray:
    """Decode and featurise ``batch_size`` files at a time, so at most one
    batch of pixels is resident (full CelebA decodes to about 24 GB). Every
    chunk must have the first chunk's image shape."""
    feat = _featurizer(cfg)
    feats, expected = [], None
    for i in range(0, len(files), batch_size):
        arr = _load_images(files[i : i + batch_size], dim, open_fn)
        if expected is None:
            expected = arr.shape[1:]
        elif arr.shape[1:] != expected:
            raise ValueError(
                f"mixed image sizes across the directory ({arr.shape[1:]} vs {expected} around "
                f"file #{i}); pass dim / --image-dim to resize uniformly"
            )
        feats.append(feat(arr))
    return np.concatenate(feats)


def precalculate(
    cfg: Config,
    image_dir: str,
    out_npz: str,
    limit: Optional[int] = None,
    batch_size: int = 100,
    dim: Optional[int] = None,
    save_features: int = 0,
) -> None:
    """Dataset -> ``mu``/``sigma`` npz; ``save_features=N`` also stores the
    first N raw feature rows (float16), which KID and PRDC need."""
    files, open_fn = _image_source(image_dir, cfg.image_ext)
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no images in {image_dir}")
    feats = compute_features_from_files(files, cfg, batch_size, dim=dim, open_fn=open_fn)
    mu, sigma = activation_statistics(feats)
    extra = {"features": feats[:save_features].astype(np.float16)} if save_features else {}
    np.savez_compressed(out_npz, mu=mu, sigma=sigma, **extra)
    print(f"pre-calculate: {len(files)} images -> {out_npz}")


def evaluate_generated(
    cfg: Config,
    gen_dir: str,
    stats_npz: str,
    log_path: str,
    batch_size: int = 100,
    dim: Optional[int] = None,
    with_is: bool = False,
    with_kid: bool = False,
    with_prdc: bool = False,
    prdc_k: int = 5,
) -> float:
    """Generated dir + stats npz -> FID, appended to ``log_path`` with a
    time stamp per line; ``with_is``/``with_kid``/``with_prdc`` add the
    Inception Score, KID and precision/recall/density/coverage from the
    same features (KID and PRDC need a stats npz with raw features).
    Returns the FID."""
    files = sorted(glob(os.path.join(gen_dir, "*.jpg"))) + sorted(glob(os.path.join(gen_dir, "*.png")))
    if not files:
        raise FileNotFoundError(f"no generated images in {gen_dir}")
    if not os.path.isfile(stats_npz):  # fail before minutes of feature compute
        raise FileNotFoundError(f"stats file {stats_npz} not found — run pre-calculate first")
    with np.load(stats_npz) as z:
        mu_r, sigma_r = z["mu"], z["sigma"]
        real_feats = z["features"] if "features" in z.files else None
    if (with_kid or with_prdc) and real_feats is None:
        raise ValueError(
            f"{'KID needs' if with_kid else 'precision/recall need'} raw real features but {stats_npz} has only "
            "(mu, sigma) — re-run pre-calculate with save_features/--save-features N"
        )
    feats = compute_features_from_files(files, cfg, batch_size, dim=dim)
    mu_g, sigma_g = activation_statistics(feats)
    fid = frechet_distance(mu_r, sigma_r, mu_g, sigma_g)
    lines = [f"{fid_label(cfg)}: {fid}"]
    if with_is:
        from littlegan_tpu_torch.eval.inception import class_probs_from_features
        from littlegan_tpu_torch.eval.inception_score import inception_score

        m, s = inception_score(class_probs_from_features(_inception_params(cfg)[0], feats))
        lines.append(f"{is_label(cfg)}: {m} +/- {s}")
        print(lines[-1])
    if with_kid:
        from littlegan_tpu_torch.eval.kid import kid

        m, s = kid(real_feats, feats)
        lines.append(f"KID{_tag(cfg)}: {m} +/- {s}")
        print(lines[-1])
    if with_prdc:
        from littlegan_tpu_torch.eval.prdc import prdc

        k = min(prdc_k, len(real_feats) - 1, len(feats) - 1)
        if k < prdc_k:
            print(f"prdc: lowering k {prdc_k} -> {k} for the small sample", file=sys.stderr)
        vals = prdc(np.asarray(real_feats, np.float64), feats, k=k)
        lines.append(
            f"PRDC{_tag(cfg)} (k={k}): precision={vals['precision']} recall={vals['recall']} "
            f"density={vals['density']} coverage={vals['coverage']}"
        )
        print(lines[-1])
    with open(log_path, "a") as f:
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        f.writelines(f"{stamp} {line}\n" for line in lines)
    return fid


def main(argv=None) -> int:
    from argparse import ArgumentParser

    from littlegan_tpu_torch.config import load_config

    p = ArgumentParser(prog="littlegan-tpu-torch-evaluate")
    p.add_argument("mode", type=str, help="pre-calculate or calc (anything else = calc)")
    p.add_argument("image_dir", type=str)
    p.add_argument("stats", type=str, help="npz path (output for pre-calculate, input for calc)")
    p.add_argument("model_dir", type=str, nargs="?", default="", help="unused; CLI-compat")
    p.add_argument("log", type=str, nargs="?", default="fid.log")
    p.add_argument("--gpu", type=str, default="", help="ignored (one card, or --device)")
    p.add_argument("--device", type=str, default=None, help="torch device (default: the CUDA card)")
    p.add_argument("-e", "--env", type=str, default="sample")
    p.add_argument("--image-dim", type=int, default=None,
                   help="center-crop + resize every image to this size before featurizing "
                   "(required when the directory mixes sizes)")
    p.add_argument("--is", dest="with_is", action="store_true",
                   help="also compute the Inception Score from the same features (calc mode)")
    p.add_argument("--kid", dest="with_kid", action="store_true",
                   help="also compute the Kernel Inception Distance (calc mode; needs a "
                   "stats npz written with --save-features)")
    p.add_argument("--prdc", dest="with_prdc", action="store_true",
                   help="also compute precision/recall/density/coverage (calc mode; "
                   "needs a stats npz written with --save-features)")
    p.add_argument("--prdc-k", type=int, default=5, help="k for the k-NN manifold radii (papers' default 5)")
    p.add_argument("--save-features", type=int, default=0,
                   help="pre-calculate mode: embed the first N raw feature rows in the "
                   "stats npz (enables --kid later)")
    args = p.parse_args(argv)
    cfg = load_config(args.env)  # fid_weights / image_ext come from env files
    if args.device is not None:
        cfg.extra["device"] = args.device
    if args.mode == "pre-calculate":
        precalculate(cfg, args.image_dir, args.stats, dim=args.image_dim, save_features=args.save_features)
    else:  # reference quirk: any mode but pre-calculate is calc
        fid = evaluate_generated(
            cfg, args.image_dir, args.stats, args.log, dim=args.image_dim, with_is=args.with_is,
            with_kid=args.with_kid, with_prdc=args.with_prdc, prdc_k=args.prdc_k,
        )
        print(f"{fid_label(cfg)}:", fid)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
