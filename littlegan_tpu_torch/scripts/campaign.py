"""Convergence campaign: long-horizon training with a pinned metric
trajectory, the counterpart of the JAX repo's ``scripts/campaign.py``.

Trains on the structured synthetic set (``make_structured_data.py``: each of
the 7 attribute bits controls a visible property, so conditioning can be
measured) over a long horizon through one ``Trainer`` (``device_data``, K
updates per CUDA graph replay), optionally with ``Config.cond_bias``
chasing the 7th (global-statistic) attribute. At each eval point
(``--eval-every`` epochs, and the last) it records:

  - the train losses (G/D/A) the trainer logged,
  - the generator's conditioning effect sizes (7 attributes, fixed noise,
    one bit flipped at a time: :func:`generator_effects`),
  - the adjuster's effect sizes on REAL images (:func:`adjuster_effects`),
  - the discriminator's condition-head accuracy on real images,
  - the FID, IS, KID and PRDC TREND between ``--fid-n`` generated images and
    the dataset, with the deterministic RANDOM-INIT Inception
    (``allow_random_fid``): self-consistent trends under the
    ``*_trend_random_init`` keys, NOT comparable to published FID (there is
    never a bare ``fid`` key).

The epoch with the best FID trend is pinned (``Trainer.pin_checkpoint``) so
checkpoint rotation keeps it; a resumed campaign re-pins it from the
trajectory. The JAX script's ``--no-donate`` (XLA buffer donation) has no
counterpart.

Usage:
  python -m littlegan_tpu_torch.scripts.campaign <exp> [--epochs N] [--eval-every K]
      [--cond-bias] [--data DIR] [--dim 128] [--n 6400] [--kernels]
Artifacts: <result-dir>/<exp>/campaign_trajectory.json (one record per
eval). Without a card it exits 2 (``--device cpu`` asks for the CPU
explicitly, for the tests).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List

import numpy as np


def region_means(x):
    """The mean intensity of each attribute's region or channel in a batch
    of [-1, 1] NHWC images, as one (7,) tensor on their device (the regions
    of ``make_structured_data.py::make_image``)."""
    import torch

    x = (x.float() + 1.0) / 2.0
    d = x.shape[1]
    return torch.stack([
        x[:, :, :, 0].mean(),
        x[:, d // 4: d // 2, :, 1].mean(),
        x[:, d // 2:, :, 2].mean(),
        x[:, d // 3: 2 * d // 3, d // 3: 2 * d // 3, :].mean(),
        x[:, d // 8: d // 4, :, :].mean(),
        x[:, : d // 4, : d // 4, :].mean(),
        x.mean(),
    ])


def gen_stats(model, noise, cond):
    """:func:`region_means` of the generator's images."""
    import torch

    with torch.inference_mode():
        return region_means(model.generator(noise, cond))


def adj_stats(model, image, cond):
    """:func:`region_means` of the adjuster's images."""
    import torch

    with torch.inference_mode():
        return region_means(model.adjuster(image, cond))


def generator_effects(model, noise, base_cond) -> List[float]:
    """Per attribute j: the region mean j of G's images with bit j on, less
    with every bit off (same noise)."""
    from littlegan_tpu_torch.utils.image import soft

    g_base = gen_stats(model, noise, base_cond).cpu().numpy()
    out = []
    for j in range(base_cond.shape[1]):
        c = base_cond.clone()
        c[:, j] = soft(1.0)
        out.append(float(gen_stats(model, noise, c).cpu().numpy()[j] - g_base[j]))
    return out


def adjuster_effects(model, images, cond_dim: int) -> List[float]:
    """Per attribute j: the region mean j of the adjuster's output on real
    ``images`` with target bit j on, less with it off (the others off)."""
    import torch

    from littlegan_tpu_torch.utils.image import soft

    rows = images.shape[0]
    out = []
    for j in range(cond_dim):
        off = torch.full((rows, cond_dim), (soft(-1.0) + 1) / 2, dtype=torch.float32, device=images.device)
        on = off.clone()
        on[:, j] = (soft(1.0) + 1) / 2
        s_on = adj_stats(model, images, on).cpu().numpy()
        s_off = adj_stats(model, images, off).cpu().numpy()
        out.append(float(s_on[j] - s_off[j]))
    return out


def main(argv=None) -> int:
    tmp = tempfile.gettempdir()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("exp")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--eval-every", type=int, default=10)
    p.add_argument("--cond-bias", action="store_true")
    p.add_argument("--ema", type=float, default=0.0, help="generator EMA decay (0 = off)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-pairs per update (effective batch = grad_accum * batch_size)")
    p.add_argument("--adj-half", action="store_true",
                   help="the adjuster on one alternating N-row batch per step (Config.adj_half_batch)")
    p.add_argument("--moment-dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--remat", action="store_true", help="recompute each network application in the backward")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="epoch-checkpoint cadence (Config.ckpt_every); align with --eval-every so evaluated "
                        "epochs stay pinnable")
    p.add_argument("--fid-n", type=int, default=1024,
                   help="generated images per FID/IS/KID trend eval (trends compare only at equal --fid-n)")
    p.add_argument("--eval-chunk", type=int, default=0,
                   help="generated images per generate+featurise call (0 = auto: 128 up to 512², 32 above)")
    p.add_argument("--eval-rows", type=int, default=0,
                   help="rows per effect-size stat batch (0 = auto: 64 up to 512², 32 above)")
    p.add_argument("--kernels", action="store_true", help="both kernel flags on (use_pallas, use_pallas_boundary)")
    p.add_argument("--data", default=os.path.join(tmp, "structured_celeba"))
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--n", type=int, default=6400)
    p.add_argument("--result-dir", default=os.path.join(tmp, "campaign_result"))
    p.add_argument("--device", default=None, help="'cpu' to run on the CPU; default: the card")
    args = p.parse_args(argv)

    eval_chunk = args.eval_chunk or (128 if args.dim <= 512 else 32)
    eval_rows = args.eval_rows or (64 if args.dim <= 512 else 32)
    if args.fid_n % eval_chunk:
        raise SystemExit(f"--fid-n {args.fid_n} must be a multiple of the eval chunk {eval_chunk} "
                         "(one generate->featurize call shape)")
    import torch

    if args.device is None and not torch.cuda.is_available():
        print("campaign: no CUDA device (--device cpu asks for the CPU explicitly)", file=sys.stderr)
        return 2
    from littlegan_tpu_torch.config import Config
    from littlegan_tpu_torch.data.celeba import CelebA
    from littlegan_tpu_torch.eval.fid import activation_statistics, frechet_distance
    from littlegan_tpu_torch.eval.inception import (
        class_probs_from_features, device_params, inception_features, init_inception_params,
    )
    from littlegan_tpu_torch.eval.inception_score import inception_score
    from littlegan_tpu_torch.eval.kid import kid
    from littlegan_tpu_torch.eval.prdc import prdc
    from littlegan_tpu_torch.scripts.make_structured_data import generate
    from littlegan_tpu_torch.training.trainer import Trainer
    from littlegan_tpu_torch.utils.device import resolve_device
    from littlegan_tpu_torch.utils.image import ensure_pm1, soft

    device = resolve_device(args.device)
    if not os.path.isdir(os.path.join(args.data, "img")):
        generate(args.data, args.n, args.dim)
    base = dict(
        exp_name=args.exp, mode="train", image_path=os.path.join(args.data, "img"),
        attr_path=os.path.join(args.data, "attrs.txt"), image_dim=args.dim,
        init_dim=args.dim // 16,  # 4 stride-2 encoder halvings (the reference's geometry)
        batch_size=args.batch_size, grad_accum=args.grad_accum, compute_dtype="bfloat16", device_data=True,
        # one dispatch takes 2*K*grad_accum batch ids: K = 8 only where the epoch holds them
        steps_per_dispatch=8 if args.n // args.batch_size >= 16 * args.grad_accum else 1,
        freq_gen=10_000_000, freq_test=10_000_000,  # the trainer's own artifacts off: the campaign evaluates
        all_result_dir=args.result_dir, test_data_dir=os.path.join(args.result_dir, "test-data"),
        restore=True, reuse=True, debug=True, ckpt_every=args.ckpt_every, keep_checkpoints=3,
        cond_bias=args.cond_bias, ema_decay=args.ema, adj_half_batch=args.adj_half,
        moment_dtype=args.moment_dtype, remat=args.remat, allow_random_fid=True,
        use_pallas=args.kernels, use_pallas_boundary=args.kernels,
    )

    # --- the dataset's statistics for the FID trend (random-init Inception, once) ---
    cfg0 = Config(**base)
    ds = CelebA(cfg0)
    incep_host = init_inception_params("", seed=0)
    incep = device_params(incep_host, device)

    def features_of(images_u8: np.ndarray) -> np.ndarray:
        return np.concatenate([inception_features(incep, torch.from_numpy(images_u8[i: i + 128]).to(device))
                               .cpu().numpy() for i in range(0, len(images_u8), 128)])

    stats_path = os.path.join(args.result_dir, f"ref_stats_{args.dim}.npz")
    if os.path.isfile(stats_path):
        with np.load(stats_path) as z:
            mu_r, sigma_r = z["mu"], z["sigma"]
            real_feats = z["features"] if "features" in z.files else None
    else:
        imgs = []
        it = ds.epoch_iterator(0)
        for _ in range(max(1, min(ds.batches, 2048 // cfg0.batch_size))):
            img, _ = next(it)
            imgs.append(img if img.dtype == np.uint8 else ((img + 1) * 127.5).astype(np.uint8))
        real_u8 = np.concatenate(imgs)
        real_feats = features_of(real_u8)
        mu_r, sigma_r = activation_statistics(real_feats)
        real_feats = real_feats[:1024].astype(np.float16)
        os.makedirs(args.result_dir, exist_ok=True)
        np.savez_compressed(stats_path, mu=mu_r, sigma=sigma_r, features=real_feats)
        print(f"dataset stats over {len(real_u8)} images -> {stats_path}")

    def gen_features(model, noise, cond) -> np.ndarray:
        """G -> uint8 (the truncating cast) -> Inception features, on the card."""
        with torch.inference_mode():
            img = model.generator(noise, cond).float()
            u8 = ((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
            return inception_features(incep, u8).cpu().numpy()

    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    eval_noise = t(rng.normal(size=(eval_rows, cfg0.noise_dim)))
    fid_noise = t(rng.normal(size=(args.fid_n, cfg0.noise_dim)))
    fid_cond = t(soft(np.where(rng.random((args.fid_n, cfg0.cond_dim)) < 0.5, -1.0, 1.0)))
    base_cond = torch.full((eval_rows, cfg0.cond_dim), soft(-1.0), dtype=torch.float32, device=device)
    real_img, real_cond = next(ds.epoch_iterator(1))
    real_rows = t(ensure_pm1(real_img)[:eval_rows])

    # ONE Trainer for the whole horizon; the evals run from its epoch callback,
    # so the card store and the captured graphs live across eval points.
    cfg = Config(**{**base, "epoch": args.epochs})
    tr = Trainer(cfg, ds, device=device)
    traj_path = os.path.join(cfg.result_dir, "campaign_trajectory.json")
    records = []
    if os.path.isfile(traj_path):
        with open(traj_path) as f:
            records = json.load(f)
    evaluated = {r["epoch"] for r in records}
    chunk_t0 = [time.time()]

    # keep the best-FID-trend epoch's checkpoint through rotation; on resume
    # re-pin it from the trajectory (pins live in one Trainer)
    best = [None, None]  # [fid, epoch]
    for r in records:
        if best[0] is None or r["fid_trend_random_init"] < best[0]:
            best[:] = [r["fid_trend_random_init"], r["epoch"]]
    if best[1] is not None:
        tr.pin_checkpoint(best[1])

    def _maybe_pin_best(fid_trend: float, epoch: int) -> None:
        if best[0] is not None and fid_trend >= best[0]:
            return
        if best[1] is not None:
            tr.unpin_checkpoint(best[1])
        tr.pin_checkpoint(epoch)
        best[:] = [fid_trend, epoch]

    def losses_since(step0: int) -> dict:
        """The mean of each loss the trainer logged after ``step0``."""
        from littlegan_tpu_torch.utils.tensorboard import read_scalars

        tr.writer.flush()
        scalars = read_scalars(os.path.join(cfg.result_dir, "log"))
        return {k: round(float(np.mean([v for s, v in series if s > step0])), 4)
                for k, series in scalars.items() if k.startswith("loss/") and any(s > step0 for s, _ in series)}

    last_step = [tr.global_step]

    def eval_point(epoch: int) -> None:
        if (epoch % args.eval_every != 0 and epoch != args.epochs) or epoch in evaluated:
            return
        train_secs = time.time() - chunk_t0[0]
        model = tr.eval_model()  # the EMA weights when enabled: what users sample
        gen_fx = [round(v, 4) for v in generator_effects(model, eval_noise, base_cond)]
        adj_fx = [round(v, 4) for v in adjuster_effects(model, real_rows, cfg.cond_dim)]
        _, d_cond = tr._call(tr._disc, real_rows)
        acc = float(((d_cond.float().cpu().numpy() > 0.5) == (real_cond[:eval_rows] > 0)).mean())

        gen_feats = np.concatenate([gen_features(model, fid_noise[i: i + eval_chunk], fid_cond[i: i + eval_chunk])
                                    for i in range(0, args.fid_n, eval_chunk)])
        mu_g, sigma_g = activation_statistics(gen_feats)
        fid_trend = float(frechet_distance(mu_r, sigma_r, mu_g, sigma_g))
        _maybe_pin_best(fid_trend, epoch)
        is_trend, _ = inception_score(class_probs_from_features(incep_host, gen_feats))
        kid_trend = kid(real_feats, gen_feats, subset_size=256, n_subsets=32)[0] if real_feats is not None else None
        prdc_trend = None
        if real_feats is not None and min(len(real_feats), len(gen_feats)) > 5:
            prdc_trend = {name: round(v, 4)
                          for name, v in prdc(np.asarray(real_feats, np.float64), gen_feats, k=5).items()}
        rec = {
            "epoch": epoch,
            "global_step": tr.global_step,
            "train_secs": round(train_secs, 1),
            "losses": losses_since(last_step[0]),
            "gen_effects": gen_fx,
            "gen_learned": int(sum(d > 0.02 for d in gen_fx)),
            "adj_effects": adj_fx,
            "adj_learned": int(sum(d > 0.02 for d in adj_fx)),
            "d_cond_acc": round(acc, 4),
            "fid_trend_random_init": round(fid_trend, 3),
            "is_trend_random_init": round(is_trend, 4),
            "kid_trend_random_init": round(kid_trend, 6) if kid_trend is not None else None,
            "prdc_trend_random_init": prdc_trend,
            "cond_bias": args.cond_bias,
            "ema_decay": args.ema,
            "batch_size": args.batch_size,
            "grad_accum": args.grad_accum,
            "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        }
        records.append(rec)
        evaluated.add(epoch)
        with open(traj_path, "w") as f:
            json.dump(records, f, indent=1)
        print("EVAL", json.dumps(rec), flush=True)
        chunk_t0[0] = time.time()
        last_step[0] = tr.global_step

    tr.train(epoch_callback=eval_point)
    print(f"trajectory -> {traj_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
