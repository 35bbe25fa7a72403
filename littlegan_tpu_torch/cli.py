"""Command line of the port: ``python -m littlegan_tpu_torch <mode> <exp_name> ...``.

The same surface as ``python -m littlegan_tpu`` (the reference's
``main.py <mode> <exp_name> [-e ENV] [-g GPUS] [--debug]``), all eleven
modes: ``train``, ``plot``, ``visual``, ``random-sample``, ``evaluate``,
``condition-sample``, ``evaluate-sample``, ``export-model``,
``interpolate``, ``serve`` and ``report``. A mode runs on the card;
``--device cpu`` runs it on the CPU instead. ``evaluate`` runs in-process
(the reference shells out to evaluate.py). One card only: ``--devices``
above 1 (multi-GPU) exits 2.
"""

from __future__ import annotations

import json
import os
import sys
import time
from argparse import ArgumentParser
from typing import Optional, Sequence

import numpy as np

from littlegan_tpu_torch.config import MODES, Config, load_config

# the reference's 8 hand-picked 7-bit attribute rows for condition-sample
CONDITION_ROWS = np.array(
    [
        [0, 0, 0, 0, 0, 1, 0],
        [0, 0, 0, 0, 0, 1, 1],
        [0, 0, 0, 0, 0, 0, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 0, 0, 0, 1, 0, 1],
        [1, 0, 1, 0, 1, 0, 1],
        [1, 1, 1, 0, 1, 0, 1],
        [1, 1, 1, 1, 1, 0, 1],
    ],
    np.float32,
)


def build_parser() -> ArgumentParser:
    p = ArgumentParser(prog="littlegan-tpu-torch", description="LittleGAN on PyTorch / CUDA")
    p.add_argument("mode", type=str, choices=list(MODES), help="run mode")
    p.add_argument("exp_name", type=str, help="experiment name")
    p.add_argument("-e", "--env", type=str, default="sample", help="config environment")
    p.add_argument("-g", "--gpu", type=str, default="", help="ignored (one card, or --device)")
    p.add_argument("--debug", action="store_true", help="ignore dirty git tree")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None, dest="epoch")
    p.add_argument("--batch-size", type=int, default=None, dest="batch_size")
    p.add_argument("--synthetic-data", action="store_true", help="use the synthetic dataset")
    p.add_argument("--device", type=str, default=None, help="torch device (default: the CUDA card)")
    # serve-mode knobs (ignored by every other mode; the full set is on
    # `python -m littlegan_tpu_torch.serving`)
    p.add_argument("--port", type=int, default=8600, help="serve/visual mode: HTTP port")
    p.add_argument("--reload-every", type=float, default=0.0, dest="reload_every",
                   help="serve mode: poll + hot-swap new checkpoints every N seconds")
    p.add_argument("--devices", type=int, default=None, dest="serve_devices",
                   help="serve mode: cards per device call (one card only: above 1 is refused)")
    return p


def parse_config(argv: Optional[Sequence[str]] = None) -> Config:
    args = build_parser().parse_args(argv)
    if args.env != "sample" and not os.path.isfile(f"{args.env}.config.json"):
        raise FileNotFoundError(
            f"config environment {args.env!r}: no {args.env}.config.json in {os.getcwd()} "
            "(config files are looked up in the current working directory)"
        )
    overrides = {
        k: v for k, v in vars(args).items()
        if v is not None and k not in ("synthetic_data", "gpu", "device", "debug", "port", "reload_every",
                                       "serve_devices")
    }
    cfg = load_config(args.env, overrides)
    if args.debug:
        cfg = cfg.replace(debug=True)
    if args.synthetic_data:
        cfg.extra["synthetic_data"] = True
    if args.device is not None:
        cfg.extra["device"] = args.device
    if cfg.mode in ("serve", "visual"):
        cfg.extra.setdefault("serve_port", args.port)
        cfg.extra.setdefault("serve_reload_every", args.reload_every)
    if args.serve_devices is not None:
        cfg.extra["serve_devices"] = args.serve_devices
    return cfg


def make_dataset(cfg: Config):
    """Synthetic data only on request; else CelebA from ``image_path``."""
    if cfg.extra.get("synthetic_data"):
        from littlegan_tpu_torch.data import SyntheticDataset

        n = max(4 * cfg.batch_size, 64)
        print(f"Using SyntheticDataset ({n} items)")
        return SyntheticDataset(cfg, num_items=n)
    is_zip = os.path.isfile(cfg.image_path) and cfg.image_path.lower().endswith(".zip")
    if not (os.path.isdir(cfg.image_path) or is_zip):
        raise FileNotFoundError(
            f"image_path {cfg.image_path!r} is not a directory or .zip archive; "
            f"pass --synthetic-data to run without CelebA"
        )
    from littlegan_tpu_torch.data import CelebA

    return CelebA(cfg)


def _batches(data, cfg: Config, n: int):
    """``n`` (image, cond) batches from the dataset's epoch 0 order,
    re-iterating (epoch b + 1) when a short dataset runs out."""
    it = data.epoch_iterator(0)
    for b in range(n):
        batch = next(it, None)
        if batch is None:
            it = data.epoch_iterator(b + 1)
            batch = next(it, None)
            if batch is None:
                raise ValueError(
                    f"dataset yields ZERO full batches (needs >= {cfg.batch_size} images); "
                    "add data or lower batch_size"
                )
        yield batch


def _visual(cfg: Config) -> None:
    """TensorBoard on the run's log directory; without a tensorboard
    binary, the built-in HTML report served and regenerated per request."""
    import subprocess

    logdir = os.path.join(cfg.result_dir, "log")
    print("The result path is", logdir)
    try:  # an argv list: exp_name is user input and must stay one --logdir value
        rc = subprocess.run(["tensorboard", "--host", "0.0.0.0", "--logdir", logdir]).returncode
    except KeyboardInterrupt:  # the user stopped a working server
        rc = 0
    except FileNotFoundError:
        rc = 127
    if rc == 127:
        from littlegan_tpu_torch import report

        print(f"tensorboard unavailable; serving the built-in report instead (event files are "
              f"TensorBoard-format at {logdir})")
        report.serve_report(cfg, port=int(cfg.extra.get("serve_port", 8600)))
    elif rc not in (0, 130, -2):  # 130 / -SIGINT: Ctrl-C on a working server
        print("tensorboard unavailable; event files are TensorBoard-format at", logdir)


def _evaluate_sample(cfg: Config, trainer, data) -> None:
    """``evaluate_sample_size`` images through ``sample_u8``, numbered from
    1: ``evaluate/gen/<i>.jpg``, ``evaluate/adj/{real,fake}_<i>.jpg`` and one
    ``evaluate/disc/<batch>.json`` of D's scores per batch."""
    from littlegan_tpu_torch.utils.image import BatchImageWriter

    out = os.path.join(cfg.result_dir, "evaluate")
    batches = int(np.ceil(cfg.evaluate_sample_size / cfg.batch_size))
    rng = np.random.default_rng(cfg.seed)
    base = 1
    with BatchImageWriter() as writer:  # JPEG encoding overlaps the card's next batch
        for b, (image, cond) in enumerate(_batches(data, cfg, batches)):
            noise = rng.normal(size=(cond.shape[0], cfg.noise_dim)).astype(np.float32)
            gen, scores, adj_real, adj_fake = trainer.sample_u8(noise, cond, image)
            with open(os.path.join(out, "disc", f"{b}.json"), "w") as f:
                json.dump(scores, f)
            for i in range(gen.shape[0]):
                writer.save(gen[i], os.path.join(out, "gen", f"{base + i}.jpg"))
                if adj_real is not None:
                    writer.save(adj_real[i], os.path.join(out, "adj", f"real_{base + i}.jpg"))
                    writer.save(adj_fake[i], os.path.join(out, "adj", f"fake_{base + i}.jpg"))
            base += gen.shape[0]
            if (b + 1) % 50 == 0:
                print(f"evaluate-sample: {b + 1}/{batches} batches")


def _evaluate(cfg: Config) -> None:
    """FID (and the ``eval_metrics`` asked for) of ``evaluate/gen`` and,
    with the adjuster, ``evaluate/adj`` against the pre-calculated stats."""
    from littlegan_tpu_torch.eval.evaluate import evaluate_generated, fid_label

    known = {"fid", "is", "kid", "prdc"}
    metrics = {m.lower() for m in cfg.eval_metrics}
    if not metrics <= known:
        raise ValueError(f"unknown eval_metrics {sorted(metrics - known)}; choose from {sorted(known)}")
    stats = os.path.join(cfg.test_data_dir, cfg.evaluate_pre_calculated)
    for sub, log in (("gen", "fid-gen.log"), ("adj", "fid-adj.log")):
        if sub == "adj" and not cfg.train_adj:
            continue
        fid = evaluate_generated(
            cfg, os.path.join(cfg.result_dir, "evaluate", sub), stats,
            os.path.join(cfg.result_dir, "evaluate", log),
            with_is="is" in metrics, with_kid="kid" in metrics, with_prdc="prdc" in metrics,
        )
        print(f"{fid_label(cfg)} ({sub}): {fid}")


def _condition_sample(cfg: Config, trainer) -> None:
    """One noise row against the reference's 8 attribute rows (random rows
    for another ``cond_dim``), ``condition_sample_batch`` times, each a
    1 x 8 grid ``sample/condition-gen-<i>.jpg``."""
    from littlegan_tpu_torch.utils.image import save_image

    cond = CONDITION_ROWS
    if cfg.cond_dim != 7:
        cond = (np.random.default_rng(cfg.seed).random((8, cfg.cond_dim)) < 0.5).astype(np.float32)
    rng = np.random.default_rng(cfg.seed)
    for i in range(1, 1 + cfg.condition_sample_batch):
        noise = np.repeat(rng.normal(size=(1, cfg.noise_dim)), 8, 0).astype(np.float32)
        save_image(trainer.generate(noise, cond), os.path.join(cfg.result_dir, "sample", f"condition-gen-{i}.jpg"),
                   (1, 8))


def _interpolate(cfg: Config, trainer) -> None:
    """A latent slerp grid (``interpolate_rows`` pairs x ``interpolate_steps``)
    at a fixed random condition and, with the adjuster, a sweep of each
    attribute from soft(-1) to soft(+1) on one generated image."""
    from littlegan_tpu_torch.utils.image import save_image, soft
    from littlegan_tpu_torch.utils.latent import slerp

    rows, steps = cfg.interpolate_rows, cfg.interpolate_steps
    if rows < 1 or steps < 2:
        raise ValueError(
            f"interpolate needs interpolate_rows >= 1 and interpolate_steps >= 2, got {rows}/{steps}"
        )
    rng = np.random.default_rng(cfg.seed)
    now = int(time.time())
    t = np.linspace(0.0, 1.0, steps, dtype=np.float32)
    z0 = rng.normal(size=(rows, cfg.noise_dim)).astype(np.float32)
    z1 = rng.normal(size=(rows, cfg.noise_dim)).astype(np.float32)
    # batch order [t0 r0..rN, t1 r0..rN, ...]: the grid fills columns downward
    z = slerp(z0, z1, t).reshape(steps * rows, cfg.noise_dim)
    row_cond = soft(np.where(rng.random((rows, cfg.cond_dim)) < 0.5, -1.0, 1.0)).astype(np.float32)
    gen = trainer.generate(z, np.tile(row_cond, (steps, 1)))
    save_image(gen, os.path.join(cfg.result_dir, "sample", f"interpolate-z-{now}.jpg"), (rows, steps))
    if cfg.train_adj:
        base_z = rng.normal(size=(1, cfg.noise_dim)).astype(np.float32)
        base_cond = soft(np.where(rng.random((1, cfg.cond_dim)) < 0.5, -1.0, 1.0)).astype(np.float32)
        base = trainer.generate(base_z, base_cond)
        sweep = np.tile(base_cond, (steps * cfg.cond_dim, 1))
        for j in range(cfg.cond_dim):  # column t of row j: attribute j forced to soft(2t - 1)
            sweep[np.arange(steps) * cfg.cond_dim + j, j] = soft(2.0 * t - 1.0)
        adj = trainer.adjust(np.tile(base, (steps * cfg.cond_dim, 1, 1, 1)), sweep)
        save_image(adj, os.path.join(cfg.result_dir, "sample", f"interpolate-attr-{now}.jpg"), (cfg.cond_dim, steps))
    print(f"interpolate grids -> {os.path.join(cfg.result_dir, 'sample')}")


def _random_sample(cfg: Config, trainer, data) -> None:
    """``random_sample_batch`` dataset batches through ``predict``: the
    generated grid, D's scores, the adjusted grid and the inputs' npz."""
    from littlegan_tpu_torch.utils.image import ensure_pm1

    now = int(time.time())
    rng = np.random.default_rng(cfg.seed)
    out = os.path.join(cfg.result_dir, "sample")
    for b, (image, cond) in enumerate(_batches(data, cfg, cfg.random_sample_batch)):
        image = ensure_pm1(image)
        noise = rng.normal(size=(cond.shape[0], cfg.noise_dim)).astype(np.float32)
        trainer.predict(
            noise, cond, image, os.path.join(out, f"generator-{now}-{b}.jpg"),
            os.path.join(out, f"discriminator-{now}-{b}.json"), os.path.join(out, f"adjuster-{now}-{b}.jpg"),
        )
        np.savez_compressed(os.path.join(out, f"input_data-{now}-{b}.npz"), n=noise, c=cond, i=image)


def main(argv: Optional[Sequence[str]] = None) -> int:
    cfg = parse_config(argv)
    devices = cfg.extra.get("serve_devices")
    if devices is not None and devices > 1:
        print(f"--devices {devices}: multi-GPU is not ported yet (ROADMAP A13); the port runs on one card",
              file=sys.stderr)
        return 2
    print("Application Params:", json.dumps(cfg.to_json_dict(), default=str)[:500])
    print("Running Mode:", cfg.mode)
    device = cfg.extra.get("device")

    if cfg.mode == "visual":
        _visual(cfg)
        return 0
    if cfg.mode == "report":
        from littlegan_tpu_torch.report import generate_report

        generate_report(cfg)
        return 0
    if cfg.mode == "evaluate":
        _evaluate(cfg)
        return 0
    if cfg.mode == "serve":
        from littlegan_tpu_torch.serving import serve

        serve(cfg.replace(restore=True), port=int(cfg.extra.get("serve_port", 8600)), batch_size=cfg.batch_size,
              reload_every_s=float(cfg.extra.get("serve_reload_every", 0.0)), device=device)
        return 0

    from littlegan_tpu_torch.training.trainer import Trainer

    if cfg.mode == "train":
        from littlegan_tpu_torch.utils.provenance import ensure_clean_tree

        ensure_clean_tree(cfg)
        data = make_dataset(cfg)
        print("Using Attribute:", data.label)
        Trainer(cfg, data, device=device).train()
        return 0
    cfg = cfg.replace(reuse=True, restore=True)
    if cfg.mode in ("random-sample", "evaluate-sample"):
        data = make_dataset(cfg)
        trainer = Trainer(cfg, data, device=device)
        (_random_sample if cfg.mode == "random-sample" else _evaluate_sample)(cfg, trainer, data)
        return 0
    trainer = Trainer(cfg, None, device=device)
    if cfg.mode == "plot":
        print(trainer.plot())
    elif cfg.mode == "condition-sample":
        _condition_sample(cfg, trainer)
    elif cfg.mode == "interpolate":
        _interpolate(cfg, trainer)
    else:  # export-model
        print("Exported weights-only checkpoint to", trainer.export_model_checkpoint())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
