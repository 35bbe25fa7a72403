"""Command line of the port: ``python -m littlegan_tpu_torch <mode> <exp_name> ...``.

The same surface as ``python -m littlegan_tpu`` (the reference's
``main.py <mode> <exp_name> [-e ENV] [-g GPUS] [--debug]``). Only ``train``
is ported; every other mode exits with status 2 and says so. ``train``
runs on the card; ``--device cpu`` runs it on the CPU instead.
"""

from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser
from typing import Optional, Sequence

from littlegan_tpu_torch.config import MODES, Config, load_config

PORTED_MODES = ("train",)


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
        if v is not None and k not in ("synthetic_data", "gpu", "device", "debug")
    }
    cfg = load_config(args.env, overrides)
    if args.debug:
        cfg = cfg.replace(debug=True)
    if args.synthetic_data:
        cfg.extra["synthetic_data"] = True
    if args.device is not None:
        cfg.extra["device"] = args.device
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


def main(argv: Optional[Sequence[str]] = None) -> int:
    cfg = parse_config(argv)
    if cfg.mode not in PORTED_MODES:
        print(f"mode {cfg.mode!r} is not ported yet (ROADMAP A9); ported: {', '.join(PORTED_MODES)}",
              file=sys.stderr)
        return 2
    print("Application Params:", json.dumps(cfg.to_json_dict(), default=str)[:500])
    print("Running Mode:", cfg.mode)
    from littlegan_tpu_torch.training.trainer import Trainer
    from littlegan_tpu_torch.utils.provenance import ensure_clean_tree

    ensure_clean_tree(cfg)
    data = make_dataset(cfg)
    print("Using Attribute:", data.label)
    Trainer(cfg, data, device=cfg.extra.get("device")).train()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
