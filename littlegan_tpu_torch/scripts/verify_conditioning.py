"""Conditioning sanity check on a trained checkpoint, the counterpart of the
JAX package's ``scripts/verify_conditioning.py`` line for line.

Generates images with one attribute bit flipped (+1 vs -1, others fixed) and
measures the attribute's visual statistic in the generated images, plus the
discriminator cond-head's agreement with ground-truth labels on real images.
Designed for the structured synthetic dataset
(``python -m littlegan_tpu_torch.scripts.make_structured_data``, the port's
own copy of the JAX repo's script: each of the 7 selected bits controls a
visible property), but the D-head check works on any dataset. It runs
through the port's ``serving.InferenceEngine`` (batch 64), so on the card
the forwards run the kernels the config's flags select.

Usage: run from a directory containing the experiment's sample.config.json:
    python -m littlegan_tpu_torch.scripts.verify_conditioning <exp_name> [--device cpu]
"""

import argparse

import numpy as np


def stat(images, j):
    """Mean intensity in the region/channel attribute j controls."""
    x = (images + 1.0) / 2.0  # [0,1]
    d = x.shape[1]
    regions = [
        x[:, :, :, 0],                       # 0: red tint
        x[:, :, d // 4 : d // 2, 1],         # 1: green stripe
        x[:, d // 2 :, :, 2],                # 2: blue bottom
        x[:, d // 3 : 2 * d // 3, d // 3 : 2 * d // 3, :],  # 3: center square
        x[:, d // 8 : d // 4, :, :],         # 4: bright band
        x[:, : d // 4, : d // 4, :],         # 5: checker corner
        x,                                   # 6: global brightness
    ]
    return float(np.mean(regions[j % len(regions)]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("exp", nargs="?", default="struct")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU; default: the card")
    args = ap.parse_args(argv)

    from littlegan_tpu_torch.config import load_config
    from littlegan_tpu_torch.data.celeba import CelebA
    from littlegan_tpu_torch.serving import InferenceEngine
    from littlegan_tpu_torch.utils.image import ensure_pm1, soft

    cfg = load_config("sample", {"exp_name": args.exp, "mode": "verify"})
    engine = InferenceEngine(cfg, batch_size=64, device=args.device)

    # --- generator conditioning: flip one bit, fixed noise, measure shift ---
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(64, cfg.noise_dim)).astype(np.float32)
    base = np.full((64, cfg.cond_dim), soft(-1.0), np.float32)

    print("generator conditioning (stat with bit=+1 minus bit=-1; positive = learned):")
    learned = 0
    for j in range(cfg.cond_dim):
        c_plus = base.copy()
        c_plus[:, j] = soft(1.0)
        s_plus = stat(engine.generate(c_plus, noise), j)
        s_minus = stat(engine.generate(base, noise), j)
        delta = s_plus - s_minus
        learned += delta > 0.02
        print(f"  attr{j}: {delta:+.4f}")
    print(f"  => {learned}/{cfg.cond_dim} attributes visibly conditioned")

    # --- discriminator cond head vs ground truth on real images ---
    ds = CelebA(cfg)
    img, cond = next(ds.epoch_iterator(0))
    real = ensure_pm1(img)[: engine.batch]
    d = engine.discriminate(real)
    pred = (d["cond"][: cond.shape[0]] > 0.5).astype(np.float32)
    truth = (cond[: engine.batch] > 0).astype(np.float32)
    acc = float((pred[: truth.shape[0]] == truth[: pred.shape[0]]).mean())
    print(f"discriminator cond-head accuracy on real images: {acc:.3f}")

    # --- adjuster conditioning: adjust REAL images toward bit j on/off ---
    # training feeds the adjuster conds remapped to ~[0,1]
    # (eager_trainer.py:155-156): on ~= (soft(1)+1)/2, off ~= (soft(-1)+1)/2
    n = real.shape[0]
    print("adjuster conditioning (stat with bit on minus off on ADJUSTED reals):")
    learned = 0
    for j in range(cfg.cond_dim):
        on = np.full((n, cfg.cond_dim), (soft(-1.0) + 1) / 2, np.float32)
        off = on.copy()
        on[:, j] = (soft(1.0) + 1) / 2
        s_on = stat(engine.adjust(real, on), j)
        s_off = stat(engine.adjust(real, off), j)
        delta = s_on - s_off
        learned += delta > 0.02
        print(f"  attr{j}: {delta:+.4f}")
    print(f"  => {learned}/{cfg.cond_dim} attributes adjustable")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
