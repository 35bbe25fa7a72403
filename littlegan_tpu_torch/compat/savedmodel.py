"""Export trained models as a TensorFlow SavedModel.

The port of littlegan_tpu/compat/savedmodel.py. The JAX package converts
its forwards with ``jax2tf``; PyTorch has no such converter, so here the
three forwards are written in TF ops over the port's float32 weights
(numpy arrays, baked in as constants): the 5x5 stride-2 SAME ``conv2d`` and
``conv2d_transpose`` with the kernel layouts the port keeps (HWIO; HWOI for
transposed convs, TF's own ``conv2d_transpose`` layout), the per-sample
instance norm over all non-batch axes with scalar gamma/beta (one-pass
variance, eps on the std), LeakyReLU, the dense heads, tanh and sigmoid.
The plain 5x5 convs stand in for the port's space-to-depth boundary
convs, which are exact rearrangements of them. Named signatures, as the JAX
export writes them:

- ``generate(noise[b,noise_dim], cond[b,cond_dim]) -> image [b,H,W,3]``
- ``adjust(image[b,H,W,3], cond[b,cond_dim]) -> image [b,H,W,3]``
- ``discriminate(image[b,H,W,3]) -> {'pr': [b,1], 'cond': [b,cond_dim]}``

The batch is ``None`` in every ``TensorSpec``, so one export serves any
batch size. Images are [-1,1] float32 NHWC. Weights are the EMA generator
parts when the checkpoint carries them (``training/state.py::eval_params``).
TensorFlow is imported lazily; the rest of the port works without it (the
card's host has none, so this export runs on a host with TensorFlow).

    python -m littlegan_tpu_torch.compat.savedmodel <exp> [-e ENV] [--out DIR] \\
        [--only generate,adjust,discriminate] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Mapping, Optional

import numpy as np

from littlegan_tpu_torch.config import Config


def _tf_forwards(tf, cfg: Config, p: Dict[str, Any]):
    """The generator, adjuster and discriminator of ``cfg`` in TF ops over
    ``p`` (the port's parameter names): numpy arrays, baked in as
    constants, or ``tf.Variable``s, read at each call
    (``compat/tf_reference_step.py`` trains them)."""
    alpha = cfg.leaky_alpha
    const = {k: v if isinstance(v, tf.Variable) else tf.constant(v) for k, v in p.items()}

    def norm(x, pre):
        axes = list(range(1, len(x.shape)))
        mean = tf.reduce_mean(x, axes, keepdims=True)
        var = tf.maximum(tf.reduce_mean(tf.square(x), axes, keepdims=True) - tf.square(mean), 0.0)
        return (x - mean) / (tf.sqrt(var) + 1e-3) * const[f"{pre}.gamma"] + const[f"{pre}.beta"]

    def lrelu(x):
        return tf.nn.leaky_relu(x, alpha)

    def conv(x, pre, stride):
        return tf.nn.conv2d(x, const[f"{pre}.kernel"], stride, "SAME") + const[f"{pre}.bias"]

    def deconv(x, pre, stride):
        k = const[f"{pre}.kernel"]
        s = tf.shape(x)
        out = tf.stack([s[0], s[1] * stride, s[2] * stride, k.shape[2]])
        return tf.nn.conv2d_transpose(x, k, out, stride, "SAME") + const[f"{pre}.bias"]

    def dense(x, pre):
        return tf.matmul(x, const[f"{pre}.kernel"]) + const[f"{pre}.bias"]

    def encoder(x):
        maps = []
        for i in range(1, 5):
            x = lrelu(norm(conv(x, f"encoder.block{i}.conv", 2), f"encoder.block{i}.norm"))
            maps.append(x)
        return maps

    def decoder(x, skips):
        for i in range(1, 5):
            if skips[i - 1] is not None:
                x = x + skips[i - 1]
            x = lrelu(norm(deconv(x, f"decoder.block{i}.conv", 2), f"decoder.block{i}.norm"))
        return x

    def out_conv(x, cond):
        y = deconv(x, "out_conv", 1)
        if cfg.cond_bias:
            y = y + tf.matmul(cond, const["out_conv.cond_kernel"])[:, None, None, :]
        return tf.tanh(y)

    shape = [-1, cfg.init_dim, cfg.init_dim, cfg.conv_filter[0]]

    def generate(noise, cond):
        x = lrelu(dense(tf.concat([noise, cond], -1), "g_head.dense"))
        x = norm(tf.reshape(x, shape), "g_head.norm")
        return out_conv(decoder(x, [None] * 4), cond)

    def adjust(image, cond):
        maps = encoder(image)
        c = norm(lrelu(dense(cond, "adj_head.dense")), "adj_head.norm")
        return out_conv(decoder(tf.reshape(c, shape), maps[::-1]), cond)

    def discriminate(image):
        fmap = encoder(image)[-1]
        flat = tf.reshape(fmap, [tf.shape(fmap)[0], -1])
        return {"pr": tf.sigmoid(dense(flat, "d_head.pr")), "cond": tf.sigmoid(dense(flat, "d_head.cond"))}

    return generate, adjust, discriminate


def export_saved_model(
    cfg: Config,
    params: Mapping[str, Any],
    out_dir: str,
    include: tuple = ("generate", "adjust", "discriminate"),
) -> str:
    """Write a SavedModel of ``params`` to ``out_dir``; returns ``out_dir``.

    ``params``: ``name -> tensor`` for the whole model (pass
    ``eval_params(state)`` for the EMA weights). ``include``: which
    signatures to export.
    """
    try:
        import tensorflow as tf
    except ImportError as e:  # pragma: no cover - env-dependent
        raise ImportError("SavedModel export needs tensorflow") from e

    arrays = {k: v.detach().float().cpu().numpy() for k, v in params.items()}
    generate, adjust, discriminate = _tf_forwards(tf, cfg, arrays)
    h = w = cfg.image_dim
    c = cfg.image_channel
    spec_noise = tf.TensorSpec([None, cfg.noise_dim], tf.float32, name="noise")
    spec_cond = tf.TensorSpec([None, cfg.cond_dim], tf.float32, name="cond")
    spec_image = tf.TensorSpec([None, h, w, c], tf.float32, name="image")

    module = tf.Module()
    signatures: Dict[str, Any] = {}

    def add(name, fn, specs):
        tf_fn = tf.function(fn, autograph=False, input_signature=specs)
        setattr(module, name, tf_fn)
        signatures[name] = tf_fn.get_concrete_function(*specs)

    if "generate" in include:
        add("generate", generate, [spec_noise, spec_cond])
    if "adjust" in include:
        add("adjust", adjust, [spec_image, spec_cond])
    if "discriminate" in include:
        add("discriminate", discriminate, [spec_image])
    if not signatures:
        raise ValueError(f"nothing to export: include={include!r}")

    os.makedirs(out_dir, exist_ok=True)
    tf.saved_model.save(module, out_dir, signatures=signatures)
    return out_dir


def export_experiment(cfg: Config, out_dir: Optional[str] = None, device=None, **kw) -> str:
    """Export the experiment's latest checkpoint (EMA weights when present).

    Restores like the trainer does (``restore_latest`` over
    ``result/<exp>/checkpoint``, the state on ``device``: the card unless
    ``device="cpu"``), picks ``eval_params``, writes the SavedModel to
    ``out_dir`` (default ``result/<exp>/model/savedmodel``).
    """
    from littlegan_tpu_torch.training.checkpoint import make_checkpointer
    from littlegan_tpu_torch.training.state import create_train_state, eval_params
    from littlegan_tpu_torch.utils.device import resolve_device

    template = create_train_state(cfg, resolve_device(device))
    state, _ = make_checkpointer(cfg, os.path.join(cfg.result_dir, "checkpoint")).restore_latest(template)
    if state is None:
        raise FileNotFoundError(
            f"no checkpoint under {cfg.result_dir}/checkpoint — train first (or convert a reference "
            "checkpoint, python -m littlegan_tpu_torch.compat.reference_checkpoint import)"
        )
    if out_dir is None:
        out_dir = os.path.join(cfg.result_dir, "model", "savedmodel")
    return export_saved_model(cfg, eval_params(state), out_dir, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m littlegan_tpu_torch.compat.savedmodel",
                                 description="Export an experiment's latest checkpoint as a TensorFlow SavedModel.")
    ap.add_argument("exp_name")
    ap.add_argument("-e", "--env", default="sample")
    ap.add_argument("--out", default=None, help="output dir (default result/<exp>/model/savedmodel)")
    ap.add_argument("--only", default="generate,adjust,discriminate",
                    help="comma-separated subset of signatures to export")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from littlegan_tpu_torch.config import load_config

    cfg = load_config(env=args.env, overrides={"exp_name": args.exp_name, "mode": "export-model"})
    include = tuple(s.strip() for s in args.only.split(",") if s.strip())
    out = export_experiment(cfg, out_dir=args.out, device=args.device, include=include)
    print(f"SavedModel written to {out} (signatures: {', '.join(include)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
