"""The reference's training step in TensorFlow, over the port's weights.

The reference trains with three ``tf.GradientTape``s
(eager_trainer.py:115-169): the generator's and the discriminator's around
one forward (fake from noise and batch 2's conditions, D on the augmented
real batch and on fake), the adjuster's around its own (the adjuster on
``[img1, stop_gradient(fake)]`` toward ``[cond2, cond1]``, D on its
output); D's gradients clipped to +-``clip_range``; three TF-v1 Adams
(G and D with ``beta_1``/``beta_2``, the adjuster with the defaults).
:class:`TFReferenceStep` runs that recipe on ``tf.Variable``s made from a
port parameter set (the port's names, ``compat/reference_checkpoint.py``'s
mapping: HWIO conv kernels, HWOI transposed ones, (in, out) dense
kernels), through the forwards of ``compat/savedmodel.py::_tf_forwards``
and the TF 1.15 Keras binary cross-entropy (clip to [eps, 1 - eps], back to
logits, ``sigmoid_cross_entropy_with_logits``).

It is the TF side of ``scripts/baseline_anchor.py``, a same-host CPU
comparison; TensorFlow is imported when a step is built, and the port
otherwise runs without it (the card's host has none).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from littlegan_tpu_torch.compat.savedmodel import _tf_forwards
from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.utils.image import soft

# the port's top-level modules of each optimizer's variables (training/state.py's groups)
GROUPS = {"d": ("encoder", "d_head"), "g": ("g_head", "decoder", "out_conv"), "a": ("adj_head",)}


def import_tensorflow():
    """TensorFlow on the CPU only (its GPUs hidden), or a clear error."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("the TensorFlow reference step needs tensorflow, which this host lacks "
                          "(it runs on a CPU host with TensorFlow; the card's host has none)") from e
    tf.config.set_visible_devices([], "GPU")
    return tf


class TFReferenceStep:
    """The reference recipe on ``tf.Variable``s holding ``params``
    (``name -> array``, the port's names). :meth:`grads` gives one step's
    losses and per-variable gradients, :meth:`step` applies them."""

    def __init__(self, cfg: Config, params: Mapping[str, np.ndarray]):
        tf = import_tensorflow()
        self.tf, self.cfg = tf, cfg
        self.vars = {k: tf.Variable(np.asarray(v, np.float32)) for k, v in params.items()}
        self.generate, self.adjust, self.discriminate = _tf_forwards(tf, cfg, self.vars)
        self.names = {g: [k for k in self.vars if k.split(".")[0] in mods] for g, mods in GROUPS.items()}
        adam = tf.compat.v1.train.AdamOptimizer
        self.opts = {"g": adam(cfg.lr, cfg.beta_1, cfg.beta_2), "d": adam(cfg.lr, cfg.beta_1, cfg.beta_2),
                     "a": adam(cfg.lr)}

    def bce(self, t, p):
        """TF 1.15's Keras binary cross-entropy, meaned over the batch."""
        tf = self.tf
        eps = 1e-7
        p = tf.clip_by_value(tf.convert_to_tensor(p, tf.float32), eps, 1.0 - eps)
        per = tf.nn.sigmoid_cross_entropy_with_logits(labels=tf.convert_to_tensor(t, tf.float32),
                                                      logits=tf.math.log(p / (1.0 - p)))
        return tf.reduce_mean(tf.reduce_mean(per, axis=-1))

    def grads(self, img1, img2, cond1, cond2, noise, new_image, with_adj: bool = True) -> Dict:
        """One step's {"d_loss", "g_loss", "a_loss", "fake", "adj", and
        "d_grads", "g_grads", "a_grads": ``name -> gradient``}; without
        ``with_adj`` (the warm-up gate, batch_no <= 10) no adjuster tape."""
        tf, cfg, bce = self.tf, self.cfg, self.bce
        l1 = cfg.l1_lambda
        img1, img2, cond1, cond2 = (tf.convert_to_tensor(x) for x in (img1, img2, cond1, cond2))
        with tf.GradientTape() as gen_tape, tf.GradientTape() as disc_tape:
            fake = self.generate(tf.convert_to_tensor(noise), cond2)
            real = self.discriminate(tf.convert_to_tensor(new_image))
            faked = self.discriminate(fake)
            d_loss = (2.0 * bce(cond1, real["cond"]) + bce(soft(tf.ones_like(real["pr"])), real["pr"])
                      + bce(soft(tf.zeros_like(faked["pr"])), faked["pr"]))
            g_loss = (bce(soft(tf.ones_like(faked["pr"])), faked["pr"]) + bce(cond2, faked["cond"])
                      + l1 * tf.reduce_mean(tf.abs(img2 - fake)))
        var = lambda g: [self.vars[k] for k in self.names[g]]  # noqa: E731
        out = {"fake": fake, "d_loss": d_loss, "g_loss": g_loss, "a_loss": None, "adj": None, "a_grads": None,
               "d_grads": dict(zip(self.names["d"], disc_tape.gradient(d_loss, var("d")))),
               "g_grads": dict(zip(self.names["g"], gen_tape.gradient(g_loss, var("g"))))}
        if with_adj:
            tgt_cond = tf.concat([cond2, cond1], 0)
            with tf.GradientTape() as adj_tape:
                adj = self.adjust(tf.concat([img1, tf.stop_gradient(fake)], 0), (tgt_cond + 1.0) * 0.5)
                scored = self.discriminate(adj)
                a_loss = (bce(soft(tf.ones_like(scored["pr"])), scored["pr"]) + bce(tgt_cond, scored["cond"])
                          + l1 * tf.reduce_mean(tf.abs(tf.concat([img2, img1], 0) - adj)))
            out.update(adj=adj, a_loss=a_loss, a_grads=dict(zip(self.names["a"], adj_tape.gradient(a_loss, var("a")))))
        return out

    def step(self, img1, img2, cond1, cond2, noise, new_image, with_adj: bool = True):
        """One reference update: the gradients, D's clipped (``use_clip``),
        then the D, G and (``with_adj``) adjuster Adams. Returns the
        losses (d, g, a; a None without the adjuster)."""
        tf, cfg = self.tf, self.cfg
        ref = self.grads(img1, img2, cond1, cond2, noise, new_image, with_adj)
        d_grads = ref["d_grads"]
        if cfg.use_clip:
            d_grads = {k: tf.clip_by_value(g, -cfg.clip_range, cfg.clip_range) for k, g in d_grads.items()}
        for g, grads in (("d", d_grads), ("g", ref["g_grads"]), ("a", ref["a_grads"])):
            if grads is not None:
                self.opts[g].apply_gradients([(grads[k], self.vars[k]) for k in self.names[g]])
        return ref["d_loss"], ref["g_loss"], ref["a_loss"]
