"""Loss functions, the port of littlegan_tpu/ops/losses.py (the reference's math).

Every BCE is Keras' probability-space ``binary_crossentropy``: predictions
clipped to ``[1e-7, 1 - 1e-7]``, the pointwise BCE averaged over the LAST
axis, then averaged over the batch. Targets may be negative (the softened
-1 labels, -0.94) and the formula is applied to them as it is. All in f32.

  D: 2*BCE(real_cond, real_c) + BCE(soft(1), real_pr) + BCE(soft(0), fake_pr)
  G: BCE(soft(1), fake_pr) + BCE(cond, fake_c) + l1_lambda * L1(image, fake)
  A: the same form as G, against the adjusted image.
"""

from __future__ import annotations

import torch

from littlegan_tpu_torch.utils.image import soft

_EPS = 1e-7  # Keras backend.epsilon()


def binary_crossentropy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Keras-compatible BCE on probabilities, mean over the last axis."""
    p = y_pred.float().clamp(_EPS, 1.0 - _EPS)
    t = y_true.float()
    return (-(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))).mean(-1)


def mean_squared_error(y_true, y_pred: torch.Tensor) -> torch.Tensor:
    """Keras-compatible MSE, mean over the last axis."""
    return (y_pred.float() - torch.as_tensor(y_true, dtype=torch.float32, device=y_pred.device)).square().mean(-1)


def _bce_mean(y_true, y_pred) -> torch.Tensor:
    return binary_crossentropy(y_true, y_pred).mean()


def discriminator_loss(real_true_c, real_pred_c, real_pred_pr, fake_pred_pr) -> torch.Tensor:
    """The condition term weighs twice."""
    ones = torch.full_like(real_pred_pr, soft(1.0))
    zeros = torch.full_like(fake_pred_pr, soft(0.0))
    return 2.0 * _bce_mean(real_true_c, real_pred_c) + _bce_mean(ones, real_pred_pr) + _bce_mean(zeros, fake_pred_pr)


def generator_loss(cond_ori, cond_disc, pr_disc, image_ori, image_gen, l1_lambda: float) -> torch.Tensor:
    """The L1 target is the batch whose conditions G consumed (image 2)."""
    ones = torch.full_like(pr_disc, soft(1.0))
    l1 = (image_ori.float() - image_gen.float()).abs().mean()
    return _bce_mean(ones, pr_disc) + _bce_mean(cond_ori, cond_disc) + l1_lambda * l1


def adjuster_loss(cond_ori, cond_disc, pr_disc, image_ori, image_adj, l1_lambda: float) -> torch.Tensor:
    return generator_loss(cond_ori, cond_disc, pr_disc, image_ori, image_adj, l1_lambda)
