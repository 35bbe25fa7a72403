"""The adversarial train step, the port of littlegan_tpu/training/step.py.

One step (the reference's eager_trainer.py:115-169):

1. both uint8 batches are rescaled to [-1, 1] on the card and batch 1 is
   augmented (flip, brightness, contrast, hue, noise);
2. the generator makes ``fake`` from noise and batch 2's conditions; D
   scores the augmented real batch and ``fake``; with ``train_adj`` the
   adjuster remaps ``[img1, fake]`` to the target conditions and D scores
   its output;
3. each parameter group takes the gradient of its own loss only, as the
   ``stop_gradient``s of the JAX step route them (``step.py:160-203``):
   D (encoder + d_head) <- disc loss, G (g_head + decoder + out_conv) <-
   gen loss, A (adj_head) <- adj loss;
4. D's gradient is clipped to ±``clip_range``; three masked TF-v1 Adams
   apply the partition schedule and the adjuster's warm-up gate
   (``batch_no > 10``); the G-only EMA follows.

How the gradient routing is done here: D runs ONCE on ``fake`` (JAX runs it
twice, with live and with frozen parameters, and XLA merges the two), then
``torch.autograd.grad`` is taken three times on the one graph: the disc loss
with respect to D's parameters, the gen loss with respect to G's, the adj
loss with respect to the adjuster head's. A loss's gradient with respect to
parameters it is not asked for is never formed, which is what JAX's
``stop_gradient`` on the frozen copies achieves.

Random draws (latent noise, augmentation) are arguments (:class:`StepDraws`),
drawn by :func:`draw_step` from a ``torch.Generator``: tests feed the JAX
step's draws instead. ``batch_no`` is a host integer, so the partition
masks and the adjuster gate are decided on the host.

Not ported yet, and refused with ``NotImplementedError``: ``use_gp`` (a
grad-of-grad penalty), ``remat`` and ``grad_accum > 1`` (ROADMAP A5).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models.littlegan import s2d_active
from littlegan_tpu_torch.ops.augment import AugmentDraws, augment, draw_augment
from littlegan_tpu_torch.ops.losses import adjuster_loss, discriminator_loss, generator_loss
from littlegan_tpu_torch.ops.s2d import depth_to_space, space_to_depth
from littlegan_tpu_torch.training.optimizer import lr_scale_from_config, masked_adam_update
from littlegan_tpu_torch.training.partition import build_partition_masks, resolve_mask
from littlegan_tpu_torch.training.state import A_KEYS, D_KEYS, G_KEYS, TrainState, subtree

LOSS_KEYS = ("loss/gen", "loss/disc", "loss/adj")


class StepDraws(NamedTuple):
    noise: torch.Tensor  # (B, noise_dim) f32 latent noise
    augment: AugmentDraws  # batch 1's augmentation draws


class StepOutput(NamedTuple):
    state: TrainState
    metrics: Dict[str, torch.Tensor]  # the three losses, 0-dim f32 on the device
    fake_image: torch.Tensor  # raw layout, compute dtype
    adj_image: torch.Tensor  # (1, 1, 1, 1) zeros when train_adj is off


def check_supported(cfg: Config) -> None:
    """Refuse the step options the port does not have yet."""
    for on, what in (
        (cfg.use_gp, "use_gp (the gradient penalty)"),
        (cfg.remat, "remat"),
        (cfg.grad_accum > 1, f"grad_accum={cfg.grad_accum}"),
    ):
        if on:
            raise NotImplementedError(f"{what} is not ported to littlegan_tpu_torch yet (ROADMAP A5)")


def draw_step(generator: torch.Generator, cfg: Config, n: int, device) -> StepDraws:
    """One step's draws from ``generator`` (which lives on ``device``):
    noise ~ N(0, 1), then the augmentation draws of an n-image batch."""
    noise = torch.randn((n, cfg.noise_dim), generator=generator, device=device)
    aug = draw_augment(generator, n, (n, cfg.image_dim, cfg.image_dim, cfg.image_channel), device)
    return StepDraws(noise, aug)


def prep_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> f32 [-1, 1] on the tensor's device; floats pass."""
    if x.dtype == torch.uint8:
        return x.float() / 127.5 - 1.0
    return x


def total_loss_fn(
    model, batch1, batch2, noise: torch.Tensor, new_image: torch.Tensor, cfg: Config, adj_sel: Optional[int] = None
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(the three losses on one autograd graph, {"fake", "adj"} images in
    raw layout). ``adj_sel`` (``adj_half_batch`` only) is ``batch_no % 2``:
    the adjuster takes the real task on even steps, the generated one on odd."""
    img1, cond1 = batch1
    img2, cond2 = batch2
    s2 = s2d_active(cfg)
    if s2:
        img1, img2, new_image = space_to_depth(img1), space_to_depth(img2), space_to_depth(new_image)
    dt = getattr(torch, cfg.compute_dtype)
    img1, img2, new_image = img1.to(dt), img2.to(dt), new_image.to(dt)

    fake = model.generator(noise, cond2, s2d_out=s2)
    real_pr, real_c = model.discriminator(new_image, s2d_in=s2)
    fake_pr, fake_c = model.discriminator(fake, s2d_in=s2)
    d_loss = discriminator_loss(cond1, real_c, real_pr, fake_pr)
    g_loss = generator_loss(cond2, fake_c, fake_pr, img2, fake, cfg.l1_lambda)

    adj_image = torch.zeros((1, 1, 1, 1), device=fake.device)
    a_loss = torch.zeros((), device=fake.device)
    if cfg.train_adj:
        fake_data = fake.detach()
        if cfg.adj_half_batch:
            if adj_sel is None:
                raise ValueError("adj_half_batch requires adj_sel (= batch_no % 2)")
            tgt_cond, in_img, tgt_img = (cond2, img1, img2) if adj_sel == 0 else (cond1, fake_data, img1)
        else:
            tgt_cond = torch.cat([cond2, cond1])
            in_img = torch.cat([img1, fake_data])
            tgt_img = torch.cat([img2, img1])
        adj_image = model.adjuster(in_img, (tgt_cond + 1.0) * 0.5, s2d_in=s2, s2d_out=s2)
        adj_pr, adj_c = model.discriminator(adj_image, s2d_in=s2)
        a_loss = adjuster_loss(tgt_cond, adj_c, adj_pr, tgt_img, adj_image, cfg.l1_lambda)

    fake_out = depth_to_space(fake) if s2 else fake
    adj_out = depth_to_space(adj_image) if s2 and cfg.train_adj else adj_image
    losses = {"loss/gen": g_loss, "loss/disc": d_loss, "loss/adj": a_loss}
    return losses, {"fake": fake_out.detach(), "adj": adj_out.detach()}


def compute_grads(
    state: TrainState, batch1, batch2, draws: StepDraws, batch_no: int, cfg: Config
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(``name -> gradient`` for every parameter, aux with the detached
    losses and images): everything in a step before the optimizer."""
    check_supported(cfg)
    model = state.model
    batch1 = (prep_images(batch1[0]), batch1[1])
    batch2 = (prep_images(batch2[0]), batch2[1])
    new_image = augment(batch1[0], draws.augment)
    adj_sel = batch_no % 2 if cfg.adj_half_batch else None
    losses, aux = total_loss_fn(model, batch1, batch2, draws.noise, new_image, cfg, adj_sel)

    grads: Dict[str, torch.Tensor] = {}
    routes = [("loss/disc", D_KEYS), ("loss/gen", G_KEYS)]
    if cfg.train_adj:
        routes.append(("loss/adj", A_KEYS))
    for i, (loss, keys) in enumerate(routes):
        params = subtree(model, keys)
        gs = torch.autograd.grad(losses[loss], list(params.values()), retain_graph=i < len(routes) - 1)
        grads.update(zip(params, gs))
    if not cfg.train_adj:
        grads.update({k: torch.zeros_like(p) for k, p in subtree(model, A_KEYS).items()})
    aux.update({k: v.detach().float() for k, v in losses.items()})
    return grads, aux


def apply_updates(
    state: TrainState, grads: Dict[str, torch.Tensor], aux, batch_no: int, cfg: Config, part_masks
) -> StepOutput:
    """D-gradient clipping, the partition masks, the adjuster's warm-up
    gate and the three masked Adams, in place; then the G-only EMA."""
    model = state.model
    d_params = subtree(model, D_KEYS)
    d_grads = {k: grads[k] for k in d_params}
    if cfg.use_clip:  # eager_trainer.py:146-148, D only
        d_grads = {k: g.clamp(-cfg.clip_range, cfg.clip_range) for k, g in d_grads.items()}
    g_params, a_params = subtree(model, G_KEYS), subtree(model, A_KEYS)

    def mask(which):
        return resolve_mask(part_masks[which], batch_no, cfg.use_partition, cfg.partition_interval)

    g_mask, d_mask, a_mask = mask("generator"), mask("discriminator"), mask("adjuster")
    gate = 1.0 if cfg.train_adj and batch_no > 10 else 0.0  # eager_trainer.py:152
    a_mask = {k: m * gate for k, m in a_mask.items()}
    lr_scale = lr_scale_from_config(cfg)
    tick_all = cfg.adam_tf_parity
    masked_adam_update({k: grads[k] for k in g_params}, state.opt_g, g_params, g_mask, cfg.lr, cfg.beta_1,
                       cfg.beta_2, tick_all=tick_all, lr_scale=lr_scale)
    masked_adam_update(d_grads, state.opt_d, d_params, d_mask, cfg.lr, cfg.beta_1, cfg.beta_2,
                       tick_all=tick_all, lr_scale=lr_scale)
    # the adjuster's Adam has the default betas and never ticks all
    masked_adam_update({k: grads[k] for k in a_params}, state.opt_a, a_params, a_mask, cfg.lr, 0.9, 0.999,
                       lr_scale=lr_scale)
    if cfg.ema_decay > 0 and state.ema is not None:
        with torch.no_grad():
            d = np.float32(cfg.ema_decay)
            for k, e in state.ema.items():  # d and 1 - d in f32, as in JAX
                e.copy_(float(d) * e.float() + float(np.float32(1.0) - d) * g_params[k].float())
    metrics = {k: aux[k] for k in LOSS_KEYS}
    return StepOutput(state=state, metrics=metrics, fake_image=aux["fake"], adj_image=aux["adj"])


def partition_masks(model) -> dict:
    return build_partition_masks(
        subtree(model, G_KEYS), subtree(model, D_KEYS), subtree(model, A_KEYS)
    )


def train_step(
    state: TrainState, batch1, batch2, draws: StepDraws, batch_no: int, cfg: Config, part_masks=None
) -> StepOutput:
    """One step, in place on ``state``. ``batch1``/``batch2``: (images
    uint8 or [-1, 1] float NHWC, softened conditions) on the state's device."""
    if part_masks is None:
        part_masks = partition_masks(state.model)
    grads, aux = compute_grads(state, batch1, batch2, draws, batch_no, cfg)
    return apply_updates(state, grads, aux, batch_no, cfg, part_masks)


def make_train_step(cfg: Config, state: TrainState):
    """``step(state, batch1, batch2, draws, batch_no)`` with ``cfg`` and the
    partition masks bound."""
    check_supported(cfg)
    return functools.partial(train_step, cfg=cfg, part_masks=partition_masks(state.model))
