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

Random draws (latent noise, augmentation, the penalty's mix) are arguments
(:class:`StepDraws`), drawn by :func:`draw_step` from a ``torch.Generator``:
tests feed the JAX step's draws instead. With gradient accumulation
(``grad_accum`` = M) an update takes M micro-pairs, their draws stacked
over M, and applies the mean of their float32 gradients once
(:func:`accum_train_step`).

Two forms of the optimizer tail. The one-update steps (:func:`train_step`,
the gather step, :func:`accum_train_step`) take ``batch_no`` as a host
integer and decide the partition masks and the adjuster gate on the host.
The K-update steps over the device-resident dataset
(:func:`make_scan_train_step`, :func:`make_scan_accum_train_step`) must not
ask the host inside a CUDA graph: the host writes each update's schedule
as a row (:func:`schedule_rows`: masks, Adam step sizes, the
``adj_half_batch`` parity) and the updates read it on the device
(:func:`scan_updates`). Both forms give the same result.

``use_gp`` adds the WGAN-GP penalty on interpolates of the augmented real
batch and ``fake`` to D's loss (:func:`gradient_penalty`): a third D pass
with live parameters, differentiated twice. It runs on the plain ops only:
with a kernel flag it is refused (:func:`check_supported`), since the
kernels' backwards are first order only, and the JAX package's Pallas
kernels cannot be differentiated twice either. ``remat`` recomputes each
network application (G, each D pass, the adjuster) in its own backward
(``torch.utils.checkpoint``), as the JAX step's ``jax.checkpoint``; the
penalty's D pass is not wrapped, as in JAX. An s2d-layout store
(``store_s2d``) holds the device store in block layout: the step skips its
per-step ``space_to_depth`` and augments batch 1 with ``augment_s2d``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models.littlegan import s2d_active
from littlegan_tpu_torch.ops.augment import AugmentDraws, augment, augment_s2d, draw_augment
from littlegan_tpu_torch.ops.losses import adjuster_loss, discriminator_loss, generator_loss
from littlegan_tpu_torch.ops.s2d import depth_to_space, space_to_depth
from littlegan_tpu_torch.training.dispatch import GraphedUpdates
from littlegan_tpu_torch.training.optimizer import (
    advance_counts, lr_scale_from_config, masked_adam_update, masked_adam_update_rows,
)
from littlegan_tpu_torch.training.partition import adjuster_gate, build_partition_masks, mask_rows, resolve_mask
from littlegan_tpu_torch.training.state import A_KEYS, D_KEYS, G_KEYS, TrainState, subtree

LOSS_KEYS = ("loss/gen", "loss/disc", "loss/adj")
# the three Adams: (state field, partition model, parameter parts)
_ADAMS = (("opt_g", "generator", G_KEYS), ("opt_d", "discriminator", D_KEYS), ("opt_a", "adjuster", A_KEYS))


class StepDraws(NamedTuple):
    noise: torch.Tensor  # (B, noise_dim) f32 latent noise
    augment: AugmentDraws  # batch 1's augmentation draws
    gp_eps: Optional[torch.Tensor] = None  # (B, 1, 1, 1) f32 U[0, 1): the penalty's mix, with use_gp only


class StepOutput(NamedTuple):
    state: TrainState
    metrics: Dict[str, torch.Tensor]  # the three losses, f32 on the device: 0-dim, or (K,) from K updates
    fake_image: torch.Tensor  # raw layout, compute dtype (the last update's)
    adj_image: torch.Tensor  # (1, 1, 1, 1) zeros when train_adj is off


def check_supported(cfg: Config) -> None:
    """Refuse what the step cannot run: the gradient penalty with a kernel
    flag on."""
    if cfg.use_gp and (cfg.use_pallas or cfg.use_pallas_boundary):
        raise ValueError(
            "use_gp needs use_pallas=False and use_pallas_boundary=False: the penalty differentiates D "
            "twice, and the kernels' backwards are first order only (the JAX reference cannot "
            "differentiate its Pallas kernels twice either)"
        )


def draw_step(generator: torch.Generator, cfg: Config, n: int, device) -> StepDraws:
    """One step's draws from ``generator`` (which lives on ``device``):
    noise ~ N(0, 1), the augmentation draws of an n-image batch, and last,
    with ``use_gp`` only, the penalty's mix ~ U[0, 1) per sample."""
    noise = torch.randn((n, cfg.noise_dim), generator=generator, device=device)
    aug = draw_augment(generator, n, (n, cfg.image_dim, cfg.image_dim, cfg.image_channel), device)
    eps = torch.rand((n, 1, 1, 1), generator=generator, device=device) if cfg.use_gp else None
    return StepDraws(noise, aug, eps)


def map_draws(fn, *draws: StepDraws) -> StepDraws:
    """``fn`` applied field by field across ``draws``."""
    aug = AugmentDraws(*(fn(*fields) for fields in zip(*(d.augment for d in draws))))
    eps = None if draws[0].gp_eps is None else fn(*(d.gp_eps for d in draws))
    return StepDraws(fn(*(d.noise for d in draws)), aug, eps)


def stack_draws(draws: Sequence[StepDraws]) -> StepDraws:
    """Draws stacked over a new leading axis (micro-steps, or updates)."""
    return map_draws(lambda *xs: torch.stack(xs), *draws)


def prep_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> f32 [-1, 1] on the tensor's device; floats pass."""
    if x.dtype == torch.uint8:
        return x.float() / 127.5 - 1.0
    return x


def gradient_penalty(model, real: torch.Tensor, fake: torch.Tensor, eps: torch.Tensor, s2: bool) -> torch.Tensor:
    """WGAN-GP on ``eps * real + (1 - eps) * fake`` (JAX ``step.py:74-86``):
    ``mean((||d sum(D_pr) / d inter||_2 - 1)^2)``, the norm per sample in
    f32 with 1e-12 under the root. ``inter`` promotes to f32 (``eps`` is
    f32) and D casts it, as in JAX. The gradient is taken with
    ``create_graph``, so D's parameters get the penalty's second-order
    gradient; ``fake`` comes detached."""
    inter = (eps * real + (1.0 - eps) * fake).requires_grad_(True)
    pr, _ = model.discriminator(inter, s2d_in=s2)
    (g,) = torch.autograd.grad(pr.sum(), inter, create_graph=True)
    norms = torch.sqrt(g.float().square().sum((1, 2, 3)) + 1e-12)
    return (norms - 1.0).square().mean()


def _remat(fn, on: bool):
    """``fn`` recomputed in its own backward when ``on`` (``cfg.remat``).
    Nothing inside a network draws, and CUDA-graph capture may not save the
    card's RNG state, so no RNG state is kept."""
    if not on:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False)


def total_loss_fn(
    model, batch1, batch2, noise: torch.Tensor, new_image: torch.Tensor, cfg: Config,
    adj_sel: Optional[torch.Tensor] = None, gp_eps: Optional[torch.Tensor] = None, inputs_s2d: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(the three losses on one autograd graph, {"fake", "adj"} images in
    raw layout). ``adj_sel`` (``adj_half_batch`` only) is ``batch_no % 2``
    as a 0-dim tensor: the adjuster takes the real task on even steps, the
    generated one on odd, chosen on the device (JAX ``step.py:185-193``).
    ``gp_eps``: the penalty's mix (``use_gp``). ``inputs_s2d``: the images
    arrive in block layout already (an s2d-layout store)."""
    img1, cond1 = batch1
    img2, cond2 = batch2
    s2 = s2d_active(cfg)
    if s2 and not inputs_s2d:
        img1, img2, new_image = space_to_depth(img1), space_to_depth(img2), space_to_depth(new_image)
    dt = getattr(torch, cfg.compute_dtype)
    img1, img2, new_image = img1.to(dt), img2.to(dt), new_image.to(dt)
    generator = _remat(model.generator, cfg.remat)
    discriminator = _remat(model.discriminator, cfg.remat)

    fake = generator(noise, cond2, s2d_out=s2)
    real_pr, real_c = discriminator(new_image, s2d_in=s2)
    fake_pr, fake_c = discriminator(fake, s2d_in=s2)
    d_loss = discriminator_loss(cond1, real_c, real_pr, fake_pr)
    if cfg.use_gp:
        if gp_eps is None:
            raise ValueError("use_gp requires the penalty's draws (StepDraws.gp_eps)")
        # from the augmented real batch, the sample D is trained on (JAX step.py:166-170)
        d_loss = d_loss + cfg.gp_weight * gradient_penalty(model, new_image, fake.detach(), gp_eps, s2)
    g_loss = generator_loss(cond2, fake_c, fake_pr, img2, fake, cfg.l1_lambda)

    adj_image = torch.zeros((1, 1, 1, 1), device=fake.device)
    a_loss = torch.zeros((), device=fake.device)
    if cfg.train_adj:
        fake_data = fake.detach()
        if cfg.adj_half_batch:
            if adj_sel is None:
                raise ValueError("adj_half_batch requires adj_sel (= batch_no % 2)")
            even = adj_sel == 0
            tgt_cond = torch.where(even, cond2, cond1)
            in_img = torch.where(even, img1, fake_data)
            tgt_img = torch.where(even, img2, img1)
        else:
            tgt_cond = torch.cat([cond2, cond1])
            in_img = torch.cat([img1, fake_data])
            tgt_img = torch.cat([img2, img1])
        adj_image = _remat(model.adjuster, cfg.remat)(in_img, (tgt_cond + 1.0) * 0.5, s2d_in=s2, s2d_out=s2)
        adj_pr, adj_c = discriminator(adj_image, s2d_in=s2)
        a_loss = adjuster_loss(tgt_cond, adj_c, adj_pr, tgt_img, adj_image, cfg.l1_lambda)

    fake_out = depth_to_space(fake) if s2 else fake
    adj_out = depth_to_space(adj_image) if s2 and cfg.train_adj else adj_image
    losses = {"loss/gen": g_loss, "loss/disc": d_loss, "loss/adj": a_loss}
    return losses, {"fake": fake_out.detach(), "adj": adj_out.detach()}


def micro_grads(
    state: TrainState, batch1, batch2, draws: StepDraws, cfg: Config, adj_sel: Optional[torch.Tensor] = None,
    inputs_s2d: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(``name -> gradient`` for every parameter, aux with the detached
    losses and images) of one micro-pair: everything in a step before the
    optimizer. Reads nothing from the host. ``inputs_s2d``: both batches
    are in block layout (an s2d-layout store), augmented as such."""
    check_supported(cfg)
    model = state.model
    batch1 = (prep_images(batch1[0]), batch1[1])
    batch2 = (prep_images(batch2[0]), batch2[1])
    new_image = (augment_s2d if inputs_s2d else augment)(batch1[0], draws.augment)
    losses, aux = total_loss_fn(model, batch1, batch2, draws.noise, new_image, cfg, adj_sel, draws.gp_eps,
                                inputs_s2d)

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


def _adj_sel(batch_no: int, cfg: Config, device) -> Optional[torch.Tensor]:
    return torch.full((), batch_no % 2, device=device) if cfg.adj_half_batch else None


def compute_grads(
    state: TrainState, batch1, batch2, draws: StepDraws, batch_no: int, cfg: Config, inputs_s2d: bool = False
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """:func:`micro_grads` of the step at host ``batch_no``."""
    return micro_grads(state, batch1, batch2, draws, cfg, _adj_sel(batch_no, cfg, batch1[0].device), inputs_s2d)


def accum_grads(
    state: TrainState, batch1s, batch2s, draws: StepDraws, cfg: Config, adj_sel: Optional[torch.Tensor] = None,
    inputs_s2d: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(mean gradients over the M stacked micro-pairs, the last micro-step's
    aux), the port of JAX ``accum_grads`` (``step.py:370-403``).
    ``batch1s``/``batch2s``: (images (M, B, ...), conds (M, B, c));
    ``draws``: stacked over M. Each micro-pair's gradients are summed in
    float32, then divided by M."""
    m = batch1s[0].shape[0]
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in state.model.parameters()]
    names = [n for n, _ in state.model.named_parameters()]
    for j in range(m):
        grads, aux = micro_grads(
            state, (batch1s[0][j], batch1s[1][j]), (batch2s[0][j], batch2s[1][j]),
            map_draws(lambda x: x[j], draws), cfg, adj_sel, inputs_s2d,
        )
        torch._foreach_add_(acc, [grads[n].float() for n in names])
    torch._foreach_div_(acc, float(m))
    return dict(zip(names, acc)), aux


def _clip_d(grads: Dict[str, torch.Tensor], cfg: Config, d_names) -> Dict[str, torch.Tensor]:
    """D's gradients clipped to ±clip_range (eager_trainer.py:146-148, D only)."""
    if not cfg.use_clip:
        return grads
    return {**grads, **{k: grads[k].clamp(-cfg.clip_range, cfg.clip_range) for k in d_names}}


def _adam_args(cfg: Config, opt: str) -> Tuple[float, float, bool]:
    """(b1, b2, tick_all) of one of the three Adams: the adjuster's has the
    default betas and never ticks all (its apply count is its tick count)."""
    if opt == "opt_a":
        return 0.9, 0.999, False
    return cfg.beta_1, cfg.beta_2, cfg.adam_tf_parity


@torch.no_grad()
def _update_ema(state: TrainState, cfg: Config) -> None:
    if cfg.ema_decay > 0 and state.ema is not None:
        g_params = subtree(state.model, G_KEYS)
        d = np.float32(cfg.ema_decay)
        for k, e in state.ema.items():  # d and 1 - d in f32, as in JAX
            e.copy_(float(d) * e.float() + float(np.float32(1.0) - d) * g_params[k].float())


def apply_updates(
    state: TrainState, grads: Dict[str, torch.Tensor], aux, batch_no: int, cfg: Config, part_masks
) -> StepOutput:
    """D-gradient clipping, the partition masks, the adjuster's warm-up
    gate and the three masked Adams, in place, decided on the host from
    ``batch_no``; then the G-only EMA."""
    model = state.model
    grads = _clip_d(grads, cfg, subtree(model, D_KEYS))
    lr_scale = lr_scale_from_config(cfg)
    gate = adjuster_gate(batch_no, cfg.train_adj)
    for opt, which, keys in _ADAMS:
        params = subtree(model, keys)
        mask = resolve_mask(part_masks[which], batch_no, cfg.use_partition, cfg.partition_interval)
        if opt == "opt_a":
            mask = {k: m * gate for k, m in mask.items()}
        b1, b2, tick_all = _adam_args(cfg, opt)
        masked_adam_update({k: grads[k] for k in params}, getattr(state, opt), params, mask, cfg.lr, b1, b2,
                           tick_all=tick_all, lr_scale=lr_scale)
    _update_ema(state, cfg)
    metrics = {k: aux[k] for k in LOSS_KEYS}
    return StepOutput(state=state, metrics=metrics, fake_image=aux["fake"], adj_image=aux["adj"])


def schedule_rows(state: TrainState, cfg: Config, part_masks, batch_nos: Sequence[int]) -> np.ndarray:
    """(K, width) float32: one row per update at ``batch_nos``, read on the
    device by :func:`apply_updates_rows`. For each Adam (G, D, A) its
    leaves' 0/1 masks (the partition schedule; the adjuster's times its
    gate), then their step sizes; last the update's ``batch_no % 2``.
    Advances the state's host counts through the K updates."""
    masks = mask_rows(part_masks, batch_nos, cfg.use_partition, cfg.partition_interval, cfg.train_adj)
    lr_scale = lr_scale_from_config(cfg)
    cols = []
    for opt, which, _ in _ADAMS:
        b1, b2, tick_all = _adam_args(cfg, opt)
        cols += [masks[which], advance_counts(getattr(state, opt), masks[which], cfg.lr, b1, b2, tick_all, lr_scale)]
    cols.append((np.asarray(batch_nos, np.int64) % 2).astype(np.float32)[:, None])
    return np.concatenate(cols, axis=1)


def schedule_width(state: TrainState) -> int:
    return 2 * sum(len(getattr(state, opt).count) for opt, _, _ in _ADAMS) + 1


def apply_updates_rows(state: TrainState, grads: Dict[str, torch.Tensor], aux, row: torch.Tensor,
                       cfg: Config) -> StepOutput:
    """:func:`apply_updates` from one device row of :func:`schedule_rows`:
    the masks select with ``torch.where`` and the step sizes are tensors, so
    no value comes from the host."""
    model = state.model
    grads = _clip_d(grads, cfg, subtree(model, D_KEYS))
    off = 0
    for opt, _, keys in _ADAMS:
        params = subtree(model, keys)
        n = len(params)
        b1, b2, _ = _adam_args(cfg, opt)
        masked_adam_update_rows({k: grads[k] for k in params}, getattr(state, opt), params,
                                row[off:off + n], row[off + n:off + 2 * n], b1, b2)
        off += 2 * n
    _update_ema(state, cfg)
    metrics = {k: aux[k] for k in LOSS_KEYS}
    return StepOutput(state=state, metrics=metrics, fake_image=aux["fake"], adj_image=aux["adj"])


def partition_masks(model) -> dict:
    return build_partition_masks(
        subtree(model, G_KEYS), subtree(model, D_KEYS), subtree(model, A_KEYS)
    )


def train_step(
    state: TrainState, batch1, batch2, draws: StepDraws, batch_no: int, cfg: Config, part_masks=None,
    inputs_s2d: bool = False,
) -> StepOutput:
    """One step, in place on ``state``. ``batch1``/``batch2``: (images
    uint8 or [-1, 1] float NHWC, or in block layout with ``inputs_s2d``,
    softened conditions) on the state's device."""
    if part_masks is None:
        part_masks = partition_masks(state.model)
    grads, aux = compute_grads(state, batch1, batch2, draws, batch_no, cfg, inputs_s2d)
    return apply_updates(state, grads, aux, batch_no, cfg, part_masks)


def make_train_step(cfg: Config, state: TrainState):
    """``step(state, batch1, batch2, draws, batch_no)`` with ``cfg`` and the
    partition masks bound."""
    check_supported(cfg)
    return functools.partial(train_step, cfg=cfg, part_masks=partition_masks(state.model))


def accum_train_step(
    state: TrainState, batch1s, batch2s, draws: StepDraws, batch_no: int, cfg: Config, part_masks=None
) -> StepOutput:
    """Gradient accumulation, the port of JAX ``accum_train_step``: the mean
    gradient over M micro-pairs, then ONE optimizer apply at ``batch_no``
    (clipping applies to the mean). ``batch1s``/``batch2s`` and ``draws``
    carry a leading (M,) axis; metrics and images are the last micro-step's."""
    if part_masks is None:
        part_masks = partition_masks(state.model)
    grads, aux = accum_grads(state, batch1s, batch2s, draws, cfg, _adj_sel(batch_no, cfg, batch1s[0].device))
    return apply_updates(state, grads, aux, batch_no, cfg, part_masks)


def make_accum_train_step(cfg: Config, state: TrainState):
    """``step(state, batch1s, batch2s, draws, batch_no)`` with (M, B, ...)
    stacked batches and draws."""
    check_supported(cfg)
    return functools.partial(accum_train_step, cfg=cfg, part_masks=partition_masks(state.model))


# ------------------------------------------------ the device-resident dataset --


def take_batch(store: torch.Tensor, b) -> torch.Tensor:
    """Batch ``b`` of a (n_batches, B, ...) store: a view for a host int, a
    gather for a 0-dim device tensor (no host read)."""
    if isinstance(b, torch.Tensor):
        return store.index_select(0, b.long().reshape(1))[0]
    return store[int(b)]


def _check_store_layout(cfg: Config, store_s2d: bool) -> None:
    """An s2d-layout store needs the s2d step active, else its block-layout
    images would meet the raw model. The trainer keeps a raw store, as the
    JAX trainer does (``trainer.py:545-552``); only the step makers take
    ``store_s2d``."""
    if store_s2d and not s2d_active(cfg):
        raise ValueError(
            "store_s2d=True but the s2d step is inactive for this config (s2d needs use_s2d, "
            "kernel_size=5 and an even image_dim) — upload a RAW-layout store instead"
        )


def make_gather_train_step(cfg: Config, state: TrainState, store_s2d: bool = False):
    """``step(state, images, conds, b1, b2, draws, batch_no)``: one train
    step whose two batches are ids into the (n_batches, B, ...) device store
    (``cfg.device_data`` with one update per call). With ``store_s2d`` the
    store is in block layout (``ops/s2d.py::space_to_depth`` of each
    batch)."""
    check_supported(cfg)
    _check_store_layout(cfg, store_s2d)
    part_masks = partition_masks(state.model)

    def step(state, images, conds, b1, b2, draws, batch_no):
        batch1 = (take_batch(images, b1), take_batch(conds, b1))
        batch2 = (take_batch(images, b2), take_batch(conds, b2))
        return train_step(state, batch1, batch2, draws, batch_no, cfg, part_masks, store_s2d)

    return step


def scan_updates(state: TrainState, images, conds, ids1, ids2, draws: StepDraws, rows: torch.Tensor,
                 cfg: Config, inputs_s2d: bool = False):
    """K applied updates from the device store, in place, reading nothing
    from the host: ``ids1``/``ids2`` (K,) batch ids, or (K, M) for M
    accumulated micro-pairs per update; ``draws`` stacked over K (then M);
    ``rows`` the (K, width) :func:`schedule_rows`. Returns the (K, 3)
    losses and the last update's fake and adj images."""
    losses = []
    for i in range(ids1.shape[0]):
        adj_sel = rows[i, -1] if cfg.adj_half_batch else None
        d = map_draws(lambda x: x[i], draws)
        if ids1.dim() == 2:
            gather = lambda ids: (images.index_select(0, ids), conds.index_select(0, ids))  # noqa: E731
            grads, aux = accum_grads(state, gather(ids1[i]), gather(ids2[i]), d, cfg, adj_sel, inputs_s2d)
        else:
            batch1 = (take_batch(images, ids1[i]), take_batch(conds, ids1[i]))
            batch2 = (take_batch(images, ids2[i]), take_batch(conds, ids2[i]))
            grads, aux = micro_grads(state, batch1, batch2, d, cfg, adj_sel, inputs_s2d)
        out = apply_updates_rows(state, grads, aux, rows[i], cfg)
        losses.append(torch.stack([out.metrics[k] for k in LOSS_KEYS]))
    return torch.stack(losses), out.fake_image, out.adj_image


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor an update writes: parameters, moments, the EMA."""
    out = list(state.model.parameters())
    for opt, _, _ in _ADAMS:
        adam = getattr(state, opt)
        out += list(adam.mu.values()) + list(adam.nu.values())
    return out + (list(state.ema.values()) if state.ema is not None else [])


def zero_draws(cfg: Config, n: int, device) -> StepDraws:
    """Draws of an n-image batch, all zero but a contrast factor of 1."""
    z = lambda *shape: torch.zeros(shape, device=device)  # noqa: E731
    aug = AugmentDraws(torch.zeros((n,), dtype=torch.bool, device=device), z(), z() + 1.0, z(),
                       z(n, cfg.image_dim, cfg.image_dim, cfg.image_channel))
    return StepDraws(z(n, cfg.noise_dim), aug, z(n, 1, 1, 1) if cfg.use_gp else None)


def _make_scan_dispatch(cfg: Config, state: TrainState, n_steps: int, micro: Optional[int], store_s2d: bool):
    """The K-update step over the device store, the port's counterpart of
    JAX ``_make_scan_dispatch`` (``step.py:554-611``): the host turns the
    batch ids and the schedule of updates ``batch_no0 … batch_no0+K-1`` into
    one (K, width) float32 array, and ``GraphedUpdates``
    (``training/dispatch.py``) runs :func:`scan_updates` on it (one CUDA
    graph replay on the card). ``micro``: M for (K, M) ids, None for (K,)."""
    check_supported(cfg)
    _check_store_layout(cfg, store_s2d)
    part_masks = partition_masks(state.model)
    m = micro or 1

    def body(inputs, draws, state, images, conds):
        ids1, ids2 = inputs[:, :m].long(), inputs[:, m:2 * m].long()
        if micro is None:
            ids1, ids2 = ids1[:, 0], ids2[:, 0]
        return scan_updates(state, images, conds, ids1, ids2, draws, inputs[:, 2 * m:], cfg, store_s2d)

    graphed = GraphedUpdates(body)

    def host_inputs(b1s, b2s, rows) -> np.ndarray:
        ids = [np.asarray(b, np.int64).reshape(n_steps, m) for b in (b1s, b2s)]
        if max(int(np.max(i)) for i in ids) >= 1 << 24:
            raise ValueError("batch ids must stay below 2**24 (they travel as float32)")
        return np.concatenate([ids[0], ids[1], rows], axis=1).astype(np.float32)

    def step(state, images, conds, b1s, b2s, draws, batch_no0):
        rows = schedule_rows(state, cfg, part_masks, range(batch_no0, batch_no0 + n_steps))
        losses, fake, adj = graphed(host_inputs(b1s, b2s, rows), draws, (state, images, conds), state_tensors(state))
        return StepOutput(state, {k: losses[:, i] for i, k in enumerate(LOSS_KEYS)}, fake, adj)

    def prepare(state, images, conds):
        """Capture the CUDA graph now (on a CPU state: nothing to do)."""
        lead = (n_steps,) if micro is None else (n_steps, m)
        draws = zero_draws(cfg, images.shape[1], images.device)
        draws = map_draws(lambda x: x.expand(*lead, *x.shape).contiguous(), draws)
        zeros = np.zeros((n_steps, 2 * m + schedule_width(state)), np.float32)
        graphed.prepare(zeros, draws, (state, images, conds), state_tensors(state))

    step.prepare = prepare
    step.graphed = graphed
    return step


def make_scan_train_step(cfg: Config, state: TrainState, n_steps: int, store_s2d: bool = False):
    """K train steps per call over the device store:
    ``step(state, images, conds, b1s (K,), b2s (K,), draws, batch_no0)``,
    ``draws`` the K updates' :class:`StepDraws` stacked. Update i takes
    batches ``b1s[i]``, ``b2s[i]`` and the schedule of ``batch_no0 + i``,
    exactly as K sequential steps would. Returns the state (updated in
    place), (K,) metrics and the LAST update's images (cadence artifacts
    snap to the group). ``step.prepare(state, images, conds)`` captures the
    graph ahead of the first call. ``store_s2d``: the store is in block
    layout, as for :func:`make_gather_train_step`."""
    return _make_scan_dispatch(cfg, state, n_steps, None, store_s2d)


def make_scan_accum_train_step(cfg: Config, state: TrainState, n_steps: int, store_s2d: bool = False):
    """``grad_accum`` x the device store: K applied updates per call, each
    the mean over ``cfg.grad_accum`` = M micro-pairs. As
    :func:`make_scan_train_step` with (K, M) batch ids and draws stacked
    over (K, M)."""
    return _make_scan_dispatch(cfg, state, n_steps, cfg.grad_accum, store_s2d)
