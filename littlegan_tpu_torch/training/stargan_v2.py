"""StarGAN v2's training iteration, the body of ``core/solver.py``'s loop,
and K iterations per CUDA-graph replay.

One iteration (:func:`iteration`), from a card-resident uint8 image store
and its labels:

1. the source batch, the reference batch and the second reference batch
   are gathered by id, cropped, resized and flipped (``ops/resample.py``);
   the labels of the source and reference batches are the source and
   target domains;
2. D latent-guided, then D reference-guided: BCE on the real and the fake
   logits plus ``lambda_reg`` times R1 (:func:`r1_reg`, a double backward
   through D), the fake made by G from a style of F (of z) or of E (of the
   reference) without gradient; each loss steps D's Adam;
3. G latent-guided with (z, z2), stepping G's, F's and E's Adams; G
   reference-guided with (x_ref, x_ref2), stepping G's only. Each loss is
   ``adv + lambda_sty * |E(fake) - s| - lambda_ds * |fake - fake2| +
   lambda_cyc * |G(fake, E(real)) - real|``, fake2 made without gradient;
4. the EMA of G, F and E (``lerp(param, ema, ema_decay)``).

Each gradient is ``torch.autograd.grad`` of the phase's loss with respect
to the networks its phase steps (the published ``backward()`` fills every
gradient and the steps use these). The six Adam steps follow
``torch.optim.Adam`` (``training/optimizer.py::adam_l2_update_rows``);
their step sizes and bias corrections, and the iteration's ``lambda_ds``,
come from a float32 row the host writes (:func:`schedule_rows`), so a
CUDA graph bakes in no number that changes with the iteration.

:func:`make_stargan_scan_step` runs K iterations per call through
``training/dispatch.py::GraphedUpdates``: one CUDA graph replay on the
card, R1's double backward inside it, eagerly on the CPU. The draws (z,
z2, the 3B crop boxes and flips) are made outside the graph
(:func:`draw_iteration`) and copied in; the ids and rows travel as the
graph's (K, width) float32 input.

Spans (``utils/spans.py``, under a profiler only): ``stargan_v2.d_latent``,
``.d_ref``, ``.g_latent``, ``.g_ref``, each holding ``.<phase>.grad`` (the
phase's ``autograd.grad``: in a D phase the BCE backward and R1's double
backward), ``.r1`` (R1's first backward, inside the D phases) and
``.ema``. Counters: the networks' calls (``models/stargan_v2.py``) and
``stargan_v2.r1``, 8 / 7 / 3 / 6 / 2 per iteration for G / E / F / D / R1.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models.stargan_v2 import check_supported
from littlegan_tpu_torch.ops.cuda._build import LaunchCounter
from littlegan_tpu_torch.ops.resample import crop_resize, draw_crops
from littlegan_tpu_torch.training.dispatch import GraphedUpdates
from littlegan_tpu_torch.training.optimizer import adam_l2_update_rows, torch_adam_step
from littlegan_tpu_torch.training.state import STARGAN_ADAMS, StarGANState, subtree
from littlegan_tpu_torch.training.step import state_tensors
from littlegan_tpu_torch.utils.spans import span

R1_CALLS = LaunchCounter("stargan_v2.r1")
LOSS_KEYS = ("d_latent.real", "d_latent.fake", "d_latent.reg", "d_ref.real", "d_ref.fake", "d_ref.reg",
             "g_latent.adv", "g_latent.sty", "g_latent.ds", "g_latent.cyc",
             "g_ref.adv", "g_ref.sty", "g_ref.ds", "g_ref.cyc")
NET_OF = {opt: net for opt, net in STARGAN_ADAMS}
# the iteration's six Adam steps in order: (phase, Adam)
STEPS = (("d_latent", "opt_d"), ("d_ref", "opt_d"), ("g_latent", "opt_g"), ("g_latent", "opt_f"),
         ("g_latent", "opt_e"), ("g_ref", "opt_g"))
ROW_WIDTH = 2 * len(STEPS) + 1  # each step's (step size, sqrt of bias correction 2), then lambda_ds


class StarGANDraws(NamedTuple):
    z: torch.Tensor  # (B, latent_dim) N(0, 1), latent-guided style
    z2: torch.Tensor  # (B, latent_dim), the diversity loss's second style
    boxes: torch.Tensor  # (3B, 4) crop boxes of the source, reference and second reference images
    flips: torch.Tensor  # (3B,) bool


def draw_iteration(gen: torch.Generator, cfg: Config, device) -> StarGANDraws:
    """One iteration's draws from ``gen`` (on ``device``): z, z2, then the
    3B images' crops and flips."""
    b = cfg.batch_size
    z = torch.randn((b, cfg.latent_dim), generator=gen, device=device)
    z2 = torch.randn((b, cfg.latent_dim), generator=gen, device=device)
    boxes, flips = draw_crops(gen, 3 * b, cfg.image_dim, cfg.randcrop_prob, device)
    return StarGANDraws(z, z2, boxes, flips)


def stack_draws(draws: Sequence[StarGANDraws]) -> StarGANDraws:
    return StarGANDraws(*(torch.stack(xs) for xs in zip(*draws)))


def lambda_ds_at(cfg: Config, it: int) -> float:
    """lambda_ds of iteration ``it`` (from 0): decayed linearly to 0 over ``ds_iter``."""
    return max(0.0, cfg.lambda_ds * (1.0 - it / cfg.ds_iter))


def schedule_rows(state: StarGANState, cfg: Config, iterations: Sequence[int], advance: bool = True) -> np.ndarray:
    """(K, ROW_WIDTH) float32: for each iteration its six Adam steps'
    (step size, sqrt of bias correction 2), advancing the host counts
    (unless ``advance`` is False), then its lambda_ds."""
    saved = None if advance else {opt: dict(getattr(state, opt).count) for opt in state.OPTS}
    rows = []
    for it in iterations:
        row = []
        for _, opt in STEPS:
            lr = cfg.f_lr if opt == "opt_f" else cfg.lr
            row += torch_adam_step(getattr(state, opt), lr, cfg.beta_1, cfg.beta_2)
        rows.append(row + [lambda_ds_at(cfg, it)])
    if saved is not None:
        for opt, counts in saved.items():
            getattr(state, opt).count.update(counts)
    return np.asarray(rows, np.float32).reshape(len(rows), ROW_WIDTH)


def adv_loss(logits: torch.Tensor, target: float) -> torch.Tensor:
    logits = logits.float()
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


def r1_reg(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R1: ``0.5 * mean_b sum (d sum(out) / dx)^2``, taken with ``create_graph``."""
    R1_CALLS.add()
    with span("stargan_v2.r1"):
        (g,) = torch.autograd.grad(out.float().sum(), x, create_graph=True)
        return 0.5 * g.float().square().reshape(x.shape[0], -1).sum(1).mean(0)


def d_loss(model, cfg: Config, x_real, y_org, y_trg, z=None, x_ref=None):
    """(loss, [real, fake, reg]) of a D phase, latent-guided with ``z``, else reference-guided."""
    x = x_real.detach().requires_grad_(True)
    out = model.discriminator(x, y_org)
    real = adv_loss(out, 1.0)
    reg = r1_reg(out, x)
    with torch.no_grad():
        s = model.mapping_network(z, y_trg) if z is not None else model.style_encoder(x_ref, y_trg)
        x_fake = model.generator(x_real, s)
    fake = adv_loss(model.discriminator(x_fake, y_trg), 0.0)
    return real + fake + cfg.lambda_reg * reg, [real, fake, reg]


def g_loss(model, cfg: Config, x_real, y_org, y_trg, lam_ds, latent: bool, guide, guide2):
    """(loss, [adv, sty, ds, cyc]) of a G phase: styles of F from (z, z2)
    when ``latent``, else of E from (x_ref, x_ref2)."""
    style = model.mapping_network if latent else model.style_encoder
    s_trg = style(guide, y_trg)
    x_fake = model.generator(x_real, s_trg)
    adv = adv_loss(model.discriminator(x_fake, y_trg), 1.0)
    sty = (model.style_encoder(x_fake, y_trg).float() - s_trg.float()).abs().mean()
    with torch.no_grad():  # the published code detaches fake2: no gradient reaches its pass
        x_fake2 = model.generator(x_real, style(guide2, y_trg))
    ds = (x_fake.float() - x_fake2.float()).abs().mean()
    x_rec = model.generator(x_fake, model.style_encoder(x_real, y_org))
    cyc = (x_rec.float() - x_real).abs().mean()
    return adv + cfg.lambda_sty * sty - lam_ds * ds + cfg.lambda_cyc * cyc, [adv, sty, ds, cyc]


def _step(state: StarGANState, cfg: Config, loss: torch.Tensor, cols: List[int], row: torch.Tensor) -> None:
    """The gradient of ``loss`` for the Adams of the steps ``cols`` (indices
    into :data:`STEPS`), then their updates from ``row``."""
    opts = [STEPS[c][1] for c in cols]
    params = [subtree(state.model, (NET_OF[opt],)) for opt in opts]
    flat = [p for ps in params for p in ps.values()]
    with span(f"stargan_v2.{STEPS[cols[0]][0]}.grad"):
        grads = iter(torch.autograd.grad(loss, flat))
    for c, opt, ps in zip(cols, opts, params):
        adam_l2_update_rows({k: next(grads) for k in ps}, getattr(state, opt), ps, row[2 * c], row[2 * c + 1],
                            cfg.beta_1, cfg.beta_2, cfg.weight_decay)


@torch.no_grad()
def update_ema(state: StarGANState, cfg: Config) -> None:
    if state.ema is None:
        return
    with span("stargan_v2.ema"):
        params = subtree(state.model, ("generator", "mapping_network", "style_encoder"))
        names = list(state.ema)
        ema = [state.ema[k] for k in names]
        torch._foreach_copy_(ema, torch._foreach_lerp([params[k] for k in names], ema, cfg.ema_decay))


def iteration(state: StarGANState, images: torch.Tensor, labels: torch.Tensor, ids: torch.Tensor,
              draws: StarGANDraws, row: torch.Tensor, cfg: Config) -> torch.Tensor:
    """One iteration in place on ``state``, reading nothing from the host:
    ``images`` the (N, H, W, 3) uint8 store, ``labels`` its (N,) int64
    domains, ``ids`` the (3B,) source, reference and second reference ids,
    ``row`` the iteration's :func:`schedule_rows` row. Returns the (14,)
    float32 loss terms (:data:`LOSS_KEYS`)."""
    b, model = cfg.batch_size, state.model
    x = crop_resize(images.index_select(0, ids), draws.boxes, draws.flips)
    y = labels.index_select(0, ids)
    x_real, x_ref, x_ref2 = x[:b], x[b:2 * b], x[2 * b:]
    y_org, y_trg = y[:b], y[b:2 * b]
    terms: List[torch.Tensor] = []
    with span("stargan_v2.d_latent"):
        loss, t = d_loss(model, cfg, x_real, y_org, y_trg, z=draws.z)
        _step(state, cfg, loss, [0], row)
        terms += t
    with span("stargan_v2.d_ref"):
        loss, t = d_loss(model, cfg, x_real, y_org, y_trg, x_ref=x_ref)
        _step(state, cfg, loss, [1], row)
        terms += t
    lam = row[-1]
    with span("stargan_v2.g_latent"):
        loss, t = g_loss(model, cfg, x_real, y_org, y_trg, lam, True, draws.z, draws.z2)
        _step(state, cfg, loss, [2, 3, 4], row)
        terms += t
    with span("stargan_v2.g_ref"):
        loss, t = g_loss(model, cfg, x_real, y_org, y_trg, lam, False, x_ref, x_ref2)
        _step(state, cfg, loss, [5], row)
        terms += t
    update_ema(state, cfg)
    return torch.stack([t.detach().float() for t in terms])


def make_stargan_scan_step(cfg: Config, state: StarGANState, n_steps: int):
    """K iterations per call: ``step(state, images, labels, ids (K, 3B),
    draws, it0)`` with ``draws`` the K iterations' :class:`StarGANDraws`
    stacked and iteration ``it0 + i`` the i-th (its lambda_ds and Adam
    counts). Returns the (K, 14) loss terms; the state is updated in place.
    ``step.prepare(state, images, labels)`` captures the CUDA graph ahead of
    the first call (on a CPU state nothing is captured: every call runs the
    iterations eagerly)."""
    check_supported(cfg)
    n_ids = 3 * cfg.batch_size

    def body(inputs, draws, state, images, labels):
        losses = []
        for i in range(inputs.shape[0]):
            d = StarGANDraws(*(x[i] for x in draws))
            losses.append(iteration(state, images, labels, inputs[i, :n_ids].long(), d, inputs[i, n_ids:], cfg))
        return torch.stack(losses)

    graphed = GraphedUpdates(body)

    def host_inputs(ids, rows) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(n_steps, n_ids)
        if ids.max() >= 1 << 24:
            raise ValueError("image ids must stay below 2**24 (they travel as float32)")
        return np.concatenate([ids, rows], axis=1).astype(np.float32)

    def step(state, images, labels, ids, draws: StarGANDraws, it0: int):
        with span("step.schedule"):
            inputs = host_inputs(ids, schedule_rows(state, cfg, range(it0, it0 + n_steps)))
        return graphed(inputs, draws, (state, images, labels), state_tensors(state))

    def prepare(state, images, labels):
        """Capture the CUDA graph now, from draws of a throwaway generator
        and rows that leave the counts as they are (on a CPU state: nothing)."""
        gen = torch.Generator(device=images.device).manual_seed(0)
        draws = stack_draws([draw_iteration(gen, cfg, images.device) for _ in range(n_steps)])
        rows = schedule_rows(state, cfg, range(n_steps), advance=False)
        graphed.prepare(host_inputs(np.zeros((n_steps, n_ids)), rows), draws, (state, images, labels),
                        state_tensors(state))

    step.prepare = prepare
    step.graphed = graphed
    return step


def eager_iterations(state: StarGANState, cfg: Config, images, labels, ids, draws: StarGANDraws,
                     it0: int) -> torch.Tensor:
    """The K iterations of one ``make_stargan_scan_step`` call run eagerly,
    one :func:`iteration` call each (no graph, on any device): the (K, 14)
    loss terms."""
    rows = torch.from_numpy(schedule_rows(state, cfg, range(it0, it0 + len(ids)))).to(images.device)
    ids = torch.as_tensor(np.asarray(ids, np.int64), device=images.device)
    return torch.stack([iteration(state, images, labels, ids[i], StarGANDraws(*(x[i] for x in draws)), rows[i], cfg)
                        for i in range(len(rows))])


def translate(model, cfg: Config, x: torch.Tensor, z: torch.Tensor,
              ema: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """(B, domains, 3, H, W) float32: each image of ``x`` (NCHW in [-1, 1])
    turned into every domain with the styles F gives ``z``, with the EMA
    weights swapped in when given (the sample grids)."""
    live = {}
    with torch.no_grad():
        if ema is not None:
            params = dict(model.named_parameters())
            for k, e in ema.items():
                live[k] = params[k].detach().clone()
                params[k].copy_(e)
        try:
            outs = []
            for d in range(cfg.num_domains):
                y = torch.full((x.shape[0],), d, dtype=torch.long, device=x.device)
                outs.append(model.generator(x, model.mapping_network(z, y)).float())
        finally:
            for k, v in live.items():
                params[k].copy_(v)
    return torch.stack(outs, 1)
