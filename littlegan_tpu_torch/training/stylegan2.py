"""StyleGAN2's training iteration (``training/loss.py::StyleGAN2Loss`` and
``training/training_loop.py`` of NVlabs/stylegan2-ada-pytorch, lazy
regularisation), and K iterations per CUDA-graph replay.

One iteration (:func:`iteration`), from a card-resident uint8 image store,
runs its phases in order, each that runs taking an Adam step of its
network:

1. Gmain: ``softplus(-D(G(z)))``, stepping G;
2. Greg, on iterations ``it % g_reg_interval == 0``, at batch ``B / 2``:
   ``g = d sum(G(w) * n) / dw`` (n the path-length noise over ``sqrt(H
   W)``, with ``create_graph``), ``len = sqrt(mean_ws sum g^2)``,
   ``pl_mean <- lerp(pl_mean, mean(len), 0.01)`` (with its gradient),
   loss ``(len - pl_mean)^2 * PL_WEIGHT * g_reg_interval``, stepping G;
3. Dmain: ``softplus(D(G(z))) + softplus(-D(x))``, G run without gradient,
   stepping D;
4. Dreg, on iterations ``it % d_reg_interval == 0``: ``sum (d sum D(x) /
   dx)^2 * R1_GAMMA / 2 * d_reg_interval``, stepping D;
5. the EMA of G (``lerp(param, ema, 0.5 ** (B / (EMA_KIMG * 1000)))``),
   its buffer ``w_avg`` copied.

Each G pass maps z to w (updating ``w_avg``), broadcasts it to the
``num_ws`` layers and, with probability ``STYLE_MIXING``, takes the layers
from a cutoff drawn uniform over ``1 .. num_ws - 1`` from a second z's w:
a mask by layer index, so that the graph stays static. Each G pass draws
its own noise maps.

The Adams are ``torch.optim.Adam``'s arithmetic
(``training/optimizer.py::adam_l2_update_rows``, weight decay 0, eps 1e-8)
with the lazy ratio ``c = interval / (interval + 1)``: lr times c, betas to
the power c; one Adam a network, its main and regularisation phases
stepping it alike. A penalty's gradient reaches no ToRGB bias of G (path
length) and no bias of D's 4x4 epilogue (R1): the published losses add
``img * 0`` and ``logits * 0`` to the penalty, so those leaves get a zero
gradient and their Adam steps them (count and second moment) as every
other leaf. A step's row carries its (step size, sqrt of bias correction
2) pair (:func:`schedule_rows`); the host advances the counts.

:func:`make_stylegan2_scan_step` runs K iterations per call through
``training/dispatch.py::GraphedUpdates``: one CUDA graph replay on the
card (both double backwards inside it), eagerly on the CPU. Which phases
run is fixed by the iterations' numbers, so a call's graph is that of its
phase pattern: a K of ``d_reg_interval`` = 16 from an iteration that is a
multiple of 16 replays one graph for every call. An iteration's draws
(the real ids and x-flips, each pass's z, mixing z, cutoff and noise maps,
the path-length noise) are made outside the graph (:func:`draw_iteration`)
and copied in; the schedule rows travel as the graph's (K, 8) float32
input.

Spans (``utils/spans.py``, under a profiler only): ``stylegan2.g_main``,
``.g_reg``, ``.d_main``, ``.d_reg``, each holding ``.<phase>.grad`` (the
phase's ``autograd.grad``: in a reg phase the penalty's double backward),
``.pl`` and ``.r1`` (the penalties' first backwards, inside Greg and Dreg)
and ``.ema``. Counters: the networks' calls (``models/stylegan2.py``) and
``stylegan2.pl`` / ``stylegan2.r1``.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models.stylegan2 import PL_BATCH_SHRINK, check_supported, noise_sizes, num_ws
from littlegan_tpu_torch.ops.cuda._build import LaunchCounter
from littlegan_tpu_torch.ops.gradfix import no_weight_gradients
from littlegan_tpu_torch.training.dispatch import GraphedUpdates
from littlegan_tpu_torch.training.optimizer import adam_l2_update_rows, torch_adam_step
from littlegan_tpu_torch.training.state import StyleGAN2State, subtree
from littlegan_tpu_torch.training.step import state_tensors
from littlegan_tpu_torch.utils.spans import span

PL_CALLS = LaunchCounter("stylegan2.pl")
R1_CALLS = LaunchCounter("stylegan2.r1")
LOSS_KEYS = ("g_main", "pl_penalty", "d_fake", "d_real", "r1_penalty", "pl_mean")
# paper256's loss and EMA settings (loss.py, train.py), fixed here
R1_GAMMA = 1.0
PL_WEIGHT = 2.0
PL_DECAY = 0.01  # pl_mean's lerp weight
STYLE_MIXING = 0.9  # the probability of a mixing cutoff in a G pass
EMA_KIMG = 20.0  # the EMA's half-life in thousands of images
W_AVG = "G.mapping.w_avg"  # the EMA's key of the mapping's w_avg buffer
STEPS = (("g_main", "G"), ("g_reg", "G"), ("d_main", "D"), ("d_reg", "D"))  # an iteration's Adam steps in order
ROW_WIDTH = 2 * len(STEPS)


class GDraws(NamedTuple):
    z: torch.Tensor  # (n, z_dim)
    z2: torch.Tensor  # (n, z_dim), the mixing style's
    cutoff: torch.Tensor  # () int64: the first layer of the mixing style (num_ws: no mixing)
    noise: torch.Tensor  # (n, sum of res^2) the layers' noise maps, in compute dtype


class StyleGAN2Draws(NamedTuple):
    ids: torch.Tensor  # (B,) int64 real ids into the store
    flips: torch.Tensor  # (B,) bool x-flips
    g_main: GDraws
    d_main: GDraws
    g_reg: Optional[GDraws] = None  # on Greg iterations
    pl_noise: Optional[torch.Tensor] = None  # (B / 2, 3, H, W) N(0, 1)


def runs(cfg: Config, it: int) -> Tuple[bool, bool]:
    """(Greg, Dreg) of iteration ``it`` (from 0)."""
    return it % cfg.g_reg_interval == 0, it % cfg.d_reg_interval == 0


def pattern(cfg: Config, it0: int, n: int) -> Tuple[Tuple[bool, bool], ...]:
    return tuple(runs(cfg, it) for it in range(it0, it0 + n))


def pl_batch(cfg: Config) -> int:
    return cfg.batch_size // PL_BATCH_SHRINK


def draw_g(gen: torch.Generator, cfg: Config, n: int, device) -> GDraws:
    nws = num_ws(cfg.image_dim)
    z = torch.randn((n, cfg.z_dim), generator=gen, device=device)
    z2 = torch.randn((n, cfg.z_dim), generator=gen, device=device)
    cut = torch.randint(1, nws, (), generator=gen, device=device)
    mix = torch.rand((), generator=gen, device=device) < STYLE_MIXING
    cutoff = torch.where(mix, cut, torch.full_like(cut, nws))
    size = sum(r * r for r in noise_sizes(cfg.image_dim))
    noise = torch.randn((n, size), generator=gen, device=device, dtype=getattr(torch, cfg.compute_dtype))
    return GDraws(z, z2, cutoff, noise)


def draw_iteration(gen: torch.Generator, cfg: Config, device, it: int, n_store: int) -> StyleGAN2Draws:
    """Iteration ``it``'s draws from ``gen`` (on ``device``): the real ids
    (uniform over the store) and x-flips, then Gmain's, Greg's (on its
    iterations, with the path-length noise) and Dmain's."""
    b = cfg.batch_size
    ids = torch.randint(0, n_store, (b,), generator=gen, device=device)
    flips = torch.rand((b,), generator=gen, device=device) < 0.5  # --mirror=1
    g_main = draw_g(gen, cfg, b, device)
    g_reg = pl_noise = None
    if runs(cfg, it)[0]:
        g_reg = draw_g(gen, cfg, pl_batch(cfg), device)
        d = cfg.image_dim
        pl_noise = torch.randn((pl_batch(cfg), 3, d, d), generator=gen, device=device)
    return StyleGAN2Draws(ids, flips, g_main, draw_g(gen, cfg, b, device), g_reg, pl_noise)


def _stack(xs):
    return None if not xs else (GDraws(*(torch.stack(f) for f in zip(*xs))) if isinstance(xs[0], GDraws)
                                else torch.stack(xs))


def stack_draws(draws: Sequence[StyleGAN2Draws]) -> StyleGAN2Draws:
    """K iterations' draws stacked; Greg's over the Greg iterations alone."""
    return StyleGAN2Draws(*(_stack([getattr(d, f) for d in draws if getattr(d, f) is not None])
                            for f in StyleGAN2Draws._fields))


def draw_at(draws: StyleGAN2Draws, pat, i: int) -> StyleGAN2Draws:
    """Iteration i's draws out of :func:`stack_draws`'s, ``pat`` the call's :func:`pattern`."""
    def at(x, j):
        return None if x is None else (GDraws(*(f[j] for f in x)) if isinstance(x, GDraws) else x[j])

    r = sum(g for g, _ in pat[:i])
    reg = pat[i][0]
    return StyleGAN2Draws(at(draws.ids, i), at(draws.flips, i), at(draws.g_main, i), at(draws.d_main, i),
                          at(draws.g_reg, r) if reg else None, at(draws.pl_noise, r) if reg else None)


# ------------------------------------------------------------------ Adam rows --


def lazy(cfg: Config, net: str) -> Tuple[float, float, float]:
    """(lr, beta_1, beta_2) of a network's Adam with the lazy ratio."""
    interval = cfg.g_reg_interval if net == "G" else cfg.d_reg_interval
    c = interval / (interval + 1) if interval > 0 else 1.0
    return cfg.lr * c, cfg.beta_1 ** c, cfg.beta_2 ** c


def schedule_rows(state: StyleGAN2State, cfg: Config, iterations: Sequence[int], advance: bool = True) -> np.ndarray:
    """(K, ROW_WIDTH) float32: each iteration's :data:`STEPS` pairs (zeros
    for a phase that does not run), advancing the host counts (unless
    ``advance`` is False)."""
    saved = None if advance else {opt: dict(getattr(state, opt).count) for opt in state.OPTS}
    rows = []
    for it in iterations:
        g_reg, d_reg = runs(cfg, it)
        row = []
        for phase, net in STEPS:
            on = {"g_reg": g_reg, "d_reg": d_reg}.get(phase, True)
            adam = state.opt_g if net == "G" else state.opt_d
            row += torch_adam_step(adam, *lazy(cfg, net)) if on else [0.0, 0.0]
        rows.append(row)
    if saved is not None:
        for opt, counts in saved.items():
            getattr(state, opt).count.update(counts)
    return np.asarray(rows, np.float32).reshape(len(rows), ROW_WIDTH)


# ----------------------------------------------------------------- iteration --


def make_ws(model, cfg: Config, d: GDraws) -> torch.Tensor:
    """(n, num_ws, w_dim) styles of a G pass: w of z (``w_avg`` updated),
    the layers from the cutoff on from the mixing z's w."""
    mapping = model.G.mapping
    w = mapping(d.z, update_w_avg=True)
    nws = num_ws(cfg.image_dim)
    w2 = mapping(d.z2)
    mix = (torch.arange(nws, device=w.device) >= d.cutoff)[None, :, None]
    return torch.where(mix, w2[:, None], w[:, None])


def real_images(images: torch.Tensor, ids: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) float32 in [-1, 1] of the store's uint8 NHWC images, mirrored where ``flips``."""
    x = images.index_select(0, ids).permute(0, 3, 1, 2).float() / 127.5 - 1.0
    return torch.where(flips[:, None, None, None], x.flip(3), x)


def _step(state: StyleGAN2State, cfg: Config, loss: torch.Tensor, col: int, row: torch.Tensor) -> None:
    """The gradient of ``loss`` for every leaf of step ``col``'s network
    (index into :data:`STEPS`; zero where it does not reach), then its Adam
    update from ``row``."""
    phase, net = STEPS[col]
    params = subtree(state.model, (net,))
    with span(f"stylegan2.{phase}.grad"):
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True, materialize_grads=True)
    _, b1, b2 = lazy(cfg, net)
    adam_l2_update_rows(dict(zip(params, grads)), state.opt_g if net == "G" else state.opt_d, params,
                        row[2 * col], row[2 * col + 1], b1, b2, 0.0)


def g_main(state: StyleGAN2State, cfg: Config, d: GDraws) -> torch.Tensor:
    model = state.model
    img = model.G.synthesis(make_ws(model, cfg, d), d.noise)
    return F.softplus(-model.D(img)).mean()


def path_length(state: StyleGAN2State, cfg: Config, d: GDraws, pl_noise: torch.Tensor):
    """(loss, mean penalty) of Greg; ``state.pl_mean`` moved on."""
    model = state.model
    ws = make_ws(model, cfg, d)
    img = model.G.synthesis(ws, d.noise)
    n = pl_noise / math.sqrt(img.shape[2] * img.shape[3])
    PL_CALLS.add()
    with span("stylegan2.pl"), no_weight_gradients():
        (g,) = torch.autograd.grad((img * n).sum(), ws, create_graph=True)
    lengths = g.square().sum(2).mean(1).sqrt()
    pl_mean = state.pl_mean.lerp(lengths.mean(), PL_DECAY)
    penalty = (lengths - pl_mean).square()
    with torch.no_grad():
        state.pl_mean.copy_(pl_mean)
    return (penalty * PL_WEIGHT).mean() * cfg.g_reg_interval, penalty.mean()


def d_main(state: StyleGAN2State, cfg: Config, d: GDraws, x_real: torch.Tensor):
    model = state.model
    with torch.no_grad():
        img = model.G.synthesis(make_ws(model, cfg, d), d.noise)
    fake = F.softplus(model.D(img)).mean()
    real = F.softplus(-model.D(x_real)).mean()
    return fake, real


def r1(state: StyleGAN2State, cfg: Config, x_real: torch.Tensor):
    """(loss, mean penalty) of Dreg."""
    x = x_real.detach().requires_grad_(True)
    logits = state.model.D(x)
    R1_CALLS.add()
    with span("stylegan2.r1"), no_weight_gradients():
        (g,) = torch.autograd.grad(logits.sum(), x, create_graph=True)
    penalty = g.square().sum((1, 2, 3))
    return (penalty * (R1_GAMMA / 2)).mean() * cfg.d_reg_interval, penalty.mean()


@torch.no_grad()
def update_ema(state: StyleGAN2State, cfg: Config) -> None:
    with span("stylegan2.ema"):
        beta = ema_beta(cfg)
        params = subtree(state.model, ("G",))
        names = [k for k in state.ema if k in params]
        ema = [state.ema[k] for k in names]
        torch._foreach_copy_(ema, torch._foreach_lerp([params[k] for k in names], ema, beta))
        state.ema[W_AVG].copy_(state.model.G.mapping.w_avg)


def ema_beta(cfg: Config) -> float:
    return 0.5 ** (cfg.batch_size / (EMA_KIMG * 1000))


def iteration(state: StyleGAN2State, images: torch.Tensor, draws: StyleGAN2Draws, row: torch.Tensor,
              cfg: Config, reg: Tuple[bool, bool]) -> torch.Tensor:
    """One iteration in place on ``state``, reading nothing from the host:
    ``images`` the (N, H, W, 3) uint8 store, ``row`` the iteration's
    :func:`schedule_rows` row, ``reg`` its (Greg, Dreg). Returns the (6,)
    float32 terms (:data:`LOSS_KEYS`; 0 for a phase that did not run)."""
    zero = torch.zeros((), device=images.device)
    x_real = real_images(images, draws.ids, draws.flips)
    with span("stylegan2.g_main"):
        loss = g_main(state, cfg, draws.g_main)
        _step(state, cfg, loss, 0, row)
        terms = [loss]
    with span("stylegan2.g_reg"):
        if reg[0]:
            loss, pen = path_length(state, cfg, draws.g_reg, draws.pl_noise)
            _step(state, cfg, loss, 1, row)
        terms.append(pen if reg[0] else zero)
    with span("stylegan2.d_main"):
        fake, real = d_main(state, cfg, draws.d_main, x_real)
        _step(state, cfg, fake + real, 2, row)
        terms += [fake, real]
    with span("stylegan2.d_reg"):
        if reg[1]:
            loss, pen = r1(state, cfg, x_real)
            _step(state, cfg, loss, 3, row)
        terms.append(pen if reg[1] else zero)
    update_ema(state, cfg)
    terms.append(state.pl_mean.clone())
    return torch.stack([t.detach().float() for t in terms])


def stylegan2_state_tensors(state: StyleGAN2State) -> List[torch.Tensor]:
    """Every tensor an iteration writes: :func:`state_tensors`' and ``w_avg``, ``pl_mean``."""
    return state_tensors(state) + [state.model.G.mapping.w_avg, state.pl_mean]


def make_stylegan2_scan_step(cfg: Config, state: StyleGAN2State, n_steps: int):
    """K iterations per call: ``step(state, images, draws, it0)`` with
    ``draws`` the K iterations' :class:`StyleGAN2Draws` stacked
    (:func:`stack_draws`) and iteration ``it0 + i`` the i-th (its phases and
    Adam counts). Returns the (K, 6) terms; the state is updated in place.
    Each phase pattern captures a CUDA graph of its own at its first call
    (``step.prepare(state, images, it0)`` ahead of it); on a CPU state every
    call runs the iterations eagerly."""
    check_supported(cfg)
    graphs: Dict[tuple, GraphedUpdates] = {}

    def graph_of(pat) -> GraphedUpdates:
        if pat not in graphs:
            def body(inputs, draws, state, images):
                return torch.stack([iteration(state, images, draw_at(draws, pat, i), inputs[i], cfg, pat[i])
                                    for i in range(len(pat))])
            graphs[pat] = GraphedUpdates(body)
        return graphs[pat]

    def step(state, images, draws: StyleGAN2Draws, it0: int):
        pat = pattern(cfg, it0, n_steps)
        with span("step.schedule"):
            rows = schedule_rows(state, cfg, range(it0, it0 + n_steps))
        return graph_of(pat)(rows, draws, (state, images), stylegan2_state_tensors(state))

    def prepare(state, images, it0: int = 0):
        """Capture the graph of the call at ``it0`` now, from draws of a
        throwaway generator and rows that leave the counts as they are (on
        a CPU state: nothing)."""
        gen = torch.Generator(device=images.device).manual_seed(0)
        draws = stack_draws([draw_iteration(gen, cfg, images.device, it, images.shape[0])
                             for it in range(it0, it0 + n_steps)])
        rows = schedule_rows(state, cfg, range(it0, it0 + n_steps), advance=False)
        graph_of(pattern(cfg, it0, n_steps)).prepare(rows, draws, (state, images), stylegan2_state_tensors(state))

    step.prepare = prepare
    step.graphs = graphs
    return step


def eager_iterations(state: StyleGAN2State, cfg: Config, images, draws: StyleGAN2Draws, it0: int) -> torch.Tensor:
    """The K iterations of one ``make_stylegan2_scan_step`` call run eagerly,
    one :func:`iteration` call each (no graph, on any device): the (K, 6) terms."""
    pat = pattern(cfg, it0, len(draws.ids))
    rows = torch.from_numpy(schedule_rows(state, cfg, range(it0, it0 + len(pat)))).to(images.device)
    return torch.stack([iteration(state, images, draw_at(draws, pat, i), rows[i], cfg, pat[i])
                        for i in range(len(pat))])


@torch.no_grad()
def generate(state: StyleGAN2State, cfg: Config, z: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) float32 images of the EMA generator from z, without
    mixing or ``w_avg`` updates (the sample grids)."""
    model = state.model
    live = {}
    params = dict(model.G.named_parameters())
    for k, e in state.ema.items():
        if k.startswith("G.") and k[2:] in params:
            live[k] = params[k[2:]].detach().clone()
            params[k[2:]].copy_(e)
    try:
        w = model.G.mapping(z)
        return model.G.synthesis(w[:, None].expand(-1, num_ws(cfg.image_dim), -1), noise).float()
    finally:
        for k, v in live.items():
            params[k[2:]].copy_(v)
