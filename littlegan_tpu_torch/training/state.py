"""Train state: the shared model and three Adam states, the port of
littlegan_tpu/training/state.py.

The three optimizers own disjoint parts of the one :class:`LittleGAN`:

    opt_d: encoder + d_head             (D trains the shared encoder)
    opt_g: g_head + decoder + out_conv  (G trains the shared decoder/out conv)
    opt_a: adj_head                     (the reference trains only its own head)

G and D use Adam(lr, beta_1, beta_2); the adjuster's Adam the default betas
(0.9, 0.999). ``ema`` is a float32 copy of G's parameters when
``Config.ema_decay > 0``, else None.

:class:`StarGANState` is StarGAN v2's (``Config.model = "stargan_v2"``):
its four networks, one ``torch.optim.Adam``-form state per network
(``opt_g``, ``opt_f``, ``opt_e``, ``opt_d``) and the EMA of G, F and E.
Each state's ``OPTS`` names its Adams, in the order checkpoints store them.

:class:`StyleGAN2State` is StyleGAN2's (``Config.model = "stylegan2"``):
G and D, one ``torch.optim.Adam``-form state each (``opt_g``, ``opt_d``),
the EMA of G's parameters and of its ``w_avg`` buffer, and ``pl_mean``,
the path-length penalty's running mean.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models import stargan_v2, stylegan2
from littlegan_tpu_torch.models.littlegan import LittleGAN, init_params
from littlegan_tpu_torch.training.optimizer import AdamState, adam_init

G_KEYS = ("g_head", "decoder", "out_conv")
D_KEYS = ("encoder", "d_head")
A_KEYS = ("adj_head",)


class TrainState(NamedTuple):
    OPTS = ("opt_g", "opt_d", "opt_a")
    model: LittleGAN
    opt_g: AdamState
    opt_d: AdamState
    opt_a: AdamState
    ema: Optional[Dict[str, torch.Tensor]] = None


def subtree(model: LittleGAN, keys: Sequence[str]) -> Dict[str, torch.nn.Parameter]:
    """``name -> parameter`` for the parameters under the top-level parts ``keys``."""
    return {n: p for n, p in model.named_parameters() if n.split(".", 1)[0] in keys}


def check_state_config(cfg: Config) -> None:
    if not 0.0 <= cfg.ema_decay < 1.0:
        raise ValueError(
            f"ema_decay must be in [0, 1), got {cfg.ema_decay}: 1.0 freezes "
            "the EMA at the random init (every eval/export would silently "
            "emit untrained weights) and >1 diverges"
        )
    if cfg.moment_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"moment_dtype must be 'float32' or 'bfloat16', got "
            f"{cfg.moment_dtype!r} (Adam math is always f32; this only "
            "picks the mu/nu STORAGE dtype)"
        )


def create_train_state(cfg: Config, device=None, model: Optional[LittleGAN] = None) -> TrainState:
    """A fresh state on ``device``: ``model`` if given, else a seeded
    ``init_params(cfg, cfg.seed)``; zero moments in ``cfg.moment_dtype``."""
    check_state_config(cfg)
    model = (init_params(cfg, cfg.seed) if model is None else model).to(device)
    mdt = getattr(torch, cfg.moment_dtype)
    g = subtree(model, G_KEYS)
    return TrainState(
        model=model,
        opt_g=adam_init(g, mdt),
        opt_d=adam_init(subtree(model, D_KEYS), mdt),
        opt_a=adam_init(subtree(model, A_KEYS), mdt),
        ema={k: p.detach().clone() for k, p in g.items()} if cfg.ema_decay > 0 else None,
    )


def eval_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """``name -> tensor`` for inference: the live parameters with the EMA of
    G's parts over them when there is one."""
    params = {n: p.detach() for n, p in state.model.named_parameters()}
    if state.ema is not None:
        params.update(state.ema)
    return params


# StarGAN v2's networks by the Adam that steps each
STARGAN_ADAMS = (("opt_g", "generator"), ("opt_f", "mapping_network"), ("opt_e", "style_encoder"),
                 ("opt_d", "discriminator"))


class StarGANState(NamedTuple):
    OPTS = tuple(opt for opt, _ in STARGAN_ADAMS)
    model: stargan_v2.StarGANv2
    opt_g: AdamState
    opt_f: AdamState
    opt_e: AdamState
    opt_d: AdamState
    ema: Optional[Dict[str, torch.Tensor]] = None  # G's, F's and E's parameters


def create_stargan_state(cfg: Config, device=None, model: Optional[stargan_v2.StarGANv2] = None) -> StarGANState:
    """A fresh StarGAN v2 state on ``device``: ``model`` if given, else
    ``he_init`` from ``cfg.seed``; zero float32 moments and counts; the EMA
    (``ema_decay > 0``) a copy of G's, F's and E's weights."""
    check_state_config(cfg)
    if cfg.moment_dtype != "float32":
        raise ValueError("stargan_v2 keeps float32 moments (moment_dtype float32), as torch.optim.Adam does")
    if model is None:
        model = stargan_v2.init_params(stargan_v2.StarGANv2(cfg), cfg.seed)
    model = model.to(device)
    opts = {opt: adam_init(subtree(model, (net,))) for opt, net in STARGAN_ADAMS}
    ema = None
    if cfg.ema_decay > 0:
        ema = {k: p.detach().clone() for k, p in subtree(model, ("generator", "mapping_network", "style_encoder")).items()}
    return StarGANState(model=model, ema=ema, **opts)


class StyleGAN2State(NamedTuple):
    OPTS = ("opt_g", "opt_d")
    model: stylegan2.StyleGAN2
    opt_g: AdamState
    opt_d: AdamState
    pl_mean: torch.Tensor  # () float32
    ema: Dict[str, torch.Tensor]  # G's parameters and w_avg


def create_stylegan2_state(cfg: Config, device=None, model: Optional[stylegan2.StyleGAN2] = None) -> StyleGAN2State:
    """A fresh StyleGAN2 state on ``device``: ``model`` if given, else the
    published init from ``cfg.seed``; zero float32 moments and counts,
    ``pl_mean`` 0; the EMA a copy of G's weights and ``w_avg``."""
    check_state_config(cfg)
    if cfg.moment_dtype != "float32":
        raise ValueError("stylegan2 keeps float32 moments (moment_dtype float32), as torch.optim.Adam does")
    if model is None:
        model = stylegan2.init_params(stylegan2.StyleGAN2(cfg), cfg.seed)
    model = model.to(device)
    ema = {k: p.detach().clone() for k, p in subtree(model, ("G",)).items()}
    ema["G.mapping.w_avg"] = model.G.mapping.w_avg.detach().clone()
    return StyleGAN2State(model=model, opt_g=adam_init(subtree(model, ("G",))), opt_d=adam_init(subtree(model, ("D",))),
                          pl_mean=torch.zeros((), device=model.G.mapping.w_avg.device), ema=ema)
