"""Train state: the shared model and three Adam states, the port of
littlegan_tpu/training/state.py.

The three optimizers own disjoint parts of the one :class:`LittleGAN`:

    opt_d: encoder + d_head             (D trains the shared encoder)
    opt_g: g_head + decoder + out_conv  (G trains the shared decoder/out conv)
    opt_a: adj_head                     (the reference trains only its own head)

G and D use Adam(lr, beta_1, beta_2); the adjuster's Adam the default betas
(0.9, 0.999). ``ema`` is a float32 copy of G's parameters when
``Config.ema_decay > 0``, else None.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models.littlegan import LittleGAN, init_params
from littlegan_tpu_torch.training.optimizer import AdamState, adam_init

G_KEYS = ("g_head", "decoder", "out_conv")
D_KEYS = ("encoder", "d_head")
A_KEYS = ("adj_head",)


class TrainState(NamedTuple):
    model: LittleGAN
    opt_g: AdamState
    opt_d: AdamState
    opt_a: AdamState
    ema: Optional[Dict[str, torch.Tensor]] = None


def subtree(model: LittleGAN, keys: Sequence[str]) -> Dict[str, torch.nn.Parameter]:
    """``name -> parameter`` for the parameters under the top-level parts ``keys``."""
    return {n: p for n, p in model.named_parameters() if n.split(".", 1)[0] in keys}


def create_train_state(cfg: Config, device=None, model: Optional[LittleGAN] = None) -> TrainState:
    """A fresh state on ``device``: ``model`` if given, else a seeded
    ``init_params(cfg, cfg.seed)``; zero moments in ``cfg.moment_dtype``."""
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
