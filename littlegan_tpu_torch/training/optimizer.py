"""Masked Adam with TF-v1 semantics, the port of littlegan_tpu/training/optimizer.py.

The reference runs three ``tf.compat.v1.train.AdamOptimizer``s and, under
the partition schedule, updates only some of a model's weights per step;
the others keep their Adam slots untouched. :func:`masked_adam_update`
takes a per-leaf 0/1 mask:

- a masked-off leaf keeps its moments, its count and its value;
- an active leaf takes the v1 update ``lr_t = lr * sqrt(1 - b2^t) /
  (1 - b1^t)``, ``p -= lr_t * m / (sqrt(v) + eps)`` (eps outside the sqrt).

The count is per leaf by default; ``tick_all=True`` (``Config.adam_tf_parity``)
advances every leaf's count on every call, v1's shared beta powers.

How this differs in form from the JAX function, not in result:

- Leaves are dicts ``name -> tensor`` (the model's parameter names), and the
  update happens IN PLACE under ``torch.no_grad()``: parameters, ``mu`` and
  ``nu`` are the same tensors afterwards. The function also returns them.
- Counts are Python ints on the host; ``b1**t``, ``b2**t`` and ``lr_t`` are
  evaluated in float32 with numpy, as JAX evaluates them in float32.
- Two forms. :func:`masked_adam_update` (the host-fed step) takes each mask
  as a Python number and makes the JAX function's where-select on the
  host: a masked-off leaf is not touched at all. :func:`masked_adam_update_rows`
  (the K-update dispatch, which cannot ask the host) takes the masks and
  step sizes as device tensors and selects with ``torch.where``, as JAX
  does; :func:`advance_counts` moves the host counts through those updates
  and gives their step sizes. Either way a non-finite gradient on a
  masked-off leaf cannot reach its moments or value (the reason JAX selects
  rather than multiplies), and both forms run the same float32 arithmetic
  on an active leaf, so they agree bit for bit.
- Leaves are updated with PyTorch's multi-tensor (``_foreach``) ops;
  moments stored in bfloat16 are upcast to float32 for the math and rounded
  back on store. Parameters are float32, as the model keeps them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch


def lr_scale_fn(
    kind: str, warmup_steps: int = 0, decay_steps: int = 0, min_ratio: float = 0.0
) -> Optional[Callable[[np.float32], np.float32]]:
    """``t -> scale`` over the float32 apply count t >= 1, or None for the
    constant-1 schedule (the update then skips the multiply, as in JAX):
    linear warmup ``min(t / warmup, 1)``, then over ``decay_steps`` applies a
    linear, cosine or exponential decay to ``min_ratio``, held after."""
    kinds = ("constant", "linear", "cosine", "exponential")
    if kind not in kinds:
        raise ValueError(f"lr_schedule must be one of {kinds}, got {kind!r}")
    decaying = kind != "constant" and decay_steps > 0
    if kind != "constant" and decay_steps <= 0 and warmup_steps <= 0:
        raise ValueError(
            f"lr_schedule={kind!r} does nothing without lr_decay_steps or "
            "lr_warmup_steps — set a horizon or use 'constant'"
        )
    if kind == "exponential" and decaying and min_ratio <= 0.0:
        raise ValueError("exponential lr_schedule needs lr_min_ratio > 0 (its decay floor)")
    if not 0.0 <= min_ratio <= 1.0:
        raise ValueError(f"lr_min_ratio must be in [0, 1], got {min_ratio}")
    if kind == "constant" and warmup_steps <= 0:
        return None
    f32 = np.float32

    def fn(t):
        t = f32(t)
        scale = np.minimum(t / f32(warmup_steps), f32(1.0)) if warmup_steps > 0 else f32(1.0)
        if decaying:
            p = np.clip((t - f32(warmup_steps)) / f32(decay_steps), f32(0.0), f32(1.0))
            r = f32(min_ratio)
            if kind == "linear":
                base = f32(1.0) - (f32(1.0) - r) * p
            elif kind == "cosine":
                base = r + (f32(1.0) - r) * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * p))
            else:
                base = r ** p
            scale = scale * base
        return f32(scale)

    return fn


def lr_scale_from_config(cfg):
    return lr_scale_fn(cfg.lr_schedule, cfg.lr_warmup_steps, cfg.lr_decay_steps, cfg.lr_min_ratio)


class AdamState(NamedTuple):
    count: Dict[str, int]  # per-leaf apply counts (int32 in a checkpoint)
    mu: Dict[str, torch.Tensor]  # first moments
    nu: Dict[str, torch.Tensor]  # second moments


def adam_init(params: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32) -> AdamState:
    """Zero moments in ``dtype`` (``Config.moment_dtype``: their storage
    only, the math is float32) and zero counts."""
    return AdamState(
        count={k: 0 for k in params},
        mu={k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()},
    )


def adam_lr_t(lr: float, b1: float, b2: float, count: int, lr_scale=None) -> float:
    """The v1 bias-corrected step size at apply count ``count``, in float32."""
    f32 = np.float32
    t = f32(max(count, 1))
    lr_t = f32(lr) * np.sqrt(f32(1.0) - f32(b2) ** t) / (f32(1.0) - f32(b1) ** t)
    if lr_scale is not None:
        lr_t = f32(lr_t * lr_scale(t))
    return float(f32(lr_t))


def _adam_math(g: List[torch.Tensor], m: List[torch.Tensor], v: List[torch.Tensor], steps: Sequence,
               b1: float, b2: float, eps: float, in_place: bool):
    """(m', v', the amounts to subtract from the parameters) of one v1 Adam
    update of each leaf, float32; m' and v' are m and v updated in place
    when ``in_place``. ``steps``: each leaf's ``lr_t``, Python floats or
    0-dim float32 tensors (the same product either way).

    Rounded in the JAX function's order: ``b1*m + (1-b1)*g``,
    ``b2*v + (1-b2)*(g*g)`` and ``(lr_t*m') / (sqrt(v') + eps)``, each
    product rounded on its own (no fused ``addcmul``/``alpha`` forms)."""
    if in_place:
        torch._foreach_mul_(m, b1)
        torch._foreach_mul_(v, b2)
        m_new, v_new = m, v
    else:
        m_new, v_new = torch._foreach_mul(m, b1), torch._foreach_mul(v, b2)
    torch._foreach_add_(m_new, torch._foreach_mul(g, 1.0 - b1))
    g2 = torch._foreach_mul(g, g)
    torch._foreach_mul_(g2, 1.0 - b2)
    torch._foreach_add_(v_new, g2)
    denom = torch._foreach_sqrt(v_new)
    torch._foreach_add_(denom, eps)
    delta = torch._foreach_mul(m_new, list(steps))
    torch._foreach_div_(delta, denom)
    return m_new, v_new, delta


@torch.no_grad()
def masked_adam_update(
    grads: Dict[str, torch.Tensor],
    state: AdamState,
    params: Dict[str, torch.Tensor],
    mask: Dict[str, float],
    lr: float,
    b1: float,
    b2: float,
    eps: float = 1e-8,
    tick_all: bool = False,
    lr_scale=None,
):
    """One masked Adam step, in place. ``mask``: a 0./1. per leaf. Returns
    (params, state), the same objects updated."""
    active = [k for k in params if float(mask[k]) > 0.5]
    for k in params:
        if tick_all or k in active:
            state.count[k] += 1
    if not active:
        return params, state
    steps = [adam_lr_t(lr, b1, b2, state.count[k], lr_scale) for k in active]
    m, v, delta = _adam_math([grads[k].float() for k in active], [state.mu[k].float() for k in active],
                             [state.nu[k].float() for k in active], steps, b1, b2, eps, in_place=True)
    torch._foreach_sub_([params[k] for k in active], delta)
    for k, mk, vk in zip(active, m, v):
        if state.mu[k].dtype != torch.float32:  # bf16 storage: round back
            state.mu[k].copy_(mk)
            state.nu[k].copy_(vk)
    return params, state


def advance_counts(
    state: AdamState, masks: np.ndarray, lr: float, b1: float, b2: float, tick_all: bool = False, lr_scale=None
) -> np.ndarray:
    """Move the host counts through K updates whose (K, leaves) 0/1 ``masks``
    (leaves in ``state.count``'s order) are given, as K calls of
    :func:`masked_adam_update` would; returns the (K, leaves) float32 step
    sizes ``lr_t`` those updates apply (a masked-off leaf's is unused)."""
    names = list(state.count)
    steps = np.zeros(masks.shape, np.float32)
    for i, row in enumerate(masks):
        for j, k in enumerate(names):
            if tick_all or row[j] > 0.5:
                state.count[k] += 1
            steps[i, j] = adam_lr_t(lr, b1, b2, state.count[k], lr_scale)
    return steps


@torch.no_grad()
def masked_adam_update_rows(
    grads: Dict[str, torch.Tensor],
    state: AdamState,
    params: Dict[str, torch.Tensor],
    mask: torch.Tensor,
    steps: torch.Tensor,
    b1: float,
    b2: float,
    eps: float = 1e-8,
) -> None:
    """One masked Adam step, in place, from device rows: ``mask`` and
    ``steps`` are (leaves,) float32 tensors in ``params``' order (the 0/1
    masks and the step sizes of :func:`advance_counts`). Every leaf's update
    is computed and ``torch.where`` keeps the old value, moments included,
    where the mask is 0. The host counts are not touched here."""
    names = list(params)
    on = mask > 0.5
    m, v, delta = _adam_math([grads[k].float() for k in names], [state.mu[k].float() for k in names],
                             [state.nu[k].float() for k in names], steps.unbind(), b1, b2, eps, in_place=False)
    for j, k in enumerate(names):
        p = params[k]
        torch.where(on[j], p - delta[j], p, out=p)
        for new, old in ((m[j], state.mu[k]), (v[j], state.nu[k])):
            torch.where(on[j], new.to(old.dtype), old, out=old)
