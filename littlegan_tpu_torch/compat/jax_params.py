"""Load a JAX parameter set into the port's :class:`LittleGAN`.

The JAX package flattens its parameter pytree to path keys
(``training/checkpoint.py::_flatten``): ``encoder/block1/conv/kernel``,
``g_head/norm/gamma``, ... The port's modules keep the same names with dots
and the same array layouts (HWIO conv kernels, ``(kh, kw, out, in)``
transposed-conv kernels, ``(in, out)`` dense kernels), so a key maps to one
parameter and an array loads as it is; the layout permutes to PyTorch's
happen in ``ops/conv.py`` at each call.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from littlegan_tpu_torch.models.littlegan import LittleGAN


def jax_key(param_name: str) -> str:
    """``encoder.block1.conv.kernel`` -> ``encoder/block1/conv/kernel``."""
    return param_name.replace(".", "/")


def params_from_jax(flat: Mapping[str, np.ndarray], model: LittleGAN) -> LittleGAN:
    """Copy JAX-keyed arrays into ``model``'s parameters in place and return
    it. Every parameter must have its key, with the same shape (KeyError,
    ValueError otherwise); keys the model has no parameter for are ignored,
    as the JAX package's template restore does."""
    named = dict(model.named_parameters())
    missing = [jax_key(n) for n in named if jax_key(n) not in flat]
    if missing:
        raise KeyError(f"JAX parameters missing: {missing}")
    for name, p in named.items():
        arr = np.asarray(flat[jax_key(name)])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(
                f"JAX parameter {jax_key(name)} has shape {arr.shape}, the model expects {tuple(p.shape)}"
            )
        with torch.no_grad():
            p.copy_(torch.tensor(arr, dtype=torch.float32))
    return model

