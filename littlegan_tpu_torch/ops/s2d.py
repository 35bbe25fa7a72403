"""Space-to-depth (2x2 block) execution of the image-resolution boundary.

The port's copy of littlegan_tpu/ops/s2d.py, with the same index algebra.
Every full-resolution image tensor is carried as its 2x2-block
rearrangement ``[N, H/2, W/2, 4C]`` with channel order (row phase, col
phase, c), and the three boundary convolutions become 3x3 block-space
convolutions whose kernels are exact rearrangements of the reference-shaped
5x5 parameters:

- encoder block1 (5x5 stride-2 SAME conv):           K[m, q]    = w[2m + q - 1]
- decoder block4 (5x5 stride-2 SAME transposed conv): K[m, p]    = w[3 - 2m + p]
- out_conv (5x5 stride-1 SAME transposed conv):       K[m, p, q] = w[4 - 2m + p - q]

(zero outside [0, 5), per spatial axis). Each kernel is one gather over a
zero-ring-padded copy of the parameter, so the parameters keep their
reference shapes. The model's modules hold the gather indices as buffers
(:func:`register_index`); a call without them makes them for that call.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/2, W/2, 4C], channel order (pi, pj, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    n, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 2 * h, 2 * w, c)


def _conv1_index():
    m = np.arange(3)[:, None, None, None]
    n = np.arange(3)[None, :, None, None]
    qi = np.arange(2)[None, None, :, None]
    qj = np.arange(2)[None, None, None, :]
    return (np.broadcast_to(2 * m + qi, (3, 3, 2, 2)),  # 2m + q - 1, +1 for the ring
            np.broadcast_to(2 * n + qj, (3, 3, 2, 2)))


def _deconv_index():
    m = np.arange(3)[:, None, None, None]
    n = np.arange(3)[None, :, None, None]
    pi = np.arange(2)[None, None, :, None]
    pj = np.arange(2)[None, None, None, :]
    return (np.broadcast_to(4 - 2 * m + pi, (3, 3, 2, 2)),  # 3 - 2m + p, +1 for the ring
            np.broadcast_to(4 - 2 * n + pj, (3, 3, 2, 2)))


def _outconv_index():
    sh = (3, 3, 2, 2, 2, 2)  # m, n, pi, pj, qi, qj
    m = np.arange(3).reshape(3, 1, 1, 1, 1, 1)
    n = np.arange(3).reshape(1, 3, 1, 1, 1, 1)
    pi = np.arange(2).reshape(1, 1, 2, 1, 1, 1)
    pj = np.arange(2).reshape(1, 1, 1, 2, 1, 1)
    qi = np.arange(2).reshape(1, 1, 1, 1, 2, 1)
    qj = np.arange(2).reshape(1, 1, 1, 1, 1, 2)
    return (np.broadcast_to(5 - 2 * m + pi - qi, sh),  # 4 - 2m + p - q, +1 for the ring
            np.broadcast_to(5 - 2 * n + pj - qj, sh))


# the (row, column) gather indices of each rearrangement, by kernel name
INDEX = {"conv1": _conv1_index(), "deconv": _deconv_index(), "outconv": _outconv_index()}


def index_tensors(name: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gather indices of rearrangement ``name`` as int64 tensors on
    ``device``. Made outside inference mode, so that a model served first
    can still be trained."""
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device) for a in INDEX[name])


def register_index(module: torch.nn.Module, name: str) -> None:
    """Keep rearrangement ``name``'s indices on ``module`` as non-persistent
    buffers ``s2d_<name>_ih`` / ``_iw``: made on the CPU when the module is
    built (also under a meta-device context), they move with ``.to(device)``,
    so a step captured in a CUDA graph never copies them from the host and a
    traced forward (``torch.export``) sees them as the module's buffers."""
    for axis, t in zip(("ih", "iw"), index_tensors(name, "cpu")):
        module.register_buffer(f"s2d_{name}_{axis}", t, persistent=False)


def module_index(module: torch.nn.Module, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    return getattr(module, f"s2d_{name}_ih"), getattr(module, f"s2d_{name}_iw")


def _gather_kernel(w: torch.Tensor, name: str, index) -> torch.Tensor:
    """K[...] = w_ring_padded[ih[...], iw[...]] (a zero ring around the two
    spatial axes lets indices -1..k land in range). ``index``: the (ih, iw)
    tensors on ``w``'s device, or None to make them for this call."""
    _check5(w)
    ih, iw = index_tensors(name, w.device) if index is None else index
    wp = F.pad(w, (0, 0, 0, 0, 1, 1, 1, 1))
    return wp[ih, iw]


def _check5(w: torch.Tensor) -> None:
    if w.shape[0] != 5 or w.shape[1] != 5:
        raise ValueError(f"the s2d path assumes kernel_size=5, got {tuple(w.shape)}")


def s2d_conv1_kernel(w: torch.Tensor, index=None) -> torch.Tensor:
    """(5,5,C,OC) HWIO stride-2 SAME kernel -> (3,3,4C,OC) block-space kernel
    consuming an s2d input."""
    k = _gather_kernel(w, "conv1", index)  # (m, n, qi, qj, C, OC)
    return k.reshape(3, 3, 4 * w.shape[2], w.shape[3])


def s2d_deconv_kernel(w: torch.Tensor, index=None) -> torch.Tensor:
    """(5,5,OC,IC) transposed-conv stride-2 SAME kernel -> (3,3,IC,4OC) HWIO
    block-space kernel producing an s2d output."""
    k = _gather_kernel(w, "deconv", index)  # (m, n, pi, pj, OC, IC)
    oc, ic = w.shape[2], w.shape[3]
    return k.permute(0, 1, 5, 2, 3, 4).reshape(3, 3, ic, 4 * oc)


def s2d_outconv_kernel(w: torch.Tensor, index=None) -> torch.Tensor:
    """(5,5,OC,IC) transposed-conv stride-1 SAME kernel -> (3,3,4IC,4OC) HWIO
    block-space kernel, s2d input and output."""
    k = _gather_kernel(w, "outconv", index)  # (m, n, pi, pj, qi, qj, OC, IC)
    oc, ic = w.shape[2], w.shape[3]
    return k.permute(0, 1, 4, 5, 7, 2, 3, 6).reshape(3, 3, 4 * ic, 4 * oc)


def tile_bias(bias: torch.Tensor) -> torch.Tensor:
    """Per-channel bias for an s2d tensor: channel order (pi, pj, c) means
    plain tiling reproduces the full-resolution broadcast."""
    return bias.repeat(4)
