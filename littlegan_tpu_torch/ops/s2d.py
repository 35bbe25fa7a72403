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
reference shapes.
"""

from __future__ import annotations

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


_INDEX_CACHE: dict = {}


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a tensor on ``device``, copied there once per device: a
    step captured in a CUDA graph may not copy from the host. Made outside
    inference mode, so that a model served first can still be trained."""
    key = (a.shape, a.tobytes(), str(device))
    if key not in _INDEX_CACHE:
        with torch.inference_mode(False):
            _INDEX_CACHE[key] = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return _INDEX_CACHE[key]


def _gather_kernel(w: torch.Tensor, ih: np.ndarray, iw: np.ndarray) -> torch.Tensor:
    """K[...] = w_ring_padded[ih[...], iw[...]] (a zero ring around the two
    spatial axes lets indices -1..k land in range)."""
    wp = F.pad(w, (0, 0, 0, 0, 1, 1, 1, 1))
    return wp[_index(ih, w.device), _index(iw, w.device)]


def _check5(w: torch.Tensor) -> None:
    if w.shape[0] != 5 or w.shape[1] != 5:
        raise ValueError(f"the s2d path assumes kernel_size=5, got {tuple(w.shape)}")


def s2d_conv1_kernel(w: torch.Tensor) -> torch.Tensor:
    """(5,5,C,OC) HWIO stride-2 SAME kernel -> (3,3,4C,OC) block-space kernel
    consuming an s2d input."""
    _check5(w)
    m = np.arange(3)[:, None, None, None]
    n = np.arange(3)[None, :, None, None]
    qi = np.arange(2)[None, None, :, None]
    qj = np.arange(2)[None, None, None, :]
    ih = np.broadcast_to(2 * m + qi, (3, 3, 2, 2))  # 2m + q - 1, +1 for the ring
    iw = np.broadcast_to(2 * n + qj, (3, 3, 2, 2))
    k = _gather_kernel(w, ih, iw)  # (m, n, qi, qj, C, OC)
    return k.reshape(3, 3, 4 * w.shape[2], w.shape[3])


def s2d_deconv_kernel(w: torch.Tensor) -> torch.Tensor:
    """(5,5,OC,IC) transposed-conv stride-2 SAME kernel -> (3,3,IC,4OC) HWIO
    block-space kernel producing an s2d output."""
    _check5(w)
    m = np.arange(3)[:, None, None, None]
    n = np.arange(3)[None, :, None, None]
    pi = np.arange(2)[None, None, :, None]
    pj = np.arange(2)[None, None, None, :]
    ih = np.broadcast_to(4 - 2 * m + pi, (3, 3, 2, 2))  # 3 - 2m + p, +1 for the ring
    iw = np.broadcast_to(4 - 2 * n + pj, (3, 3, 2, 2))
    k = _gather_kernel(w, ih, iw)  # (m, n, pi, pj, OC, IC)
    oc, ic = w.shape[2], w.shape[3]
    return k.permute(0, 1, 5, 2, 3, 4).reshape(3, 3, ic, 4 * oc)


def s2d_outconv_kernel(w: torch.Tensor) -> torch.Tensor:
    """(5,5,OC,IC) transposed-conv stride-1 SAME kernel -> (3,3,4IC,4OC) HWIO
    block-space kernel, s2d input and output."""
    _check5(w)
    sh = (3, 3, 2, 2, 2, 2)  # m, n, pi, pj, qi, qj
    m = np.arange(3).reshape(3, 1, 1, 1, 1, 1)
    n = np.arange(3).reshape(1, 3, 1, 1, 1, 1)
    pi = np.arange(2).reshape(1, 1, 2, 1, 1, 1)
    pj = np.arange(2).reshape(1, 1, 1, 2, 1, 1)
    qi = np.arange(2).reshape(1, 1, 1, 1, 2, 1)
    qj = np.arange(2).reshape(1, 1, 1, 1, 1, 2)
    ih = np.broadcast_to(5 - 2 * m + pi - qi, sh)  # 4 - 2m + p - q, +1 for the ring
    iw = np.broadcast_to(5 - 2 * n + pj - qj, sh)
    k = _gather_kernel(w, ih, iw)  # (m, n, pi, pj, qi, qj, OC, IC)
    oc, ic = w.shape[2], w.shape[3]
    return k.permute(0, 1, 4, 5, 7, 2, 3, 6).reshape(3, 3, 4 * ic, 4 * oc)


def tile_bias(bias: torch.Tensor) -> torch.Tensor:
    """Per-channel bias for an s2d tensor: channel order (pi, pj, c) means
    plain tiling reproduces the full-resolution broadcast."""
    return bias.repeat(4)
