"""StarGAN v2's resampling: 2x2 average-pool downsampling, nearest x2
upsampling, and the training images' random-resized crop on the card.

The pool and the upsample run through ``ops/cuda/resample.py``'s
Functions (a CUDA kernel over channels-last maps on the card, the plain
version on the CPU), each the other's backward: the pool's backward is the
gradient over 4 spread by a nearest x2 upsample, a function of the
gradient alone, so a double backward (R1) sends nothing back into the
forward's graph.

The crop follows the published transform (``core/data_loader.py``): with
probability ``randcrop_prob`` torchvision's ``RandomResizedCrop`` (area
0.8-1.0 of the image, aspect ratio 0.9-1.1, ten tries and then the whole
image), the crop resized back to the image's size, then a horizontal flip
with probability 0.5. :func:`draw_crops` draws the boxes and flips of a
batch from a generator on the card, outside any CUDA graph;
:func:`crop_resize` applies them with a bilinear ``grid_sample`` at pixel
centres (the resize of a crop box ``(top, left, h, w)`` back to (H, W)),
so a box of the whole image returns the image.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from littlegan_tpu_torch.ops.cuda.resample import Down2, Up2

SCALE = (0.8, 1.0)
RATIO = (0.9, 1.1)
TRIES = 10


def downsample(x: torch.Tensor) -> torch.Tensor:
    """``F.avg_pool2d(x, 2)``."""
    return Down2.apply(x, 0.25)


def upsample(x: torch.Tensor) -> torch.Tensor:
    """``F.interpolate(x, scale_factor=2, mode="nearest")``."""
    return Up2.apply(x, 1.0)


def draw_crops(gen: torch.Generator, n: int, dim: int, prob: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(boxes (n, 4) float32 ``(top, left, height, width)`` in pixels, flips
    (n,) bool) of n square ``dim`` images. A box takes the first of
    ``TRIES`` (area, ratio) draws whose width and height fit, else the whole
    image, as torchvision's; boxes not applied (probability ``1 - prob``)
    are the whole image."""
    u = torch.rand((n, TRIES, 2), generator=gen, device=device)
    area = dim * dim * (SCALE[0] + (SCALE[1] - SCALE[0]) * u[..., 0])
    ratio = torch.exp(math.log(RATIO[0]) + (math.log(RATIO[1]) - math.log(RATIO[0])) * u[..., 1])
    w = torch.round(torch.sqrt(area * ratio))
    h = torch.round(torch.sqrt(area / ratio))
    fits = (w <= dim) & (h <= dim)
    first = fits.float().argmax(1, keepdim=True)
    ok = fits.any(1)
    full = torch.full((n,), float(dim), device=device)
    w = torch.where(ok, w.gather(1, first)[:, 0], full)
    h = torch.where(ok, h.gather(1, first)[:, 0], full)
    pos = torch.rand((n, 2), generator=gen, device=device)
    top = torch.floor(pos[:, 0] * (dim - h + 1))
    left = torch.floor(pos[:, 1] * (dim - w + 1))
    apply = torch.rand((n,), generator=gen, device=device) < prob
    zero = torch.zeros_like(full)
    boxes = torch.stack([torch.where(apply, top, zero), torch.where(apply, left, zero),
                         torch.where(apply, h, full), torch.where(apply, w, full)], 1)
    flips = torch.rand((n,), generator=gen, device=device) < 0.5
    return boxes, flips


def crop_resize(images: torch.Tensor, boxes: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """(n, C, H, W) float32 in [-1, 1] of n NHWC uint8 images: each box cut
    out and resized back to (H, W) bilinearly, mirrored where ``flips``."""
    x = images.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    n, _, h, w = x.shape
    top, left, bh, bw = boxes.unbind(1)
    sx, sy = bw / w, bh / h
    zero = torch.zeros_like(sx)
    theta = torch.stack([torch.stack([torch.where(flips, -sx, sx), zero, (2.0 * left + bw) / w - 1.0], 1),
                         torch.stack([zero, sy, (2.0 * top + bh) / h - 1.0], 1)], 1)
    grid = F.affine_grid(theta, [n, x.shape[1], h, w], align_corners=False)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="border", align_corners=False)
