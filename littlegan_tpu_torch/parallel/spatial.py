"""Spatial (data x model) sharded training, the port of littlegan_tpu/parallel/spatial.py.

For resolutions where one card cannot hold a batch's activations, the
image HEIGHT is split over a second mesh axis. Under a ``('data', 'model')``
mesh (:class:`~littlegan_tpu_torch.parallel.mesh.SpatialGroup`) each rank
trains its ``batch_size / data`` rows of every global batch, and of those
rows its ``H / model`` image rows. The JAX package leaves the halo
exchanges, the norms' cross-shard sums and the gradients' reduction to XLA;
here :class:`Spatial` holds the model axis and the functions below are the
sharded forms of the model's ops, with the collectives of
``parallel/halo.py``:

- a map is held H-sharded when its height divides the model size, and
  replicated over the model ranks otherwise (JAX
  ``parallel/act_sharding.py``'s policy): a stage too small to tile
  gathers its input and runs whole on every model rank; a replicated map
  entering a stage that tiles is sliced to this rank's rows;
- a SAME convolution of a sharded map borrows the rows its window needs
  from the neighbours (:func:`~littlegan_tpu_torch.parallel.halo.halo_h`)
  and runs VALID along H, SAME along W; a transposed convolution borrows
  one row each side (stride 2) and crops its full output where the
  forward conv's leading pad says, in global coordinates;
- an instance norm of a sharded map sums each sample's (Σx, Σx²) over the
  model ranks in float32: one all-reduce per norm (the one-pass form,
  var = E[x²] − mean², the JAX norm's default);
- the dense heads work on this rank's part of the ``init_dim x init_dim x
  C`` map: G's and the adjuster's heads compute its columns (the rows of
  the row-major reshape), D's heads a partial product over its rows plus
  one all-reduce of the (B, 1 + cond_dim) logits. With ``shard_dense``
  those kernels hold only this rank's columns or rows
  (``parallel/zero.py``);
- a parameter read by a replicated stage gets its whole gradient on every
  model rank; :meth:`Spatial.param` scales that gradient by 1 / model, so
  that every gradient meets the others in one sum over the model axis
  (and a mean over the data axis: ``parallel/train.py``'s ``GradSync``).

The kernels (K1, K1', K2, K3) stay off under a model axis, as JAX turns its
own off (``spatial.py:53-54``): each computes a whole sample's moments, and
the model takes its plain route wherever it is given ``sp``
(``models/littlegan.py::_kernels``). :func:`resolve_config` turns s2d off
where block space does not tile the model axis (JAX
``step.py::_resolve_mesh_s2d``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.ops.conv import conv2d, deconv2d, dense, same_pads
from littlegan_tpu_torch.ops.norm import instance_norm as plain_instance_norm
from littlegan_tpu_torch.parallel.halo import all_reduce, gather_h, halo_h, scale_grad, slice_h, sum_moments


# shard_dense's parameter specs, keyed by path (JAX zero.py:88-95): G's and
# the adjuster's dense kernels and biases shard their output columns (the
# rows of the row-major reshape, so this rank's H-rows), D's head kernels
# their input rows; D's head biases stay whole
DENSE_HEAD_SPECS = {
    ("g_head", "dense", "kernel"): (None, "model"),
    ("g_head", "dense", "bias"): ("model",),
    ("adj_head", "dense", "kernel"): (None, "model"),
    ("adj_head", "dense", "bias"): ("model",),
    ("d_head", "pr", "kernel"): ("model", None),
    ("d_head", "cond", "kernel"): ("model", None),
}
# the same as parameter name -> the axis sharded over the model ranks
DENSE_AXES = {".".join(path): spec.index("model") for path, spec in DENSE_HEAD_SPECS.items()}


class Spatial:
    """The model axis as the step sees it: ``mg`` (a
    :class:`~littlegan_tpu_torch.parallel.mesh.DataGroup` of the model
    ranks of this data index) and whether the dense heads are sharded."""

    def __init__(self, mg, shard_dense: bool = False):
        self.mg = mg
        self.m = mg.world
        self.rank = mg.rank
        self.shard_dense = shard_dense

    def tiles(self, height: int) -> bool:
        """Whether a map ``height`` rows high is held H-sharded."""
        return height % self.m == 0

    def part(self, n: int) -> slice:
        """This rank's share of ``n`` rows (or columns)."""
        per = n // self.m
        return slice(self.rank * per, (self.rank + 1) * per)

    def param(self, p: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """``p`` as a replicated stage reads it: its gradient over 1 / model."""
        return None if p is None else scale_grad(p, 1.0 / self.m)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of every element of an H-sharded ``x``, in float32, replicated."""
        return all_reduce(x.float().sum(), self.mg) / (x.numel() * self.m)

    def hw_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Each image's per-channel mean over (H, W) of an H-sharded NHWC ``x``."""
        return sum_moments(x.sum((1, 2), keepdim=True), self.mg) / (x.shape[1] * self.m * x.shape[2])


def spatial_s2d_compatible(cfg: Config, n_model: int) -> bool:
    """Whether s2d composes with an H-sharded model axis of ``n_model``: the
    2x2 blocks keep every shard boundary when block space tiles the axis
    (JAX ``step.py::spatial_s2d_compatible``)."""
    return (cfg.image_dim // 2) % n_model == 0


def resolve_config(cfg: Config, n_model: int) -> Tuple[Config, str]:
    """(the config a spatial step runs, a note of what changed): s2d off
    where block space does not tile the model axis."""
    if n_model > 1 and cfg.use_s2d and not spatial_s2d_compatible(cfg, n_model):
        return cfg.replace(use_s2d=False), f"s2d off (block height {cfg.image_dim // 2} does not tile {n_model})"
    return cfg, ""


# ----------------------------------------------------- the model's ops --


def conv(x, kernel, bias, stride: int, sp: Spatial, height: int) -> torch.Tensor:
    """``conv2d`` (SAME) of a map ``height`` rows high globally."""
    k = kernel.shape[0]
    out = -(-height // stride)
    if sp.tiles(height) and sp.tiles(out):
        lo, _ = same_pads(height, k, stride)
        x = halo_h(x, lo, max(k - stride - lo, 0), sp.mg)
        return conv2d(x, kernel, bias, stride, pad_h=(0, 0))
    if sp.tiles(height):
        x = gather_h(x, sp.mg)
    y = conv2d(x, sp.param(kernel), sp.param(bias), stride)
    return slice_h(y, sp.mg) if sp.tiles(out) else y


def deconv(x, kernel, bias, stride: int, sp: Spatial, height: int) -> torch.Tensor:
    """``deconv2d`` (TF SAME transposed conv) of a map ``height`` rows high
    globally. Output row o is full-output row o + pad_lo, which input rows
    [(o + pad_lo - k + 1) / s, (o + pad_lo) / s] reach."""
    k = kernel.shape[0]
    out = height * stride
    if sp.tiles(height):
        plo = same_pads(out, k, stride)[0]
        lo, hi = (k - 1 - plo) // stride, (plo - 1 + stride) // stride
        x = halo_h(x, lo, hi, sp.mg)
        return deconv2d(x, kernel, bias, stride, crop_h=(plo + stride * lo, stride * (height // sp.m)))
    y = deconv2d(x, sp.param(kernel), sp.param(bias), stride)
    return slice_h(y, sp.mg) if sp.tiles(out) else y


def instance_norm(x, gamma, beta, sp: Spatial, height: int, eps: float = 1e-3) -> torch.Tensor:
    """``instance_norm`` (one-pass) of a map ``height`` rows high globally
    (or of a head's features, sharded with its ``init_dim`` rows)."""
    if not sp.tiles(height):
        return plain_instance_norm(x, sp.param(gamma), sp.param(beta), eps)
    red = tuple(range(1, x.ndim))
    xf = x.float()
    n = xf[0].numel() * sp.m
    s = sum_moments(torch.stack([xf.sum(red), xf.square().sum(red)]), sp.mg) / n  # (2, N): E[x], E[x^2]
    shape = (-1,) + (1,) * (x.ndim - 1)
    mean = s[0].reshape(shape)
    var = (s[1].reshape(shape) - mean.square()).clamp_min(0.0)
    normed = (xf - mean) / (var.sqrt() + eps)
    return (normed * gamma.float() + beta.float()).to(x.dtype)


def head_dense(x, kernel, bias, sp: Spatial, height: int) -> torch.Tensor:
    """G's or the adjuster's dense head: the columns of this rank's rows of
    the ``height``-row map (all of them, replicated, when it does not tile)."""
    if not sp.tiles(height):
        return dense(x, sp.param(kernel), sp.param(bias))
    if not sp.shard_dense:
        cols = sp.part(kernel.shape[1])
        kernel, bias = kernel[:, cols], bias[cols]
    return dense(x, kernel, bias)


def d_head(fmap, pr, cond, sp: Spatial, height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """D's two dense heads (``pr`` and ``cond`` are their ``Affine``\\ s) on
    the flattened map: a float32 partial product over this rank's rows,
    summed over the model ranks, then the biases."""
    flat = fmap.reshape(fmap.shape[0], -1)
    if not sp.tiles(height):
        return dense(flat, sp.param(pr.kernel), sp.param(pr.bias)), dense(flat, sp.param(cond.kernel),
                                                                           sp.param(cond.bias))
    pk, ck = pr.kernel, cond.kernel
    if not sp.shard_dense:
        rows = sp.part(pk.shape[0])
        pk, ck = pk[rows], ck[rows]
    part = dense(flat.float(), torch.cat([pk, ck], 1).float())
    logits = all_reduce(part, sp.mg).to(fmap.dtype)
    p_out = logits[:, :1] + sp.param(pr.bias).to(fmap.dtype)
    c_out = logits[:, 1:] + sp.param(cond.bias).to(fmap.dtype)
    return p_out, c_out
