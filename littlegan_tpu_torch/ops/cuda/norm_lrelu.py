"""Fused instance norm + LeakyReLU: the CUDA kernel's wrapper and its plain version.

Replaces ``littlegan_tpu/ops/pallas/norm_lrelu.py::fused_instance_norm_lrelu``
(the forward, ``_fwd_kernel`` / ``_fwd_pallas``). It closes every encoder and
decoder block: ``leaky_relu(instance_norm(x, gamma, beta), alpha)`` per sample
over all of (H, W, C), with f32 one-pass stats and scalar gamma, beta.

What bounds it on the H100 is bytes: a few operations per element, so the
least time is one read of x and one write of y at 3.35 TB/s. The design
(``csrc/norm_lrelu.cu``) splits each sample over many blocks so that a
batch of 8 fills the card: a stats launch writes per-chunk f32 partials, an
apply launch reduces them in a fixed order (deterministic, no atomics) and
writes y with 16-byte stores. ``norm_lrelu_from_stats`` is the apply launch
alone, for stats that a conv epilogue already produced (encoder block1,
``boundary_conv.py``).

A CPU tensor takes the plain PyTorch version below; a CUDA tensor launches
the kernel or raises. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from littlegan_tpu_torch.ops.conv import leaky_relu
from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.ops.norm import instance_norm, instance_norm_from_stats

_MIN_CHUNK = 2048  # elements per block at the least: 8 vectors of 8 bf16 per thread
_BLOCKS_PER_SM = 4  # aim for this many blocks per SM over the whole batch
_sm_count = {}


def fused_instance_norm_lrelu_plain(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, alpha: float = 0.3, eps: float = 1e-3
) -> torch.Tensor:
    return leaky_relu(instance_norm(x, gamma, beta, eps), alpha)


def norm_lrelu_from_stats_plain(
    y: torch.Tensor,
    s1: torch.Tensor,
    s2: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    alpha: float = 0.3,
    eps: float = 1e-3,
) -> torch.Tensor:
    return leaky_relu(instance_norm_from_stats(y, s1, s2, gamma, beta, eps), alpha)


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_count[idx]


def chunking(n: int, m: int, sms: int) -> Tuple[int, int]:
    """(chunk, chunks): elements per block (a multiple of 8) and blocks per
    sample, so that n samples of m elements give about ``_BLOCKS_PER_SM``
    blocks per SM without blocks smaller than ``_MIN_CHUNK``."""
    chunks = max(1, min(math.ceil(m / _MIN_CHUNK), math.ceil(_BLOCKS_PER_SM * sms / n)))
    chunk = 8 * math.ceil(math.ceil(m / chunks) / 8)
    return chunk, math.ceil(m / chunk)


def _check_inputs(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{what}: expected an NHWC tensor, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous (NHWC)")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.numel() != 1 or t.device != x.device:
            raise ValueError(f"{what}: {name} must be one value on {x.device}")


def _scalar(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(1).to(torch.float32).contiguous()


def fused_instance_norm_lrelu(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, alpha: float = 0.3, eps: float = 1e-3
) -> torch.Tensor:
    """leaky_relu(instance_norm(x, gamma, beta), alpha). x: (N, H, W, C)
    float32 or bfloat16; gamma, beta: shape (1,). Output in x's dtype."""
    if x.device.type == "cpu":
        return fused_instance_norm_lrelu_plain(x, gamma, beta, alpha, eps)
    _check_inputs(x, gamma, beta, "fused_instance_norm_lrelu")
    code = _build.dtype_code(x)
    n, m = x.shape[0], x[0].numel()
    chunk, chunks = chunking(n, m, _sms(x.device))
    y = torch.empty_like(x)
    part = torch.empty((2, n, chunks), dtype=torch.float32, device=x.device)
    g, b = _scalar(gamma), _scalar(beta)
    err = _build.lib().lg_norm_lrelu(
        code, x.data_ptr(), y.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        g.data_ptr(), b.data_ptr(), n, m, chunk, chunks, alpha, eps, _build.stream_ptr(x.device),
    )
    _build.check(err, "fused_instance_norm_lrelu")
    fused_instance_norm_lrelu.launches.add()
    return y


def norm_lrelu_from_stats(
    y: torch.Tensor,
    s1: torch.Tensor,
    s2: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    alpha: float = 0.3,
    eps: float = 1e-3,
) -> torch.Tensor:
    """``fused_instance_norm_lrelu`` from per-sample sums s1 = sum(y) and
    s2 = sum(y^2), each f32 of shape (N,)."""
    if y.device.type == "cpu":
        return norm_lrelu_from_stats_plain(y, s1, s2, gamma, beta, alpha, eps)
    _check_inputs(y, gamma, beta, "norm_lrelu_from_stats")
    n, m = y.shape[0], y[0].numel()
    for name, s in (("s1", s1), ("s2", s2)):
        if s.shape != (n,) or s.dtype != torch.float32 or s.device != y.device or not s.is_contiguous():
            raise ValueError(f"norm_lrelu_from_stats: {name} must be contiguous f32 ({n},) on {y.device}")
    code = _build.dtype_code(y)
    chunk, chunks = chunking(n, m, _sms(y.device))
    out = torch.empty_like(y)
    g, b = _scalar(gamma), _scalar(beta)
    err = _build.lib().lg_norm_lrelu_apply(
        code, y.data_ptr(), out.data_ptr(), s1.data_ptr(), s2.data_ptr(),
        g.data_ptr(), b.data_ptr(), n, m, chunk, chunks, alpha, eps, _build.stream_ptr(y.device),
    )
    _build.check(err, "norm_lrelu_from_stats")
    norm_lrelu_from_stats.launches.add()
    return out


fused_instance_norm_lrelu.launches = _build.LaunchCounter()
norm_lrelu_from_stats.launches = _build.LaunchCounter()
