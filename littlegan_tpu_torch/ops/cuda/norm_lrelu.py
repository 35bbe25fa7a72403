"""Fused instance norm + LeakyReLU: the CUDA kernels' wrappers, their plain versions and autograd.

Replaces ``littlegan_tpu/ops/pallas/norm_lrelu.py::fused_instance_norm_lrelu``:
the forward (``_fwd_kernel`` / ``_fwd_pallas``) and its custom VJP's backward
(``_bwd_kernel`` / ``_bwd_pallas``). It closes every encoder and decoder
block: ``leaky_relu(instance_norm(x, gamma, beta), alpha)`` per sample over
all of (H, W, C), with f32 stats and scalar gamma, beta. The moments are the
Pallas op's (``_moments``): two passes (the mean, then the mean of squared
deviations) where it holds the sample whole (:func:`holds_whole_sample`),
one pass (sum and sum of squares, variance clamped at 0) elsewhere.

What bounds it on the H100 is bytes: a few operations per element, so the
least time is one read of x and one write of y forward, and a read of x and
dy and a write of dx backward, at 3.35 TB/s. The forward
(``csrc/norm_lrelu.cu``, :func:`fwd_plan`) gives each sample one thread
block cluster whose blocks copy their shares of x into shared memory, add
their sums through distributed shared memory (a second exchange for the
two-pass variance) and write y from shared memory: x is read once, in one
launch. Samples too large for the cluster's shared memory, and one-pass
batches whose x the second launch finds in L2, take two launches
(per-chunk partials, then a fixed-order reduce and the write, rereading x).
Either route writes the sample's f32 (mean, std), shape (2, N), which the
backward reads, so it sees the forward's moments bit for bit. The backward
(``csrc/norm_lrelu_bwd.cu``) writes per-chunk partials of sum(dz) and
sum(dz * n) and reduces those per sample for dx and over the batch for
dgamma and dbeta, in two passes; for a batch whose x and dy outgrow L2 (the
large train shapes) it instead gives each sample one cluster: its blocks
read their shares of x and dy once, keep what their shared memory holds,
reread the rest from L2 while it is still there, and share their sums
through distributed shared memory (:func:`bwd_plan`).
``norm_lrelu_from_stats`` is the apply launch alone, for stats that a conv
epilogue already produced (encoder block1, ``boundary_conv.py``), with
one-pass moments as ``instance_norm_from_stats``; its backward also returns
the stats' cotangents.

:class:`FusedNormLReLU` and :class:`NormLReLUFromStats` are the autograd
Functions the model calls. A CPU tensor takes the plain PyTorch versions
below, forward and backward; a CUDA tensor launches the kernels or raises.
A raw wrapper asked for a result that autograd would have to differentiate
raises instead of returning it detached. The Functions' backwards are first
order only (:func:`first_order_only`): a gradient of their gradient (what a
gradient penalty asks for) raises instead of dropping the second-order
terms. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from littlegan_tpu_torch.ops.conv import leaky_relu
from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.ops.norm import instance_norm_from_stats

_MIN_CHUNK = 2048  # elements per block at the least: 8 vectors of 8 bf16 per thread
_BLOCKS_PER_SM = 4  # aim for this many blocks per SM over the whole batch
# The Pallas op holds a sample whole, and takes two-pass moments, where its
# f32 copy takes at most _WHOLE_SAMPLE_F32_LIMIT bytes or its rows do not
# split into _CHUNK_ROWS-row chunks (``_pick_chunk``).
_WHOLE_SAMPLE_F32_LIMIT = 512 * 1024
_CHUNK_ROWS = 8
# The forward's cluster route: one thread block cluster per sample, of a
# power of two blocks: as many as give each block about _FWD_SHARE bytes of
# x and the batch at least _FWD_MIN_BLOCKS blocks, at most _FWD_CLUSTER (the
# largest portable cluster); _MAX_CLUSTER for samples of _FWD_BIG_SAMPLE
# bytes or more in batches of _FWD_BIG_BATCH or more, or where a share would
# not fit. Clusters of 16 are placed a GPC at a time and ran slower
# everywhere else (PERF.md, the K1 route table). A block keeps its whole
# share in shared memory, at most _FWD_SMEM_MAX bytes (the H100's 227 KB
# less the kernel's static arrays); a sample that does not fit 16 such
# shares takes the two-launch route. So does a one-pass batch of at least _FWD_BIG_BATCH
# samples whose x takes at most _FWD_TWO_LAUNCH_BYTES: its second launch
# finds x in L2, while the cluster route's one wave loads, synchronises and
# writes in lock step (tied or faster at (32, 64, 64, 64): PERF.md).
_FWD_SHARE = 32 << 10
_FWD_MIN_BLOCKS = 64
_FWD_CLUSTER = 8
_FWD_BIG_SAMPLE = 1 << 20
_FWD_BIG_BATCH = 16
_FWD_SMEM_MAX = 224 << 10
_FWD_TWO_LAUNCH_BYTES = 16 << 20
# The backward's cluster route: a thread block cluster per sample, of at
# most _MAX_CLUSTER blocks (the H100's largest cluster), as many as give
# each block about _BWD_SHARE bytes of the sample's x and dy. Each block
# keeps part of its share in shared memory and reads the rest again from
# L2: as little as keeps the rest of all blocks in flight within
# _BWD_L2_BYTES, at least a quarter of the share, at most _BWD_SMEM_MAX
# (more blocks in flight against fewer L2 misses: PERF.md, PR 3). Blocks
# in flight: SMs x at most _BWD_BLOCKS_PER_SM (256 threads at about 40
# registers) or what _SMEM_PER_SM holds. A batch whose x and dy take at
# most _BWD_TWO_PASS_BYTES stays on the two-pass route, whose second pass
# finds them in L2.
_BWD_TWO_PASS_BYTES = 24 << 20
_BWD_SHARE = 64 << 10
_BWD_SMEM_MAX = 128 << 10
_BWD_L2_BYTES = 32 << 20
_BWD_BLOCKS_PER_SM = 6
_SMEM_PER_SM = 227 << 10
_MAX_CLUSTER = 16
_sm_count = {}


def _per_sample(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape((-1,) + (1,) * (ndim - 1))


def holds_whole_sample(shape) -> bool:
    """Whether the Pallas op holds an (N, H, W, C) tensor's sample whole and
    takes its moments in two passes: the port's copy of ``_pick_chunk``'s
    rule (``littlegan_tpu/ops/pallas/norm_lrelu.py:57-61``)."""
    _, h, w, c = shape
    return h * w * c * 4 <= _WHOLE_SAMPLE_F32_LIMIT or h % _CHUNK_ROWS != 0


def instance_norm_moments_plain(x: torch.Tensor) -> torch.Tensor:
    """The per-sample f32 (mean, std) of an NHWC tensor, shape (2, N), as the
    Pallas op's ``_moments`` takes them: two-pass where it holds the sample
    whole, else one-pass with the variance clamped at 0."""
    red = tuple(range(1, x.ndim))
    xf = x.float()
    mean = xf.mean(red, keepdim=True)
    if holds_whole_sample(x.shape):
        var = (xf - mean).square().mean(red)
    else:
        var = (xf.square().mean(red) - mean.reshape(-1).square()).clamp_min(0.0)
    return torch.stack([mean.reshape(-1), var.sqrt()])


def fused_instance_norm_lrelu_plain(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, alpha: float = 0.3, eps: float = 1e-3
) -> torch.Tensor:
    return _norm_lrelu_plain(x, instance_norm_moments_plain(x), gamma, beta, alpha, eps)


def _norm_lrelu_plain(x, moments, gamma, beta, alpha, eps) -> torch.Tensor:
    mean, std = (_per_sample(t, x.ndim) for t in moments)
    normed = (x.float() - mean) / (std + eps)
    return leaky_relu((normed * gamma.float() + beta.float()).to(x.dtype), alpha)


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


def fused_instance_norm_lrelu_bwd_plain(
    x: torch.Tensor,
    dy: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    alpha: float = 0.3,
    eps: float = 1e-3,
    stats: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta): the analytic VJP of ``_bwd_kernel``
    (``littlegan_tpu/ops/pallas/norm_lrelu.py:128-150``), in f32, from the
    forward's (mean, std) ``stats`` (taken afresh if None); dx in x's dtype,
    dgamma and dbeta f32 of shape (1,), summed over the batch."""
    red = tuple(range(1, x.ndim))
    xf = x.float()
    g, b = gamma.float().reshape(()), beta.float().reshape(())
    if stats is None:
        stats = instance_norm_moments_plain(x)
    mean, std = (_per_sample(t, x.ndim) for t in stats)
    d = std + eps
    nrm = (xf - mean) / d
    dz = dy.float() * torch.where(nrm * g + b >= 0, 1.0, alpha)
    dn = dz * g
    dx = (dn - dn.mean(red, keepdim=True)) / d - nrm * (dn * nrm).mean(red, keepdim=True) / std.clamp_min(1e-20)
    return dx.to(x.dtype), (dz * nrm).sum().reshape(1), dz.sum().reshape(1)


def norm_lrelu_from_stats_bwd_plain(
    y: torch.Tensor,
    s1: torch.Tensor,
    s2: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    dout: torch.Tensor,
    alpha: float = 0.3,
    eps: float = 1e-3,
) -> Tuple[torch.Tensor, ...]:
    """(dy, ds1, ds2, dgamma, dbeta), the VJP of ``norm_lrelu_from_stats``.
    mean = s1/M and var = s2/M - mean^2 depend on the sums, not on y, so dy
    is the direct path dn/d, and the sums get
    ``ds1 = (-sum(dn)/d - 2 mean dvar)/M``, ``ds2 = dvar/M`` with
    ``dvar = -sum(dn n)/(2 d std)`` (0 where the variance clamps)."""
    red = tuple(range(1, y.ndim))
    m = float(y[0].numel())
    g, b = gamma.float().reshape(()), beta.float().reshape(())
    mean = s1.float() / m
    var = s2.float() / m - mean.square()
    std = var.clamp_min(0.0).sqrt()
    d = std + eps
    nrm = (y.float() - _per_sample(mean, y.ndim)) / _per_sample(d, y.ndim)
    dz = dout.float() * torch.where(nrm * g + b >= 0, 1.0, alpha)
    dn = dz * g
    dy = dn / _per_sample(d, y.ndim)
    dstd = -(dn * nrm).sum(red) / d
    dvar = torch.where(var > 0, dstd * 0.5 / std.clamp_min(1e-20), 0.0)
    ds1 = (-dn.sum(red) / d - 2.0 * mean * dvar) / m
    ds2 = dvar / m
    return dy.to(y.dtype), ds1, ds2, (dz * nrm).sum().reshape(1), dz.sum().reshape(1)


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


class FwdPlan(NamedTuple):
    """How the forward kernel splits a batch: each sample in ``chunks``
    blocks of ``chunk`` elements (a multiple of 8). ``cluster``: those
    blocks form one thread block cluster that keeps the sample in shared
    memory (x read once, one launch); else two launches over (sample x
    chunk) blocks, the second rereading x. ``two_pass``: the Pallas op's
    whole-sample moments, which only the cluster route computes."""

    chunk: int
    chunks: int
    cluster: bool
    two_pass: bool


def fwd_plan(
    n: int, m: int, itemsize: int, sms: int, two_pass: bool = False, blocks: Optional[int] = None,
) -> FwdPlan:
    """The forward's plan for n samples of m elements of ``itemsize`` bytes;
    ``two_pass`` as :func:`holds_whole_sample` says for the shape. The
    cluster route, blocks per sample as the constants above say, where a
    sample fits 16 blocks' shared memory; else, and for a one-pass batch
    that fits ``_FWD_TWO_LAUNCH_BYTES``, two launches chunked by
    :func:`chunking`, which two-pass moments cannot take (ValueError).
    ``blocks`` forces a cluster of that many blocks, or with 0 the
    two-launch route: the wrappers take the default, the argument is for
    measuring the routes against each other (``chip_smoke.py``)."""
    two_launches = FwdPlan(*chunking(n, m, sms), False, False)
    if blocks == 0:
        if two_pass:
            raise ValueError("the two-launch route takes one-pass moments only")
        return two_launches
    forced = blocks is not None
    if not forced:
        if not two_pass and n >= _FWD_BIG_BATCH and n * m * itemsize <= _FWD_TWO_LAUNCH_BYTES:
            return two_launches
        want = max(-(-m * itemsize // _FWD_SHARE), -(-_FWD_MIN_BLOCKS // n))
        blocks = min(_FWD_CLUSTER, 1 << (want - 1).bit_length())
        if ((m * itemsize >= _FWD_BIG_SAMPLE and n >= _FWD_BIG_BATCH)
                or 8 * -(-m // (8 * blocks)) * itemsize > _FWD_SMEM_MAX):
            blocks = _MAX_CLUSTER
    chunk = 8 * -(-m // (8 * blocks))
    if chunk * itemsize <= _FWD_SMEM_MAX:
        return FwdPlan(chunk, -(-m // chunk), True, two_pass)
    if forced or two_pass:
        raise ValueError(
            f"a sample of {m} elements does not fit {blocks} blocks' shared memory"
            + (", and the two-launch route does not take two-pass moments" if two_pass else "")
        )
    return two_launches


class BwdPlan(NamedTuple):
    """How the backward kernels split a batch: each sample in ``chunks``
    blocks of ``chunk`` elements. ``kept`` > 0, the cluster route: those
    blocks form one thread block cluster, each block keeping the first
    ``kept`` elements of its share of x and dy in shared memory. Else the
    two-pass route over (sample x chunk) blocks."""

    chunk: int
    chunks: int
    kept: int = 0

    @property
    def one_pass(self) -> bool:
        """Whether x and dy are read from device memory once (the cluster
        route; what it does not keep it rereads from L2)."""
        return self.kept > 0


def bwd_plan(
    n: int, m: int, itemsize: int, sms: int, smem: Optional[int] = None,
    two_pass_bytes: int = _BWD_TWO_PASS_BYTES,
) -> BwdPlan:
    """The backward's plan for n samples of m elements of ``itemsize``
    bytes. The cluster route where m is a multiple of 8 and the batch's x
    and dy take more than ``two_pass_bytes``: blocks per sample a power of
    two, enough for about ``_BWD_SHARE`` bytes of x and dy per block and two
    blocks per SM over the batch, at most ``_MAX_CLUSTER``; each keeps
    ``smem`` bytes of its share if given, else what the rule above picks.
    Else, or with ``smem`` 0, two passes over (sample x chunk) blocks
    (:func:`chunking`). The wrappers take the defaults; the arguments are
    for measuring the routes against each other (``chip_smoke.py``)."""
    if m % 8 or smem == 0 or 2 * n * m * itemsize <= two_pass_bytes:
        return BwdPlan(*chunking(n, m, sms))
    want = max(-(-2 * m * itemsize // _BWD_SHARE), -(-2 * sms // n))
    blocks = min(_MAX_CLUSTER, 1 << (want - 1).bit_length())
    chunk = 8 * -(-m // (8 * blocks))
    if smem is not None:
        return BwdPlan(chunk, blocks, min(chunk, 8 * max(1, smem // (16 * itemsize))))

    def rest_in_l2(kept: int) -> int:
        per_sm = min(_BWD_BLOCKS_PER_SM, _SMEM_PER_SM // (2 * kept * itemsize + 1024))
        return min(n * blocks, sms * per_sm) * (chunk - kept) * 2 * itemsize

    kept = min(chunk, 8 * (_BWD_SMEM_MAX // (16 * itemsize)))
    while kept % 16 == 0 and 4 * (kept // 2) >= chunk and rest_in_l2(kept // 2) <= _BWD_L2_BYTES:
        kept //= 2
    return BwdPlan(chunk, blocks, kept)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_plan(plan, m: int, what: str) -> None:
    kept = getattr(plan, "kept", 0)
    if plan.chunk % 8 or plan.chunks * plan.chunk < m or kept % 8 or kept > plan.chunk:
        raise ValueError(f"{what}: {plan} does not cover a sample of {m} elements in whole vectors")


def refuse_grad(what: str, function: str, *tensors: Optional[torch.Tensor]) -> None:
    """A kernel's output is a fresh tensor autograd cannot see: when grad
    mode is on and an input requires grad, raise instead of returning it
    detached (a silent stop of the gradient)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, and the kernel's result would be detached from "
            f"autograd; call it through {function}.apply"
        )


def first_order_only(backward):
    """Decorate a kernel Function's ``backward``: raise when autograd runs it
    to build a graph (``create_graph=True``, a gradient of a gradient). The
    backward launches kernels autograd cannot trace, so a second
    differentiation would drop the terms through it. ``once_differentiable``
    alone raises only where the second backward reaches its outputs; a
    penalty whose other terms reach the same parameters would lose these
    silently."""

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"{type(ctx).__name__.removesuffix('Backward')}: the kernel's backward is first order only; "
                "a gradient of its gradient (create_graph=True, e.g. use_gp) is not supported"
            )
        return backward(ctx, *grads)

    return wrapper


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


def _check_like(x: torch.Tensor, t: torch.Tensor, name: str, what: str) -> None:
    if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_sums(n: int, device, what: str, **sums: torch.Tensor) -> None:
    for name, s in sums.items():
        if s.shape != (n,) or s.dtype != torch.float32 or s.device != device or not s.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous f32 ({n},) on {device}")


def _scalar(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(1).to(torch.float32).contiguous()


def _check_stats(stats: torch.Tensor, n: int, device, what: str) -> None:
    if stats.shape != (2, n) or stats.dtype != torch.float32 or stats.device != device or not stats.is_contiguous():
        raise ValueError(f"{what}: stats must be the forward's contiguous f32 (2, {n}) (mean, std) on {device}")


def _fused_forward(
    x, gamma, beta, alpha, eps, plan: Optional[FwdPlan] = None, write_y: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(y, stats): y (None unless ``write_y``) and the per-sample f32
    (mean, std), shape (2, N), that the backward reads."""
    if x.device.type == "cpu":
        stats = instance_norm_moments_plain(x)
        return (_norm_lrelu_plain(x, stats, gamma, beta, alpha, eps) if write_y else None), stats
    what = "fused_instance_norm_lrelu"
    refuse_grad(what, "FusedNormLReLU", x, gamma, beta)
    _check_inputs(x, gamma, beta, what)
    code = _build.dtype_code(x)
    n, m = x.shape[0], x[0].numel()
    if plan is None:
        plan = fwd_plan(n, m, x.element_size(), _sms(x.device), holds_whole_sample(x.shape))
    _check_plan(plan, m, what)
    if plan.two_pass and not plan.cluster:
        raise ValueError(f"{what}: {plan}: only the cluster route takes two-pass moments")
    y = torch.empty_like(x) if write_y else None
    y_ptr = y.data_ptr() if write_y else None
    stats = torch.empty((2, n), dtype=torch.float32, device=x.device)
    g, b = _scalar(gamma), _scalar(beta)
    lib, stream = _build.lib(), _build.stream_ptr(x.device)
    if plan.cluster:
        err = lib.lg_norm_lrelu_cluster(
            code, x.data_ptr(), y_ptr, stats.data_ptr(), g.data_ptr(), b.data_ptr(), n, m, plan.chunk,
            plan.chunks, int(plan.two_pass), alpha, eps, stream,
        )
    else:
        part = torch.empty((2, n, plan.chunks), dtype=torch.float32, device=x.device)
        err = lib.lg_norm_lrelu(
            code, x.data_ptr(), y_ptr, part[0].data_ptr(), part[1].data_ptr(), stats.data_ptr(),
            g.data_ptr(), b.data_ptr(), n, m, plan.chunk, plan.chunks, alpha, eps, stream,
        )
    _build.check(err, what)
    if write_y:
        fused_instance_norm_lrelu.launches.add()
    return y, stats


def fused_instance_norm_lrelu(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, alpha: float = 0.3, eps: float = 1e-3,
    plan: Optional[FwdPlan] = None,
) -> torch.Tensor:
    """leaky_relu(instance_norm(x, gamma, beta), alpha). x: (N, H, W, C)
    float32 or bfloat16; gamma, beta: shape (1,). Output in x's dtype.
    ``plan``: the kernel's split of the batch (default :func:`fwd_plan`'s)."""
    return _fused_forward(x, gamma, beta, alpha, eps, plan)[0]


def fused_instance_norm_lrelu_bwd(
    x: torch.Tensor,
    dy: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    alpha: float = 0.3,
    eps: float = 1e-3,
    stats: Optional[torch.Tensor] = None,
    plan: Optional[BwdPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta) of ``fused_instance_norm_lrelu`` for the output
    cotangent dy (x's shape and dtype). ``stats``: the forward's (2, N)
    (mean, std); without them the forward's kernel takes them first (no y
    written). ``plan``: the kernel's split of the batch (default
    :func:`bwd_plan`'s). dgamma and dbeta are f32 (1,), summed over the
    batch."""
    what = "fused_instance_norm_lrelu_bwd"
    if x.device.type == "cpu":
        if stats is not None:
            _check_stats(stats, x.shape[0], x.device, what)
        return fused_instance_norm_lrelu_bwd_plain(x, dy, gamma, beta, alpha, eps, stats)
    refuse_grad(what, "FusedNormLReLU", x, dy, gamma, beta)
    _check_inputs(x, gamma, beta, what)
    _check_like(x, dy, "dy", what)
    code = _build.dtype_code(x)
    n, m = x.shape[0], x[0].numel()
    sms = _sms(x.device)
    if stats is None:
        stats = _fused_forward(x, gamma, beta, alpha, eps, write_y=False)[1]
    _check_stats(stats, n, x.device, what)
    dx = torch.empty_like(x)
    if plan is None:
        plan = bwd_plan(n, m, x.element_size(), sms) if _aligned(x, dy, dx) else BwdPlan(*chunking(n, m, sms))
    _check_plan(plan, m, what)
    part = torch.empty((2, n, plan.chunks), dtype=torch.float32, device=x.device)
    dgb = torch.empty((2,), dtype=torch.float32, device=x.device)
    g, b = _scalar(gamma), _scalar(beta)
    err = _build.lib().lg_norm_lrelu_bwd(
        code, x.data_ptr(), dy.data_ptr(), dx.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), g.data_ptr(), b.data_ptr(), dgb[0].data_ptr(),
        dgb[1].data_ptr(), n, m, *plan, alpha, eps, _build.stream_ptr(x.device),
    )
    _build.check(err, what)
    fused_instance_norm_lrelu_bwd.launches.add()
    return dx, dgb[0:1], dgb[1:2]


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
    refuse_grad("norm_lrelu_from_stats", "NormLReLUFromStats", y, s1, s2, gamma, beta)
    _check_inputs(y, gamma, beta, "norm_lrelu_from_stats")
    n, m = y.shape[0], y[0].numel()
    _check_sums(n, y.device, "norm_lrelu_from_stats", s1=s1, s2=s2)
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


def norm_lrelu_from_stats_bwd(
    y: torch.Tensor,
    s1: torch.Tensor,
    s2: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    dout: torch.Tensor,
    alpha: float = 0.3,
    eps: float = 1e-3,
    plan: Optional[BwdPlan] = None,
) -> Tuple[torch.Tensor, ...]:
    """(dy, ds1, ds2, dgamma, dbeta) of ``norm_lrelu_from_stats`` for the
    output cotangent dout; dy in y's dtype, the rest f32. ``plan`` as in
    :func:`fused_instance_norm_lrelu_bwd`."""
    if y.device.type == "cpu":
        return norm_lrelu_from_stats_bwd_plain(y, s1, s2, gamma, beta, dout, alpha, eps)
    what = "norm_lrelu_from_stats_bwd"
    refuse_grad(what, "NormLReLUFromStats", y, s1, s2, gamma, beta, dout)
    _check_inputs(y, gamma, beta, what)
    _check_like(y, dout, "dout", what)
    n, m = y.shape[0], y[0].numel()
    _check_sums(n, y.device, what, s1=s1, s2=s2)
    code = _build.dtype_code(y)
    sms = _sms(y.device)
    dy = torch.empty_like(y)
    if plan is None:
        plan = bwd_plan(n, m, y.element_size(), sms) if _aligned(y, dout, dy) else BwdPlan(*chunking(n, m, sms))
    _check_plan(plan, m, what)
    part = torch.empty((2, n, plan.chunks), dtype=torch.float32, device=y.device)
    ds = torch.empty((2, n), dtype=torch.float32, device=y.device)
    dgb = torch.empty((2,), dtype=torch.float32, device=y.device)
    g, b = _scalar(gamma), _scalar(beta)
    err = _build.lib().lg_norm_lrelu_from_stats_bwd(
        code, y.data_ptr(), dout.data_ptr(), dy.data_ptr(), s1.data_ptr(), s2.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), g.data_ptr(), b.data_ptr(), dgb[0].data_ptr(), dgb[1].data_ptr(),
        ds[0].data_ptr(), ds[1].data_ptr(), n, m, *plan, alpha, eps, _build.stream_ptr(y.device),
    )
    _build.check(err, what)
    norm_lrelu_from_stats_bwd.launches.add()
    return dy, ds[0], ds[1], dgb[0:1], dgb[1:2]


fused_instance_norm_lrelu.launches = _build.LaunchCounter("fused_instance_norm_lrelu")
fused_instance_norm_lrelu_bwd.launches = _build.LaunchCounter("fused_instance_norm_lrelu_bwd")
norm_lrelu_from_stats.launches = _build.LaunchCounter("norm_lrelu_from_stats")
norm_lrelu_from_stats_bwd.launches = _build.LaunchCounter("norm_lrelu_from_stats_bwd")


class FusedNormLReLU(torch.autograd.Function):
    """``fused_instance_norm_lrelu`` with ``fused_instance_norm_lrelu_bwd``
    as its backward (the Pallas op's custom VJP)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, alpha: float = 0.3, eps: float = 1e-3):
        y, stats = _fused_forward(x, gamma, beta, alpha, eps)
        ctx.save_for_backward(x, gamma, beta, stats)
        ctx.alpha, ctx.eps = alpha, eps
        return y

    @staticmethod
    @first_order_only
    def backward(ctx, dy):
        x, gamma, beta, stats = ctx.saved_tensors  # stats: the forward's (mean, std)
        dx, dg, db = fused_instance_norm_lrelu_bwd(
            x, dy.to(x.dtype).contiguous(), gamma, beta, ctx.alpha, ctx.eps, stats
        )
        return dx, dg.to(gamma.dtype).reshape(gamma.shape), db.to(beta.dtype).reshape(beta.shape), None, None


class NormLReLUFromStats(torch.autograd.Function):
    """``norm_lrelu_from_stats`` with ``norm_lrelu_from_stats_bwd`` as its
    backward; the sums' cotangents flow on to the conv that made them."""

    @staticmethod
    def forward(ctx, y, s1, s2, gamma, beta, alpha: float = 0.3, eps: float = 1e-3):
        out = norm_lrelu_from_stats(y, s1, s2, gamma, beta, alpha, eps)
        ctx.save_for_backward(y, s1, s2, gamma, beta)
        ctx.alpha, ctx.eps = alpha, eps
        return out

    @staticmethod
    @first_order_only
    def backward(ctx, dout):
        y, s1, s2, gamma, beta = ctx.saved_tensors
        dy, ds1, ds2, dg, db = norm_lrelu_from_stats_bwd(
            y, s1, s2, gamma, beta, dout.to(y.dtype).contiguous(), ctx.alpha, ctx.eps
        )
        return (dy, ds1.to(s1.dtype), ds2.to(s2.dtype), dg.to(gamma.dtype).reshape(gamma.shape),
                db.to(beta.dtype).reshape(beta.shape), None, None)
