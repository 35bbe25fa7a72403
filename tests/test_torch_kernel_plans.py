"""How the port's kernels split their work, on the CPU.

``ops/cuda/norm_lrelu.py::fwd_plan`` is what the K1 forward wrapper hands
to ``csrc/norm_lrelu.cu``: per sample, ``chunks`` blocks of ``chunk``
elements, on the cluster route (one thread block cluster per sample holding
it in shared memory, x read once) or the two-launch route.
``ops/cuda/norm_lrelu.py::bwd_plan`` is what the K2 and K1' backward
wrappers hand to ``csrc/norm_lrelu_bwd.cu``: per sample, ``chunks`` blocks
of ``chunk`` elements, and for the cluster route (one thread block cluster
per sample, x and dy read from device memory once) the ``kept`` elements of
x and of dy each block holds in shared memory; else the two-pass route. The
shapes are the train step's (``chip_smoke.py``'s ``K2_STEP`` and, for the
stats-in norm's backward, ``BLOCK1_STEP`` with y's 64 channels)."""

import math

import pytest
import torch

from littlegan_tpu_torch.ops.cuda import boundary_conv as tbc
from littlegan_tpu_torch.ops.cuda import norm_lrelu as tnl

K2_SHAPES = [
    (32, 32, 32, 128), (32, 16, 16, 256), (32, 8, 8, 384), (32, 64, 64, 64), (32, 64, 64, 128),
    (64, 32, 32, 128), (64, 16, 16, 256), (64, 8, 8, 384), (64, 64, 64, 64), (64, 64, 64, 128),
]
BLOCK1_SHAPES = [(32, 64, 64, 64), (64, 64, 64, 64)]
SHAPES = [pytest.param(s, id=f"K2-{'x'.join(map(str, s))}") for s in K2_SHAPES] + [
    pytest.param(s, id=f"K1bwd-{'x'.join(map(str, s))}") for s in BLOCK1_SHAPES
]
DTYPES = [torch.float32, torch.bfloat16]
SMS = 132  # the H100's SMs


def _plan(shape, dtype, **kw):
    """(n, m, itemsize, the plan); ``kw`` goes to ``bwd_plan``."""
    n, m = shape[0], math.prod(shape[1:])
    item = torch.tensor([], dtype=dtype).element_size()
    return n, m, item, tnl.bwd_plan(n, m, item, SMS, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_chunks_cover_every_element_of_a_sample(shape, dtype):
    _, m, _, plan = _plan(shape, dtype)
    assert plan.chunk % 8 == 0 and plan.chunk > 0
    assert (plan.chunks - 1) * plan.chunk < m <= plan.chunks * plan.chunk


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_a_batch_beyond_l2_takes_the_cluster_route(shape, dtype):
    """One cluster of at most 16 blocks (a power of two) per sample where
    the batch's x and dy outgrow the two-pass threshold; else two passes,
    chunked as the forward."""
    n, m, item, plan = _plan(shape, dtype)
    if 2 * n * m * item > tnl._BWD_TWO_PASS_BYTES:
        assert plan.one_pass
        assert plan.chunks <= 16 and plan.chunks & (plan.chunks - 1) == 0
    else:
        assert plan == (*tnl.chunking(n, m, SMS), 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_what_a_block_keeps_fits_its_shared_memory(shape, dtype):
    """A block keeps whole 16-byte vectors of x and dy: at least a quarter
    of its share, at most all of it and at most ``_BWD_SMEM_MAX`` bytes."""
    _, _, item, plan = _plan(shape, dtype, two_pass_bytes=0)
    assert plan.kept % 8 == 0 and 0 < plan.kept <= plan.chunk
    assert 2 * plan.kept * item <= tnl._BWD_SMEM_MAX
    assert 4 * plan.kept >= plan.chunk or 2 * plan.kept * item == tnl._BWD_SMEM_MAX


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_a_fixed_share_is_kept_as_asked(shape, dtype):
    _, _, item, plan = _plan(shape, dtype, smem=32 << 10, two_pass_bytes=0)
    assert plan.kept == min(plan.chunk, (32 << 10) // (2 * item))


@pytest.mark.parametrize("shape,kept_kb", [
    ((32, 64, 64, 64), 16), ((32, 64, 64, 128), 64), ((64, 32, 32, 128), 16), ((64, 64, 64, 64), 32),
    ((64, 64, 64, 128), 64),
])
def test_bf16_train_shapes_keep_the_share_that_ran_fastest(shape, kept_kb):
    """The rule's picks at the large bf16 train shapes: the shares that ran
    fastest on the H100 (PERF.md, PR 3)."""
    _, _, item, plan = _plan(shape, torch.bfloat16)
    assert plan.one_pass and 2 * plan.kept * item == kept_kb << 10


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plan_fills_the_card(shape, dtype):
    """At least two blocks per SM over the batch, or 16 per sample."""
    n, _, _, plan = _plan(shape, dtype)
    assert n * plan.chunks >= min(2 * SMS, 16 * n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_blocks_stay_near_the_aimed_share(shape, dtype):
    """Blocks per sample: enough that a block's share of x and dy is about
    ``_BWD_SHARE`` (64 KB), unless 16 blocks hold more."""
    _, m, item, plan = _plan(shape, dtype, two_pass_bytes=0)
    assert 2 * plan.chunk * item <= tnl._BWD_SHARE or plan.chunks == 16


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_two_pass_route_is_chunked_as_the_forward(shape, dtype):
    """Without shared memory for the cluster route (``smem=0``) the plan is
    the two-pass route, chunked as the forward's two-launch route."""
    n, m, item, plan = _plan(shape, dtype, smem=0)
    assert not plan.one_pass and plan == (*tnl.chunking(n, m, SMS), 0)
    assert plan[:2] == tnl.fwd_plan(n, m, item, SMS, blocks=0)[:2]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_the_backward_takes_the_forwards_moments_whatever_its_route(shape, dtype):
    """K2's stats input is K1's (2, N) f32 (mean, std) on either forward
    route, not the two-launch route's (2, N, chunks) partials: the backward
    no longer depends on how the forward split the batch."""
    n, m, item, _ = _plan(shape, dtype)
    for plan in (tnl.fwd_plan(n, m, item, SMS), tnl.fwd_plan(n, m, item, SMS, blocks=0)):
        tnl._check_stats(torch.empty((2, n)), n, torch.device("cpu"), "bwd")
        with pytest.raises(ValueError, match=rf"\(2, {n}\)"):
            tnl._check_stats(torch.empty((2, n, plan.chunks)), n, torch.device("cpu"), "bwd")


def test_a_length_not_a_multiple_of_8_takes_two_passes():
    assert not tnl.bwd_plan(4, 3 * 5 * 7, 2, SMS).one_pass


@pytest.mark.parametrize("shape", [(64, 64, 64, 128), (32, 64, 64, 128), (64, 64, 64, 64), (64, 32, 32, 128)])
def test_the_largest_bf16_train_shapes_take_the_cluster_route(shape):
    assert _plan(shape, torch.bfloat16)[3].one_pass


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"), (torch.float32, "fma")])
def test_boundary_conv_routes_by_dtype(dtype, route):
    """bf16 runs on the tensor cores; f32 keeps the FMA loop (TF32 would
    miss its 1e-5 tolerance)."""
    assert tbc.kernel_route(dtype) == route


# K1's shapes: the serve path's (batch 8, encoder blocks 2-4 and decoder
# blocks 1-4) and the train step's (batch 32 and the adjuster's 64 rows)
K1_SPATIAL = [(32, 32, 128), (16, 16, 256), (8, 8, 384), (64, 64, 64), (64, 64, 128)]
K1_SHAPES = [pytest.param((n,) + hwc, id=f"K1-{n}x{'x'.join(map(str, hwc))}") for n in (8, 32, 64) for hwc in K1_SPATIAL]


def _fwd(shape, dtype, **kw):
    n, m = shape[0], math.prod(shape[1:])
    item = torch.tensor([], dtype=dtype).element_size()
    return n, m, item, tnl.fwd_plan(n, m, item, SMS, tnl.holds_whole_sample(shape), **kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_fwd_chunks_cover_every_element_of_a_sample(shape, dtype):
    _, m, _, plan = _fwd(shape, dtype)
    assert plan.chunk % 8 == 0 and plan.chunk > 0
    assert (plan.chunks - 1) * plan.chunk < m <= plan.chunks * plan.chunk


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_fwd_cluster_fits_the_card(shape, dtype):
    """At most 16 blocks per cluster (8, the portable size, but for samples
    of 1 MiB or more in batches of 16 or more), each holding its whole share
    in shared memory; the two-launch route chunks as :func:`chunking`."""
    n, m, item, plan = _fwd(shape, dtype)
    if plan.cluster:
        assert 1 <= plan.chunks <= 16
        assert plan.chunk * item <= tnl._FWD_SMEM_MAX <= 227 << 10
        assert plan.chunks <= 8 or m * item >= 1 << 20
    else:
        assert plan == (*tnl.chunking(n, m, SMS), False, False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_whole_sample_shapes_take_the_cluster_route(shape, dtype):
    """Only the cluster route computes the Pallas op's two-pass moments;
    the plan says two-pass exactly where the Pallas op holds the sample."""
    _, _, _, plan = _fwd(shape, dtype)
    assert plan.two_pass == tnl.holds_whole_sample(shape)
    if plan.two_pass:
        assert plan.cluster


@pytest.mark.parametrize("hwc", K1_SPATIAL)
def test_batch_8_spreads_each_sample_over_8_blocks(hwc):
    """The serve batch: a cluster of 8 blocks per sample, 64 blocks in all.
    Clusters of 16 would fill the card's 132 SMs but ran slower at every
    batch-8 shape on the H100 (PERF.md, the K1 route table)."""
    _, _, _, plan = _fwd((8,) + hwc, torch.bfloat16)
    assert plan.cluster and plan.chunks == 8


@pytest.mark.parametrize("shape,route", [
    ((8, 64, 64, 64), 8), ((8, 64, 64, 128), 8), ((32, 64, 64, 64), 0), ((32, 64, 64, 128), 16),
    ((64, 64, 64, 64), 8), ((64, 64, 64, 128), 16),
])
def test_bf16_chunked_shapes_take_the_route_that_ran_fastest(shape, route):
    """The one-pass shapes' routes (0: two launches, else blocks per
    cluster): the fastest in the same-call comparison on the H100 (PERF.md,
    the K1 route table)."""
    _, _, _, plan = _fwd(shape, torch.bfloat16)
    assert not plan.two_pass and (plan.chunks if plan.cluster else 0) == route


@pytest.mark.parametrize("blocks", [1, 2, 4, 8, 16])
def test_a_forced_cluster_has_the_blocks_asked(blocks):
    """A share beyond shared memory (256 KB in one block) raises."""
    if blocks == 1:
        with pytest.raises(ValueError, match="does not fit 1 blocks"):
            _fwd((32, 32, 32, 128), torch.bfloat16, blocks=blocks)
        return
    n, m, _, plan = _fwd((32, 32, 32, 128), torch.bfloat16, blocks=blocks)
    assert plan.cluster and plan.chunks == blocks and plan.chunk == m // blocks


def test_a_sample_beyond_16_blocks_of_shared_memory_takes_two_launches():
    n, m = 4, 256 * 256 * 64  # 8 MiB of bf16 per sample, 512 KiB per block
    assert tnl.fwd_plan(n, m, 2, SMS) == (*tnl.chunking(n, m, SMS), False, False)
    with pytest.raises(ValueError, match="two-pass"):
        tnl.fwd_plan(n, m, 2, SMS, two_pass=True)
    with pytest.raises(ValueError, match="one-pass"):
        tnl.fwd_plan(n, 1024, 2, SMS, two_pass=True, blocks=0)
