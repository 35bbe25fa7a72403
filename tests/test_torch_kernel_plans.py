"""How the port's kernels split their work, on the CPU.

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
    the two-pass route with the forward's chunking."""
    n, m, _, plan = _plan(shape, dtype, smem=0)
    assert not plan.one_pass and plan == (*tnl.chunking(n, m, SMS), 0)


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
