"""TF SAME's uneven border through the norm kernels: the encoder's norms
write their map inside the next stride-2 conv's border, the decoder's read
theirs out of the transposed conv's full output, and their backwards read
and write the gradients the same way (``ops/cuda/norm_lrelu.py``'s
``border`` and windowed inputs, ``csrc/norm_map.cuh``, ``ops/conv.py``'s
``conv2d_padded`` and ``deconv2d_full``, the routing in
``models/littlegan.py``).

On the CPU: the plain versions of the bordered and windowed entries against
``F.pad`` and slicing; the conv entries against ``conv2d`` and ``deconv2d``;
the Functions' gradients against the pad / slice composition; which of the
model's Function calls take a border or a window, and that a step's
gradients equal those of today's composition (``same_border`` and
``same_crop`` patched to None) bit for bit.

On a card (marked ``card``; skips without one): every kernel route at the
128² and 256² train shapes, batch 32 and 64, bit for bit against the same
route over contiguous tensors (the bordered buffer starts out as NaN); one
``micro_grads`` of littlegan-128 at batch 32 against the composition; and,
under a ``TorchDispatchMode``, no pad, slice backward or activation-sized
clone in that step, with the ``same_border.*`` counters at 12 / 12 / 6 / 6.
On the card's host, which has no JAX: ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_same_border.py -m card``.
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from littlegan_tpu_torch.config import Config as TConfig
from littlegan_tpu_torch.models import littlegan as tm
from littlegan_tpu_torch.ops import conv as tconv
from littlegan_tpu_torch.ops.cuda import _build
from littlegan_tpu_torch.ops.cuda import boundary_conv as tbc
from littlegan_tpu_torch.ops.cuda import norm_lrelu as tnl
from littlegan_tpu_torch.training import step as tstep
from littlegan_tpu_torch.training.state import create_train_state
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

BORDER = (1, 2, 1, 2)  # TF SAME's pads of a 5x5 stride-2 conv over an even map
TINY = dict(batch_size=4, image_dim=16, init_dim=1, noise_dim=13, attr=[0, 1, 2, 3, 4, 5, 6],
            conv_filter=[24, 16, 12, 8, 4], kernel_size=5, use_s2d=True, use_partition=False, train_adj=True,
            debug=True)
REFERENCE = dict(batch_size=32, image_dim=128, init_dim=8, noise_dim=93, attr=[8, 15, 20, 22, 26, 36, 39],
                 conv_filter=[384, 256, 128, 64, 32], kernel_size=5, compute_dtype="bfloat16", use_s2d=True,
                 use_partition=True, partition_interval=4, train_adj=True, use_clip=True, clip_range=0.5,
                 debug=True)
COUNTERS = ("write", "grad_read", "crop_read", "grad_write")


def _pad(y, border=BORDER):
    top, bottom, left, right = border
    return F.pad(y, (0, 0, left, right, top, bottom))


def _window(full, border=BORDER):
    top, bottom, left, right = border
    return full[:, top:full.shape[1] - bottom, left:full.shape[2] - right]


def _scalars(gen, device):
    return (torch.rand(1, generator=gen).to(device) + 0.5, torch.rand(1, generator=gen).to(device) - 0.5)


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The CPU: plain versions, conv entries, Functions, the model's route


@pytest.mark.parametrize("hw", [(8, 8), (8, 7), (7, 8), (7, 7), (2, 2)])
def test_conv_entries_equal_conv2d_and_deconv2d(hw):
    """``same_border`` is SAME's pads where they are uneven, and
    ``conv2d_padded`` of the map inside them is ``conv2d``; the window
    ``same_crop`` names in ``deconv2d_full``'s output is ``deconv2d``."""
    h, w = hw
    gen = torch.Generator().manual_seed(h * 10 + w)
    x = torch.randn(2, h, w, 4, generator=gen)
    kernel, bias = torch.randn(5, 5, 4, 3, generator=gen), torch.randn(3, generator=gen)
    border = tconv.same_border(h, w, 5, 2)
    assert border == (None if h % 2 and w % 2 else (*tconv.same_pads(h, 5, 2), *tconv.same_pads(w, 5, 2)))
    if border is not None:
        assert torch.equal(tconv.conv2d_padded(_pad(x, border), kernel, bias, 2), tconv.conv2d(x, kernel, bias, 2))
    dkernel = torch.randn(5, 5, 3, 4, generator=gen)
    crop = tconv.same_crop(h, w, 5, 2)
    assert crop == (1, 1, 2 * h, 2 * w)  # an even output: always uneven
    top, left, rows, cols = crop
    full = tconv.deconv2d_full(x, dkernel, bias, 2)
    assert full.shape == (2, 2 * h + 3, 2 * w + 3, 3)
    assert torch.equal(full[:, top:top + rows, left:left + cols], tconv.deconv2d(x, dkernel, bias, 2))
    assert tconv.same_crop(h, w, 5, 1) is None  # stride 1: symmetric


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 6, 6, 8), (2, 4, 5, 3)], ids=["6x6x8", "4x5x3"])
def test_plain_bordered_and_windowed_entries_equal_pad_and_slice(shape, dtype):
    """On the CPU the wrappers' bordered outputs are ``F.pad`` of their
    plain outputs, and a windowed input gives what its contiguous copy
    gives: K1, K2 (windowed x and dy, bordered dx), K1' (bordered) and
    K1' bwd (windowed dout)."""
    gen = torch.Generator().manual_seed(7)
    n, h, w, c = shape
    full = torch.randn(n, h + 3, w + 3, c, generator=gen).to(dtype)
    x = _window(full)
    g, b = _scalars(gen, "cpu")
    y = tnl.fused_instance_norm_lrelu(x.contiguous(), g, b)
    assert _same(tnl.fused_instance_norm_lrelu(x, g, b), y)
    assert _same(tnl._fused_forward(x, g, b, 0.3, 1e-3, border=BORDER)[0], _pad(y))
    dy = _window(torch.randn(n, h + 3, w + 3, c, generator=gen).to(dtype))
    want = tnl.fused_instance_norm_lrelu_bwd(x.contiguous(), dy.contiguous(), g, b)
    got = tnl.fused_instance_norm_lrelu_bwd(x, dy, g, b, border=BORDER)
    assert _same(got[0], _pad(want[0])) and all(_same(a, w_) for a, w_ in zip(got[1:], want[1:]))
    s1, s2 = x.float().sum((1, 2, 3)), x.float().square().sum((1, 2, 3))
    out = tnl.norm_lrelu_from_stats(x.contiguous(), s1, s2, g, b)
    assert _same(tnl.norm_lrelu_from_stats(x, s1, s2, g, b, border=BORDER), _pad(out))
    want = tnl.norm_lrelu_from_stats_bwd(x.contiguous(), s1, s2, g, b, dy.contiguous())
    got = tnl.norm_lrelu_from_stats_bwd(x, s1, s2, g, b, dy)
    assert all(_same(a, w_) for a, w_ in zip(got, want))


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


@pytest.mark.parametrize("uses", ["padded", "map", "both"])
def test_bordered_functions_equal_the_pad_composition(uses):
    """``FusedNormLReLU`` and ``NormLReLUFromStats`` with a border return
    (padded, map): the composition's ``F.pad`` of the map and the map; their
    gradients, whether the padded buffer, the map view or both are used,
    equal the composition's."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(3, 6, 6, 8, generator=gen)
    g, b = _scalars(gen, "cpu")
    wp, wm = torch.randn(3, 9, 9, 8, generator=gen), torch.randn(3, 6, 6, 8, generator=gen)

    def loss(padded, y):  # an unused output gets no gradient at all
        terms = ([(padded * wp).sum()] if uses != "map" else []) + ([(y * wm).sum()] if uses != "padded" else [])
        return sum(terms)

    for fn, args in ((tnl.FusedNormLReLU, ()), (tnl.NormLReLUFromStats, ("sums",))):
        grads = []
        for bordered in (True, False):
            xl, gl, bl = _leaf(x), _leaf(g), _leaf(b)
            ins = (xl, xl.sum((1, 2, 3)), (xl * xl).sum((1, 2, 3))) if args else (xl,)
            if bordered:
                padded, y = fn.apply(*ins, gl, bl, 0.3, 1e-3, BORDER)
            else:
                y = fn.apply(*ins, gl, bl, 0.3)
                padded = _pad(y)
            grads.append((padded.detach(), y.detach(), *torch.autograd.grad(loss(padded, y), (xl, gl, bl))))
        assert all(_same(a, w_) for a, w_ in zip(*grads)), fn.__name__


def test_windowed_function_equals_the_slice_composition():
    """``FusedNormLReLU`` with a crop takes the window of the full map; the
    gradient of the full map (zeros outside the window) equals what the
    slice and its ``.contiguous()`` give."""
    gen = torch.Generator().manual_seed(4)
    full = torch.randn(3, 9, 9, 8, generator=gen)
    g, b = _scalars(gen, "cpu")
    wy = torch.randn(3, 6, 6, 8, generator=gen)
    got, want = [], []
    for crop, out in (((1, 1, 6, 6), got), (None, want)):
        fl, gl, bl = _leaf(full), _leaf(g), _leaf(b)
        if crop:
            y = tnl.FusedNormLReLU.apply(fl, gl, bl, 0.3, 1e-3, None, crop)
        else:
            y = tnl.FusedNormLReLU.apply(_window(fl).contiguous(), gl, bl, 0.3)
        out += [y.detach(), *torch.autograd.grad((y * wy).sum(), (fl, gl, bl))]
    assert all(_same(a, w_) for a, w_ in zip(got, want))


def _composition(monkeypatch):
    """Today's pad / crop composition: the model finds no uneven border."""
    monkeypatch.setattr(tm, "_next_border", lambda y, cfg: None)
    monkeypatch.setattr(tm, "same_crop", lambda *a: None)


def _step_case(cfg, device, seed=5):
    torch.manual_seed(seed)
    state = create_train_state(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n, d = cfg.batch_size, cfg.image_dim

    def pair():
        image = torch.rand((n, d, d, cfg.image_channel), generator=gen, device=device) * 2 - 1
        cond = torch.where(torch.rand((n, cfg.cond_dim), generator=gen, device=device) < 0.5, 0.98, -0.94)
        return image, cond

    b1, b2 = pair(), pair()
    return state, b1, b2, tstep.draw_step(gen, cfg, n, device)


def _grads(cfg, device):
    state, b1, b2, draws = _step_case(cfg, device)
    grads, aux = tstep.compute_grads(state, b1, b2, draws, 3, cfg)
    losses = {k: aux[k] for k in tstep.LOSS_KEYS if k in aux}
    return grads, losses


def _check_route_equals_composition(cfg, device, monkeypatch):
    route = _grads(cfg, device)
    with monkeypatch.context() as m:
        _composition(m)
        today = _grads(cfg, device)
    assert route[1].keys() == today[1].keys() and route[0].keys() == today[0].keys()
    for k in today[1]:
        assert _same(route[1][k], today[1][k]), k
    for k in today[0]:
        assert _same(route[0][k], today[0][k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "raw"])
def test_step_gradients_equal_the_composition(dtype, s2d, monkeypatch):
    """One step's losses and every gradient through the bordered and
    windowed Functions (their plain versions) against today's composition,
    bit for bit."""
    _check_route_equals_composition(TConfig(**TINY).replace(compute_dtype=dtype, use_s2d=s2d), "cpu", monkeypatch)


NORM_FUNCTIONS = (tnl.FusedNormLReLU, tnl.NormLReLUFromStats)
KERNEL_FUNCTIONS = NORM_FUNCTIONS + (tbc.BoundaryConvS2D,)  # every kernel Function the model calls


class _Calls:
    """The calls of ``functions`` (the norm kernels' Functions by default),
    by (Function, direction, what it took: "border", "crop" or "plain")."""

    def __init__(self, monkeypatch, functions=NORM_FUNCTIONS):
        self.counts = {}

        def kind(border, crop):
            return "border" if border is not None else "crop" if crop is not None else "plain"

        def forward(cls, orig):
            at = {tnl.NormLReLUFromStats: 7, tnl.FusedNormLReLU: 5}.get(cls)  # where the border argument sits

            def wrapped(ctx, *a):
                border = a[at] if at is not None and len(a) > at else None
                crop = a[6] if cls is tnl.FusedNormLReLU and len(a) > 6 else None
                self._add(cls, "forward", kind(border, crop))
                return orig(ctx, *a)
            return staticmethod(wrapped)

        def backward(cls, orig):
            def wrapped(ctx, *g):
                self._add(cls, "backward", kind(getattr(ctx, "border", None), getattr(ctx, "crop", None)))
                return orig(ctx, *g)
            return staticmethod(wrapped)

        for cls in functions:
            monkeypatch.setattr(cls, "forward", forward(cls, cls.forward))
            monkeypatch.setattr(cls, "backward", backward(cls, cls.backward))

    def _add(self, cls, direction, kind):
        key = (cls.__name__, direction, kind)
        self.counts[key] = self.counts.get(key, 0) + 1


def test_the_model_routes_each_uneven_border_through_the_kernels(monkeypatch):
    """In one step (D on the real and the generated batch, the adjuster's
    encoder, D on its images, G's and the adjuster's decoder), encoder
    blocks 1-3 write their maps inside the next conv's border (12 forwards,
    12 backwards) and decoder blocks 1-3 read theirs out of the full
    output (6 and 6); block 4 of each, and nothing else, stays plain."""
    calls = _Calls(monkeypatch)
    cfg = TConfig(**TINY)
    state, b1, b2, draws = _step_case(cfg, "cpu")
    tstep.compute_grads(state, b1, b2, draws, 3, cfg)
    assert calls.counts == {
        ("NormLReLUFromStats", "forward", "border"): 4, ("NormLReLUFromStats", "backward", "border"): 4,
        ("FusedNormLReLU", "forward", "border"): 8, ("FusedNormLReLU", "backward", "border"): 8,
        ("FusedNormLReLU", "forward", "crop"): 6, ("FusedNormLReLU", "backward", "crop"): 6,
        ("FusedNormLReLU", "forward", "plain"): 6, ("FusedNormLReLU", "backward", "plain"): 6,
    }


@pytest.mark.parametrize("case", ["dropout", "gp", "odd maps"])
def test_no_border_where_the_kernels_do_not_write_it(case, monkeypatch):
    """Dropout masks keep their Functions borderless; the gradient penalty
    takes the plain route, so no Function is called at all; a map whose
    next conv pads it evenly (a 12-pixel image's 3-pixel map) is not
    bordered: no Function call takes a border where the code sees none."""
    calls = _Calls(monkeypatch)
    cfg = TConfig(**TINY)
    gen = torch.Generator().manual_seed(2)
    if case == "gp":
        cfg = cfg.replace(use_gp=True)
    if case == "odd maps":
        cfg = cfg.replace(image_dim=12, use_s2d=False)
    model = tm.init_params(cfg)
    image = torch.rand(2, cfg.image_dim, cfg.image_dim, 3, generator=gen) * 2 - 1
    masks = None
    if case == "dropout":
        shapes = [o.shape for o in model.encoder(image)]
        masks = [torch.rand(s, generator=gen) < 0.5 for s in shapes]
        calls.counts.clear()
    model.discriminator(image, dropout_masks=masks)
    kinds = {k[2] for k in calls.counts}
    if case == "odd maps":
        # maps of 6, 3, 2 and 1 pixels: the next conv pads 6 and 2 unevenly, 3 evenly; block 4 has no next
        assert calls.counts == {("FusedNormLReLU", "forward", "border"): 2, ("FusedNormLReLU", "forward", "plain"): 2}
    elif case == "gp":
        assert calls.counts == {}
    else:
        assert kinds <= {"plain"} and calls.counts


class _OneRank:
    """A model axis of one rank, whose collectives copy: a spatial mesh's
    code path in one process."""

    world, rank = 1, 0

    def all_gather(self, out, inp):
        return out.copy_(inp)

    def reduce_scatter_sum(self, out, inp):
        return out.copy_(inp)

    def all_reduce_sum_(self, t):
        return t


@pytest.mark.parametrize("case", ["plain config", "spatial mesh", "gp", "plain_versions"])
def test_the_kernels_route_is_taken_unless_a_mesh_or_the_penalty_forbids_it(case, monkeypatch):
    """``models/littlegan.py::_kernels``: a config with no option set sends
    D's encoder through the kernel Functions (block1's boundary conv and its
    stats-in norm, the fused norm of blocks 2-4); under a spatial mesh's
    model axis, with the gradient penalty and inside
    ``_build.plain_versions()`` no kernel Function is called."""
    from littlegan_tpu_torch.parallel.spatial import Spatial

    calls = _Calls(monkeypatch, KERNEL_FUNCTIONS)
    cfg = TConfig(**TINY).replace(use_gp=case == "gp")
    model = tm.init_params(cfg)
    image = torch.rand(2, cfg.image_dim, cfg.image_dim, 3, generator=torch.Generator().manual_seed(4)) * 2 - 1
    with _build.plain_versions() if case == "plain_versions" else contextlib.nullcontext():
        pr, cond = model.discriminator(image, sp=Spatial(_OneRank()) if case == "spatial mesh" else None)
        (pr.sum() + cond.sum()).backward()
    if case == "plain config":
        assert calls.counts == {
            ("BoundaryConvS2D", "forward", "plain"): 1, ("BoundaryConvS2D", "backward", "plain"): 1,
            ("NormLReLUFromStats", "forward", "border"): 1, ("NormLReLUFromStats", "backward", "border"): 1,
            ("FusedNormLReLU", "forward", "border"): 2, ("FusedNormLReLU", "backward", "border"): 2,
            ("FusedNormLReLU", "forward", "plain"): 1, ("FusedNormLReLU", "backward", "plain"): 1,
        }
    else:
        assert calls.counts == {}
    assert float(model.encoder.block1.conv.kernel.grad.abs().sum()) > 0


def test_runs_kernel_says_no_on_the_cpu_and_inside_plain_versions():
    """``_build.runs_kernel``: the kernel for a CUDA device, the plain
    version for the CPU; inside ``plain_versions()`` the plain version for
    both, and the kernel again once the context is left, by an exception
    too (the device objects are made without a card)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert _build.runs_kernel(cuda) and not _build.runs_kernel(cpu) and not _build.plain_only()
    with _build.plain_versions():
        assert not _build.runs_kernel(cuda) and not _build.runs_kernel(cpu) and _build.plain_only()
        with _build.plain_versions():
            assert not _build.runs_kernel(cuda)
        assert not _build.runs_kernel(cuda)
    assert _build.runs_kernel(cuda)
    with pytest.raises(KeyError), _build.plain_versions():
        raise KeyError("inside")
    assert _build.runs_kernel(cuda) and not _build.runs_kernel(cpu) and not _build.plain_only()


# ---------------------------------------------------------------------------
# The card: every route of every changed kernel, and the step


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _nan_buffers(monkeypatch):
    """Every bordered buffer the wrappers allocate starts out as NaN, so a
    border the kernel does not write shows."""
    orig = tnl._padded

    def padded(like, border):
        buf, inner, mp = orig(like, border)
        buf.fill_(float("nan"))
        return buf, inner, mp

    monkeypatch.setattr(tnl, "_padded", padded)


def _train_maps(size):
    """(encoder maps written inside a border: K1' block 1, K1 blocks 2-3;
    decoder maps read out of a full output: blocks 1-3), as (H, C)."""
    cf = REFERENCE["conv_filter"]
    enc = [(size // 2, cf[3]), (size // 4, cf[2]), (size // 8, cf[1])]
    init = size // 16
    dec = [(2 * init, cf[1]), (4 * init, cf[2]), (8 * init, cf[3])]
    return enc, dec


def _fwd_routes(n, m, sms, two_pass):
    plans = {"default": tnl.fwd_plan(n, m, 2, sms, two_pass), "two launches": tnl.fwd_plan(n, m, 2, sms, False, 0),
             "three launches": tnl.fwd_plan(n, m, 2, sms, True, 0)}
    for blocks in (8, 16):
        for tp in (False, True):
            with contextlib.suppress(ValueError):
                plans[f"cluster {blocks}{' two-pass' if tp else ''}"] = tnl.fwd_plan(n, m, 2, sms, tp, blocks)
    return plans


def _bwd_routes(n, m, sms):
    return {"default": tnl.bwd_plan(n, m, 2, sms), "cluster": tnl.bwd_plan(n, m, 2, sms, two_pass_bytes=0),
            "two passes": tnl.bwd_plan(n, m, 2, sms, smem=0)}


@pytest.mark.card
@pytest.mark.parametrize("batch", [32, 64])
@pytest.mark.parametrize("size", [128, 256])
def test_bordered_and_windowed_kernels_on_every_route(card, size, batch, monkeypatch):
    """K1 and K1' writing inside the border equal ``F.pad`` of their
    contiguous output, NaN-filled buffers and all; K1 reading a window of a
    larger map equals it reading the contiguous copy; K2 reading a windowed
    dy (and x) and writing dx inside a border, and K1' bwd reading a windowed
    dout, equal them over contiguous tensors: each route, bit for bit."""
    _nan_buffers(monkeypatch)
    gen = torch.Generator(device=card).manual_seed(size + batch)
    sms = tnl._sms(card)
    enc, dec = _train_maps(size)
    checked = 0
    for side, c in enc + dec:
        full = torch.randn((batch, side + 3, side + 3, c), generator=gen, device=card).to(torch.bfloat16)
        x = _window(full)
        xc = x.contiguous()
        g, b = _scalars(torch.Generator().manual_seed(side), card)
        m = side * side * c
        for name, plan in _fwd_routes(batch, m, sms, tnl.holds_whole_sample(x.shape, 2)).items():
            want, wstats = tnl._fused_forward(xc, g, b, 0.3, 1e-3, plan)
            got, stats = tnl._fused_forward(xc, g, b, 0.3, 1e-3, plan, border=BORDER)
            assert _same(got, _pad(want)) and _same(stats, wstats), (side, c, name, "border")
            got, stats = tnl._fused_forward(x, g, b, 0.3, 1e-3, plan)
            assert _same(got, want) and _same(stats, wstats), (side, c, name, "window")
            checked += 1
        dy = _window(torch.randn(full.shape, generator=gen, device=card).to(torch.bfloat16))
        stats = tnl._fused_forward(xc, g, b, 0.3, 1e-3)[1]
        for name, plan in _bwd_routes(batch, m, sms).items():
            want = tnl.fused_instance_norm_lrelu_bwd(xc, dy.contiguous(), g, b, 0.3, 1e-3, stats, plan)
            got = tnl.fused_instance_norm_lrelu_bwd(x, dy, g, b, 0.3, 1e-3, stats, plan, border=BORDER)
            assert _same(got[0], _pad(want[0])), (side, c, name, "K2")
            assert all(_same(a, w_) for a, w_ in zip(got[1:], want[1:])), (side, c, name, "K2 sums")
            checked += 1
        if (side, c) == enc[0]:  # K1' and its backward: encoder block 1
            s1, s2 = xc.float().sum((1, 2, 3)), xc.float().square().sum((1, 2, 3))
            want = tnl.norm_lrelu_from_stats(xc, s1, s2, g, b)
            assert _same(tnl.norm_lrelu_from_stats(xc, s1, s2, g, b, border=BORDER), _pad(want)), (side, "K1'")
            for name, plan in _bwd_routes(batch, m, sms).items():
                want = tnl.norm_lrelu_from_stats_bwd(xc, s1, s2, g, b, dy.contiguous(), plan=plan)
                got = tnl.norm_lrelu_from_stats_bwd(xc, s1, s2, g, b, dy, plan=plan)
                assert all(_same(a, w_) for a, w_ in zip(got, want)), (side, name, "K1' bwd")
                checked += 1
    assert checked > 0


class _Ops(TorchDispatchMode):
    """The aten ops a region runs, with the shapes of their first input."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        first = args[0] if args and isinstance(args[0], torch.Tensor) else None
        self.ops.append((str(func.overloadpacket.__name__), None if first is None else tuple(first.shape)))
        return func(*args, **(kwargs or {}))


@pytest.mark.card
def test_reference_step_equals_the_composition_on_the_card(card, monkeypatch):
    """One ``micro_grads`` of littlegan-128 at batch 32 through the kernels:
    losses and every gradient equal today's pad / crop composition, bit for
    bit (cuDNN held to its deterministic algorithms in both)."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        _check_route_equals_composition(TConfig(**REFERENCE), card, monkeypatch)


def _map_copies(cfg, device, state, b1, b2, draws):
    """The pads, slice backwards and clones of an activation map (batch
    rows, every other side 16 or more) in one step, and the engagement
    counters' increments."""
    before = _build.launch_counts()
    with _Ops() as mode:
        tstep.compute_grads(state, b1, b2, draws, 3, cfg)
    torch.cuda.synchronize(device)
    after = _build.launch_counts()
    copies = [(op, shape) for op, shape in mode.ops
              if op in ("constant_pad_nd", "slice_backward", "clone") and shape is not None and len(shape) == 4
              and shape[0] in (cfg.batch_size, 2 * cfg.batch_size) and min(shape[1:]) >= 16]
    return copies, {k: after[f"same_border.{k}"] - before.get(f"same_border.{k}", 0) for k in COUNTERS}


@pytest.mark.card
def test_reference_step_runs_no_pad_crop_or_copy(card, monkeypatch):
    """Under a ``TorchDispatchMode`` the same step runs no
    ``constant_pad_nd``, ``slice_backward`` or clone of a map, where today's
    composition (the control) runs all three; the engagement counters read
    12 / 12 / 6 / 6, and 0 in the control."""
    cfg = TConfig(**REFERENCE)
    case = _step_case(cfg, card)
    tstep.compute_grads(case[0], *case[1:], 3, cfg)  # builds the kernels
    copies, counts = _map_copies(cfg, card, *case)
    assert copies == []
    assert counts == {"write": 12, "grad_read": 12, "crop_read": 6, "grad_write": 6}
    with monkeypatch.context() as m:
        _composition(m)
        copies, counts = _map_copies(cfg, card, *case)
    assert {op for op, _ in copies} == {"constant_pad_nd", "slice_backward", "clone"}
    assert counts == dict.fromkeys(COUNTERS, 0)
