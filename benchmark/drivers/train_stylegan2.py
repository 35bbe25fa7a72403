"""StyleGAN2 training over a card-resident store, K iterations per CUDA-graph
replay.

The program's own path for ``model: stylegan2``: the image store on the
card, ``training/stylegan2.py::make_stylegan2_scan_step`` (K iterations of
the lazy phases Gmain, Greg, Dmain, Dreg captured in one graph by
``training/dispatch.py::GraphedUpdates``) called back to back, closed loop.
Traffic parameters:

- ``k``: iterations per replay (16, one lazy period: Greg on 4 of them,
  Dreg on 1; every call starts at a multiple of 16, so one graph serves
  all); ``store_images`` images made on the card from the seed;
- ``trace_dispatches``: replays in the traced window with ``--trace 1``
  (one more, traced before it, fills the queue); ``check_replays``: the
  replays set-up runs and the check compares; ``check_chunk``: the samples
  the float32 reference takes at a time (whole minibatch-stddev groups);
  ``check_lr`` (optional): the step size of both Adams in the checked
  replays.

Each iteration's draws come from a generator on the card seeded from the
seed: the real ids (uniform over the store), x-flips, and each G pass's z,
mixing z, cutoff and noise maps, and the path-length noise
(``training/stylegan2.py::draw_iteration``). Iterations are numbered from
0 in each checked replay and run on from there in the window. The readings
count an iteration as an update of ``batch`` = B: ``train_images_per_s``
then counts the real and the generated batch that D and G train on, 2 x
64 images an iteration (ADA's kimg rate times 2000).

Set-up builds the state from the seed's weights, captures the graph and
runs ``check_replays`` replays of it, each from fresh weights of the seed
(zero moments and counts, ``pl_mean`` and ``w_avg`` 0, the EMA a copy);
then the window runs replays until ``--seconds`` have passed and a
synchronize closes it. With ``--trace 1`` the traced replays are followed
by two eager iterations whose numbers run both regularisation phases, the
second under the profiler: its ``littlegan:stylegan2.*`` spans give the
device ms of the kernels launched inside them (``span_device_ms``).

Once the program's state and store are freed (the checked iterations'
real images copied out first), the plain float32 reference
(``benchmark/reference/stylegan2.py``) works out again, from the same
weights, images and draws:

- ``loss_gap_first``: of each checked replay's first iteration, the terms
  computed before any Adam step touched the weights they read (``FRESH``:
  Gmain's loss and Dmain's real term), the worst gap relative to the
  reference's value (as in ``drivers/train_graph.py``);
- ``loss_gap_all``: the same over every term the checked replays computed
  that ran (the first replay's K iterations whole, with ``pl_mean``, and
  the first iteration of the others);
- ``change_gap``: the reference follows the first replay's K iterations
  whole; per parameter of G and D, and per leaf of G's EMA, the gap
  between the norms of the program's and the reference's change from the
  start (``drivers/train_graph.py``'s ``change_numbers``, over the
  parameters and over the EMA apart, the larger);
- ``change_dir_gap``: the same changes' direction, per network (G, D) and
  for G's EMA: the norm of the program's change less the reference's over
  the norm of the reference's (``drivers/train_stargan_v2.py``'s
  ``direction_numbers``), the largest; ``change_dir_gap_d``: D's alone.
  A state left unchanged reads 1. Both are readings only, with no limit:
  from seed to seed the program's swing as far as the float8 control's
  and within a tenth of a planted fault's.

With ``ctx.controls`` (``benchmark/calibrate.py limits``) the same numbers
of the float8 reference (``control``) and of the planted faults
(``reference.stylegan2.FAULTS``) in the program's place.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import tempfile
import time
from typing import Dict, List

import numpy as np

from benchmark import harness
from benchmark.drivers.train_graph import change_numbers, loss_gaps, port_config
from benchmark.drivers.train_stargan_v2 import direction_numbers
from benchmark.reference import stylegan2 as ref

FRESH = [ref.LOSSES.index(n) for n in ("g_main", "d_real")]
SPANS = ("dispatch", "draws")  # the host spans a device idle gap is named by, most specific first
SPAN_PREFIX = "littlegan:"


def span_device_ms(trace: dict) -> Dict[str, float]:
    """Device ms of the kernels launched inside each ``littlegan:stylegan2.*``
    span of a Chrome trace: the launches (runtime calls, by correlation id)
    whose start lies in the span, on any thread (autograd launches a
    backward's kernels from its own)."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"][len(SPAN_PREFIX):]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(SPAN_PREFIX + "stylegan2.")]
    launch = {e["args"]["correlation"]: e["ts"] for e in events if e.get("ph") == "X"
              and e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    device = [(launch.get(e["args"].get("correlation")), e.get("dur", 0)) for e in events
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "args" in e]
    out: Dict[str, float] = {}
    for a, b, name in spans:
        us = sum(dur for t, dur in device if t is not None and a <= t <= b)
        out[name] = out.get(name, 0.0) + us / 1e3
    return out


def make_store(n: int, d: int, gen, device):
    """(n, d, d, 3) uint8 images on the card."""
    import torch

    images = torch.empty((n, d, d, 3), dtype=torch.uint8, device=device)
    step = max(1, (1 << 30) // (d * d * 3))
    for i in range(0, n, step):
        images[i:i + step].random_(0, 256, generator=gen)
    return images


def real_images(images_u8, flips):
    """(B, 3, H, W) float32 in [-1, 1] of (B, H, W, 3) uint8, mirrored where ``flips`` (the reference's input)."""
    import torch

    x = images_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    return torch.where(flips[:, None, None, None], torch.flip(x, [3]), x)


def ref_draws(d) -> dict:
    """One iteration's program draws as the reference takes them."""
    g = lambda x: None if x is None else {"z": x.z, "z2": x.z2, "cutoff": x.cutoff, "noise": x.noise}  # noqa: E731
    return {"g_main": g(d.g_main), "d_main": g(d.d_main), "g_reg": g(d.g_reg), "pl_noise": d.pl_noise}


def reference_run(cfgd: dict, p0, reals, draws: List, k: int, chunk=None, precision=ref.F32, fault=None):
    """The reference's ``k`` iterations from ``p0`` (iterations 0..k-1):
    ((k, 6) terms, final parameters, final EMA, final w_avg, each leaf's
    first gradient norm). ``reals``: each iteration's (B, H, W, 3) uint8
    images and flips; ``draws``: each iteration's :func:`ref_draws`."""
    import torch

    model, hp = ref.Model.from_config(cfgd, precision, fault), ref.Hyper.from_config(cfgd)
    p = ref.leaves(p0)
    opts, run, norms = ref.adams(p, hp, fault), ref.new_run(p, model.w_dim), {}
    terms = []
    for i in range(k):
        x = real_images(*reals[i])
        terms.append(ref.iteration(model, p, opts, run, x, draws[i], i, hp, chunk, fault,
                                   grad_norms=norms if i == 0 else None))
    return torch.stack(terms), {key: v.detach() for key, v in p.items()}, run.ema, run.w_avg, norms


def state_numbers(p0, prog, prog_ema, ref_params, ref_ema, grad_norms) -> Dict[str, float]:
    """``change_gap`` (the parameters' and the EMA's, the larger),
    ``change_dir_gap`` and ``change_dir_gap_d`` of a run's state after the
    first replay against the float32 reference's (the EMA's ``w_avg``, a
    buffer, apart)."""
    keys = [k for k in ref_ema if k in grad_norms]
    ema = {f"ema.{k}": ref_ema[k] for k in keys}
    prog_e = {f"ema.{k}": prog_ema[k] for k in keys}
    p0_e = {**p0, **{f"ema.{k}": p0[k] for k in keys}}
    norms_e = {f"ema.{k}": grad_norms[k] for k in keys}
    params = change_numbers(p0, prog, ref_params, grad_norms)
    of_ema = change_numbers(p0_e, prog_e, ema, norms_e)
    direction = direction_numbers(p0_e, {**prog, **prog_e}, {**ref_params, **ema}, {**grad_norms, **norms_e})
    return {**params, "change_gap": max(params["change_gap"], of_ema["change_gap"]),
            "change_gap_params": params["change_gap"], "change_gap_ema": of_ema["change_gap"], **direction,
            "change_dir_gap_d": direction["change_dir_gap.D"]}


def ran(cfgd: dict, k: int) -> np.ndarray:
    """(k, 6) bool: which terms iterations 0..k-1 compute."""
    hp = ref.Hyper.from_config(cfgd)
    out = np.ones((k, len(ref.LOSSES)), bool)
    for i in range(k):
        g, d = hp.runs(i)
        out[i, ref.LOSSES.index("pl_penalty")] = g
        out[i, ref.LOSSES.index("r1_penalty")] = d
    return out


def loss_gap_all(got_first, got0, want_first, want0, mask0) -> float:
    """The worst relative gap of the terms that ran: the first replay's (K,
    6) ``got0`` whole, and each other replay's first iteration (rows 1 on
    of the (replays, 6) ``got_first``)."""
    got = np.concatenate([got0[mask0], got_first[1:].reshape(-1)])
    want = np.concatenate([want0[mask0], want_first[1:].reshape(-1)])
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-12)).max())


@contextlib.contextmanager
def step_size(cfg, lr):
    """``cfg.lr`` set to ``lr`` inside (None: left as it is): the scan step
    works out each call's Adam step sizes from it on the host."""
    saved = cfg.lr
    cfg.lr = saved if lr is None else lr
    try:
        yield
    finally:
        cfg.lr = saved


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from littlegan_tpu_torch.models.stylegan2 import StyleGAN2
    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.training import stylegan2 as sg
    from littlegan_tpu_torch.training.state import create_stylegan2_state

    cfgd, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    check_lr = tr.get("check_lr")
    cfg_check = {**cfgd, **({"lr": check_lr} if check_lr is not None else {})}
    cfg = port_config(cfgd, device_data=True, steps_per_dispatch=tr["k"])
    k, b = tr["k"], cfgd["batch_size"]
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    # weights and dataset from the seed, on the card
    gen = torch.Generator(device=dev).manual_seed(ctx.sub_seed(1))
    shapes = ref.Model.from_config(cfgd).shapes()
    p0 = ref.init_params(shapes, gen, dev, cfgd.get("mapping_lr_mul", 0.01))
    model = StyleGAN2(cfg)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            prm.copy_(p0[name])
    state = create_stylegan2_state(cfg, dev, model)
    images = make_store(tr["store_images"], cfgd["image_dim"], gen, dev)
    n_store = images.shape[0]
    draw_gen = torch.Generator(device=dev).manual_seed(ctx.sub_seed(3))
    step = sg.make_stylegan2_scan_step(cfg, state, k)
    step.prepare(state, images, 0)
    it = 0

    def next_draws(it0, n):
        with ctx.spans.span("draws"):
            return sg.stack_draws([sg.draw_iteration(draw_gen, cfg, dev, i, n_store) for i in range(it0, it0 + n)])

    def dispatch():
        nonlocal it
        draws = next_draws(it, k)
        with ctx.spans.span("dispatch"):
            out = step(state, images, draws, it)
        it += k
        return draws, out

    def load(params):  # a fresh state with these weights: zero moments and counts, the EMA a copy
        with torch.no_grad():
            for name, prm in state.model.named_parameters():
                prm.copy_(params[name])
            for opt in state.OPTS:
                adam = getattr(state, opt)
                for key in adam.count:
                    adam.count[key] = 0
                    adam.mu[key].zero_()
                    adam.nu[key].zero_()
            state.model.G.mapping.w_avg.zero_()
            state.pl_mean.zero_()
            for key, e in state.ema.items():
                e.copy_(params[key] if key in params else torch.zeros_like(e))

    # set-up's replays, each from fresh weights of the seed: the reference
    # follows the first one whole, and the first iteration of each
    pat = sg.pattern(cfg, 0, k)
    starts = []
    for r in range(tr.get("check_replays", 1)):
        weights = p0 if r == 0 else ref.init_params(shapes, gen, dev, cfgd.get("mapping_lr_mul", 0.01))
        if r:
            load(weights)
        it = 0
        with step_size(cfg, check_lr):
            draws, out = dispatch()
        each = [sg.draw_at(draws, pat, i) for i in range(k if r == 0 else 1)]
        reals = [(images[d.ids].clone(), d.flips.clone()) for d in each]
        starts.append((weights, reals[:1], [ref_draws(d) for d in each[:1]], out[0].cpu().numpy()))
        if r == 0:
            reals0, draws0, got0 = reals, [ref_draws(d) for d in each], out.cpu().numpy()
            prog = {name: prm.detach().clone() for name, prm in state.model.named_parameters()}
            prog_ema = {name: e.clone() for name, e in state.ema.items()}
    sync()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s: store {n_store} images, K = {k}, {len(prog)} parameters")

    iterations, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        dispatch()
        iterations += k
    sync()
    window_s = time.perf_counter() - t0

    readings = {"kind": "train", "setup_s": setup_s, "updates": iterations, "window_s": window_s, "batch": b,
                "config": cfgd, "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    if ctx.trace:
        n = tr.get("trace_dispatches", 1)

        def body():
            for _ in range(n):
                dispatch()
            sync()

        before = _build.launch_counts()
        trace = harness.profiled(ctx.spans, body, lead=dispatch)
        after = _build.launch_counts()
        readings.update(trace=trace, traced_updates=(n + 1) * k, idle_gaps=trace.idle_gaps(SPANS, "host"),
                        traced_launches={c: after[c] - before.get(c, 0) for c in after
                                         if c.startswith("stylegan2.")})
        period = math.lcm(cfg.g_reg_interval, cfg.d_reg_interval)
        it = -(-it // period) * period
        readings.update(span_device_ms=eager_span_ms(state, cfg, images, next_draws, it, period, sync),
                        span_iterations=1)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the check, once the program's state and store are freed
    del state, step, model, images
    if cuda:
        torch.cuda.empty_cache()
    ref.no_tf32()
    t_ref = time.perf_counter()
    chunk = tr.get("check_chunk")

    def readings_of(precision=ref.F32, fault=None):
        terms, params, ema, w_avg, norms = reference_run(cfg_check, p0, reals0, draws0, k, chunk, precision, fault)
        firsts = [terms[0]] + [reference_run(cfg_check, w, rl, dr, 1, chunk, precision, fault)[0][0]
                               for w, rl, dr, _ in starts[1:]]
        return torch.stack(firsts).cpu().numpy(), terms.cpu().numpy(), params, ema, w_avg, norms

    want, want0, ref_params, ref_ema, ref_w_avg, grad_norms = readings_of()
    got = np.stack([s[3] for s in starts])
    mask0 = ran(cfgd, k)
    first_cols = [i for i in range(len(ref.LOSSES)) if mask0[0, i]]
    nums = {**loss_gaps(got[:, FRESH], want[:, FRESH]),
            "loss_gap_all": loss_gap_all(got[:, first_cols], got0, want[:, first_cols], want0, mask0),
            **state_numbers(p0, prog, prog_ema, ref_params, ref_ema, grad_norms),
            "w_avg_gap": float(torch.linalg.vector_norm(prog_ema[sg.W_AVG] - ref_w_avg)
                               / torch.linalg.vector_norm(ref_w_avg).clamp_min(1e-30))}
    gaps0 = np.where(mask0, np.abs(got0 - want0) / np.maximum(np.abs(want0), 1e-12), 0.0).max(0)
    readings["loss_terms"] = {"names": list(ref.LOSSES), "program": got.tolist(), "reference": want.tolist(),
                              "program_replay0": got0.tolist(), "reference_replay0": want0.tolist()}
    ctx.log(f"reference: {len(starts)} first iterations and {k} iterations in {time.perf_counter() - t_ref:.3f} s; "
            f"readings {nums}; worst gap by term {dict(zip(ref.LOSSES, np.round(gaps0, 5).tolist()))}")
    if ctx.controls:  # the fp8 reference and the planted faults, each in the program's place
        for name, kw in (("control", {"precision": ref.Precision("fp8")}),
                         *((f, {"fault": f}) for f in ref.FAULTS)):
            firsts, terms0, params, ema, _, _ = readings_of(**kw)
            readings[name] = {**loss_gaps(firsts[:, FRESH], want[:, FRESH]),
                              "loss_gap_all": loss_gap_all(firsts[:, first_cols], terms0, want[:, first_cols],
                                                           want0, mask0),
                              **state_numbers(p0, params, ema, ref_params, ref_ema, grad_norms)}
            readings["loss_terms"][name] = firsts.tolist()
        readings["program"] = nums
    checks = [(name, nums[name], float(lim)) for name, lim in ctx.cell.limits.items()]
    return harness.Outcome(iterations, 0, readings, checks, peak)


def eager_span_ms(state, cfg, images, next_draws, it: int, period: int, sync) -> Dict[str, float]:
    """Device ms per ``stylegan2.*`` span of one eager iteration that runs
    both regularisation phases, under the profiler (after one unprofiled
    such iteration, which meets every first use)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from littlegan_tpu_torch.training.stylegan2 import eager_iterations

    for i in range(2):
        at = it + i * period
        draws = next_draws(at, 1)
        if i == 0:
            eager_iterations(state, cfg, images, draws, at)
            sync()
            continue
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if images.is_cuda else [])
        with profile(activities=acts) as prof:
            eager_iterations(state, cfg, images, draws, at)
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return span_device_ms(json.load(f))
    finally:
        os.remove(path)
