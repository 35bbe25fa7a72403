"""StarGAN v2 training over a card-resident store, K iterations per
CUDA-graph replay.

The program's own path for ``model: stargan_v2``: the domain store on the
card, ``training/stargan_v2.py::make_stargan_scan_step`` (K iterations of
the four optimizer phases captured in one graph by
``training/dispatch.py::GraphedUpdates``) called back to back, closed loop.
Traffic parameters:

- ``k``: iterations per replay; ``store_images`` images made on the card
  from the seed, labelled by ``domain_counts`` (domain 0 first);
- ``trace_dispatches``: replays in the traced window with ``--trace 1``
  (one more, traced before it, fills the queue); ``check_replays``: the
  replays set-up runs and the check compares; ``check_lr``: the step size
  of G's, E's and D's Adams in those replays (F keeps ``f_lr``).

Each iteration takes 3B ids from ``data/domains.py::BalancedSampler`` on a
numpy stream from the seed (B sources, B references, B second references
of the same domains), and fresh draws (z, z2, crop boxes, flips) from a
generator on the card. Iterations are numbered from 0 (lambda_ds's decay)
in each checked replay, and run on from there in the window. The readings
count an iteration as an update of ``batch`` = B: ``train_images_per_s``
then counts the source and the reference batch, the two batches
gradients flow from.

Set-up builds the state from the seed's weights, captures the graph and
runs ``check_replays`` replays of that graph, each from fresh weights of
the seed (zero moments and counts, the EMA a copy); then the window runs
replays until ``--seconds`` have passed and a synchronize closes it. With
``--trace 1`` the traced replays are followed by one eager iteration under
the profiler, whose ``littlegan:stargan_v2.*`` spans give the device ms of
the kernels launched inside them (``span_device_ms``: by the launch's
time, since the backward's kernels are launched from autograd's own
thread).

The checked replays step with ``check_lr`` in place of ``lr`` (the step
sizes travel in the graph's input rows, so it is the same graph). With
beta_1 0 every Adam step moves each element by about its step size in the
sign of its gradient, and the published lr, 1e-4, moves D so far in one
step that the terms after it follow the sign of gradients near zero: the
bf16 program and the float32 reference part there by up to 60%, and after
8 iterations their changes differ in direction as much as the float8
control's do (PERF.md §6). At ``check_lr`` the weights stay near their
start and every term and change is held. Once the program's state is
freed, the plain float32 reference (``benchmark/reference/stargan_v2.py``)
works out again, at the same step sizes, from the same weights, ids,
draws and iteration numbers:

- ``loss_gap_first``: of the 14 loss terms of each checked replay's first
  iteration, the six computed before any Adam step touched the weights
  they read (``FRESH``: D latent-guided's three, and G latent-guided's
  style, diversity and cycle terms), the worst gap relative to the
  reference's value (as in ``drivers/train_graph.py``);
- ``loss_gap_all``: the same over every term the checked replays
  computed: the first replay's K iterations whole, the first iteration of
  the others (all kept in the readings, ``loss_terms``);
- ``change_gap``: the reference follows the first replay's K iterations
  whole; per parameter of the four networks, and per leaf of the EMA of G,
  F and E, the gap between the norms of the program's and the reference's
  change from the start (``drivers/train_graph.py``'s ``change_numbers``,
  over the parameters and over the EMA apart; leaves whose first gradient
  in the reference is under a thousandth of the median leaf's, the biases
  ahead of an instance norm, are left out);
- ``change_dir_gap``: the same changes' direction. Per network (D, G, F,
  E) and per EMA (of G, F, E), over its live leaves together, the norm of
  the program's change less the reference's, over the norm of the
  reference's; the largest of the seven. A sign-led step's norm barely
  depends on the gradient; its direction does. A state left unchanged
  reads 1. ``change_dir_gap_d``: D's alone, held apart because bf16 turns
  D's step signs far less than G's (PERF.md §6), so a fault in a D phase
  shows there first.

With ``ctx.controls`` (``benchmark/calibrate.py limits``) the same numbers
of the float8 reference (``control``) and of the planted faults
(``reference.stargan_v2.FAULTS``) in the program's place.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List

import numpy as np

from benchmark import harness
from benchmark.drivers.train_graph import change_numbers, loss_gaps, port_config
from benchmark.reference import stargan_v2 as ref

# the loss terms of an iteration computed before any Adam step touched the weights they read
FRESH = [ref.LOSSES.index(n) for n in ("d_latent.real", "d_latent.fake", "d_latent.reg", "g_latent.sty",
                                       "g_latent.ds", "g_latent.cyc")]
SPANS = ("dispatch", "draws", "id write")  # the host spans a device idle gap is named by, most specific first
SPAN_PREFIX = "littlegan:"
COUNTERS = ("stargan_v2.generator", "stargan_v2.style_encoder", "stargan_v2.mapping", "stargan_v2.discriminator",
            "stargan_v2.r1")


def make_store(counts: List[int], d: int, gen, device):
    """(images (N, d, d, 3) uint8, labels (N,) int64) on the card; the labels as numpy too."""
    import torch

    n = sum(counts)
    images = torch.empty((n, d, d, 3), dtype=torch.uint8, device=device)
    step = max(1, (1 << 30) // (d * d * 3))
    for i in range(0, n, step):
        images[i:i + step].random_(0, 256, generator=gen)
    labels = np.repeat(np.arange(len(counts)), counts).astype(np.int64)
    return images, torch.from_numpy(labels).to(device), labels


def span_device_ms(trace: dict) -> Dict[str, float]:
    """Device ms of the kernels launched inside each ``littlegan:stargan_v2.*``
    span of a Chrome trace: the launches (runtime calls, by correlation id)
    whose start lies in the span, on any thread."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"][len(SPAN_PREFIX):]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(SPAN_PREFIX + "stargan_v2.")]
    launch = {e["args"]["correlation"]: e["ts"] for e in events if e.get("ph") == "X"
              and e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    device = [(launch.get(e["args"].get("correlation")), e.get("dur", 0)) for e in events
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "args" in e]
    out: Dict[str, float] = {}
    for a, b, name in spans:
        us = sum(dur for t, dur in device if t is not None and a <= t <= b)
        out[name] = out.get(name, 0.0) + us / 1e3
    return out


def reference_run(cfgd: dict, p0, images, labels, ids, draws, k: int, precision=ref.F32, fault=None):
    """The reference's ``k`` iterations from ``p0`` (iterations 0..k-1):
    ((k, 14) loss terms, final parameters, final EMA, each leaf's first
    gradient norm)."""
    import torch

    model, hp = ref.Model.from_config(cfgd, precision), ref.Hyper.from_config(cfgd)
    p = ref.leaves(p0)
    opts, ema, norms = ref.adams(p, hp), ref.new_ema(p), {}
    losses = []
    for i in range(k):
        batch = ref.take(images, labels, torch.as_tensor(ids[i], device=images.device), draws.boxes[i],
                         draws.flips[i], cfgd["batch_size"])
        losses.append(ref.iteration(model, p, opts, ema, batch, {"z": draws.z[i], "z2": draws.z2[i]}, i, hp,
                                    fault=fault, grad_norms=norms if i == 0 else None))
    return torch.stack(losses), {key: v.detach() for key, v in p.items()}, ema, norms


def direction_numbers(p0, prog, ref_params, ref_grad_norms: Dict[str, float]) -> Dict[str, float]:
    """``change_dir_gap``: per group of leaves (the first part of the name:
    a network, or ``ema.<network>``), over its leaves whose first gradient
    is at least a thousandth of the median leaf's,
    ``|prog - p0 - (ref - p0)| / |ref - p0|``; the largest group's, and each."""
    import torch

    med_g = float(np.median(list(ref_grad_norms.values())))
    sq: Dict[str, List[float]] = {}
    for k, g in ref_grad_norms.items():
        if g < 1e-3 * med_g:
            continue
        dr = (ref_params[k] - p0[k]).double()
        parts = k.split(".")
        acc = sq.setdefault(".".join(parts[:2] if parts[0] == "ema" else parts[:1]), [0.0, 0.0])
        acc[0] += float(torch.linalg.vector_norm((prog[k] - p0[k]).double() - dr)) ** 2
        acc[1] += float(torch.linalg.vector_norm(dr)) ** 2
    gaps = {f"change_dir_gap.{n}": (a / max(b, 1e-300)) ** 0.5 for n, (a, b) in sq.items()}
    return {"change_dir_gap": max(gaps.values()), **gaps}


def state_numbers(p0, prog, prog_ema, ref_params, ref_ema, grad_norms) -> Dict[str, float]:
    """``change_gap`` (the parameters' and the EMA's, the larger),
    ``change_dir_gap`` and ``change_dir_gap_d`` of a run's state after the
    first replay against the float32 reference's."""
    ema = {f"ema.{k}": v for k, v in ref_ema.items()}
    prog_e = {f"ema.{k}": v for k, v in prog_ema.items()}
    p0_e = {**p0, **{f"ema.{k}": p0[k] for k in ref_ema}}
    norms_e = {f"ema.{k}": grad_norms[k] for k in ref_ema}
    params = change_numbers(p0, prog, ref_params, grad_norms)
    of_ema = change_numbers(p0_e, prog_e, ema, norms_e)
    direction = direction_numbers(p0_e, {**prog, **prog_e}, {**ref_params, **ema}, {**grad_norms, **norms_e})
    return {**params, "change_gap": max(params["change_gap"], of_ema["change_gap"]),
            "change_gap_params": params["change_gap"], "change_gap_ema": of_ema["change_gap"], **direction,
            "change_dir_gap_d": direction["change_dir_gap.discriminator"]}


def loss_gap_all(got_first, got0, want_first, want0) -> float:
    """The worst relative gap of the loss terms: the first replay's (K, 14)
    ``got0`` whole, and each other replay's first iteration (rows 1 on of
    the (replays, 14) ``got_first``)."""
    got, want = np.concatenate([got0, got_first[1:]]), np.concatenate([want0, want_first[1:]])
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-12)).max())


@contextlib.contextmanager
def step_size(cfg, lr: float):
    """``cfg.lr`` set to ``lr`` inside: the scan step works out each call's
    Adam step sizes from it on the host."""
    saved, cfg.lr = cfg.lr, lr
    try:
        yield
    finally:
        cfg.lr = saved


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from littlegan_tpu_torch.data.domains import BalancedSampler
    from littlegan_tpu_torch.models.stargan_v2 import StarGANv2
    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.training import stargan_v2 as sg
    from littlegan_tpu_torch.training.state import create_stargan_state

    cfgd, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cfg_check = {**cfgd, "lr": tr["check_lr"]}
    cfg = port_config(cfgd, device_data=True, steps_per_dispatch=tr["k"])
    k, b = tr["k"], cfgd["batch_size"]
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    # weights and dataset from the seed, on the card
    gen = torch.Generator(device=dev).manual_seed(ctx.sub_seed(1))
    shapes = ref.Model.from_config(cfgd).shapes()
    p0 = ref.init_params(shapes, gen, dev)
    model = StarGANv2(cfg)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            prm.copy_(p0[name])
    state = create_stargan_state(cfg, dev, model)
    images, labels, labels_np = make_store(tr["domain_counts"], cfgd["image_dim"], gen, dev)
    sampler = BalancedSampler(labels_np, len(tr["domain_counts"]))
    rng = np.random.default_rng(ctx.sub_seed(2))
    draw_gen = torch.Generator(device=dev).manual_seed(ctx.sub_seed(3))
    step = sg.make_stargan_scan_step(cfg, state, k)
    step.prepare(state, images, labels)
    it = 0

    def next_inputs(n):
        with ctx.spans.span("id write"):
            ids = np.stack([sampler.draw(rng, b) for _ in range(n)])
        with ctx.spans.span("draws"):
            draws = sg.stack_draws([sg.draw_iteration(draw_gen, cfg, dev) for _ in range(n)])
        return ids, draws

    def dispatch():
        nonlocal it
        ids, draws = next_inputs(k)
        with ctx.spans.span("dispatch"):
            out = step(state, images, labels, ids, draws, it)
        it += k
        return ids, draws, out

    def load(params):  # the state as a fresh one with these weights: zero moments and counts, the EMA a copy
        with torch.no_grad():
            for name, prm in state.model.named_parameters():
                prm.copy_(params[name])
            for opt in state.OPTS:
                adam = getattr(state, opt)
                for key in adam.count:
                    adam.count[key] = 0
                    adam.mu[key].zero_()
                    adam.nu[key].zero_()
            for key, e in state.ema.items():
                e.copy_(params[key])

    # set-up's replays, each from fresh weights of the seed: the reference
    # follows the first one whole, and the first iteration of each
    starts = []
    for r in range(tr.get("check_replays", 1)):
        weights = p0 if r == 0 else ref.init_params(shapes, gen, dev)
        if r:
            load(weights)
        it = 0
        with step_size(cfg, cfg_check["lr"]):
            ids, draws, out = dispatch()
        starts.append((weights, ids[:1], sg.StarGANDraws(*(x[:1].clone() for x in draws)), out[0].cpu().numpy()))
        if r == 0:
            ids0, draws0, got0 = ids, draws, out.cpu().numpy()
            prog = {name: prm.detach().clone() for name, prm in state.model.named_parameters()}
            prog_ema = {name: e.clone() for name, e in state.ema.items()}
    sync()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s: store {images.shape[0]} images, K = {k}, {len(prog)} parameters")

    iterations, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        dispatch()
        iterations += k
    sync()
    window_s = time.perf_counter() - t0

    readings = {"kind": "train", "setup_s": setup_s, "updates": iterations, "window_s": window_s, "batch": b,
                "config": cfgd, "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    if ctx.trace:
        n = tr.get("trace_dispatches", 2)

        def body():
            for _ in range(n):
                dispatch()
            sync()

        before = _build.launch_counts()
        trace = harness.profiled(ctx.spans, body, lead=dispatch)
        after = _build.launch_counts()
        readings.update(trace=trace, traced_updates=(n + 1) * k, idle_gaps=trace.idle_gaps(SPANS, "host"),
                        traced_launches={c: after.get(c, 0) - before.get(c, 0) for c in COUNTERS})
        readings.update(span_device_ms=eager_span_ms(state, cfg, images, labels, next_inputs, it, sync),
                        span_iterations=1)
        it += 2
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the check, once the program's state is freed
    del state, step, model
    if cuda:
        torch.cuda.empty_cache()
    ref.no_tf32()
    t_ref = time.perf_counter()

    def readings_of(precision=ref.F32, fault=None):
        losses, params, ema, norms = reference_run(cfg_check, p0, images, labels, ids0, draws0, k, precision, fault)
        firsts = [losses[0]] + [reference_run(cfg_check, w, images, labels, i, d, 1, precision, fault)[0][0]
                                for w, i, d, _ in starts[1:]]
        return torch.stack(firsts).cpu().numpy(), losses.cpu().numpy(), params, ema, norms

    want, want0, ref_params, ref_ema, grad_norms = readings_of()
    got = np.stack([s[3] for s in starts])
    nums = {**loss_gaps(got[:, FRESH], want[:, FRESH]), "loss_gap_all": loss_gap_all(got, got0, want, want0),
            **state_numbers(p0, prog, prog_ema, ref_params, ref_ema, grad_norms)}
    term_gaps = (np.abs(got0 - want0) / np.maximum(np.abs(want0), 1e-12)).max(0)
    readings["loss_terms"] = {"names": list(ref.LOSSES), "program": got.tolist(), "reference": want.tolist(),
                              "program_replay0": got0.tolist(), "reference_replay0": want0.tolist()}
    ctx.log(f"reference: {len(starts)} first iterations and {k} iterations in {time.perf_counter() - t_ref:.3f} s; "
            f"readings {nums}; worst gap by term {dict(zip(ref.LOSSES, np.round(term_gaps, 5).tolist()))}")
    if ctx.controls:  # the fp8 reference and the planted faults, each in the program's place
        for name, kw in (("control", {"precision": ref.Precision("fp8")}),
                         *((f, {"fault": f}) for f in ref.FAULTS)):
            firsts, losses0, params, ema, _ = readings_of(**kw)
            readings[name] = {**loss_gaps(firsts[:, FRESH], want[:, FRESH]),
                              "loss_gap_all": loss_gap_all(firsts, losses0, want, want0),
                              **state_numbers(p0, params, ema, ref_params, ref_ema, grad_norms)}
            readings["loss_terms"][name] = firsts.tolist()
        readings["program"] = nums
    checks = [(name, nums[name], float(lim)) for name, lim in ctx.cell.limits.items()]
    return harness.Outcome(iterations, 0, readings, checks, peak)


def eager_span_ms(state, cfg, images, labels, next_inputs, it: int, sync) -> Dict[str, float]:
    """Device ms per ``stargan_v2.*`` span of one eager iteration under the
    profiler (after one unprofiled, which meets every first use)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from littlegan_tpu_torch.training.stargan_v2 import eager_iterations

    for i in range(2):
        ids, draws = next_inputs(1)
        if i == 0:
            eager_iterations(state, cfg, images, labels, ids, draws, it)
            sync()
            continue
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if images.is_cuda else [])
        with profile(activities=acts) as prof:
            eager_iterations(state, cfg, images, labels, ids, draws, it + 1)
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return span_device_ms(json.load(f))
    finally:
        os.remove(path)
