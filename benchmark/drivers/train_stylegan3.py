"""StyleGAN3-T training over a card-resident store, K iterations per
CUDA-graph replay.

The program's own path for ``model: stylegan3``: the image store on the
card, ``training/stylegan2.py::make_stylegan2_scan_step`` (K iterations of
Gmain, Dmain and the lazy Dreg captured in one graph by
``training/dispatch.py::GraphedUpdates``) called back to back, closed loop.
Traffic parameters as ``drivers/train_stylegan2.py``'s: ``k`` (16, one
lazy period: Dreg on 1), ``store_images``, ``trace_dispatches``,
``check_replays``, ``check_chunk`` (the samples the float32 reference takes
at a time: one minibatch-stddev group) and ``check_lr``: the step size of
G's Adam in the checked replays, D's scaled by the same factor.

Each iteration's draws come from a generator on the card seeded from the
seed: the real ids (uniform over the store), x-flips and each G pass's z
(``training/stylegan2.py::draw_iteration``). ``train_images_per_s`` counts
the real and the generated batch, 2 x 32 images an iteration.

Set-up builds the state from the seed's weights and buffers (the input's
frequencies and phases, every ``magnitude_ema`` 1, ``w_avg`` 0), captures
the graph and runs ``check_replays`` replays, each from fresh weights of
the seed; then the window runs replays, each waited for, until
``--seconds`` have passed (a replay of ~20 s: one queued behind another
would stretch the window, and the run, by a replay or two). With
``--trace 1`` the window runs under the profiler, at least
``trace_dispatches`` replays and none before them (the device idles only
while the first replay's draws are launched): the traced replays are the
window that ``step_mfu.stylegan3`` reads, the profiler's cost included
(~0.5%), so that a traced run, the check included, stays well inside the
benchmark's time for a run.

Once the program's state and store are freed, the plain float32 reference
(``benchmark/reference/stylegan3.py``) works out again, from the same
weights, buffers, images and draws, the numbers of
``drivers/train_stylegan2.py`` (``loss_gap_first`` over Gmain's loss and
Dmain's real term, ``loss_gap_all``, ``change_gap``, ``change_dir_gap``,
``change_dir_gap_d``, ``w_avg_gap``) and ``magnitude_gap``: the largest
gap of a layer's ``magnitude_ema`` after the first replay, over its move
from 1 in the reference. With ``ctx.controls`` the same numbers of the
float8 reference (``control``) and of the planted faults
(``reference.stylegan3.FAULTS``) in the program's place.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np

from benchmark import harness
from benchmark.drivers.train_graph import loss_gaps, port_config
from benchmark.drivers.train_stylegan2 import loss_gap_all, make_store, real_images, state_numbers
from benchmark.reference import stylegan2 as ref2
from benchmark.reference import stylegan3 as ref

FRESH = [ref.LOSSES.index(n) for n in ("g_main", "d_real")]
SPANS = ("dispatch", "draws")
MODEL = "stylegan3"


def ref_draws(d) -> dict:
    return {"g_main": {"z": d.g_main.z}, "d_main": {"z": d.d_main.z}}


def reference_run(cfgd: dict, p0, buf0, reals, draws: List, k: int, chunk=None, precision=ref.F32, fault=None):
    """The reference's ``k`` iterations from ``p0`` and ``buf0``: ((k, 6)
    terms, final parameters, final EMA, final buffers, each leaf's first
    gradient norm)."""
    import torch

    model, hp = ref.Model.from_config(cfgd, precision, fault), ref.Hyper.from_config(cfgd)
    p = ref2.leaves(p0)
    opts, run, norms = ref.adams(p, hp), ref.new_run(p, buf0), {}
    terms = []
    for i in range(k):
        x = real_images(*reals[i])
        terms.append(ref.iteration(model, p, opts, run, x, draws[i], i, hp, chunk,
                                   grad_norms=norms if i == 0 else None))
    return torch.stack(terms), {key: v.detach() for key, v in p.items()}, run.ema, run.buf, norms


def ran(cfgd: dict, k: int) -> np.ndarray:
    """(k, 6) bool: which terms iterations 0..k-1 compute."""
    hp = ref.Hyper.from_config(cfgd)
    out = np.ones((k, len(ref.LOSSES)), bool)
    out[:, ref.LOSSES.index("pl_penalty")] = False
    out[:, ref.LOSSES.index("pl_mean")] = False
    for i in range(k):
        out[i, ref.LOSSES.index("r1_penalty")] = hp.runs(i)[1]
    return out


def magnitude_gap(prog: Dict[str, float], want: Dict[str, float]) -> float:
    return max(abs(prog[k] - want[k]) / max(abs(want[k] - 1.0), 1e-12) for k in want)


@contextlib.contextmanager
def step_sizes(cfg, lr):
    """``cfg.lr`` set to ``lr`` and ``cfg.d_lr`` scaled by the same factor
    inside (None: left as they are)."""
    saved = cfg.lr, cfg.d_lr
    if lr is not None:
        cfg.lr, cfg.d_lr = lr, cfg.d_lr * lr / saved[0]
    try:
        yield
    finally:
        cfg.lr, cfg.d_lr = saved


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from littlegan_tpu_torch.models.stylegan3 import StyleGAN3
    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.training import stylegan2 as sg
    from littlegan_tpu_torch.training.state import create_stylegan2_state

    cfgd, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    check_lr = tr.get("check_lr")
    scale = 1.0 if check_lr is None else check_lr / cfgd["lr"]
    cfg_check = {**cfgd, "lr": cfgd["lr"] * scale, "d_lr": cfgd["d_lr"] * scale}
    cfg = port_config(cfgd, device_data=True, steps_per_dispatch=tr["k"])
    k, b = tr["k"], cfgd["batch_size"]
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    # weights, buffers and dataset from the seed, on the card
    gen = torch.Generator(device=dev).manual_seed(ctx.sub_seed(1))
    rmodel = ref.Model.from_config(cfgd)
    p0, buf0 = ref.init_params(rmodel, gen, dev)
    model = StyleGAN3(cfg).to(dev)
    buffers = dict(model.named_buffers())

    def put(params, bufs):
        with torch.no_grad():
            for name, prm in model.named_parameters():
                prm.copy_(params[name])
            for name, t in bufs.items():
                buffers[name].copy_(t)

    put(p0, buf0)
    state = create_stylegan2_state(cfg, dev, model)
    images = make_store(tr["store_images"], cfgd["image_dim"], gen, dev)
    n_store = images.shape[0]
    draw_gen = torch.Generator(device=dev).manual_seed(ctx.sub_seed(3))
    step = sg.make_stylegan2_scan_step(cfg, state, k)
    step.prepare(state, images, 0)
    ctx.log(f"captured {time.perf_counter() - ctx.t_start:.3f} s after the start")
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

    def load(params, bufs):  # a fresh state: zero moments and counts, the EMA a copy
        put(params, bufs)
        with torch.no_grad():
            for opt in state.OPTS:
                adam = getattr(state, opt)
                for key in adam.count:
                    adam.count[key] = 0
                    adam.mu[key].zero_()
                    adam.nu[key].zero_()
            state.pl_mean.zero_()
            for key, e in state.ema.items():
                e.copy_(params[key] if key in params else bufs[key])

    pat = sg.pattern(cfg, 0, k)
    starts = []
    for r in range(tr.get("check_replays", 1)):
        weights = (p0, buf0) if r == 0 else ref.init_params(rmodel, gen, dev)
        if r:
            load(*weights)
        it = 0
        with step_sizes(cfg, None if check_lr is None else cfg.lr * scale):
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

    def window(at_least: int = 0):
        """Replays, each waited for (one takes ~20 s: none queued behind
        the one that crosses ``--seconds``), until ``--seconds`` have
        passed and ``at_least`` have run: (iterations, seconds)."""
        done, t0 = 0, time.perf_counter()
        while done < at_least * k or time.perf_counter() - t0 < ctx.seconds:
            dispatch()
            sync()
            done += k
        return done, time.perf_counter() - t0

    readings = {"kind": "train", "setup_s": setup_s, "batch": b, "config": cfgd,
                "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    t_window = time.perf_counter()
    if ctx.trace:  # the traced replays are the window
        timed = {}
        before = _build.launch_counts()
        trace = harness.profiled(ctx.spans, lambda: timed.update(w=window(tr.get("trace_dispatches", 1))))
        after = _build.launch_counts()
        iterations, window_s = timed["w"]
        readings.update(trace=trace, traced_updates=iterations, idle_gaps=trace.idle_gaps(SPANS, "host"),
                        traced_launches={c: after[c] - before.get(c, 0) for c in after if c.startswith(MODEL + ".")})
    else:
        iterations, window_s = window()
    readings.update(updates=iterations, window_s=window_s)
    ctx.log(f"window {window_s:.3f} s: {iterations} iterations; {time.perf_counter() - t_window:.3f} s with the trace")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the check, once the program's state and store are freed
    del state, step, model, images, buffers
    if cuda:
        torch.cuda.empty_cache()
    ref.no_tf32()
    t_ref = time.perf_counter()
    chunk = tr.get("check_chunk")

    def readings_of(precision=ref.F32, fault=None):
        terms, params, ema, bufs, norms = reference_run(cfg_check, p0, buf0, reals0, draws0, k, chunk, precision,
                                                        fault)
        firsts = [terms[0]] + [reference_run(cfg_check, *w, rl, dr, 1, chunk, precision, fault)[0][0]
                               for w, rl, dr, _ in starts[1:]]
        return torch.stack(firsts).cpu().numpy(), terms.cpu().numpy(), params, ema, bufs, norms

    want, want0, ref_params, ref_ema, ref_bufs, grad_norms = readings_of()
    got = np.stack([s[3] for s in starts])
    mask0 = ran(cfgd, k)
    first_cols = [i for i in range(len(ref.LOSSES)) if mask0[0, i]]
    mags = [key for key in ref_bufs if key.endswith("magnitude_ema")]
    ref_mag = {key: float(ref_bufs[key]) for key in mags}
    nums = {**loss_gaps(got[:, FRESH], want[:, FRESH]),
            "loss_gap_all": loss_gap_all(got[:, first_cols], got0, want[:, first_cols], want0, mask0),
            **state_numbers(p0, prog, prog_ema, ref_params, ref_ema, grad_norms),
            "w_avg_gap": float(torch.linalg.vector_norm(prog_ema[sg.W_AVG] - ref_bufs[sg.W_AVG])
                               / torch.linalg.vector_norm(ref_bufs[sg.W_AVG]).clamp_min(1e-30)),
            "magnitude_gap": magnitude_gap({key: float(prog_ema[key]) for key in mags}, ref_mag)}
    gaps0 = np.where(mask0, np.abs(got0 - want0) / np.maximum(np.abs(want0), 1e-12), 0.0).max(0)
    readings["loss_terms"] = {"names": list(ref.LOSSES), "program": got.tolist(), "reference": want.tolist(),
                              "program_replay0": got0.tolist(), "reference_replay0": want0.tolist()}
    ctx.log(f"reference: {len(starts)} first iterations and {k} iterations in {time.perf_counter() - t_ref:.3f} s; "
            f"readings {nums}; worst gap by term {dict(zip(ref.LOSSES, np.round(gaps0, 5).tolist()))}")
    if ctx.controls:  # the fp8 reference and the planted faults, each in the program's place
        for name, kw in (("control", {"precision": ref.Precision("fp8")}),
                         *((f, {"fault": f}) for f in ref.FAULTS)):
            firsts, terms0, params, ema, bufs, _ = readings_of(**kw)
            readings[name] = {**loss_gaps(firsts[:, FRESH], want[:, FRESH]),
                              "loss_gap_all": loss_gap_all(firsts[:, first_cols], terms0, want[:, first_cols],
                                                           want0, mask0),
                              **state_numbers(p0, params, ema, ref_params, ref_ema, grad_norms),
                              "magnitude_gap": magnitude_gap({key: float(bufs[key]) for key in mags}, ref_mag)}
            readings["loss_terms"][name] = firsts.tolist()
            ctx.log(f"{name}: {readings[name]}")
        readings["program"] = nums
    checks = [(name, nums[name], float(lim)) for name, lim in ctx.cell.limits.items()]
    return harness.Outcome(iterations, 0, readings, checks, peak)

