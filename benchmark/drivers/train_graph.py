"""Training over the card-resident dataset, K updates per CUDA-graph replay.

The program's own path for ``device_data`` training: a uint8 store of
batches on the card, ``training/step.py::make_scan_train_step`` (K
updates captured in one graph by ``training/dispatch.py::GraphedUpdates``)
called back to back, closed loop. Traffic parameters:

- ``k``: updates per replay; ``store_images``: the dataset's images, held
  as ``store_images // batch_size`` batches made on the card from the seed;
- ``trace_dispatches``: replays in the traced window after the window with
  ``--trace 1`` (one more replay, traced before it, fills the queue).

Batch ids walk a permutation of the store drawn from the seed, a new one
each time the last is used up (epoch after epoch); each update takes the
next two batches. Each replay gets fresh noise and augmentation draws from
a generator on the card, drawn per update and stacked as the Trainer
draws them. Batch numbers run on from 1 across the run.

Set-up builds one train state from the seed's weights, captures the
graph and runs ``check_replays`` replays (the first steps the check
compares), each from fresh weights drawn from the seed, written into the
same state with zero moments and counts; then the window runs replays
until ``--seconds`` have passed and a synchronize closes it. Once the
window has closed and the program's state is freed, the plain float32
reference works out again, from the same weights, batches, draws and batch
numbers:

- ``loss_gap_first``: the three losses of each checked replay's first
  update, the worst gap relative to the reference's value. Only first
  updates from fresh weights are compared: later losses part ways by the
  sign of Adam's first steps on gradients near zero, in any precision, and
  a trained state's losses swing with saturated predictions.
- ``change_gap``: the reference follows the first replay's K updates
  whole; per parameter, the gap between the norms of the program's and
  the reference's change, relative to the reference's norm or the median
  parameter's, whichever is larger, the worst parameter. Parameters
  whose first gradient in the reference is under a thousandth of the
  median parameter's (norm gammas ahead of a scale-invariant block) are
  left out.

``limits/<cell>.json`` names the numbers compared and their limits.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np

from benchmark import harness
from benchmark.reference import littlegan as ref

# the host spans a device idle gap is named by, most specific first
SPANS = ("dispatch", "draws", "id write")


class IdWalk:
    """Batch ids of a store of ``n`` batches: permutations from ``rng``, one
    after the other."""

    def __init__(self, n: int, rng: np.random.Generator):
        self.n, self.rng = n, rng
        self.perm, self.pos = rng.permutation(n), 0

    def take(self, count: int) -> np.ndarray:
        out = []
        while count:
            if self.pos == self.n:
                self.perm, self.pos = self.rng.permutation(self.n), 0
            k = min(count, self.n - self.pos)
            out.append(self.perm[self.pos:self.pos + k])
            self.pos += k
            count -= k
        return np.concatenate(out)


def port_config(cfg: dict, **overrides):
    """The program's ``Config`` of a configuration file."""
    import dataclasses

    from littlegan_tpu_torch.config import Config

    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in cfg.items() if k in names}).replace(**overrides)


def make_store(n: int, cfg: dict, gen, device):
    """(images (n, B, H, W, C) uint8, conds (n, B, c) f32 soft +-1) on the card."""
    import torch

    b, d, c = cfg["batch_size"], cfg["image_dim"], cfg.get("image_channel", 3)
    images = torch.empty((n, b, d, d, c), dtype=torch.uint8, device=device)
    step = max(1, (1 << 30) // (b * d * d * c))
    for i in range(0, n, step):
        images[i:i + step].random_(0, 256, generator=gen)
    bits = torch.rand((n, b, len(cfg["attr"])), generator=gen, device=device) < 0.5
    conds = torch.where(bits, ref.soft(1.0), ref.soft(-1.0)).float()
    return images, conds


LOSSES = ("gen", "disc", "adj")


def draws_at(draws, i: int) -> dict:
    """Update ``i``'s draws of the program's stacked ``StepDraws``, as the reference takes them."""
    a = draws.augment
    return {"noise": draws.noise[i], "flip": a.flip[i], "delta_b": a.delta_b[i], "factor": a.factor[i],
            "delta_h": a.delta_h[i], "aug_noise": a.noise[i]}


def first_losses(cfg: dict, starts: List[tuple], precision=ref.F32, half_batch=False) -> np.ndarray:
    """(replays, 3) losses of each checked replay's first update, computed by
    the reference from the parameters the replay started from."""
    import torch

    model, hp = ref.Model.from_config(cfg, precision), ref.Hyper.from_config(cfg)
    out = []
    with torch.no_grad():
        for params, batch, draws, _ in starts:
            loss = ref.losses(model, params, *batch, draws, hp, half_batch)
            out.append([float(loss[n]) for n in LOSSES])
    return np.array(out)


def loss_gaps(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    gaps = np.abs(got - want) / np.maximum(np.abs(want), 1e-12)
    return {"loss_gap_first": float(gaps.max()), "loss_gap_replay0": float(gaps[0].max())}


def change_numbers(p0, prog, ref_params, ref_grad_norms: Dict[str, float]) -> Dict[str, float]:
    """The numbers of the parameters' change over the first replay."""
    import torch

    med_g = float(np.median(list(ref_grad_norms.values())))
    keep = [k for k, g in ref_grad_norms.items() if g >= 1e-3 * med_g]
    dp = {k: float(torch.linalg.vector_norm((prog[k] - p0[k]).double())) for k in keep}
    dr = {k: float(torch.linalg.vector_norm((ref_params[k] - p0[k]).double())) for k in keep}
    med_r = float(np.median(list(dr.values())))
    change = {k: abs(dp[k] - dr[k]) / max(dr[k], med_r, 1e-30) for k in keep}
    tot_p, tot_r = math.sqrt(sum(v * v for v in dp.values())), math.sqrt(sum(v * v for v in dr.values()))
    return {"change_gap": max(change.values()), "change_gap_median": float(np.median(list(change.values()))),
            "change_gap_total": abs(tot_p - tot_r) / tot_r, "leaves_compared": float(len(keep))}


def follow(cfg: dict, p0, batches, draws, batch_no0: int, k: int, precision=ref.F32, half_batch=False):
    """The reference's K updates from ``p0``: (final parameters, each
    parameter's first-gradient norm)."""
    import torch

    model = ref.Model.from_config(cfg, precision)
    hp = ref.Hyper.from_config(cfg)
    p = {key: v.clone() for key, v in p0.items()}
    adam = ref.Adam(p)
    grad_norms = {}
    for i in range(k):
        batch = tuple(t[i] for t in batches)
        _, grads = ref.train_update(model, p, adam, batch, draws_at(draws, i), batch_no0 + i, hp, half_batch)
        if i == 0:
            grad_norms = {key: float(torch.linalg.vector_norm(g.double())) for key, g in grads.items()}
    return p, grad_norms


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from littlegan_tpu_torch.compat.jax_params import params_from_jax
    from littlegan_tpu_torch.models.littlegan import LittleGAN
    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import draw_step, make_scan_train_step, stack_draws

    cfgd, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cfg = port_config(cfgd, device_data=True, steps_per_dispatch=tr["k"])
    k, b = tr["k"], cfgd["batch_size"]
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    # weights and dataset from the seed, on the card
    gen = torch.Generator(device=dev).manual_seed(ctx.sub_seed(1))
    shapes = ref.Model.from_config(cfgd).shapes()
    p0 = ref.init_params(shapes, gen, dev)
    model = params_from_jax({key: v.cpu().numpy() for key, v in p0.items()}, LittleGAN(cfg))
    state = create_train_state(cfg, dev, model)
    n_store = tr["store_images"] // b
    images, conds = make_store(n_store, cfgd, gen, dev)
    walk = IdWalk(n_store, np.random.default_rng(ctx.sub_seed(2)))
    draw_gen = torch.Generator(device=dev).manual_seed(ctx.sub_seed(3))
    step = make_scan_train_step(cfg, state, k)
    step.prepare(state, images, conds)
    batch_no = 1

    def dispatch():
        nonlocal batch_no
        with ctx.spans.span("id write"):
            ids = walk.take(2 * k)
        with ctx.spans.span("draws"):
            draws = stack_draws([draw_step(draw_gen, cfg, b, dev) for _ in range(k)])
        with ctx.spans.span("dispatch"):
            out = step(state, images, conds, ids[0::2], ids[1::2], draws, batch_no)
        batch_no += k
        return ids, draws, out

    def load(params):  # the state as a fresh one with these weights: zero moments and counts
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(params[n.replace(".", "/")])
            for opt in (state.opt_g, state.opt_d, state.opt_a):
                for key in opt.count:
                    opt.count[key] = 0
                    opt.mu[key].zero_()
                    opt.nu[key].zero_()

    # set-up's replays, each from fresh weights of the seed: the reference
    # follows the first one whole, and the first update of each
    starts = []
    for r in range(tr.get("check_replays", 1)):
        weights = p0 if r == 0 else ref.init_params(shapes, gen, dev)
        if r:
            load(weights)
        batch_no = 1
        ids, draws, out = dispatch()
        got = torch.stack([out.metrics["loss/" + n] for n in LOSSES], 1)[0].cpu().numpy()
        starts.append((weights, ids[:2], {key: v.clone() for key, v in draws_at(draws, 0).items()}, got))
        if r == 0:
            ids0, draws0 = ids, draws
            prog = {n.replace(".", "/"): p.detach().clone() for n, p in state.model.named_parameters()}
    sync()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s: store {n_store} batches, K = {k}, {len(prog)} parameters")

    updates, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        dispatch()
        updates += k
    sync()
    window_s = time.perf_counter() - t0

    readings = {"kind": "train", "setup_s": setup_s, "updates": updates, "window_s": window_s, "batch": b,
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
        # the device time and launches of every traced replay, the lead's too; idle time in the window only
        readings.update(trace=trace, traced_updates=(n + 1) * k, idle_gaps=trace.idle_gaps(SPANS, "host"),
                        traced_launches={name: c - before.get(name, 0) for name, c in after.items()})
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the check, once the program's state is freed
    def pick(ids):  # (images, conds) of these batches: copies, not views of the store
        ids = torch.as_tensor(np.asarray(ids), device=dev)
        return images[ids], conds[ids]

    batches = (*pick(ids0[0::2]), *pick(ids0[1::2]))
    starts = [(params, tuple(t[0] for t in (*pick(ids[:1]), *pick(ids[1:]))), draws, got)
              for params, ids, draws, got in starts]
    del images, conds, state, step, model, out
    if cuda:
        torch.cuda.empty_cache()
    ref.no_tf32()
    t_ref = time.perf_counter()
    want = first_losses(cfgd, starts)
    ref_params, grad_norms = follow(cfgd, p0, batches, draws0, 1, k)
    nums = {**loss_gaps(np.array([start[3] for start in starts]), want),
            **change_numbers(p0, prog, ref_params, grad_norms)}
    ctx.log(f"reference: {len(starts)} first updates and {k} updates in {time.perf_counter() - t_ref:.3f} s; "
            f"readings {nums}")
    if ctx.controls:  # the fp8 reference and the half-batch fault, each in the program's place
        for name, kw in (("control", {"precision": ref.Precision("fp8")}), ("half_batch", {"half_batch": True})):
            params, _ = follow(cfgd, p0, batches, draws0, 1, k, **kw)
            readings[name] = {**loss_gaps(first_losses(cfgd, starts, **kw), want),
                              **change_numbers(p0, params, ref_params, grad_norms)}
        readings["program"] = nums
    checks = [(name, nums[name], float(lim)) for name, lim in ctx.cell.limits.items()]
    return harness.Outcome(updates, 0, readings, checks, peak)
