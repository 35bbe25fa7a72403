"""Experiment: an alternate train-step formulation timed on the card, the
counterpart of the JAX repo's ``scripts/bench_step_variants.py``.

Variant B (:func:`total_loss_concat`) runs the two live-parameter D
forwards of the disc loss (the augmented real batch and the detached fake)
as ONE 2B call: fewer kernel launches and larger batches, at the cost of a
second D forward on ``fake`` for the gen loss. The port's step
(``training/step.py::total_loss_fn``) runs D once on the real batch and
once on ``fake`` and routes each loss's gradient to its own group
(``route_grads``), so B runs D over B more rows than the current step, in
as many calls (JAX's step makes three D calls on the same 2B rows, which
XLA merges). :func:`step_concat` builds a step from it
as the JAX script does: D's gradient clipped, the partition masks, the
adjuster gate (``batch_no > 10``) and three masked Adams
(``step.apply_updates``).

Both steps are timed at ``Config(batch_size=32, compute_dtype="bfloat16")``
(128², s2d, adjuster), through the kernels:

  - host wall per eager step (20 host-fed steps after 4 of warm-up, two
    batches of 32 images each: images/s = 64 / wall), which an eager step
    spends mostly waiting on the host (63-70% of it idle);
  - device busy per update: a CUDA graph of K = 8 updates over a uint8
    store replayed between CUDA events: for the current step the
    production K-update step (``bench.build_scan_harness``), for the
    variant the same loop (``step.scan_updates``') with its gradients
    (:func:`concat_harness`). Each run of 7 replays must leave the
    parameters finite.

It prints each number, the verdict on each, and one JSON line last.
``--trace DIR`` also writes a ``torch.profiler`` trace of one replay of
the current step's graph (``DIR/graph_k8.json``, for
``scripts/trace_top_ops.py``). Needs a card: without one it raises
(``utils/device.py::resolve_device``).

  python -m littlegan_tpu_torch.scripts.bench_step_variants [--trace DIR]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

K = 8  # updates per graph replay
EAGER_WARMUP, EAGER_STEPS = 4, 20
GRAPH_REPLAYS = 5


def total_loss_concat(model, batch1, batch2, noise, new_image, cfg):
    """(the three losses on one autograd graph, {"fake", "adj"} images),
    as ``step.total_loss_fn`` returns them, with the disc loss's two D
    forwards (augmented real, detached fake) in one 2B call and D run
    again on ``fake`` for the gen loss. The bench's config only: no
    gradient penalty, remat, half-batch adjuster or spatial mesh."""
    import torch

    from littlegan_tpu_torch.models.littlegan import s2d_active
    from littlegan_tpu_torch.ops.losses import adjuster_loss, discriminator_loss, generator_loss
    from littlegan_tpu_torch.ops.s2d import depth_to_space, space_to_depth

    img1, cond1 = batch1
    img2, cond2 = batch2
    s2 = s2d_active(cfg)
    if s2:
        img1, img2, new_image = space_to_depth(img1), space_to_depth(img2), space_to_depth(new_image)
    dt = getattr(torch, cfg.compute_dtype)
    img1, img2, new_image = img1.to(dt), img2.to(dt), new_image.to(dt)
    n = img1.shape[0]

    fake = model.generator(noise, cond2, s2d_out=s2)
    pr, c = model.discriminator(torch.cat([new_image, fake.detach()]), s2d_in=s2)
    d_loss = discriminator_loss(cond1, c[:n], pr[:n], pr[n:])
    fake_pr, fake_c = model.discriminator(fake, s2d_in=s2)
    g_loss = generator_loss(cond2, fake_c, fake_pr, img2, fake, cfg.l1_lambda)

    tgt_cond = torch.cat([cond2, cond1])
    adj_image = model.adjuster(torch.cat([img1, fake.detach()]), (tgt_cond + 1.0) * 0.5, s2d_in=s2, s2d_out=s2)
    adj_pr, adj_c = model.discriminator(adj_image, s2d_in=s2)
    a_loss = adjuster_loss(tgt_cond, adj_c, adj_pr, torch.cat([img2, img1]), adj_image, cfg.l1_lambda)

    losses = {"loss/gen": g_loss, "loss/disc": d_loss, "loss/adj": a_loss}
    aux = {"fake": (depth_to_space(fake) if s2 else fake).detach(),
           "adj": (depth_to_space(adj_image) if s2 else adj_image).detach()}
    return losses, aux


def check_variant(cfg) -> None:
    """Refuse a config :func:`total_loss_concat` does not run."""
    if cfg.use_gp or cfg.remat or cfg.adj_half_batch or not cfg.train_adj:
        raise ValueError("total_loss_concat runs the bench's config: no use_gp, remat or adj_half_batch, "
                         "train_adj on")


def concat_grads(state, batch1, batch2, draws, cfg):
    """``step.micro_grads`` with :func:`total_loss_concat`: (``name ->
    gradient``, aux with the detached losses and images)."""
    from littlegan_tpu_torch.ops.augment import augment
    from littlegan_tpu_torch.training.step import prep_images, route_grads

    batch1 = (prep_images(batch1[0]), batch1[1])
    batch2 = (prep_images(batch2[0]), batch2[1])
    new_image = augment(batch1[0], draws.augment)
    losses, aux = total_loss_concat(state.model, batch1, batch2, draws.noise, new_image, cfg)
    grads = route_grads(state.model, losses, cfg)
    aux.update({k: v.detach().float() for k, v in losses.items()})
    return grads, aux


def step_concat(state, batch1, batch2, draws, batch_no: int, cfg, part_masks):
    """One update of variant B, in place: clip, partition masks, the
    adjuster gate and the three masked Adams, decided on the host."""
    from littlegan_tpu_torch.training.step import apply_updates

    grads, aux = concat_grads(state, batch1, batch2, draws, cfg)
    return apply_updates(state, grads, aux, batch_no, cfg, part_masks)


def make_step_concat(cfg, state):
    """``step(state, batch1, batch2, draws, batch_no)`` of variant B."""
    from littlegan_tpu_torch.training.step import partition_masks

    check_variant(cfg)
    return functools.partial(step_concat, cfg=cfg, part_masks=partition_masks(state.model))


def host_ms(step, state, cfg, device) -> float:
    """Host wall ms per eager step: EAGER_STEPS host-fed steps on two pairs
    of uint8 batches in turns (batch numbers from 11: the adjuster on),
    after EAGER_WARMUP, closed by a synchronise."""
    import torch

    from littlegan_tpu_torch.training.step import draw_step

    gen = torch.Generator(device=device).manual_seed(1)
    shape = (cfg.batch_size, *cfg.image_shape)
    b = [(torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8),
          torch.rand((cfg.batch_size, cfg.cond_dim), generator=gen, device=device)) for _ in range(4)]
    for i in range(EAGER_WARMUP):
        step(state, b[i % 2], b[2 + i % 2], draw_step(gen, cfg, cfg.batch_size, device), i + 11)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(EAGER_STEPS):
        step(state, b[i % 2], b[2 + i % 2], draw_step(gen, cfg, cfg.batch_size, device), i + 11)
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / EAGER_STEPS * 1e3


def concat_harness(cfg, device):
    """K updates of :func:`concat_grads`' gradients and the row-form
    optimizer tail over a uint8 store of 2K batches, captured in one CUDA
    graph and run once. ``body`` is ``step.scan_updates``' loop for (K,)
    batch ids with :func:`concat_grads` in place of ``step.micro_grads``:
    a change to that loop is made here too. Returns (the state, the
    ``GraphedUpdates``)."""
    import numpy as np
    import torch

    from littlegan_tpu_torch.training.dispatch import GraphedUpdates
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import (
        LOSS_KEYS, apply_updates_rows, draw_step, map_draws, partition_masks, schedule_rows, stack_draws,
        state_tensors, take_batch,
    )

    state = create_train_state(cfg, device)
    gen = torch.Generator(device=device).manual_seed(1)
    shape = (2 * K, cfg.batch_size, *cfg.image_shape)
    images = torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)
    conds = torch.rand((2 * K, cfg.batch_size, cfg.cond_dim), generator=gen, device=device)
    draws = stack_draws([draw_step(gen, cfg, cfg.batch_size, device) for _ in range(K)])
    rows = schedule_rows(state, cfg, partition_masks(state.model), range(11, 11 + K))
    ids = np.arange(2 * K, dtype=np.float32)
    inputs = np.concatenate([ids[:K, None], ids[K:, None], rows], axis=1)

    def body(inputs, draws, state, images, conds):
        losses = []
        for i in range(K):
            i1, i2 = inputs[i, 0].long(), inputs[i, 1].long()
            grads, aux = concat_grads(state, (take_batch(images, i1), take_batch(conds, i1)),
                                      (take_batch(images, i2), take_batch(conds, i2)),
                                      map_draws(lambda x: x[i], draws), cfg)
            out = apply_updates_rows(state, grads, aux, inputs[i, 2:], cfg)
            losses.append(torch.stack([out.metrics[k] for k in LOSS_KEYS]))
        return torch.stack(losses)

    graphed = GraphedUpdates(body)
    graphed(inputs, draws, (state, images, conds), state_tensors(state))
    return state, graphed


def current_harness(cfg, device):
    """The production K-update step (``training/step.py::
    make_scan_train_step``) over ``bench.build_scan_harness``'s store,
    captured and run once. Returns (the state, the ``GraphedUpdates``)."""
    from littlegan_tpu_torch.bench import build_scan_harness

    state, dispatch = build_scan_harness(cfg, K, device=device)
    dispatch(state, 0)
    return state, dispatch.step.graphed


def replay(graphed) -> None:
    """One replay of the captured graph, on the inputs it holds; the
    kernels' counts gain the launches it holds (as ``GraphedUpdates``'
    own calls add them)."""
    from littlegan_tpu_torch.ops.cuda import _build

    graphed.graph.replay()
    for k, n in graphed.launches.items():
        _build.COUNTERS[k].add(n)


def graph_busy_ms(graphed) -> float:
    """Device ms per update: GRAPH_REPLAYS replays of the K-update graph
    between CUDA events, after one."""
    import torch

    replay(graphed)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(GRAPH_REPLAYS):
        replay(graphed)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (GRAPH_REPLAYS * K)


def trace_replay(graphed, path: str) -> None:
    """A torch.profiler trace (Chrome format) of one replay."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replay(graphed)
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)


def bench(device=None, trace: str = "") -> dict:
    """Both forms through the kernels: {"kernels_on": {...}} with each form's host ms per eager step,
    images/s and device ms per update."""
    import torch

    from littlegan_tpu_torch.config import Config
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import make_train_step
    from littlegan_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"bench_step_variants times the card, not {device}")
    cfg = Config(batch_size=32, compute_dtype="bfloat16", debug=True)
    check_variant(cfg)
    rec = {}
    for name, make, harness in (("concat", make_step_concat, concat_harness),
                                ("current", make_train_step, current_harness)):
        state = create_train_state(cfg, device)
        ms = host_ms(make(cfg, state), state, cfg, device)
        del state
        state, graphed = harness(cfg, device)
        busy = graph_busy_ms(graphed)
        if not all(torch.isfinite(p).all() for p in state.model.parameters()):
            raise RuntimeError(f"{name} step: non-finite parameters after {K * (GRAPH_REPLAYS + 2)} graphed updates")
        if trace and name == "current":
            trace_replay(graphed, os.path.join(trace, "graph_k8.json"))
        rec[name] = {"host_ms_per_step": ms, "images_per_s": 2 * cfg.batch_size / (ms / 1e3),
                     "graph_busy_ms_per_update": busy, "graph_launches": dict(graphed.launches)}
        del state, graphed
        torch.cuda.empty_cache()
    return {"kernels_on": rec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default="", help="write a trace of one replay of the current step's graph here")
    args = ap.parse_args(argv)
    import torch

    res = bench(trace=args.trace)
    print(f"# {torch.cuda.get_device_name(0)}, 128², batch 32, bf16")
    for key, rec in res.items():
        for name, label in (("concat", "concat-D variant"), ("current", "current step")):
            r = rec[name]
            print(f"{label:18s} [{key.replace('_', ' ')}] eager {r['host_ms_per_step']:7.2f} ms  "
                  f"{r['images_per_s']:8.1f} img/s | graph {r['graph_busy_ms_per_update']:7.3f} ms busy per update",
                  flush=True)
        c, b = rec["current"], rec["concat"]
        for what, k in (("device busy per update (K = 8 graph)", "graph_busy_ms_per_update"),
                        ("host wall per eager step", "host_ms_per_step")):
            d = b[k] / c[k] - 1
            print(f"verdict [{key.replace('_', ' ')}] {what}: the concat variant is {abs(d):.1%} "
                  f"{'slower' if d > 0 else 'faster'} than the current step")
    print(json.dumps({"device_kind": torch.cuda.get_device_name(0), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
