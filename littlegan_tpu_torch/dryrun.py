"""Entry points of the port for a first run: the flagship forward and a
dry run of every multi-card training regime, the counterpart of the JAX
repo's ``__graft_entry__.py``.

  python -m littlegan_tpu_torch.dryrun N                 # N ranks, one per card, NCCL
  python -m littlegan_tpu_torch.dryrun N --device cpu    # N gloo ranks on the CPU

:func:`entry` is the reference-scale forward: the conditional generator at
128x128, batch 8, bf16 compute, on the card. :func:`dryrun_multichip` runs
ONE full training step (G + D + A, three gradient routes, masked Adam,
partition schedule) on tiny shapes (JAX's config: 2 rows per rank, 16x16,
``conv_filter`` [24, 16, 12, 8, 4], float32) in every regime the JAX dry
run covers, in its order and under its tags:

1. ``dp``: the host-fed step over a data group (``GradSync``: the
   gradients' all-reduce);
2. ``accum_x_dp``: gradient accumulation (M = 2 micro-pairs) x DP, with
   ``remat``;
3. ``spatial``: a ``(data, model)`` mesh of ``[N/2, 2]`` ranks, each on
   half of every image's rows (halo exchanges, cross-rank norm moments);
4. ``zero1_x_dp``: ZeRO-1 (``Zero1``: reduce-scatter, Adam on a shard,
   all-gather) x DP;
5. ``shard_dense_x_spatial``: the dense heads sharded over the model axis
   (32x32, ``init_dim`` 2) on the spatial mesh;
6. ``moment_bf16_x_zero1_x_dp``: bf16 Adam moments, sharded;
7. ``accum_x_spatial``: accumulation on the spatial mesh;
8. ``shard_dense_x_zero1_x_spatial``: both, with ZeRO-1;
9. ``infer_dp``: the generator over N replicas (``data_parallel_infer``,
   one per card, or N on the CPU) on N + 1 ragged rows.

Each regime asserts what JAX's asserts (finite losses; the moments and
dense heads sharded where it shards them) and more: finite parameters and
the output images' shapes. The spatial regimes need an even N, and print
JAX's ``skipped: odd device count`` otherwise. ZeRO-1's size threshold is
0 while the regimes run, as in JAX (the tiny model's leaves fall under the
real one). One rank splits nothing: JAX's ZeRO-1 assertion fails on one
device, and at N = 1 the port gives ZeRO-1 the moment axes of two ranks,
so that its reduce-scatter and all-gather run (as ``chip_smoke.py`` phase
(h) does).

One process per rank, as the port's data-parallel paths run
(``parallel/launch.py``: the ranks meet at a file): over NCCL, one per
card, more ranks than visible cards are refused; with ``--device cpu``
over gloo on the CPU. The process group is made at N = 1 too: on a card
that is NCCL at world size 1. On the card the DP regimes launch the
kernels and the spatial regimes take the plain route
(``models/littlegan.py::_kernels``), and the run ends with rank 0's launch
counts.

JAX's dry run also counts XLA's "involuntary full rematerialization"
warnings of its SPMD partitioner and fails on any. The port has no
partitioner (every collective is written by hand), so that count has no
meaning here and is left out.
"""

from __future__ import annotations

import argparse
import json
import sys

def require(ok, what: str) -> None:
    """A regime's check (stays under ``python -O``, unlike assert)."""
    if not ok:
        raise AssertionError(what)


def entry(device=None):
    """(fn, example_args): the reference-scale (128x128) conditional
    generator, batch 8, bf16 compute, seeded random weights, on
    ``device`` (default the card: :func:`resolve_device`)."""
    import torch

    from littlegan_tpu_torch.config import Config
    from littlegan_tpu_torch.models.littlegan import init_params
    from littlegan_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = Config(compute_dtype="bfloat16")
    model = init_params(cfg, 0).to(device).eval()

    def fn(noise, cond):
        with torch.inference_mode():
            return model.generator(noise, cond)

    noise = torch.zeros((8, cfg.noise_dim), device=device)
    cond = torch.zeros((8, cfg.cond_dim), device=device)
    return fn, (noise, cond)


def tiny_config(n: int):
    """JAX's dry-run config (``__graft_entry__.py``) for ``n`` ranks."""
    from littlegan_tpu_torch.config import Config

    return Config(batch_size=2 * n, image_dim=16, init_dim=1, noise_dim=13, conv_filter=[24, 16, 12, 8, 4],
                  compute_dtype="float32", use_partition=True, train_adj=True, debug=True)


def _regimes(dg) -> list:
    """Run every regime on this rank of ``dg``; rank 0's printed lines."""
    import numpy as np
    import torch

    from littlegan_tpu_torch.models.littlegan import LittleGAN
    from littlegan_tpu_torch.parallel import zero
    from littlegan_tpu_torch.parallel.infer import data_parallel_infer
    from littlegan_tpu_torch.parallel.mesh import spatial_group
    from littlegan_tpu_torch.parallel.spatial import DENSE_AXES
    from littlegan_tpu_torch.parallel.train import GradSync, local_draws, replicate_state, shard_local_batch
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import (
        LOSS_KEYS, draw_step, make_accum_train_step, make_train_step, stack_draws,
    )
    from littlegan_tpu_torch.utils.image import soft

    n, device = dg.world, dg.device
    cfg = tiny_config(n)
    lines = []

    def say(line: str) -> None:
        lines.append(f"dryrun_multichip({n}) {line}")

    def inputs(c, group, accum: bool = False):
        """This rank's part of two global batches of ``c`` (the same seeds
        on every rank) and of their draws; stacked twice over M = 2 with
        ``accum``, as JAX stacks them."""
        rng = np.random.default_rng(1)
        gen = torch.Generator(device=device).manual_seed(2)
        batches = []
        for _ in range(2):
            img = rng.uniform(-1.0, 1.0, (c.batch_size, *c.image_shape)).astype(np.float32)
            cond = soft(np.where(rng.random((c.batch_size, c.cond_dim)) < 0.5, -1.0, 1.0)).astype(np.float32)
            b = (img, cond)
            if accum:
                b = tuple(np.stack([x, x]) for x in b)
            batches.append(tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                                 for x in shard_local_batch(b, group, 1 if accum else 0)))
        draws = draw_step(gen, c, c.batch_size, device)
        if accum:
            draws = stack_draws([draws, draws])
        return batches[0], batches[1], local_draws(draws, group, 1 if accum else 0)

    def run(tag, c, group, sync_of, accum: bool = False, check=None):
        state = create_train_state(c, device)
        replicate_state(state, dg)
        sync = sync_of(state)
        if check is not None:
            check(state, sync)
        b1, b2, draws = inputs(c, group, accum)
        out = (make_accum_train_step if accum else make_train_step)(c, state, sync)(state, b1, b2, draws, 11)
        metrics = {k: float(out.metrics[k]) for k in LOSS_KEYS}
        for k, v in metrics.items():
            require(np.isfinite(v), f"[{tag}] non-finite {k}")
        require(all(bool(torch.isfinite(p).all()) for p in state.model.parameters()), f"[{tag}] non-finite params")
        want = tuple(b2[0].shape[1:] if accum else b2[0].shape)
        require(tuple(out.fake_image.shape) == want, f"[{tag}] fake image {tuple(out.fake_image.shape)} != {want}")
        say(f"[{tag}] OK: {({k: round(v, 4) for k, v in metrics.items()})}")
        return state

    def zero1(group, state, shard_dense=False):
        sync = zero.Zero1(group, state, shard_dense)
        if group.world == 1:  # one rank splits nothing: the axes of two, so that its collectives run
            sync.axes = {k: zero.moment_axis(shape, 2) for k, shape in sync.shapes.items()}
        return sync

    def sharded(tag, sync):
        require(sync._sharded(sync.axes), f"[{tag}] no moment leaf sharded")

    def dense_sharded(tag, c, state, group):
        name = "g_head.dense.kernel"
        axis = DENSE_AXES[name]
        part = LittleGAN(c).get_parameter(name).shape[axis] // group.model_size
        require(state.model.get_parameter(name).shape[axis] == part and state.opt_g.mu[name].shape[axis] == part,
                f"[{tag}] dense head not sharded")

    old_threshold = zero._MIN_SHARD_ELEMS
    zero._MIN_SHARD_ELEMS = 0
    try:
        # 1. plain DP
        dp_state = run("dp", cfg, dg, lambda s: GradSync(dg))

        # 2. accumulation x DP, with remat
        run("accum_x_dp", cfg.replace(grad_accum=2, remat=True), dg, lambda s: GradSync(dg), accum=True)

        even = n % 2 == 0
        sg = spatial_group(dg, (n // 2, 2)) if even else None

        # 3. the spatial ('data', 'model') mesh
        if even:
            run("spatial", cfg.replace(batch_size=2 * (n // 2)), sg, lambda s: GradSync(sg))
        else:
            say("[spatial] skipped: odd device count")

        # 4. ZeRO-1 x DP
        run("zero1_x_dp", cfg.replace(shard_opt_state=True), dg, lambda s: zero1(dg, s),
            check=lambda s, sync: sharded("zero1", sync))

        # 5. shard_dense x spatial
        if even:
            sdcfg = cfg.replace(batch_size=n // 2, image_dim=32, init_dim=2, shard_dense=True)

            def sd_sync(s):
                zero.check_shard_dense(sdcfg, sg)
                zero.shard_dense_state(s, sg)
                return GradSync(sg, shard_dense=True)

            run("shard_dense_x_spatial", sdcfg, sg, sd_sync,
                check=lambda s, sync: dense_sharded("shard_dense", sdcfg, s, sg))
        else:
            say("[shard_dense] skipped: odd device count")

        # 6. bf16 moments x ZeRO-1 x DP
        def bf16_sharded(s, sync):
            sharded("moment_bf16", sync)
            keys = sync._sharded(sync.axes)
            require(all(getattr(s, o).mu[k].dtype == torch.bfloat16 for o in ("opt_g", "opt_d", "opt_a")
                        for k in keys if k in getattr(s, o).mu), "[moment_bf16] moments not bf16-sharded")

        run("moment_bf16_x_zero1_x_dp", cfg.replace(moment_dtype="bfloat16", shard_opt_state=True), dg,
            lambda s: zero1(dg, s), check=bf16_sharded)

        # 7. accumulation x spatial
        if even:
            run("accum_x_spatial", cfg.replace(grad_accum=2, batch_size=2 * (n // 2)), sg, lambda s: GradSync(sg),
                accum=True)
        else:
            say("[accum_x_spatial] skipped: odd device count")

        # 8. shard_dense x ZeRO-1 x spatial
        if even:
            zdcfg = cfg.replace(batch_size=n // 2, image_dim=32, init_dim=2, shard_dense=True, shard_opt_state=True)

            def zd_sync(s):
                zero.check_shard_dense(zdcfg, sg)
                zero.shard_dense_state(s, sg)
                return zero1(sg, s, shard_dense=True)

            def zd_check(s, sync):
                dense_sharded("shard_dense_x_zero1", zdcfg, s, sg)
                sharded("shard_dense_x_zero1", sync)

            run("shard_dense_x_zero1_x_spatial", zdcfg, sg, zd_sync, check=zd_check)
        else:
            say("[shard_dense_x_zero1] skipped: odd device count")
    finally:
        zero._MIN_SHARD_ELEMS = old_threshold

    # 9. DP inference: the generator over n replicas, n + 1 ragged rows (rank 0)
    if dg.rank == 0:
        devices = ([torch.device("cuda", i) for i in range(n)] if device.type == "cuda" else [device] * n)
        gen = data_parallel_infer(lambda m, z, c: m.generator(z, c).float(), 2, devices)
        rows = n + 1
        imgs = gen(dp_state.model, torch.zeros((rows, cfg.noise_dim)), torch.zeros((rows, cfg.cond_dim)))
        require(tuple(imgs.shape) == (rows, cfg.image_dim, cfg.image_dim, cfg.image_channel),
                f"[infer_dp] output {tuple(imgs.shape)}")
        require(bool(torch.isfinite(imgs).all()), "[infer_dp] non-finite generator output")
        say(f"[infer_dp] OK: {rows} ragged rows over {n} devices")
    return lines


def _rank(spec: dict) -> dict:
    """One rank of the dry run (its environment says which)."""
    import torch
    import torch.distributed as dist

    from littlegan_tpu_torch.ops.cuda import _build
    from littlegan_tpu_torch.parallel.launch import join_group
    from littlegan_tpu_torch.utils.device import resolve_device

    device = resolve_device(spec["device"])
    if device.type == "cpu":
        torch.set_num_threads(1)
    dg = join_group(device, spec["rendezvous"])
    try:
        lines = _regimes(dg)
        launches = {k: v for k, v in _build.launch_counts().items() if v}
        dist.barrier(dg.control)
    finally:
        dist.destroy_process_group()
    return {"lines": lines, "launches": launches}


def dryrun_multichip(n: int, device=None) -> dict:
    """Run every regime over ``n`` rank processes and print rank 0's lines
    (and on the card its kernels' launches); returns rank 0's result.
    ``device``: None or "cuda" for one rank per card (NCCL), "cpu" for gloo
    ranks. Raises without a card unless ``device`` is "cpu", and when ``n``
    exceeds the visible cards."""
    import torch

    from littlegan_tpu_torch.parallel.launch import run_ranks
    from littlegan_tpu_torch.utils.device import resolve_device

    cpu = resolve_device(device).type == "cpu"
    if not cpu and n > torch.cuda.device_count():
        raise SystemExit(f"dryrun: {n} ranks exceed the {torch.cuda.device_count()} visible CUDA devices "
                         "(one rank per card; --device cpu runs gloo ranks)")
    spec = {"tag": f"dryrun_multichip({n})", "device": "cpu" if cpu else None}
    result = run_ranks("littlegan_tpu_torch.dryrun", spec, n, cpu=cpu, timeout=900.0)[0]
    for line in result["lines"]:
        print(line, flush=True)
    if not cpu:
        print(f"dryrun_multichip({n}) kernel launches (rank 0): {json.dumps(result['launches'])}", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks (default 8, as the JAX dry run's devices)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu: gloo ranks on the CPU (default: one rank per card)")
    ap.add_argument("--rank", nargs=2, metavar=("SPEC", "OUT"), help=argparse.SUPPRESS)  # one rank of the run
    args = ap.parse_args(argv)
    if args.rank:
        with open(args.rank[0]) as f:
            result = _rank(json.load(f))
        with open(args.rank[1], "w") as f:
            json.dump(result, f)
        return 0
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
