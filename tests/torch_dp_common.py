"""Data-parallel runs of the port over gloo ranks, for the tests.

``run_ranks(name, world, case)`` starts ``world`` Python processes of this
file, each a rank of one gloo process group on the CPU (an ephemeral
localhost port), runs the function ``name`` of this module (or
``"module:function"`` of another module of ``tests/``) on each as
``fn(DataGroup, case)`` and returns their results in rank order. A process
start costs seconds of CPU, so a test module runs its cases of one world
size in one start (:func:`run_many`). The
workers import torch and the port only, never JAX: the test process holds
the JAX side, and the two meet in numpy arrays and torch tensors (pickled).
"""

from __future__ import annotations

import functools
import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(name: str, world: int, case: Dict[str, Any], timeout: float = 120.0) -> List[Any]:
    """``name(dg, case)`` on each of ``world`` gloo ranks; their results."""
    with tempfile.TemporaryDirectory() as tmp:
        case_path = os.path.join(tmp, "case.pkl")
        with open(case_path, "wb") as f:
            pickle.dump(case, f)
        port = free_port()
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, HERE]), "OMP_NUM_THREADS": "1"}
        env.pop("LOCAL_RANK", None)
        procs = [
            subprocess.Popen(
                [sys.executable, __file__, name, case_path, str(r), str(world), str(port),
                 os.path.join(tmp, f"{r}.pkl")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for r in range(world)
        ]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise AssertionError(f"ranks {bad} failed:\n"
                                 + "\n".join(f"--- rank {r}\n{logs[r][-4000:]}" for r, _ in bad))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_process():
    """While a port test module runs, its process computes on one torch
    thread and one BLAS thread (restored after the module). The suite runs
    in several xdist processes on a host of few cores: a pool of a thread
    per core in each process only oversubscribes the cores, and a
    single-threaded job beside them runs several times slower (a 2048-d
    ``scipy.linalg.sqrtm``, 15 s alone, took 68 s beside five 8-thread
    torch processes on an 8-core host). The port's test modules import this
    fixture, which makes it theirs."""
    import torch
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def with_shard_threshold(fn):
    """Run ``fn(dg, case)`` with ZeRO-1's size threshold
    (``zero._MIN_SHARD_ELEMS``) set to ``case["min_shard_elems"]`` when the
    case gives one (the tiny test model's leaves all fall under the real
    one), and put the module's value back after: a case run in the test's
    own process (``dg`` None) must leave no threshold to the tests that
    follow in that process."""

    @functools.wraps(fn)
    def wrapper(dg, case):
        from littlegan_tpu_torch.parallel import zero

        old = zero._MIN_SHARD_ELEMS
        zero._MIN_SHARD_ELEMS = case.get("min_shard_elems", old)
        try:
            return fn(dg, case)
        finally:
            zero._MIN_SHARD_ELEMS = old

    return wrapper


# ------------------------------------------------------------- comparisons --


def _f32(a: np.ndarray) -> np.ndarray:
    """A stored leaf as float32 (bf16 moments are 2-byte void words)."""
    a = np.asarray(a)
    if a.dtype.kind == "V":
        import torch

        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).float().numpy()
    return a.astype(np.float32)


def assert_states_close(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray], rtol: float, atol: float):
    """Two flat train states: the same keys, counts equal, every other leaf
    within rtol / atol."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if "/.count/" in k:
            assert int(got[k]) == int(w), k
        else:
            np.testing.assert_allclose(_f32(got[k]), _f32(w), rtol=rtol, atol=atol, err_msg=k)


def assert_state_matches_jax(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray], weight_atol: float):
    """A port state against a JAX one after the same updates, with the
    tolerances of tests/test_torch_step.py: counts exact, weights (and the
    EMA) to ``weight_atol`` (a few lr_t: Adam moves each weight by about
    lr_t whatever its gradient's size), first moments rtol 2e-3 / atol
    1e-6, second moments rtol 2e-3 / atol 1e-9, bf16 moments 2^-7."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        part = k.split("/")[1]
        if part == ".count":
            assert int(g) == int(w), k
        elif g.dtype.kind == "V":
            np.testing.assert_allclose(_f32(g), w.astype(np.float32), rtol=2 ** -7, atol=1e-6, err_msg=k)
        elif k.startswith((".params/", ".ema/")):
            np.testing.assert_allclose(g, w, rtol=0, atol=weight_atol, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-6 if part == ".mu" else 1e-9, err_msg=k)


# ------------------------------------------------------------------ on a rank --


def port_state(cfg, flat: Dict[str, np.ndarray]):
    """A port TrainState (CPU) holding JAX-keyed weights, fresh moments."""
    from littlegan_tpu_torch.compat.jax_params import params_from_jax
    from littlegan_tpu_torch.models.littlegan import LittleGAN
    from littlegan_tpu_torch.training.state import create_train_state

    return create_train_state(cfg, "cpu", params_from_jax(flat, LittleGAN(cfg)))


def make_sync(dg, cfg, state):
    """The ranks' reduction for ``cfg`` over ``dg`` (None: one process);
    with ``shard_dense`` the state's dense heads are sharded first."""
    from littlegan_tpu_torch.parallel.train import GradSync
    from littlegan_tpu_torch.parallel.zero import Zero1, shard_dense_state

    if dg is None:
        return None
    if cfg.shard_dense:
        shard_dense_state(state, dg)
    return Zero1(dg, state, cfg.shard_dense) if cfg.shard_opt_state else GradSync(dg, cfg.shard_dense)


@with_shard_threshold
def run_steps(dg, case):
    """Port updates from one init (``case["flat"]``) under ``case["cfg"]``,
    each rank on its rows of the global inputs of ``case["steps"]``:

    - ("train", batch1, batch2, draws, batch_no): the host-fed step;
    - ("accum", batch1s, batch2s, draws, batch_no): (M, B, ...) stacks;
    - ("gather", (images, conds), id1, id2, draws, batch_no): the store step;
    - ("scan", (images, conds), ids1, ids2, draws, batch_no0): K updates
      ((K,) ids), or K accumulated updates ((K, M) ids, ``grad_accum`` M).

    Returns {"flat": the whole state flat under the JAX keys, "losses":
    each call's, "reduced": the bytes the last update reduced, "sharded":
    the moment leaves ZeRO-1 shards, "local_shapes": the shape of each
    parameter, first moment and EMA leaf this rank holds, by port name}.
    ``dg`` None: one process. ``case["min_shard_elems"]``: ZeRO-1's size
    threshold, when given (the tiny test model's leaves all fall under the
    real one). ``case["mesh"]``
    (data, model): the ranks as a spatial mesh of that shape."""
    import torch

    from littlegan_tpu_torch.config import Config
    from littlegan_tpu_torch.parallel.mesh import spatial_group
    from littlegan_tpu_torch.parallel.train import local_draws, shard_local_batch
    from littlegan_tpu_torch.training import step as tstep
    from littlegan_tpu_torch.training.checkpoint import flatten_state

    cfg = Config(**case["cfg"])
    if dg is not None and case.get("mesh"):
        dg = spatial_group(dg, case["mesh"])
    state = port_state(cfg, case["flat"])
    sync = make_sync(dg, cfg, state)
    t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    losses = []
    for kind, *args in case["steps"]:
        if kind in ("train", "accum"):
            b1, b2, draws, batch_no = args
            axis = 0 if kind == "train" else 1
            b1, b2 = (tuple(t(x) for x in shard_local_batch(b, dg, axis)) for b in (b1, b2))
            draws = local_draws(draws, dg, axis)
            make = tstep.make_train_step if kind == "train" else tstep.make_accum_train_step
            out = make(cfg, state, sync)(state, b1, b2, draws, batch_no)
        else:
            (imgs, conds), ids1, ids2, draws, batch_no = args
            imgs, conds = t(shard_local_batch(imgs, dg, 1)), t(shard_local_batch(conds, dg, 1))
            if kind == "gather":
                out = tstep.make_gather_train_step(cfg, state, sync=sync)(
                    state, imgs, conds, ids1, ids2, local_draws(draws, dg), batch_no)
            else:
                k = len(ids1)
                lead = 1 if np.ndim(ids1) == 1 else 2
                make = tstep.make_scan_train_step if lead == 1 else tstep.make_scan_accum_train_step
                out = make(cfg, state, k, sync=sync)(state, imgs, conds, ids1, ids2,
                                                      local_draws(draws, dg, lead), batch_no)
        losses.append({k: np.atleast_1d(out.metrics[k].numpy()) for k in tstep.LOSS_KEYS})
    full = state if sync is None else sync.full_state(state)
    local = {f".params/{k}": tuple(p.shape) for k, p in state.model.named_parameters()}
    local.update({f".{o}/.mu/{k}": tuple(v.shape) for o in ("opt_g", "opt_d", "opt_a")
                  for k, v in getattr(state, o).mu.items()})
    local.update({f".ema/{k}": tuple(v.shape) for k, v in (state.ema or {}).items()})
    return {"flat": flatten_state(full), "losses": losses, "reduced": None if sync is None else sync.reduced_bytes,
            "sharded": sum(a is not None for a in getattr(sync, "axes", {}).values()), "local_shapes": local}


def run_many(dg, cases):
    """:func:`run_steps` of each case in turn: several runs per start of
    the ranks' processes."""
    return [run_steps(dg, case) for case in cases]


def train_many(dg, cases):
    """:func:`train_epochs` of each case in turn."""
    return [train_epochs(dg, case) for case in cases]


@with_shard_threshold
def train_epochs(dg, case):
    """A ``Trainer`` run on the synthetic dataset: ``case["cfg"]`` with this
    rank's result directories (``case["root"]/r<rank>``, so that what a rank
    writes is seen apart), ``case.get("interrupt_rank")`` raising its SIGINT
    flag after its first dispatch; ``case.get("min_shard_elems")`` as for
    :func:`run_steps`. Returns (the whole state flat, the
    trainer's logged losses, the exit code: 1 after an interrupt save)."""
    from littlegan_tpu_torch.config import Config
    from littlegan_tpu_torch.data.synthetic import SyntheticDataset
    from littlegan_tpu_torch.training.checkpoint import flatten_state
    from littlegan_tpu_torch.training.trainer import Trainer

    rank = 0 if dg is None else dg.rank
    root = os.path.join(case["root"], f"r{rank}")
    cfg = Config(**{**case["cfg"], "all_result_dir": os.path.join(root, "result"),
                    "test_data_dir": os.path.join(root, "test-data")})
    data = SyntheticDataset(cfg, num_items=case["items"])
    tr = Trainer(cfg, data, device="cpu", group=dg)
    logged = []
    flush = tr._flush_buffered

    def spy():
        logged.extend((s0, {k: np.atleast_1d(v.numpy()) for k, v in m.items()}) for s0, _, m in tr._metrics_buffer)
        flush()

    tr._flush_buffered = spy
    if case.get("interrupt_rank") == rank:
        after = tr._after_dispatch

        def interrupt(*args):
            tr._interrupt_requested = True
            after(*args)

        tr._after_dispatch = interrupt
    code = 0
    try:
        tr.train()
    except SystemExit as e:
        code = e.code
    return flatten_state(tr.full_state()), logged, code


def trainer_error(dg, case):
    """The message of the error a ``Trainer`` of ``case["cfg"]`` raises on
    this rank (None if it is built)."""
    from littlegan_tpu_torch.config import Config
    from littlegan_tpu_torch.training.trainer import Trainer

    root = os.path.join(case["root"], f"r{dg.rank}")
    cfg = Config(**{**case["cfg"], "all_result_dir": os.path.join(root, "result"),
                    "test_data_dir": os.path.join(root, "test-data")})
    try:
        Trainer(cfg, None, device="cpu", group=dg)
    except ValueError as e:
        return str(e)
    return None


def spatial_ops(dg, case):
    """Each op of ``case["ops"]`` on this rank's part of its global inputs,
    over a spatial mesh of ``case["mesh"]``: {"y": the output, "grads":
    the gradients of the inputs and parameters} per op, the backward seeded
    with the rank's part of the op's output weights ``w`` (all of them for a
    replicated output), so that the ranks' losses add up to the global
    <w, y>. An op: (name, inputs, w, args); with "2nd" in its args the
    gradient penalty's pattern instead: g = d<w, y>/dx with create_graph,
    then the gradient of the global sum of g^2 (over the ranks)."""
    import torch

    from littlegan_tpu_torch.parallel import halo, spatial
    from littlegan_tpu_torch.parallel.mesh import spatial_group

    sg = spatial_group(dg, case["mesh"])
    sp = spatial.Spatial(sg.model)
    m, j = sp.m, sp.rank
    rows = lambda a, n: a[:, j * (a.shape[1] // n):(j + 1) * (a.shape[1] // n)]  # noqa: E731
    out = []
    for name, inputs, w, args in case["ops"]:
        t = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True) for k, v in inputs.items()}
        if name in ("halo", "gather"):
            t["x"] = rows(t["x"].detach(), m).clone().requires_grad_(True)
        if name == "halo":
            y = halo.halo_h(t["x"], args["lo"], args["hi"], sg.model)
        elif name == "gather":
            y = halo.gather_h(t["x"], sg.model)
        elif name == "slice":
            y = halo.slice_h(t["x"], sg.model)
        elif name == "all_reduce":
            y = halo.all_reduce(t["p"][j], sg.model)
        elif name == "sum_moments":
            y = halo.sum_moments(t["p"][j], sg.model) * t["c"][j]
        else:
            h = args["height"]
            if sp.tiles(h):
                t["x"] = rows(t["x"].detach(), m).clone().requires_grad_(True)
            if name == "conv":
                y = spatial.conv(t["x"], t["k"], t["b"], args["stride"], sp, h)
            elif name == "deconv":
                y = spatial.deconv(t["x"], t["k"], t["b"], args["stride"], sp, h)
            else:
                y = spatial.instance_norm(t["x"], t["g"], t["b"], sp, h)
        wt = torch.tensor(w[j] if isinstance(w, list) else w, dtype=torch.float64)
        if wt.shape != y.shape:
            wt = rows(wt, m)
        if args.get("2nd"):
            (g,) = torch.autograd.grad((wt * y).sum(), t["x"], create_graph=True)
            loss = halo.all_reduce(g.square().sum(), sg.model) if sp.tiles(args["height"]) else g.square().sum()
            grads = torch.autograd.grad(loss, [t[k] for k in args["2nd"]])
            out.append({"y": y.detach().numpy(), "grads": dict(zip(args["2nd"], (x.numpy() for x in grads)))})
            continue
        (wt * y).sum().backward()
        out.append({"y": y.detach().numpy(), "grads": {k: v.grad.numpy() for k, v in t.items() if v.grad is not None}})
    return out


if __name__ == "__main__":
    name, case_path, rank, world, port, out_path = sys.argv[1:]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=int(world), rank=int(rank))
    from littlegan_tpu_torch.parallel.mesh import data_group

    with open(case_path, "rb") as f:
        case = pickle.load(f)
    module, _, fn = name.rpartition(":")  # "module:function" names a function of another module here
    try:
        result = getattr(importlib.import_module(module), fn) if module else globals()[fn]
        result = result(data_group("cpu"), case)
        with open(out_path, "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()
