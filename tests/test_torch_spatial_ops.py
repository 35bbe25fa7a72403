"""The spatial mesh's pieces in the port (``parallel/halo.py``,
``parallel/spatial.py``, ``parallel/mesh.py``) and its step forms against
one process, on the CPU over gloo ranks (``tests/torch_dp_common.py``).

- Each collective Function and each sharded op (conv and transposed conv
  at strides 1 and 2, the instance norm) on every rank's part of a global
  float64 input against plain single-process autograd on the whole input:
  outputs, input gradients and the ranks' parameter gradients summed,
  within 1e-10 (the norm, whose moments are float32, rtol 2e-5); the halo
  deeper than a rank's rows (2 rows from ranks of 1), maps that tile and
  maps too small to tile, and the gradient penalty's second derivative
  through them.
- The step forms over meshes [1, 2], [2, 1], [2, 2] and [1, 4]: host-fed,
  accumulation, gather and the K-update scan (eager on the CPU) against
  the port's one-process steps on the same global batches and draws,
  with the JAX spatial test's bounds (tests/test_spatial.py): losses
  within 1e-3, weights within 2.5 lr per update.
- A 2-rank spatial ``Trainer`` epoch against one process (losses, weights,
  rank 1 writes nothing), and the meshes the JAX package refuses, refused
  with its errors.
"""

import numpy as np
import pytest
import torch

import jax

from littlegan_tpu.parallel.mesh import make_mesh
from littlegan_tpu.parallel.spatial import make_spatial_train_step
from littlegan_tpu.training import create_train_state as jcreate_train_state
from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.ops.conv import conv2d, deconv2d
from littlegan_tpu_torch.ops.norm import instance_norm
from littlegan_tpu_torch.parallel import mesh as tmesh
from littlegan_tpu_torch.parallel import zero as tzero
from littlegan_tpu_torch.training import step as tstep
from test_torch_dispatch import N_BATCHES, make_store
from test_torch_parallel import _cfg_dict
from test_torch_train import batch
from torch_dp_common import run_ranks, run_steps, train_epochs
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

OPS_TOL = dict(rtol=1e-10, atol=1e-10)
NORM_TOL = dict(rtol=2e-5, atol=2e-6)  # the norm takes its moments in float32, whatever the input's dtype


def _ops(seed=0):
    """(name, inputs, output weights, args) of each op, global float64 arrays."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s)  # noqa: E731
    ops = [
        ("gather", dict(x=r(2, 8, 3, 2)), r(2, 8, 3, 2), {}),
        ("slice", dict(x=r(2, 8, 3, 2)), r(2, 8, 3, 2), {}),
        ("all_reduce", dict(p=r(4, 2, 3)), r(2, 3), {}),
        ("sum_moments", dict(p=r(4, 2, 3), c=r(4, 2, 3)), [r(2, 3) for _ in range(4)], {}),
    ]
    for lo, hi in ((1, 2), (2, 2), (3, 5), (0, 1)):
        ops.append(("halo", dict(x=r(2, 8, 3, 2)), None, dict(lo=lo, hi=hi)))
    # every conv of the model: stride 2 (encoder), stride 1 (s2d 3x3 and 5x5), at heights
    # that tile the mesh, that tile it with 1 row per rank, and that do not
    for h, k, s in ((8, 5, 2), (4, 5, 2), (8, 3, 1), (4, 5, 1), (2, 5, 2), (1, 3, 1)):
        ops.append(("conv", dict(x=r(2, h, 5, 3), k=r(k, k, 3, 4), b=r(4)), None, dict(height=h, stride=s)))
    for h, k, s in ((4, 5, 2), (1, 5, 2), (2, 5, 2), (8, 5, 1)):
        ops.append(("deconv", dict(x=r(2, h, 5, 4), k=r(k, k, 3, 4), b=r(3)), None, dict(height=h, stride=s)))
    for h in (8, 4, 1):
        ops.append(("norm", dict(x=r(2, h, 3, 4) * 2 + 1, g=r(1), b=r(1)), None, dict(height=h)))
    ops.append(("conv", dict(x=r(2, 8, 5, 3), k=r(5, 5, 3, 4), b=r(4)), None,
                dict(height=8, stride=2, **{"2nd": ["k"]})))
    ops.append(("conv", dict(x=r(2, 2, 5, 3), k=r(5, 5, 3, 4), b=r(4)), None,
                dict(height=2, stride=2, **{"2nd": ["k"]})))
    ops.append(("norm", dict(x=r(2, 8, 3, 4), g=r(1), b=r(1)), None, dict(height=8, **{"2nd": ["g"]})))
    return ops


def _plain(name, t, args):
    if name == "conv":
        return conv2d(t["x"], t["k"], t["b"], args["stride"])
    if name == "deconv":
        return deconv2d(t["x"], t["k"], t["b"], args["stride"])
    return instance_norm(t["x"], t["g"], t["b"])


def _want(name, inputs, w, args, m):
    """(the global output, {input: global gradient}) in one process."""
    t = {k: torch.tensor(v, requires_grad=True) for k, v in inputs.items()}
    if name == "halo":
        lo, hi = args["lo"], args["hi"]
        return torch.nn.functional.pad(t["x"], (0, 0, 0, 0, lo, hi)).detach().numpy(), None
    if name in ("gather", "slice"):
        y = t["x"] * 1
    elif name == "all_reduce":
        y = t["p"][:m].sum(0)
    elif name == "sum_moments":
        s = t["p"][:m].sum(0)
        y = torch.stack([s * t["c"][j] for j in range(m)])
        w = np.stack(w[:m])
    else:
        y = _plain(name, t, args)
    wt = torch.tensor(w if w is not None else np.random.default_rng(1).standard_normal(tuple(y.shape)))
    if args.get("2nd"):
        (g,) = torch.autograd.grad((wt * y).sum(), t["x"], create_graph=True)
        return y.detach().numpy(), dict(zip(args["2nd"], (x.numpy() for x in torch.autograd.grad(
            g.square().sum(), [t[k] for k in args["2nd"]]))))
    (wt * y).sum().backward()
    return y.detach().numpy(), {k: v.grad.numpy() for k, v in t.items() if v.grad is not None}


def _case_ops(m):
    """The ops with every output weight made (as the ranks' parts)."""
    out = []
    for name, inputs, w, args in _ops():
        if w is None:
            y, _ = _want(name, inputs, None, dict(args, **{"2nd": None}), m) if name != "halo" else (None, None)
            if name == "halo":
                h = inputs["x"].shape[1] // m
                w = [np.random.default_rng(10 + j).standard_normal((2, h + args["lo"] + args["hi"], 3, 2))
                     for j in range(m)]
            else:
                w = np.random.default_rng(1).standard_normal(y.shape)
        out.append((name, inputs, w, args))
    return out


@pytest.fixture(scope="module")
def op_runs():
    """model size -> (the ops, each rank's results): one start of the ranks per size."""
    return {m: (ops, run_ranks("spatial_ops", m, dict(mesh=(1, m), ops=ops)))
            for m in (2, 4) for ops in [_case_ops(m)]}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("i", range(len(_ops())), ids=[f"{o[0]}{i}" for i, o in enumerate(_ops())])
def test_op_matches_one_process(op_runs, m, i):
    """One op's output and gradients on every rank against autograd on the
    whole input: a sharded output is the rank's rows, a replicated one the
    whole; a sharded input's gradient the rank's rows of the whole one, a
    replicated input's the whole on every rank; a parameter's gradient the
    sum over the ranks."""
    ops, res = op_runs[m]
    name, inputs, w, args = ops[i]
    tol = NORM_TOL if name == "norm" else OPS_TOL
    y_want, g_want = _want(name, inputs, None if name == "halo" else w, args, m)
    ranks = [r[i] for r in res]
    if name == "halo":
        h = inputs["x"].shape[1] // m
        for j, r in enumerate(ranks):
            np.testing.assert_allclose(r["y"], y_want[:, j * h:j * h + h + args["lo"] + args["hi"]], **OPS_TOL)
        # the global loss sum_j <w_j, window_j> has the gradient of each row from every window holding it
        x = torch.tensor(inputs["x"], requires_grad=True)
        padded = torch.nn.functional.pad(x, (0, 0, 0, 0, args["lo"], args["hi"]))
        n = h + args["lo"] + args["hi"]
        sum((padded[:, j * h:j * h + n] * torch.tensor(w[j])).sum() for j in range(m)).backward()
        got = np.concatenate([r["grads"]["x"] for r in ranks], 1)
        np.testing.assert_allclose(got, x.grad.numpy(), **OPS_TOL)
        return
    sharded_out = name == "slice" or (name in ("conv", "deconv", "norm") and ranks[0]["y"].shape != y_want.shape)
    for j, r in enumerate(ranks):
        want = y_want[j] if name == "sum_moments" else y_want
        if sharded_out:
            h = want.shape[1] // m
            want = want[:, j * h:(j + 1) * h]
        np.testing.assert_allclose(r["y"], want, **tol)
    for k, gw in g_want.items():
        if name in ("all_reduce", "sum_moments") and k in ("p", "c"):
            for j, r in enumerate(ranks):
                np.testing.assert_allclose(r["grads"][k][j], gw[j], **tol, err_msg=k)
        elif k == "x" and ranks[0]["grads"]["x"].shape != gw.shape:  # a sharded input: the rank's rows
            np.testing.assert_allclose(np.concatenate([r["grads"]["x"] for r in ranks], 1), gw, **tol)
        elif k == "x":  # a replicated input: the whole gradient on every rank
            for r in ranks:
                np.testing.assert_allclose(r["grads"]["x"], gw, **tol)
        else:  # a parameter: the ranks' shares add up
            np.testing.assert_allclose(sum(r["grads"][k] for r in ranks), gw, **tol, err_msg=k)


# ------------------------------------------------------------- step forms --

LR_TOL = 2.5  # JAX's bound: weights within 2.5 lr per update (tests/test_spatial.py:54-65)


@pytest.fixture(scope="module")
def forms(tiny_cfg):
    """Port cases of every step form on the same global inputs, and each
    one's one-process result."""
    jcfg = tiny_cfg.replace(batch_size=4, use_partition=True, donate_state=False, use_s2d=True, ema_decay=0.9)
    flat = _flatten(jcreate_train_state(jcfg, jax.random.PRNGKey(2)).params)
    rng = np.random.default_rng(4)
    gen = torch.Generator().manual_seed(4)
    cases = {}
    for name, flags in (("s2d", {}), ("raw+accum", dict(use_s2d=False, grad_accum=2, adj_half_batch=True)),
                        ("zero1", dict(shard_opt_state=True, conv_filter=[24, 16, 12, 8, 6]))):
        cfg = _cfg_dict(jcfg.replace(**flags))
        if name == "zero1":
            flat = _flatten(jcreate_train_state(jcfg.replace(**flags), jax.random.PRNGKey(2)).params)
        tc = Config(**cfg)
        draw = lambda: tstep.draw_step(gen, tc, 4, "cpu")  # noqa: E731
        imgs, conds = make_store(rng, jcfg)
        if name != "raw+accum":
            steps = [("train", batch(rng, jcfg), batch(rng, jcfg), draw(), 10),
                     ("gather", (imgs, conds), 1, 2, draw(), 11),
                     ("scan", (imgs, conds), rng.integers(0, N_BATCHES, 2), rng.integers(0, N_BATCHES, 2),
                      tstep.stack_draws([draw(), draw()]), 12)]
        else:
            stack = lambda: tuple(np.stack(x) for x in zip(batch(rng, jcfg), batch(rng, jcfg)))  # noqa: E731
            steps = [("accum", stack(), stack(), tstep.stack_draws([draw(), draw()]), 11),
                     ("scan", (imgs, conds), rng.integers(0, N_BATCHES, (2, 2)), rng.integers(0, N_BATCHES, (2, 2)),
                      tstep.stack_draws([tstep.stack_draws([draw(), draw()]) for _ in range(2)]), 12)]
        case = dict(cfg=cfg, flat=flat, steps=steps, **({"min_shard_elems": 0} if name == "zero1" else {}))
        cases[name] = (case, run_steps(None, case))
    return cases


MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}  # [2, 1]: a model axis of 1 runs the data-parallel step


@pytest.fixture(scope="module")
def form_runs(forms):
    """world -> (case, mesh) -> each rank's result."""
    out = {}
    for world, meshes in MESHES.items():
        keys = [(name, mesh) for mesh in meshes for name in forms]
        res = run_ranks("run_many", world, [dict(forms[n][0], mesh=mesh) for n, mesh in keys])
        out.update(dict(zip(keys, zip(*res))))
    return out


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("name", ["s2d", "raw+accum", "zero1"])
def test_step_forms_match_one_process(forms, form_runs, name, mesh, monkeypatch):
    """Every update of each form (host-fed, gather, K = 2 scan; host-fed
    and scanned accumulation with the half-batch adjuster; the first three
    with ZeRO-1 at a size threshold of 0, where on [2, 2] the 6-wide leaves
    shard over the data ranks alone and the rest over every rank) over the
    mesh ends where one process ends, the ranks all equal."""
    case, single = forms[name]
    res = form_runs[(name, mesh)]
    lr = case["cfg"]["lr"]
    updates = sum(len(np.atleast_1d(s[2])) if s[0] == "scan" else 1 for s in case["steps"])
    for r in res[1:]:
        assert all(np.array_equal(r["flat"][k], res[0]["flat"][k]) for k in r["flat"])
    for got, want in zip(res[0]["losses"], single["losses"]):
        for k in tstep.LOSS_KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3, err_msg=k)
    for k, w in single["flat"].items():
        if k.startswith((".params/", ".ema/")):
            np.testing.assert_allclose(res[0]["flat"][k], w, rtol=0, atol=LR_TOL * lr * updates, err_msg=k)
    if name == "zero1":  # the specs the ranks took, at the case's size threshold
        monkeypatch.setattr(tzero, "_MIN_SHARD_ELEMS", case["min_shard_elems"])
        specs = [tzero._moment_spec(w.shape, {"data": mesh[0], "model": mesh[1]})
                 for k, w in single["flat"].items() if "/.mu/" in k]
        assert res[0]["sharded"] == sum(sp != () for sp in specs) > 0
        assert any("data" in sp for sp in specs) == (mesh == (2, 2))


# ---------------------------------------------------------------- trainer --


def test_trainer_epoch_matches_one_process(tiny_cfg, tmp_path):
    """A host-fed ``Trainer`` epoch over a [1, 2] mesh (predict and image
    cadences on) against one process on the same data: the logged losses
    and the weights, and only rank 0 writes."""
    jcfg = tiny_cfg.replace(batch_size=4, epoch=1, freq_gen=2, freq_test=2, exp_name="sp")
    cfg = _cfg_dict(jcfg)
    case = dict(cfg={**cfg, "mesh_axes": ["data", "model"]}, root=str(tmp_path / "mesh"), items=8 * 4)
    flat, logged, code = run_ranks("train_many", 2, [case])[0][0]
    one, one_logged, _ = train_epochs(None, dict(case, cfg=cfg, root=str(tmp_path / "one")))
    assert code == 0 and len(logged) == len(one_logged) == 4
    for (s, got), (s1, want) in zip(logged, one_logged):
        assert s == s1
        for k in tstep.LOSS_KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3, err_msg=k)
    for k, w in one.items():
        if k.startswith(".params/"):
            np.testing.assert_allclose(flat[k], w, rtol=0, atol=LR_TOL * jcfg.lr * 4, err_msg=k)
    assert (tmp_path / "mesh" / "r0" / "result" / "sp" / "checkpoint" / "ckpt-1.npz").is_file()
    assert list((tmp_path / "mesh" / "r0" / "result" / "sp" / "train" / "gen").iterdir())
    assert not (tmp_path / "mesh" / "r1" / "result").exists()


def test_trainer_refuses_a_mesh_of_another_size(tiny_cfg, tmp_path):
    """mesh_shape [2, 2] over 2 ranks: JAX ``make_mesh``'s error, on every rank."""
    cfg = _cfg_dict(tiny_cfg.replace(mesh_axes=["data", "model"], mesh_shape=[2, 2]))
    assert run_ranks("trainer_error", 2, dict(cfg=cfg, root=str(tmp_path))) == ["mesh shape [2, 2] != 2 devices"] * 2


def test_mesh_checks_match_jax(tiny_cfg):
    """The port's mesh checks raise where the JAX package's do, with its
    messages: a shape whose product is not the world (``make_mesh``), an
    odd world without a shape, a batch or an image height the axes do not
    split (``make_spatial_train_step``); one rank checks nothing."""
    with pytest.raises(AssertionError, match=r"mesh shape \[2, 2\] != 2 devices"):
        make_mesh(2, axis_names=("data", "model"), shape=[2, 2])
    with pytest.raises(ValueError, match=r"mesh shape \[2, 2\] != 2 devices"):
        tmesh.check_mesh(["data", "model"], [2, 2], 2)
    with pytest.raises(ValueError, match=r"mesh shape \[2\] != 1 devices"):
        tmesh.check_mesh(["data"], [2], 1)
    with pytest.raises(ValueError, match="pass an explicit shape for a 2-axis mesh over 3 devices"):
        make_mesh(3, axis_names=("data", "model"))
    with pytest.raises(ValueError, match="pass an explicit shape for a 2-axis mesh over 3 devices"):
        tmesh.check_mesh(["data", "model"], None, 3)
    with pytest.raises(ValueError, match="the mesh is"):
        tmesh.check_mesh(["model", "data"], None, 2)
    tmesh.check_mesh(["data", "model"], [4, 2], 1)
    assert tmesh.mesh_shape_of(None, 8) == (4, 2) == make_mesh(8, axis_names=("data", "model")).devices.shape
    params = jcreate_train_state(tiny_cfg, jax.random.PRNGKey(0)).params
    for cfg, shape in ((tiny_cfg.replace(batch_size=3), (2, 1)), (tiny_cfg.replace(image_dim=12), (1, 8))):
        with pytest.raises(ValueError) as jerr:
            make_spatial_train_step(cfg, params, make_mesh(int(np.prod(shape)), ("data", "model"), shape))
        with pytest.raises(ValueError) as terr:
            tmesh.check_spatial(cfg, shape)
        assert str(terr.value) == str(jerr.value)
