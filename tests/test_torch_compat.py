"""The port's compat/ against the JAX package's, on the CPU in f32.

- Import: one reference TF checkpoint (made by the JAX tests: tf.Module
  graph with 0 or (7, 5, 3) optimizer applies, and real Keras objects)
  goes through both packages' ``convert_reference_checkpoint``: the npz
  files are equal bit for bit, status.json too but for ``converted_from``,
  the JAX ``Checkpointer`` restores the port's file, and the port's
  generator on the imported weights is within rtol 1e-4 / atol 1e-5 of
  JAX's.
- Mapping edge cases (numpy only): the same exception types as JAX's, and
  underflowed beta powers give ``_CONVERGED_COUNT``.
- Export: one train state (random weights, EMA, moments, counts (7, 5, 3))
  written as a checkpoint; each port entry point (``main(argv)``) exports
  it: the reference checkpoint equals JAX's export of the same state (beta
  powers to 1e-6 relative, tests/test_reference_ckpt.py's bound), import
  after export is bit for bit, and ``state_to_variables`` inverts
  ``variables_to_train_state`` without TF. The SavedModel is within rtol
  1e-4 / atol 1e-5 of JAX's (tests/test_torch_models.py's port-against-JAX
  bound) and within 1e-5 of the port's own f32 forward
  (tests/test_savedmodel.py's same-package bound), on the EMA weights; the
  reloaded ``.pt2`` within 1e-6 of the port's forward and within rtol 1e-4
  / atol 1e-5 of JAX's StableHLO export.
"""

import json
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
from jax import export as jexport  # noqa: E402

from littlegan_tpu.compat import reference_checkpoint as jref  # noqa: E402
from littlegan_tpu.compat.savedmodel import export_saved_model as jax_saved_model  # noqa: E402
from littlegan_tpu.compat.stablehlo import export_stablehlo  # noqa: E402
from littlegan_tpu.models import generator_apply  # noqa: E402
from littlegan_tpu.training.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from littlegan_tpu.training.state import create_train_state as jcreate_train_state  # noqa: E402
from littlegan_tpu.training.state import eval_params as jeval_params  # noqa: E402
from littlegan_tpu_torch.compat import reference_checkpoint as tref  # noqa: E402
from littlegan_tpu_torch.compat import savedmodel as tsm  # noqa: E402
from littlegan_tpu_torch.compat import torch_export as tte  # noqa: E402
from littlegan_tpu_torch.models.littlegan import init_params  # noqa: E402
from littlegan_tpu_torch.training.checkpoint import Checkpointer  # noqa: E402
from littlegan_tpu_torch.training.state import create_train_state, eval_params  # noqa: E402
from test_reference_ckpt import (  # noqa: E402
    _build_keras_checkpoint,
    _build_tf_checkpoint,
    _random_params,
    _random_state,
    _vars_from_params,
)
from test_torch_train import tcfg_of  # noqa: E402
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

PORT_VS_JAX = dict(rtol=1e-4, atol=1e-5)
SAME_PACKAGE = dict(rtol=1e-5, atol=1e-5)
PT2_ATOL = 1e-6
POWER_RTOL = 1e-6

# name: (the JAX tests' maker, (d, g, a) applies or None for the Keras one, source status.json epoch or None)
IMPORTS = {
    "module-0": (_build_tf_checkpoint, (0, 0, 0), None),
    "module-7.5.3": (_build_tf_checkpoint, (7, 5, 3), 8),
    "keras": (_build_keras_checkpoint, None, None),
}
WANT_COUNTS = {"module-0": {"opt_g": None, "opt_d": None, "opt_a": None},
               "module-7.5.3": {"opt_g": 5, "opt_d": 7, "opt_a": 3},
               "keras": {"opt_g": None, "opt_d": None, "opt_a": None}}


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_npz_bitwise(got_path, want_path):
    got, want = _npz(got_path), _npz(want_path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _status(directory):
    with open(os.path.join(directory, "status.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def imported(tiny_cfg, tmp_path_factory):
    """Per case: the source, both packages' summaries and output dirs (the
    port's weights-only file through ``main``)."""
    p0 = _random_params(tiny_cfg)
    out = {}
    for name, (make, applies, epoch) in IMPORTS.items():
        root = tmp_path_factory.mktemp(name)
        src = make(root, tiny_cfg, p0) if applies is None else make(root, tiny_cfg, p0, *applies)
        if epoch is not None:
            with open(os.path.join(src, "status.json"), "w") as f:
                json.dump({"epoch": epoch}, f)
        dirs = {k: os.fspath(root / k) for k in ("jax", "port", "jax_w", "port_w")}
        betas = dict(beta_1=tiny_cfg.beta_1, beta_2=tiny_cfg.beta_2)
        jsum = jref.convert_reference_checkpoint(src, dirs["jax"], **betas)
        tsum = tref.convert_reference_checkpoint(src, dirs["port"], device="cpu", **betas)
        jref.convert_reference_checkpoint(src, dirs["jax_w"], weights_only=True)
        rc = tref.main(["import", src, dirs["port_w"], "--weights-only", "--device", "cpu"])
        out[name] = dict(src=src, jsum=jsum, tsum=tsum, dirs=dirs, rc=rc)
    return out


@pytest.mark.parametrize("name", list(IMPORTS))
def test_import_writes_the_jax_npz_bit_for_bit(imported, name):
    run = imported[name]
    jsum, tsum, dirs = run["jsum"], run["tsum"], run["dirs"]
    assert run["rc"] == 0
    assert tsum["tag"] == jsum["tag"] == ("7" if IMPORTS[name][2] else "0")
    assert tsum["inferred"] == jsum["inferred"]
    assert tsum["optimizers"] == jsum["optimizers"] == WANT_COUNTS[name]
    _assert_npz_bitwise(tsum["path"], jsum["path"])
    _assert_npz_bitwise(os.path.join(dirs["port_w"], "ckpt-model.npz"), os.path.join(dirs["jax_w"], "ckpt-model.npz"))
    got, want = _status(dirs["port"]), _status(dirs["jax"])
    assert got.pop("converted_from") and want.pop("converted_from")
    assert got == want


@pytest.mark.parametrize("name", list(IMPORTS))
def test_jax_restores_the_port_import_and_generates_alike(imported, tiny_cfg, name):
    """The JAX Checkpointer restores the port's file; the port's generator
    on the imported weights is within atol 1e-5 (rtol 1e-4) of JAX
    ``generator_apply``; the apply counts reach every leaf. The weights are
    N(0, 1) in every leaf, gammas included, so the f32 gaps of the two
    packages' sums reach 1.8e-5 at |y| = 0.88."""
    tsum, dirs = imported[name]["tsum"], imported[name]["dirs"]
    jstate = JCheckpointer(dirs["port"]).restore(tsum["tag"], jcreate_train_state(tiny_cfg, jax.random.PRNGKey(1)))
    tc = tcfg_of(tiny_cfg)
    pstate = Checkpointer(dirs["port"]).restore(tsum["tag"], create_train_state(tc, "cpu"))
    for field, want in WANT_COUNTS[name].items():
        assert set(getattr(pstate, field).count.values()) == {want or 0}
        assert {int(c) for c in jax.tree_util.tree_leaves(getattr(jstate, field).count)} == {want or 0}
    rng = np.random.default_rng(5)
    noise = rng.normal(size=(3, tiny_cfg.noise_dim)).astype(np.float32)
    cond = rng.uniform(-1, 1, (3, tiny_cfg.cond_dim)).astype(np.float32)
    want = np.asarray(generator_apply(jstate.params, noise, cond, tiny_cfg))
    with torch.no_grad():
        got = pstate.model.generator(torch.from_numpy(noise), torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, want, **PORT_VS_JAX)


# ------------------------------------------------------------- numpy-only


@pytest.mark.parametrize("case", ["missing", "conflicting", "equal-duplicates"])
def test_mapping_edge_cases_match_jax(tiny_cfg, case):
    v = _vars_from_params(_random_params(tiny_cfg))
    if case == "missing":
        del v["adjuster/encoder/conv1/kernel"]
    elif case == "conflicting":
        v["discriminator/encoder/conv1/kernel"] = v["adjuster/encoder/conv1/kernel"] + 1.0
    else:
        v["discriminator/encoder/conv1/kernel"] = v["adjuster/encoder/conv1/kernel"].copy()
    outcomes = []
    for fn in (jref.variables_to_params, tref.variables_to_params):
        try:
            outcomes.append(("ok", fn(v)[2]))
        except Exception as e:  # noqa: BLE001 - the exception type is the result
            outcomes.append((type(e), str(e)))
    assert outcomes[1][0] == {"missing": KeyError, "conflicting": ValueError, "equal-duplicates": "ok"}[case]
    assert outcomes[1] == outcomes[0]  # the same type and message, or the same inferred config


def test_underflowed_beta_powers_match_jax(tiny_cfg):
    v = _vars_from_params(_random_params(tiny_cfg))
    v["discriminator_optimizer/beta1_power"] = np.float32(0.0)  # long run: both underflowed
    v["discriminator_optimizer/beta2_power"] = np.float32(0.0)
    v["generator_optimizer/beta1_power"] = np.float32(0.0)  # t = 2000: beta2's power still exact
    v["generator_optimizer/beta2_power"] = np.float64(0.9 ** 2001)
    jstate, _, jreport = jref.variables_to_train_state(v, beta_1=0.5, beta_2=0.9)
    state, _, report = tref.variables_to_train_state(v, beta_1=0.5, beta_2=0.9, device="cpu")
    assert report == jreport == {"opt_g": 2000, "opt_d": "converged", "opt_a": None}
    assert tref._CONVERGED_COUNT == jref._CONVERGED_COUNT
    assert set(state.opt_d.count.values()) == {int(c) for c in jax.tree_util.tree_leaves(jstate.opt_d.count)} == {
        tref._CONVERGED_COUNT}
    assert set(state.opt_g.count.values()) == {2000} and set(state.opt_a.count.values()) == {0}


# ------------------------------------------------------------------ export


@pytest.fixture(scope="module")
def exported(tiny_cfg, tmp_path_factory):
    """A train state with random weights, EMA, moments and counts (7, 5, 3)
    written by the JAX Checkpointer as ``result/cx/checkpoint/ckpt-4``; the
    port's three entry points export it from the experiment directory, the
    JAX package exports the same state. Also eager outputs of the port's f32
    forward before and after the exports."""
    root = tmp_path_factory.mktemp("compat_export")
    jcfg = tiny_cfg.replace(ema_decay=0.9, all_result_dir=os.fspath(root / "result"), exp_name="cx")
    jstate = _random_state(jcfg)
    JCheckpointer(os.path.join(jcfg.result_dir, "checkpoint")).save("4", jstate, status={"epoch": 5, "step": 12})
    keys = ("image_dim", "init_dim", "noise_dim", "attr", "conv_filter", "all_result_dir", "compute_dtype", "ema_decay")
    (root / "sample.config.json").write_text(json.dumps({k: getattr(jcfg, k) for k in keys}))

    tc = tcfg_of(jcfg)
    pstate = Checkpointer(os.path.join(jcfg.result_dir, "checkpoint")).restore("4", create_train_state(tc, "cpu"))
    eager = tte.export_model(tc, eval_params(pstate), "cpu")
    live = tte.export_model(tc, {n: p.detach() for n, p in pstate.model.named_parameters()}, "cpu")
    rng = np.random.default_rng(9)
    inputs = {b: (rng.normal(size=(b, jcfg.noise_dim)).astype(np.float32),
                  rng.uniform(-1, 1, (b, jcfg.cond_dim)).astype(np.float32),
                  rng.uniform(-1, 1, (b, jcfg.image_dim, jcfg.image_dim, 3)).astype(np.float32)) for b in (1, 3, 5)}

    def forward(model, b):
        z, c, x = (torch.from_numpy(a) for a in inputs[b])
        with torch.no_grad():
            pr, cd = model.discriminator(x)
            return {"generate": model.generator(z, c).numpy(), "adjust": model.adjuster(x, c).numpy(),
                    "pr": pr.numpy(), "cond": cd.numpy()}

    before = forward(eager, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        rcs = {"reference": tref.main(["export", "cx", "--device", "cpu"]),
               "torch_export": tte.main(["cx", "--device", "cpu"]),
               "savedmodel": tsm.main(["cx", "--device", "cpu"])}
    fresh = tte.export_model(tc, eval_params(pstate), "cpu")  # built after the traces
    model_dir = os.path.join(jcfg.result_dir, "model")
    jparams = jeval_params(jstate)
    jdirs = {"reference": os.fspath(root / "jax_reference"), "savedmodel": os.fspath(root / "jax_savedmodel"),
             "stablehlo": os.fspath(root / "jax_stablehlo")}
    jref.export_reference_checkpoint(jstate, jdirs["reference"], tag="4", beta_1=jcfg.beta_1, beta_2=jcfg.beta_2)
    jax_saved_model(jcfg, jparams, jdirs["savedmodel"])
    export_stablehlo(jcfg, jparams, jdirs["stablehlo"], platforms=("cpu",))
    return dict(
        jcfg=jcfg, tc=tc, jstate=jstate, pstate=pstate, inputs=inputs, rcs=rcs, model_dir=model_dir, jdirs=jdirs,
        want={b: forward(eager, b) for b in inputs}, live=forward(live, 3),
        before=before, after=forward(eager, 3), fresh=forward(fresh, 3),
        port_sm=tf.saved_model.load(os.path.join(model_dir, "savedmodel")),
        jax_sm=tf.saved_model.load(jdirs["savedmodel"]),
        pt2={n: torch.export.load(os.path.join(model_dir, "torch_export", f"{n}.pt2")).module() for n in tte.ENTRY_POINTS},
    )


def test_entry_points_write_their_files(exported):
    assert exported["rcs"] == {"reference": 0, "torch_export": 0, "savedmodel": 0}
    d = exported["model_dir"]
    ref = os.path.join(d, "reference-checkpoint")
    assert os.path.isfile(os.path.join(ref, "checkpoint")) and os.path.isfile(os.path.join(ref, "4-1.index"))
    assert _status(ref) == {"epoch": 5, "exported_by": "littlegan_tpu_torch"}  # the reference resumes at the next epoch
    assert sorted(os.listdir(os.path.join(d, "torch_export"))) == [
        "adjust.pt2", "discriminate.pt2", "generate.pt2", "manifest.json"]
    assert os.path.isfile(os.path.join(d, "savedmodel", "saved_model.pb"))


def test_reference_export_equals_jax(exported):
    """The same keys in both TF checkpoints, equal arrays, the beta powers
    to 1e-6 relative."""
    got = tf.train.load_checkpoint(tf.train.latest_checkpoint(os.path.join(exported["model_dir"], "reference-checkpoint")))
    want = tf.train.load_checkpoint(tf.train.latest_checkpoint(exported["jdirs"]["reference"]))
    keys = set(want.get_variable_to_shape_map())
    assert set(got.get_variable_to_shape_map()) == keys
    values = [k for k in keys if k.endswith("/.ATTRIBUTES/VARIABLE_VALUE") and not k.startswith("save_counter")]
    assert len(values) == 46 + 2 * 46 + 6
    for k in values:
        if "_power/" in k:
            np.testing.assert_allclose(got.get_tensor(k), want.get_tensor(k), rtol=POWER_RTOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got.get_tensor(k), want.get_tensor(k), err_msg=k)


def _assert_states_equal(got, want):
    for (n, p), (m, q) in zip(got.model.named_parameters(), want.model.named_parameters()):
        assert n == m and torch.equal(p, q), n
    for field in ("opt_g", "opt_d", "opt_a"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.count == b.count, field
        for k in b.mu:
            assert torch.equal(a.mu[k], b.mu[k].float()) and torch.equal(a.nu[k], b.nu[k].float()), (field, k)


def test_import_after_export_is_bit_for_bit(exported):
    ref = os.path.join(exported["model_dir"], "reference-checkpoint")
    jcfg = exported["jcfg"]
    state, inferred, report = tref.variables_to_train_state(
        tref.read_reference_variables(ref), beta_1=jcfg.beta_1, beta_2=jcfg.beta_2, device="cpu")
    assert report == {"opt_g": 7, "opt_d": 5, "opt_a": 3}
    assert inferred["conv_filter"] == jcfg.conv_filter
    _assert_states_equal(state, exported["pstate"])


@pytest.mark.parametrize("use_ema", [False, True])
def test_state_to_variables_inverts_the_import_without_tf(exported, use_ema):
    """The numpy half: what the TF write places, array for array, and the
    importer's exact inverse; ``use_ema`` swaps in the EMA generator parts."""
    pstate, jcfg = exported["pstate"], exported["jcfg"]
    variables, report = tref.state_to_variables(pstate, jcfg.beta_1, jcfg.beta_2, use_ema=use_ema)
    assert report == {"opt_g": 7, "opt_d": 5, "opt_a": 3}
    state, _, _ = tref.variables_to_train_state(variables, jcfg.beta_1, jcfg.beta_2, device="cpu")
    if use_ema:
        got = dict(state.model.named_parameters())
        assert all(torch.equal(got[k], e) for k, e in pstate.ema.items()) and len(pstate.ema) == 22
        assert not all(torch.equal(got[k], dict(pstate.model.named_parameters())[k]) for k in pstate.ema)
        return
    _assert_states_equal(state, pstate)
    written = tref.read_reference_variables(os.path.join(exported["model_dir"], "reference-checkpoint"))
    assert sorted(written) == sorted(variables)
    for k, v in variables.items():
        assert written[k].dtype == v.dtype and written[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("b", [1, 3])
def test_savedmodel_matches_jax_and_the_port_on_ema_weights(exported, b):
    z, c, x = (tf.constant(a) for a in exported["inputs"][b])
    port, jx, want = exported["port_sm"], exported["jax_sm"], exported["want"][b]
    got = {"generate": port.generate(z, c).numpy(), "adjust": port.adjust(x, c).numpy()}
    jgot = {"generate": jx.generate(z, c).numpy(), "adjust": jx.adjust(x, c).numpy()}
    for res, out in ((got, port.discriminate(x)), (jgot, jx.discriminate(x))):
        res.update(pr=out["pr"].numpy(), cond=out["cond"].numpy())
    for k in want:
        np.testing.assert_allclose(got[k], jgot[k], **PORT_VS_JAX, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], **SAME_PACKAGE, err_msg=k)
    if b == 3:  # the EMA generator, not the live one
        assert np.abs(got["generate"] - exported["live"]["generate"]).max() > 1e-2
    assert set(port.signatures) == {"generate", "adjust", "discriminate"}
    (val,) = port.signatures["generate"](noise=z, cond=c).values()
    np.testing.assert_array_equal(val.numpy(), got["generate"])


@pytest.mark.parametrize("b", [1, 3, 5])
def test_torch_export_reloads_within_1e6_of_the_forward(exported, b):
    z, c, x = (torch.from_numpy(a) for a in exported["inputs"][b])
    pt2, want = exported["pt2"], exported["want"][b]
    d = pt2["discriminate"](x)
    got = {"generate": pt2["generate"](z, c), "adjust": pt2["adjust"](x, c), "pr": d["pr"], "cond": d["cond"]}
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], rtol=0, atol=PT2_ATOL, err_msg=k)


def test_torch_export_matches_jax_stablehlo(exported):
    inputs, pt2, d = exported["inputs"][3], exported["pt2"], exported["jdirs"]["stablehlo"]
    z, c, x = inputs
    jx = {}
    for name in tte.ENTRY_POINTS:
        with open(os.path.join(d, f"{name}.jaxexport.bin"), "rb") as f:
            jx[name] = jexport.deserialize(bytearray(f.read()))
    jd = jx["discriminate"].call(x)
    want = {"generate": jx["generate"].call(z, c), "adjust": jx["adjust"].call(x, c), "pr": jd["pr"], "cond": jd["cond"]}
    zt, ct, xt = (torch.from_numpy(a) for a in inputs)
    td = pt2["discriminate"](xt)
    got = {"generate": pt2["generate"](zt, ct), "adjust": pt2["adjust"](xt, ct), "pr": td["pr"], "cond": td["cond"]}
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), **PORT_VS_JAX, err_msg=k)


def test_torch_export_manifest(exported):
    with open(os.path.join(exported["model_dir"], "torch_export", "manifest.json")) as f:
        m = json.load(f)
    jcfg = exported["jcfg"]
    assert m["image_dim"] == jcfg.image_dim and m["device"] == "cpu" and m["torch_version"] == torch.__version__
    img = f"float32[b,{jcfg.image_dim},{jcfg.image_dim},3]"
    want = {"generate": ([f"float32[b,{jcfg.noise_dim}]", f"float32[b,{jcfg.cond_dim}]"], [img]),
            "adjust": ([img, f"float32[b,{jcfg.cond_dim}]"], [img]),
            "discriminate": ([img], ["float32[b,1]", f"float32[b,{jcfg.cond_dim}]"])}
    for name, (ins, outs) in want.items():
        e = m["entry_points"][name]
        assert (e["in_avals"], e["out_avals"], e["device"]) == (ins, outs, "cpu")
        assert e["pt2_bytes"] == os.path.getsize(os.path.join(exported["model_dir"], "torch_export", f"{name}.pt2"))
    with pytest.raises(ValueError, match="non-empty subset"):
        tte.export_torch(exported["tc"], {}, exported["model_dir"], include=("sample",), device="cpu")


def test_eager_forward_unchanged_by_an_export(exported):
    """Tracing leaves nothing behind: the same model before and after the
    exports, and a model built after them, give the same outputs."""
    before = exported["before"]
    for k in before:
        np.testing.assert_array_equal(exported["after"][k], before[k], err_msg=k)
        np.testing.assert_array_equal(exported["fresh"][k], before[k], err_msg=k)


def test_s2d_index_buffers_are_not_state(tiny_cfg):
    """The s2d gather indices ride the modules as non-persistent buffers:
    out of ``state_dict`` (checkpoints and ``load_state_dict`` see the
    parameters only), moved by ``.to``."""
    model = init_params(tcfg_of(tiny_cfg))
    names = {n for n, _ in model.named_buffers()}
    assert names == {"encoder.s2d_conv1_ih", "encoder.s2d_conv1_iw", "decoder.s2d_deconv_ih",
                     "decoder.s2d_deconv_iw", "out_conv.s2d_outconv_ih", "out_conv.s2d_outconv_iw"}
    assert set(model.state_dict()) == {n for n, _ in model.named_parameters()}
