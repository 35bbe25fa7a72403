"""The port's measurement and campaign tools against the JAX repo's
scripts, on the CPU (``--device cpu`` or ``--virtual``; without either and
without a card each tool exits non-zero and prints no result).

- ``autotune``: one point and a ``RECOMMEND`` line, as
  ``tests/test_scripts_smoke.py`` runs the JAX script; a point that fails
  is printed with its error and listed under ``failed``;
- ``serve_bench`` at 16²: every measurement line, and the reload drill with
  0 dropped requests and both reloads applied;
- ``scaling_curve --virtual 2``: DP points at 1 and 2 ranks and a spatial
  point on a [1, 2] mesh, each of gloo rank processes; a count above the
  visible ranks is refused;
- ``make_structured_data``: the same files, byte for byte, as the JAX
  script for the same seed and arguments, in both geometries and the zip
  form (the zip's member times pinned to one clock for both);
- ``campaign`` at 16², 64 images, one epoch, ``--fid-n 32 --eval-chunk
  16``: a trajectory with 7 generator and 7 adjuster effects, the losses
  and the ``*_trend_random_init`` keys (never a bare ``fid``); the refusal
  of a ``--fid-n`` that is no multiple of the chunk; its effect-size
  helpers against the JAX campaign's own (read from its source) on the
  same weights (``params_from_jax``) and noise, within 1e-5.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from littlegan_tpu.training.checkpoint import _flatten
from littlegan_tpu_torch.compat.jax_params import params_from_jax
from littlegan_tpu_torch.config import Config as TConfig
from littlegan_tpu_torch.models.littlegan import LittleGAN
from littlegan_tpu_torch.scripts import autotune, campaign, make_structured_data, scaling_curve, serve_bench
from torch_dp_common import REPO
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}_under_test", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_lines(out: str):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ---------------------------------------------------------------- autotune --

def test_autotune_one_point_and_recommend(tmp_path, capsys):
    out = tmp_path / "rec.json"
    rc = autotune.main(["--device", "cpu", "--dim", "16", "--batch", "4", "--ks", "2", "--skip-adj-half",
                        "--skip-moment-dtype", "--measure-dispatches", "1", "--out", str(out)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert rc == 0
    points = _json_lines("\n".join(lines))
    assert len(points) == 1 and points[0]["steps_per_dispatch"] == 2 and points[0]["step_ms"] > 0
    # images_per_sec is rounded to 0.1 and step_ms to 0.001 ms: half the first step, 1e-3 for the second
    want = 2 * 4 / (points[0]["step_ms"] / 1e3)
    assert points[0]["images_per_sec"] == pytest.approx(want, abs=0.05 + 1e-3 * want)
    rec_lines = [ln for ln in lines if ln.startswith("RECOMMEND ")]
    assert len(rec_lines) == 1
    rec = json.loads(rec_lines[0][len("RECOMMEND "):])
    assert rec["parity"] == rec["fastest"] and rec["opt_ins"] == [] and rec["failed"] == []
    assert rec["device_kind"] == "cpu" and rec["config_snippet"] == {"steps_per_dispatch": 2, "device_data": True}
    assert json.loads(out.read_text())["parity"]["steps_per_dispatch"] == 2


def test_autotune_reports_a_failed_point(monkeypatch, capsys):
    """A point whose harness raises is printed with its error and listed in
    RECOMMEND's ``failed``; with no point measured the run exits 1."""
    from littlegan_tpu_torch import bench

    real = bench.build_scan_harness

    def harness(cfg, k, **kw):
        if k == 3:
            raise RuntimeError("graph capture failed at K=3")
        return real(cfg, k=k, **kw)

    monkeypatch.setattr(bench, "build_scan_harness", harness)
    base = ["--device", "cpu", "--dim", "16", "--batch", "2", "--skip-adj-half", "--skip-moment-dtype",
            "--measure-dispatches", "1"]
    assert autotune.main(base + ["--ks", "1,3"]) == 0
    out = capsys.readouterr().out
    points = _json_lines(out)
    assert [p.get("error") for p in points] == [None, "RuntimeError: graph capture failed at K=3"]
    rec = json.loads(next(ln for ln in out.splitlines() if ln.startswith("RECOMMEND "))[len("RECOMMEND "):])
    assert rec["failed"] == [points[1]] and rec["fastest"]["steps_per_dispatch"] == 1
    assert autotune.main(base + ["--ks", "3"]) == 1


def test_tools_without_a_card_exit_nonzero_and_print_no_result(no_card, tmp_path, capsys):
    assert autotune.main([]) == 2
    assert serve_bench.main([]) == 2
    assert scaling_curve.main(["--out", str(tmp_path / "c.json")]) == 2
    assert campaign.main(["x", "--data", str(tmp_path / "d"), "--result-dir", str(tmp_path / "r")]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    assert not (tmp_path / "d").exists() and not (tmp_path / "c.json").exists()


# ------------------------------------------------------------- serve_bench --

def test_serve_bench_on_the_cpu(capsys):
    rc = serve_bench.main(["--device", "cpu", "--dim", "16", "--batch", "4", "--calls", "8", "--threads", "4",
                           "--reload"])
    lines = _json_lines(capsys.readouterr().out)
    assert rc == 0
    by = {ln["metric"]: ln for ln in lines}
    assert sorted(by) == sorted(["serve_generate_sustained", "serve_generate_latency_1", "serve_adjust_latency_1",
                                 "serve_discriminate_latency_1", "serve_generate_batched_concurrent",
                                 "serve_generate_latency_during_hot_reload"])
    assert by["serve_generate_sustained"]["value"] > 0 and by["serve_generate_sustained"]["device_kind"] == "cpu"
    assert by["serve_generate_latency_1"]["samples"] == 10
    assert by["serve_generate_batched_concurrent"]["samples"] == 16
    drill = by["serve_generate_latency_during_hot_reload"]
    assert drill["dropped"] == 0 and drill["reloaded"] == ["checkpoint/2", "checkpoint/3"]
    assert drill["requests_total"] > drill["requests_in_reload_windows"] > 0
    assert len(drill["reload_apply_ms"]) == 2
    assert not any("rtt_inclusive" in ln for ln in lines)


# ----------------------------------------------------------- scaling_curve --

def test_scaling_curve_virtual_dp_and_spatial(tmp_path, capsys):
    out = tmp_path / "curve.json"
    rc = scaling_curve.main(["--virtual", "2", "--batch", "2", "--iters", "2", "--warmup", "1", "--out", str(out),
                             "--trace", str(tmp_path / "trace")])
    assert rc == 0
    rows = json.loads(out.read_text())["results"]
    assert [(r["regime"], r["n_devices"], r["batch_global"]) for r in rows] == [
        ("dp", 1, 2), ("dp", 2, 4), ("spatial_model2", 2, 2)]
    assert all(r["backend"] == "cpu-virtual" and r["dim"] == 16 and r["step_ms"] > 0 for r in rows)
    for r in rows:
        assert r["img_s_chip"] == pytest.approx(r["img_s"] / r["n_devices"], abs=0.1)
        # img_s is rounded to 0.1 and step_ms to 0.001 ms: half the first step, 1e-3 for the second
        want = 1000.0 / r["step_ms"] * r["batch_global"]
        assert r["img_s"] == pytest.approx(want, abs=0.05 + 1e-3 * want)
    assert rows[0]["efficiency"] == 1.0 and rows[2]["efficiency"] > 0
    for tag, ranks in (("dp_n1", 1), ("dp_n2", 2), ("spatial_n2", 2)):
        assert sorted(os.listdir(tmp_path / "trace" / tag)) == [f"rank{r}.json" for r in range(ranks)]
    assert _json_lines(capsys.readouterr().out) == rows


def test_scaling_curve_refuses_more_ranks_than_visible(tmp_path):
    with pytest.raises(SystemExit, match=r"card counts \[4\] exceed the 2 visible"):
        scaling_curve.main(["--virtual", "2", "--devices", "1,4", "--out", str(tmp_path / "c.json")])


# ---------------------------------------------------- make_structured_data --

def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("geometry,as_zip,attr_rows", [("square", False, 0), ("square", True, 40),
                                                       ("celeba", False, 25), ("celeba", True, 0)])
def test_structured_data_byte_for_byte_with_the_jax_script(tmp_path, monkeypatch, geometry, as_zip, attr_rows):
    monkeypatch.setattr(zipfile.time, "time", lambda: 1.7e9)  # both zips' member times from one clock
    jax_gen = _script("make_structured_data").generate
    jax_gen(str(tmp_path / "jax"), 6, 24, geometry=geometry, as_zip=as_zip, attr_rows=attr_rows)
    make_structured_data.generate(str(tmp_path / "port"), 6, 24, geometry=geometry, as_zip=as_zip,
                                  attr_rows=attr_rows)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(want) == (2 if as_zip else 7)
    for name in want:
        assert got[name] == want[name], name


def test_structured_data_cli(tmp_path):
    assert make_structured_data.main([str(tmp_path / "cli"), "3", "16"]) == 0
    _script("make_structured_data").generate(str(tmp_path / "jax"), 3, 16)
    assert _tree(tmp_path / "cli") == _tree(tmp_path / "jax")


# ---------------------------------------------------------------- campaign --

def test_campaign_end_to_end(tmp_path, capsys):
    rc = campaign.main(["smoke", "--epochs", "1", "--eval-every", "1", "--dim", "16", "--n", "64",
                        "--batch-size", "4", "--fid-n", "32", "--eval-chunk", "16", "--eval-rows", "4",
                        "--data", str(tmp_path / "data"), "--result-dir", str(tmp_path / "result"),
                        "--device", "cpu"])
    assert rc == 0
    records = json.loads((tmp_path / "result" / "smoke" / "campaign_trajectory.json").read_text())
    assert len(records) == 1
    rec = records[0]
    assert rec["epoch"] == 1 and rec["global_step"] == 8  # 64 images, batch 4, 2 batches per step
    assert len(rec["gen_effects"]) == 7 and len(rec["adj_effects"]) == 7
    assert set(rec["losses"]) >= {"loss/gen", "loss/disc"}
    for key in ("fid_trend_random_init", "is_trend_random_init", "kid_trend_random_init"):
        assert np.isfinite(rec[key]), key
    assert set(rec["prdc_trend_random_init"]) == {"precision", "recall", "density", "coverage"}
    assert "fid" not in rec and 0 <= rec["d_cond_acc"] <= 1
    assert (tmp_path / "result" / "smoke" / "checkpoint" / "ckpt-1.npz").is_file()
    assert "EVAL " in capsys.readouterr().out


def test_campaign_refuses_a_fid_n_off_the_chunk(tmp_path):
    with pytest.raises(SystemExit, match="multiple of the eval chunk"):
        campaign.main(["smoke2", "--dim", "16", "--n", "64", "--batch-size", "4", "--fid-n", "33",
                       "--eval-chunk", "16", "--data", str(tmp_path / "d"), "--result-dir", str(tmp_path / "r"),
                       "--device", "cpu"])
    assert not (tmp_path / "d").exists()  # refused before any data or training


def _jax_campaign_helpers(jcfg):
    """``region_means``, ``gen_stats`` and ``adj_stats`` as the JAX
    campaign's ``main`` defines them, compiled from its source."""
    from littlegan_tpu.models import adjuster_apply, generator_apply

    with open(os.path.join(REPO, "scripts", "campaign.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef)
            and n.name in ("region_means", "gen_stats", "adj_stats")]
    assert len(defs) == 3
    ns = {"jax": jax, "jnp": jnp, "generator_apply": generator_apply, "adjuster_apply": adjuster_apply,
          "cfg0": jcfg}
    exec(compile(ast.Module(body=defs, type_ignores=[]), "scripts/campaign.py", "exec"), ns)
    return ns


def test_campaign_effect_helpers_equal_jax(tiny_cfg):
    from littlegan_tpu.models import init_params
    from littlegan_tpu_torch.utils.image import soft

    jcfg = tiny_cfg
    params = init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    model = params_from_jax(_flatten(params), LittleGAN(tcfg)).eval()
    jx = _jax_campaign_helpers(jcfg)
    rng = np.random.default_rng(7)
    rows, c = 6, jcfg.cond_dim
    noise = rng.normal(size=(rows, jcfg.noise_dim)).astype(np.float32)
    base_cond = np.full((rows, c), soft(-1.0), np.float32)
    images = rng.uniform(-1, 1, (rows, jcfg.image_dim, jcfg.image_dim, 3)).astype(np.float32)
    t = torch.from_numpy

    x = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(campaign.region_means(t(x)).numpy(), np.asarray(jx["region_means"](x)), atol=1e-6)
    np.testing.assert_allclose(campaign.gen_stats(model, t(noise), t(base_cond)).numpy(),
                               np.asarray(jx["gen_stats"](params, noise, base_cond)), atol=1e-5)

    # the JAX eval_point's loops over its own helpers
    g_base = np.asarray(jx["gen_stats"](params, noise, base_cond))
    want_gen = []
    for j in range(c):
        cj = base_cond.copy()
        cj[:, j] = soft(1.0)
        want_gen.append(float(np.asarray(jx["gen_stats"](params, noise, cj))[j] - g_base[j]))
    want_adj = []
    for j in range(c):
        on = np.full((rows, c), (soft(-1.0) + 1) / 2, np.float32)
        off = on.copy()
        on[:, j] = (soft(1.0) + 1) / 2
        want_adj.append(float(np.asarray(jx["adj_stats"](params, images, on))[j]
                              - np.asarray(jx["adj_stats"](params, images, off))[j]))
    got_gen = campaign.generator_effects(model, t(noise), t(base_cond))
    got_adj = campaign.adjuster_effects(model, t(images), c)
    np.testing.assert_allclose(got_gen, want_gen, atol=1e-5)
    np.testing.assert_allclose(got_adj, want_adj, atol=1e-5)
    assert max(map(abs, want_gen + want_adj)) > 1e-4  # the effects are not all zero: the comparison bites
