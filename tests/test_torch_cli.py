"""Every mode of ``python -m littlegan_tpu_torch`` end to end on the CPU.

The port's counterpart of tests/test_cli.py: each test drives
``cli.main([...,"--device", "cpu"])`` on synthetic data with a tiny config
in a temporary workspace (config files are read from the current
directory) and checks the mode's artifacts. The sampling grids of
``condition-sample`` and ``interpolate`` are held against the JAX CLI's on
the same checkpoint: the same draws from ``np.random.default_rng(seed)``,
so the decoded JPEGs agree within ``GRID_LEVELS`` levels (float32 outputs
within 1e-4, then JPEG coding). A last test scans the port's sources: no
module imports JAX or the JAX package.
"""

import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from littlegan_tpu_torch import cli

REPO = pathlib.Path(__file__).resolve().parent.parent
GRID_LEVELS = 3
TINY = {
    "batch_size": 4,
    "image_dim": 16,
    "init_dim": 1,
    "noise_dim": 13,
    "attr": [0, 1, 2, 3, 4, 5, 6],
    "conv_filter": [24, 16, 12, 8, 4],
    "compute_dtype": "float32",
    "epoch": 1,
    "freq_gen": 2,
    "freq_test": 4,
    "train_adj": True,
    "random_sample_batch": 2,
    "condition_sample_batch": 2,
    "evaluate_sample_size": 8,
    "allow_random_fid": True,
    "debug": True,
}


def run(*argv) -> int:
    return cli.main([*argv, "--device", "cpu"])


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A config-on-cwd workspace with one trained experiment."""
    root = tmp_path_factory.mktemp("torch_cli")
    cfg = dict(TINY, all_result_dir=str(root / "result"), test_data_dir=str(root / "test-data"))
    (root / "sample.config.json").write_text(json.dumps(cfg))
    old = os.getcwd()
    os.chdir(root)
    try:
        assert run("train", "exp", "--debug", "--synthetic-data") == 0
        yield root / "result" / "exp"
    finally:
        os.chdir(old)


def _env_file(name, **kw):
    with open("sample.config.json") as f:
        base = json.load(f)
    with open(f"{name}.config.json", "w") as f:
        json.dump({**base, **kw}, f)


def test_mode_train_artifacts(workspace):
    assert (workspace / "checkpoint" / "ckpt-1.npz").is_file() and (workspace / "config.json").is_file()
    assert list((workspace / "train" / "gen").iterdir()) and list((workspace / "test" / "disc").iterdir())
    assert list((workspace / "log").iterdir())


def test_mode_plot(workspace, capsys):
    assert run("plot", "exp") == 0
    text = (workspace / "models.txt").read_text()
    for model in ("Encoder", "Decoder", "Discriminator", "Generator", "Adjuster"):
        assert f"Model: {model}" in text and (workspace / f"{model}.dot").is_file()
    assert "total parameters" in capsys.readouterr().out


def test_mode_visual_fallback(workspace, capsys, monkeypatch):
    """Without a tensorboard binary (rc 127) visual serves the built-in
    report; the command is an argv list; a Ctrl-C'd server (rc 130) is not
    'unavailable'."""
    from littlegan_tpu_torch import report

    calls, served = [], []

    class _RC:
        def __init__(self, rc):
            self.returncode = rc

    monkeypatch.setattr(subprocess, "run", lambda argv, **kw: (calls.append(argv), _RC(127))[1])
    monkeypatch.setattr(report, "serve_report", lambda cfg, port: served.append((cfg.exp_name, port)))
    assert run("visual", "exp", "--port", "8611") == 0
    assert "tensorboard unavailable" in capsys.readouterr().out
    assert calls == [["tensorboard", "--host", "0.0.0.0", "--logdir", str(workspace / "log")]]
    assert served == [("exp", 8611)]
    monkeypatch.setattr(subprocess, "run", lambda argv, **kw: _RC(130))
    assert run("visual", "exp") == 0
    assert "tensorboard unavailable" not in capsys.readouterr().out and len(served) == 1


def test_serve_report_live(workspace):
    """serve_report regenerates the report per request and answers a render
    failure with 500 without going down."""
    import queue
    import threading
    import urllib.error
    import urllib.request

    from littlegan_tpu_torch import report
    from littlegan_tpu_torch.config import load_config

    cfg = load_config("sample", {"exp_name": "exp"})
    for c, n in ((cfg, 2), (cfg.replace(exp_name="no-such-exp"), 1)):
        ports = queue.Queue()
        t = threading.Thread(target=report.serve_report, args=(c,),
                             kwargs=dict(port=0, max_requests=n, on_bound=ports.put), daemon=True)
        t.start()
        port = ports.get(timeout=30)
        for _ in range(n):
            if c is cfg:
                with urllib.request.urlopen(f"http://localhost:{port}/", timeout=30) as r:
                    body = r.read().decode()
                assert '<svg id="losschart"' in body and "optimizer steps" in body
            else:
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(f"http://localhost:{port}/", timeout=30)
                assert ei.value.code == 500 and "report generation failed" in ei.value.read().decode()
        t.join(timeout=30)
        assert not t.is_alive()


def test_mode_random_sample(workspace):
    assert run("random-sample", "exp", "--synthetic-data") == 0
    sample = workspace / "sample"
    names = {p.name for p in sample.iterdir()}
    for b in range(TINY["random_sample_batch"]):
        for prefix, ext in (("generator", "jpg"), ("discriminator", "json"), ("adjuster", "jpg"),
                            ("input_data", "npz")):
            assert any(n.startswith(f"{prefix}-") and n.endswith(f"-{b}.{ext}") for n in names), (prefix, b)
    npz = sorted(p for p in sample.iterdir() if p.name.startswith("input_data-"))[0]
    with np.load(npz) as z:
        assert z["n"].shape == (4, 13) and z["i"].shape == (4, 16, 16, 3)


def test_mode_evaluate_sample(workspace):
    assert run("evaluate-sample", "exp", "--synthetic-data") == 0
    ev = workspace / "evaluate"
    n = TINY["evaluate_sample_size"]
    assert {p.name for p in (ev / "gen").iterdir()} == {f"{i}.jpg" for i in range(1, n + 1)}
    assert {p.name for p in (ev / "adj").iterdir()} == {f"{k}_{i}.jpg" for k in ("real", "fake")
                                                          for i in range(1, n + 1)}
    disc = sorted(p.name for p in (ev / "disc").iterdir())
    assert disc == ["0.json", "1.json"]
    assert len(json.loads((ev / "disc" / "0.json").read_text())["fake_pr"]) == 4


def _precalculated(workspace, **kw):
    from littlegan_tpu_torch.config import load_config
    from littlegan_tpu_torch.eval.evaluate import precalculate

    if not (workspace / "evaluate" / "gen" / "1.jpg").is_file():
        assert run("evaluate-sample", "exp", "--synthetic-data") == 0
    cfg = load_config("sample", {"exp_name": "exp", "mode": "evaluate"})
    cfg.extra["device"] = "cpu"
    precalculate(cfg, str(workspace / "evaluate" / "gen"), os.path.join(cfg.test_data_dir,
                 cfg.evaluate_pre_calculated), batch_size=4, **kw)


def test_mode_evaluate(workspace, capsys):
    _precalculated(workspace, save_features=16)
    _env_file("metrics", eval_metrics=["fid", "is", "kid", "prdc"])
    assert run("evaluate", "exp", "-e", "metrics") == 0
    out = capsys.readouterr().out
    assert "(gen):" in out and "(adj):" in out
    for log in ("fid-gen.log", "fid-adj.log"):
        text = (workspace / "evaluate" / log).read_text()
        for tag in ("FID[RANDOM-INIT", "IS[RANDOM-INIT", "KID[RANDOM-INIT", "PRDC[RANDOM-INIT"):
            assert tag in text, (log, tag)
    _env_file("bad", eval_metrics=["fid", "ssim"])
    with pytest.raises(ValueError, match="ssim"):
        run("evaluate", "exp", "-e", "bad")


def test_mode_export_model(workspace):
    """A weights-only npz that restores into the JAX package's template."""
    import jax

    from littlegan_tpu.config import load_config
    from littlegan_tpu.models import init_params
    from littlegan_tpu.training.checkpoint import Checkpointer

    assert run("export-model", "exp") == 0
    cfg = load_config("sample", {"exp_name": "exp"})
    template = init_params(cfg, jax.random.PRNGKey(0))
    restored = Checkpointer(str(workspace / "model")).restore("model", template)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(template)


def _decoded(path):
    from PIL import Image

    return np.asarray(Image.open(path), np.int32)


def test_condition_sample_and_interpolate_grids_match_jax_cli(workspace):
    """The JAX CLI and the port's on the same (port-written) checkpoint and
    seed: the same grids, within GRID_LEVELS of JPEG-decoded pixels."""
    from littlegan_tpu import cli as jcli

    _env_file("interp", interpolate_rows=3, interpolate_steps=4, seed=7)
    sample = workspace / "sample"
    grids = {}
    for name, main in (("jax", jcli.main), ("torch", lambda argv: run(*argv))):
        before = set(sample.glob("interpolate-*.jpg"))
        assert main(["condition-sample", "exp"]) == 0
        assert main(["interpolate", "exp", "-e", "interp"]) == 0
        new = sorted(set(sample.glob("interpolate-*.jpg")) - before)
        grids[name] = [_decoded(sample / f"condition-gen-{i}.jpg") for i in (1, 2)]
        grids[name] += [_decoded(p) for p in sorted(new, key=lambda p: p.name.split("-")[1])]
        time.sleep(1.1)  # interpolate's file names carry the second
    assert [g.shape for g in grids["torch"]] == [g.shape for g in grids["jax"]] == [
        (16, 128, 3), (16, 128, 3), (7 * 16, 4 * 16, 3), (3 * 16, 4 * 16, 3)]
    for got, want in zip(grids["torch"], grids["jax"]):
        assert np.abs(got - want).max() <= GRID_LEVELS


def test_mode_interpolate_rejects_degenerate_geometry(workspace):
    _env_file("badinterp", interpolate_steps=1)
    with pytest.raises(ValueError, match="interpolate_steps"):
        run("interpolate", "exp", "-e", "badinterp")


def test_mode_report(workspace):
    assert run("report", "exp") == 0
    doc = (workspace / "report.html").read_text()
    for part in ('<svg id="losschart"', "polyline", "data:image/jpeg;base64,", "optimizer steps",
                 "<table class='cfg'>"):
        assert part in doc, part


def test_mode_train_refuses_missing_dataset(workspace):
    with pytest.raises(FileNotFoundError):
        run("train", "exp2", "--debug")


def test_unknown_mode_rejected():
    with pytest.raises(SystemExit):
        run("frobnicate", "exp")


def test_missing_env_file_refused(workspace):
    with pytest.raises(FileNotFoundError, match="config environment"):
        run("plot", "exp", "-e", "porduction")


def test_serve_mode_parses_knobs(workspace):
    cfg = cli.parse_config(["serve", "exp", "--port", "1234", "--reload-every", "5", "--devices", "1"])
    assert (cfg.mode, cfg.extra["serve_port"], cfg.extra["serve_reload_every"], cfg.extra["serve_devices"]) == (
        "serve", 1234, 5.0, 1)
    assert "serve_devices" not in cli.parse_config(["serve", "exp"]).extra


def test_serve_devices_above_one_exits_2(workspace, capsys):
    assert run("serve", "exp", "--devices", "2") == 2
    assert "ROADMAP A13" in capsys.readouterr().err


def test_serve_mode_end_to_end(workspace):
    """``serve`` on the trained experiment in a subprocess (serve() installs
    its signal handlers in the main thread): /healthz and /generate answer,
    SIGTERM drains."""
    import urllib.request

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "littlegan_tpu_torch", "serve", "exp", "--device", "cpu", "--port", "0",
         "--batch-size", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=os.getcwd(), env=env,
    )
    try:
        deadline, lines, port = time.monotonic() + 120, [], None
        while time.monotonic() < deadline and port is None:
            line = proc.stdout.readline()
            lines.append(line)
            m = re.search(r"serving on [\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
            if not line and proc.poll() is not None:
                break
        assert port, lines
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                     data=json.dumps({"cond": [[0.98] * 7], "seed": 1}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert len(json.load(r)["images"]) == 1
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "drained, socket closed" in out, out
    assert proc.returncode == 0


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """No import of ``jax`` or ``littlegan_tpu`` anywhere in the port's
    sources or ``chip_smoke.py``, lazy imports inside functions included."""
    pat = re.compile(r"^\s*(from\s+(jax|jaxlib|littlegan_tpu)(\.|\s)|import\s+(jax|jaxlib|littlegan_tpu)(\.|\s|$|,))")
    files = sorted((REPO / "littlegan_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [f"{f.relative_to(REPO)}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert len(files) > 30 and bad == []
