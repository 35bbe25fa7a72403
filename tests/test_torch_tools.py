"""The port's tools against the JAX package's scripts, on the CPU.

- ``littlegan_tpu_torch.scripts.doctor``: with ``--device cpu`` in an empty
  directory it exits 0, ``devices`` and ``train-step`` PASS, ``image_path``
  WARNs, and its summary has the keys of ``scripts/doctor.py``'s, run in
  the same test; without ``--device cpu`` on a host without a card it exits
  1 with ``devices`` FAIL (never a CPU fallback);
- ``littlegan_tpu_torch.scripts.memory_report``: the JSON line's analytic
  fields equal ``scripts/memory_report.py``'s for the same arguments;
  ``--measure`` without a card exits 1 and prints no result line;
  ``--topology`` is refused;
- ``littlegan_tpu_torch.scripts.verify_conditioning``: on a tiny structured
  set (``scripts/make_structured_data.py``) and one npz checkpoint, each
  attribute's delta agrees with ``scripts/verify_conditioning.py``'s within
  1e-4 (float32), and the D cond-head accuracy and both "learned" counts
  are equal;
- no entry point takes ``--kernels``: the kernels run wherever the tensor
  is on the card, and argparse refuses the option.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_dp_common import REPO
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------- --kernels --

KERNELS_ENTRY_POINTS = {
    "bench": [], "scripts.serve_bench": [], "scripts.scaling_curve": [], "scripts.autotune": [],
    "scripts.campaign": ["exp"], "scripts.memory_report": [], "dryrun": ["1"],
}


@pytest.mark.parametrize("module", sorted(KERNELS_ENTRY_POINTS))
def test_no_entry_point_takes_a_kernels_option(module, capsys):
    mod = importlib.import_module(f"littlegan_tpu_torch.{module}")
    with pytest.raises(SystemExit) as exc:
        mod.main([*KERNELS_ENTRY_POINTS[module], "--kernels"])
    assert exc.value.code == 2
    assert "unrecognized arguments: --kernels" in capsys.readouterr().err


# ------------------------------------------------------------------ doctor --

def test_doctor_on_the_cpu_matches_the_jax_summary(tmp_path, monkeypatch, capsys):
    from littlegan_tpu_torch.scripts import doctor

    monkeypatch.chdir(tmp_path)  # config resolution is cwd-based
    rc = doctor.main(["--device", "cpu"])
    summary = _last_json(capsys.readouterr().out)
    assert rc == 0 and summary["ok"] is True
    by_check = {r["check"]: r["level"] for r in summary["results"]}
    assert by_check["devices"] == "PASS"
    assert by_check["train-step"] == "PASS"
    assert by_check["image_path"] == "WARN"  # no CelebA here: a WARN, not a failure
    assert by_check["cuda-build"] == "WARN"
    for name in ("native-loader", "dep:tensorflow", "dep:scipy", "attr_path", "fid_weights",
                 "evaluate_pre_calculated"):
        assert name in by_check
    assert _script("doctor").main([]) == 0
    jax_summary = _last_json(capsys.readouterr().out)
    assert summary.keys() == jax_summary.keys()
    assert {tuple(sorted(r)) for r in summary["results"]} == {tuple(sorted(r)) for r in jax_summary["results"]}


def test_doctor_without_a_card_fails_and_never_falls_back(tmp_path, monkeypatch, capsys):
    from littlegan_tpu_torch.scripts import doctor

    monkeypatch.chdir(tmp_path)
    rc = doctor.main([])
    summary = _last_json(capsys.readouterr().out)
    first = summary["results"][0]
    assert first["check"] == "devices"
    if torch.cuda.is_available():  # a host with a card checks the card
        assert first["level"] == "PASS" and "cpu" not in first["detail"].lower()
    else:
        assert rc == 1 and summary["ok"] is False
        assert first["level"] == "FAIL"
        assert [r["check"] for r in summary["results"]] == ["devices"]  # nothing ran on the CPU instead


# ----------------------------------------------------------- memory report --

REPORT_ARGS = [
    ["--dim", "128", "--batch", "32"],
    ["--dim", "128", "--batch", "32", "--mesh", "data=4"],
    ["--dim", "128", "--batch", "32", "--mesh", "data=2,model=2", "--shard-opt-state", "--shard-dense"],
    ["--dim", "256", "--batch", "8", "--moment-dtype", "bfloat16", "--ema", "0.999"],
]


@pytest.mark.parametrize("args", REPORT_ARGS, ids=[" ".join(a) for a in REPORT_ARGS])
def test_memory_report_json_equals_the_jax_script(args, monkeypatch, capsys):
    from littlegan_tpu_torch.scripts import memory_report

    assert memory_report.main(args) == 0
    got = _last_json(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["memory_report.py", *args])
    assert _script("memory_report").main() == 0
    want = _last_json(capsys.readouterr().out)
    assert got == want


def test_memory_report_refuses_the_card_only_parts_here(capsys):
    from littlegan_tpu_torch.scripts import memory_report

    if torch.cuda.is_available():
        pytest.skip("this host has a card: --measure runs there (chip_smoke.py phase (k))")
    assert memory_report.main(["--measure"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "needs a CUDA device" in out.err  # no table, no fallback line
    assert memory_report.main(["--topology", "v5e:2x4"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "--topology" in out.err
    assert memory_report.main(["--measure", "--mesh", "data=2"]) == 2


# ---------------------------------------------------- conditioning check ----

def _record(monkeypatch, cls, names, into):
    """Wrap ``cls``'s methods ``names`` to append each output to ``into[name]``."""
    for name in names:
        orig = getattr(cls, name)

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            out = _orig(self, *a, **k)
            into[_name].append(np.asarray(out, np.float32))
            return out

        monkeypatch.setattr(cls, name, wrapped)


def _deltas(images, cond_dim):
    """Each attribute's stat delta from the engine outputs in call order
    (bit on, then off, for each attribute)."""
    from littlegan_tpu_torch.scripts.verify_conditioning import stat

    return np.array([stat(images[2 * j], j) - stat(images[2 * j + 1], j) for j in range(cond_dim)])


def _summary(out: str):
    """(accuracy line, both "=> n/7" lines) of a run's output."""
    lines = out.splitlines()
    return [ln for ln in lines if "accuracy" in ln or "=>" in ln]


def _conditioning(tmp_path, monkeypatch, capsys, seed):
    from littlegan_tpu.serving import InferenceEngine as JEngine
    from littlegan_tpu_torch.compat.jax_params import jax_key
    from littlegan_tpu_torch.config import load_config
    from littlegan_tpu_torch.models import init_params
    from littlegan_tpu_torch.scripts import verify_conditioning
    from littlegan_tpu_torch.serving import InferenceEngine as TEngine
    from littlegan_tpu_torch.training.checkpoint import Checkpointer, to_numpy

    root = tmp_path / f"seed{seed}"
    data = root / "data"
    with contextlib.redirect_stdout(io.StringIO()):
        _script("make_structured_data").generate(str(data), n=64, dim=16, seed=seed)
    root.joinpath("sample.config.json").write_text(json.dumps({
        "batch_size": 64, "image_dim": 16, "init_dim": 1, "noise_dim": 13, "conv_filter": [24, 16, 12, 8, 4],
        "compute_dtype": "float32", "image_path": str(data / "img"), "attr_path": str(data / "attrs.txt"),
        "all_result_dir": str(root / "result"), "test_data_dir": str(root / "test-data"),
        "use_native_loader": False, "seed": seed,
    }))
    monkeypatch.chdir(root)
    cfg = load_config("sample", {"exp_name": "struct"})
    model = init_params(cfg, seed)
    Checkpointer(os.path.join(cfg.result_dir, "model")).save_flat(
        "model", {jax_key(k): to_numpy(v) for k, v in model.state_dict().items()})
    got = {"generate": [], "adjust": []}
    want = {"generate": [], "adjust": []}
    _record(monkeypatch, TEngine, got, got)
    _record(monkeypatch, JEngine, want, want)
    capsys.readouterr()
    assert verify_conditioning.main(["struct", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["verify_conditioning.py", "struct"])
    assert _script("verify_conditioning").main() == 0
    jax_out = capsys.readouterr().out
    return cfg, got, want, out, jax_out


def test_conditioning_check_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    for seed in range(5):
        cfg, got, want, out, jax_out = _conditioning(tmp_path, monkeypatch, capsys, seed)
        deltas = {k: _deltas(got[k], cfg.cond_dim) for k in got}
        if all(np.all(np.abs(d - 0.02) > 1e-4) for d in deltas.values()):
            break
        print(f"seed {seed}: a delta lies within 1e-4 of the 0.02 threshold; taking seed {seed + 1}")
        monkeypatch.undo()
    else:
        pytest.fail("every seed put a delta within 1e-4 of 0.02")
    for kind in ("generate", "adjust"):
        assert len(got[kind]) == len(want[kind]) == 2 * cfg.cond_dim
        np.testing.assert_allclose(deltas[kind], _deltas(want[kind], cfg.cond_dim), atol=1e-4, rtol=0)
        assert np.all(np.isfinite(deltas[kind]))
    assert _summary(out) == _summary(jax_out)
    assert len(_summary(out)) == 3
