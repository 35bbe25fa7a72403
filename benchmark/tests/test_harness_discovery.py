"""A configuration, a traffic mix, a cell's limits and a per-layer metric
are new files that the harness finds by name, with no edit to a file that
is there."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

from benchmark import harness
from conftest import ROOT


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = _digests(bench)

    cfg = json.loads((bench / "configs" / "littlegan-128.json").read_text())
    (bench / "configs" / "littlegan-96.json").write_text(json.dumps({**cfg, "image_dim": 96, "init_dim": 6}))
    (bench / "traffic" / "train-small-k8.json").write_text(json.dumps(
        {"driver": "train_graph", "k": 8, "store_images": 4096, "trace_dispatches": 1, "check_replays": 2}))
    (bench / "limits" / "littlegan-96.train-small.json").write_text(
        json.dumps({"loss_gap_first": 0.01, "change_gap": 0.3}))
    (bench / "metrics" / "updates_traced.train.py").write_text(
        "def read(r):\n    return r.get('traced_updates')\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "littlegan-96", "source": "https://github.com/IXarea/LittleGAN",
                            "file": "benchmark/configs/littlegan-96.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "littlegan-96.train-small", "config": "littlegan-96",
                              "traffic": "train-small-k8", "chips": 1, "why": "a test"})
    next(m for m in spec["end_to_end"] if m["name"] == "train_images_per_s")["workloads"].append(
        "littlegan-96.train-small")
    spec["per_layer"].append({"name": "updates_traced.train", "unit": "updates", "better": "higher",
                              "source": "program_counter", "layer": "step", "moves": "train_images_per_s",
                              "workloads": ["littlegan-96.train-small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.Cell.load("littlegan-96.train-small", root=str(root), bench=str(bench))
    assert cell.config["image_dim"] == 96 and cell.traffic["k"] == 8 and cell.limits["loss_gap_first"] == 0.01
    assert cell.driver().__name__.endswith("train_graph")
    assert [m["name"] for m in cell.per_layer] == ["updates_traced.train"]
    assert {m["name"] for m in cell.end_to_end} == {"train_images_per_s", "setup_s"}
    got = harness.read_metrics(cell.per_layer, {"traced_updates": 16}, str(bench))
    assert got == {"updates_traced.train": {"value": 16.0, "unit": "updates"}}
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing that was there changed


def test_every_cell_of_the_benchmark_loads():
    spec = harness.spec()
    for w in spec["workloads"]:
        cell = harness.Cell.load(w["name"])
        assert cell.limits and cell.driver()
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.load_module("metrics", m["name"]).read)
