"""The port's serving slice against the JAX package's, on the CPU.

- ``InferenceEngine(device="cpu")`` with the JAX engine's weights returns
  what the JAX engine returns (f32, rtol 1e-4 / atol 1e-5);
- it restores a JAX-written weights-only export and an EMA train checkpoint;
- HTTP and batcher round trips; ``serve()`` starts, answers and drains;
- with no CUDA and no device, construction raises;
- importing the port (and chip_smoke.py) loads neither jax nor littlegan_tpu.
"""

import base64
import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from littlegan_tpu import serving as jserving
from littlegan_tpu.config import Config as JConfig
from littlegan_tpu.config import load_config as jload_config
from littlegan_tpu.training.checkpoint import _flatten, make_checkpointer as jmake_checkpointer
from littlegan_tpu_torch import serving as tserving
from littlegan_tpu_torch.config import Config as TConfig
from littlegan_tpu_torch.config import load_config as tload_config

TOL = dict(rtol=1e-4, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tcfg(jcfg) -> TConfig:
    return TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


@pytest.fixture(scope="module")
def engines(tiny_cfg):
    jcfg = tiny_cfg.replace(restore=False)
    jeng = jserving.InferenceEngine(jcfg, batch_size=4)
    teng = tserving.InferenceEngine(_tcfg(jcfg), params=_flatten(jeng.params), batch_size=4, device="cpu")
    return jeng, teng


def _cond(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n, cfg.cond_dim)) < 0.5, 0.98, -0.94).astype(np.float32)


def test_config_fields_and_defaults_match_jax():
    j, t = JConfig(), TConfig()
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert j.to_json_dict() == t.to_json_dict()


def test_load_config_layers_match_jax(tmp_path):
    (tmp_path / "sample.config.json").write_text(json.dumps({"batch_size": 8, "lr": 1e-3, "cond_dim": 99}))
    (tmp_path / "myenv.config.json").write_text(json.dumps({"lr": 2e-3, "custom_key": 7}))
    over = {"epoch": 5, "exp_name": "x", "seed": None}
    j = jload_config("myenv", over, search_dirs=(str(tmp_path),))
    t = tload_config("myenv", over, search_dirs=(str(tmp_path),))
    assert t.to_json_dict() == j.to_json_dict()
    assert (t.batch_size, t.lr, t.epoch, t.extra["custom_key"], t.cond_dim) == (8, 2e-3, 5, 7, 7)


def test_generate_matches_jax_engine(engines):
    jeng, teng = engines
    cond = _cond(teng.cfg, 3)
    np.testing.assert_allclose(teng.generate(cond, seed=5), jeng.generate(cond, seed=5), **TOL)
    noise = np.random.default_rng(1).normal(size=(4, teng.cfg.noise_dim)).astype(np.float32)
    cond4 = _cond(teng.cfg, 4, 1)
    out = teng.generate(cond4, noise)
    assert out.dtype == np.float32 and out.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(out, jeng.generate(cond4, noise), **TOL)


def test_adjust_and_discriminate_match_jax_engine(engines):
    jeng, teng = engines
    img = np.random.default_rng(2).uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    cond = _cond(teng.cfg, 3, 2)
    np.testing.assert_allclose(teng.adjust(img, cond), jeng.adjust(img, cond), **TOL)
    got, want = teng.discriminate(img), jeng.discriminate(img)
    assert got["pr"].shape == (3, 1) and got["cond"].shape == (3, teng.cfg.cond_dim)
    for k in ("pr", "cond"):
        np.testing.assert_allclose(got[k], want[k], **TOL)


def test_engine_request_contract(engines):
    _, teng = engines
    cfg = teng.cfg
    with pytest.raises(ValueError):
        teng.generate(np.zeros((5, cfg.cond_dim), np.float32))  # > engine batch
    with pytest.raises(ValueError):
        teng.generate(np.zeros((3, cfg.cond_dim), np.float32), np.zeros((2, cfg.noise_dim), np.float32))
    cond = np.zeros((1, cfg.cond_dim), np.float32)
    np.testing.assert_array_equal(teng.generate(cond, seed=1), teng.generate(cond, seed=1))
    assert not np.array_equal(teng.generate(cond), teng.generate(cond))  # no seed: fresh entropy


def test_engine_without_cuda_or_device_raises(tiny_cfg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.InferenceEngine(_tcfg(tiny_cfg.replace(restore=False)), batch_size=2)


def _dirs(tiny_cfg, tmp_path, name, **kw):
    return tiny_cfg.replace(
        exp_name=name, all_result_dir=str(tmp_path / "result"), test_data_dir=str(tmp_path / "td"), **kw
    )


def test_restores_jax_weights_only_export(tiny_cfg, tmp_path):
    from littlegan_tpu.models import init_params

    jcfg = _dirs(tiny_cfg, tmp_path, "exp_model")
    params = init_params(jcfg, jax.random.PRNGKey(3))
    jmake_checkpointer(jcfg, os.path.join(jcfg.result_dir, "model")).save("model", params)
    teng = tserving.InferenceEngine(_tcfg(jcfg), batch_size=2, device="cpu")
    assert teng._ckpt_token[:2] == ("model", "model")
    want = _flatten(params)
    for name, p in teng.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name.replace(".", "/")])
    jeng = jserving.InferenceEngine(jcfg, batch_size=2)
    cond = _cond(jcfg, 2)
    np.testing.assert_allclose(teng.generate(cond, seed=4), jeng.generate(cond, seed=4), **TOL)


def test_restores_ema_weights_from_jax_train_checkpoint(tiny_cfg, tmp_path):
    from littlegan_tpu.training.state import create_train_state, eval_params

    train_cfg = _dirs(tiny_cfg, tmp_path, "exp_ema", ema_decay=0.999)
    state = create_train_state(train_cfg, jax.random.PRNGKey(0))
    state = state._replace(ema=jax.tree_util.tree_map(lambda x: x + 1.0, state.ema))
    jmake_checkpointer(train_cfg, os.path.join(train_cfg.result_dir, "checkpoint")).save(
        "1", state, {"epoch": 2, "step": 4}
    )
    serve_cfg = _tcfg(train_cfg.replace(ema_decay=0.0))
    teng = tserving.InferenceEngine(serve_cfg, batch_size=2, device="cpu")
    want = _flatten(eval_params(state))
    for name, p in teng.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name.replace(".", "/")])
    # the EMA overlay is visible: out_conv is EMA (+1), the encoder live
    live = _flatten(state.params)
    assert not np.array_equal(want["out_conv/kernel"], live["out_conv/kernel"])
    np.testing.assert_array_equal(want["encoder/block1/conv/kernel"], live["encoder/block1/conv/kernel"])


def test_maybe_reload_picks_up_a_new_export(tiny_cfg, tmp_path):
    from littlegan_tpu.models import init_params

    jcfg = _dirs(tiny_cfg, tmp_path, "exp_reload")
    ck = jmake_checkpointer(jcfg, os.path.join(jcfg.result_dir, "checkpoint"))
    ck.save("1", init_params(jcfg, jax.random.PRNGKey(0)))
    teng = tserving.InferenceEngine(_tcfg(jcfg), batch_size=2, device="cpu")
    assert teng.maybe_reload() is None
    newer = init_params(jcfg, jax.random.PRNGKey(7))
    ck.save("2", newer)
    assert teng.maybe_reload() == "checkpoint/2"
    np.testing.assert_array_equal(
        teng.model.g_head.dense.kernel.detach().numpy(), np.asarray(newer["g_head"]["dense"]["kernel"])
    )
    fresh = tserving.InferenceEngine(_tcfg(jcfg.replace(restore=False)), batch_size=2, device="cpu")
    assert fresh.maybe_reload() is None  # a fresh-init engine stays fresh-init


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _png_b64(dim=16, seed=0):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, size=(dim, dim, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_http_and_batcher_round_trip(engines):
    from http.server import ThreadingHTTPServer

    _, teng = engines
    metrics = tserving.ServerMetrics(teng.batch)
    batchers = tserving.make_batchers(teng, max_wait_ms=30.0, metrics=metrics)
    server = ThreadingHTTPServer(("127.0.0.1", 0), tserving.make_handler(teng, batchers, metrics))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"status": "ok", "batch": 4}
        with urllib.request.urlopen(url + "/", timeout=60) as r:
            assert b"5_o_Clock_Shadow" in r.read()  # tiny_cfg's attr 0 on the demo page
        results = [None] * 4

        def worker(i):
            results[i] = _post(url + "/generate", {"cond": _cond(teng.cfg, 1, i).tolist(), "seed": i})

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None and r[0] == 200 and len(r[1]["images"]) == 1 for r in results)
        assert len({r[1]["images"][0] for r in results}) == 4  # distinct seeds, distinct images
        status, out = _post(url + "/adjust", {"image_b64": _png_b64(), "cond": _cond(teng.cfg, 1).tolist()})
        assert status == 200 and len(out["images"]) == 1
        status, out = _post(url + "/discriminate", {"image_b64": _png_b64()})
        assert status == 200 and np.shape(out["pr"]) == (1, 1) and np.shape(out["cond"]) == (1, 7)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/generate", {"wrong": 1})
        assert e.value.code == 400
        want = (
            'littlegan_requests_total{endpoint="generate",code="200"} 4',
            'littlegan_requests_total{endpoint="generate",code="400"} 1',
            'littlegan_batch_rows_total{endpoint="generate"} 4',
        )
        # a request is recorded after its reply is sent: poll briefly
        deadline = time.monotonic() + 10
        while True:
            with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
                text = r.read().decode()
            if all(w in text for w in want) or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        for w in want:
            assert w in text
    finally:
        server.shutdown()
        tserving.close_batchers(batchers)
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_batcher_results_equal_direct_calls(engines):
    _, teng = engines
    rng = np.random.default_rng(3)
    noise = rng.normal(size=(4, teng.cfg.noise_dim)).astype(np.float32)
    cond = _cond(teng.cfg, 4, 3)
    direct = teng.generate(cond, noise)
    batcher = tserving.DynamicBatcher(lambda n, c: teng.generate(c, n), teng.batch, max_wait_ms=200.0)
    try:
        results = [None] * 4

        def worker(i):
            results[i] = batcher.submit(noise[i], cond[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        batcher.close()
    for i in range(4):
        np.testing.assert_allclose(results[i], direct[i], rtol=1e-5, atol=1e-6)


def test_serve_starts_answers_and_drains(tiny_cfg):
    cfg = _tcfg(tiny_cfg.replace(restore=False))
    started = threading.Event()
    box = {}

    def on_start(server):
        box["server"] = server
        started.set()

    thread = threading.Thread(
        target=tserving.serve, args=(cfg,),
        kwargs=dict(host="127.0.0.1", port=0, batch_size=2, max_wait_ms=1.0, device="cpu", on_start=on_start),
        daemon=True,
    )
    thread.start()
    assert started.wait(60)
    url = f"http://127.0.0.1:{box['server'].server_address[1]}"
    try:
        status, out = _post(url + "/generate", {"cond": _cond(cfg, 2).tolist(), "seed": 1})
        assert status == 200 and len(out["images"]) == 2
    finally:
        box["server"].shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_server_metrics_render():
    m = tserving.ServerMetrics(engine_batch=4)
    m.request_started()
    m.request_finished("generate", 200, 3.0)
    m.request_started()
    m.request_finished("generate", 400, 0.5)
    m.batch_dispatched("generate", 4)
    text = m.render()
    assert 'littlegan_request_latency_ms_bucket{endpoint="generate",le="1"} 1' in text
    assert 'littlegan_request_latency_ms_bucket{endpoint="generate",le="5"} 2' in text
    assert 'littlegan_batch_fill_bucket{endpoint="generate",le="4"} 1' in text
    assert "littlegan_inflight_requests 0" in text


def test_image_codecs_match_jax():
    img = np.random.default_rng(4).uniform(-1, 1, (16, 16, 3)).astype(np.float32)
    b64 = tserving._img_to_b64(img)
    assert b64 == jserving._img_to_b64(img)
    np.testing.assert_array_equal(tserving._b64_to_img(b64, 16), jserving._b64_to_img(b64, 16))
    np.testing.assert_array_equal(tserving._b64_to_img(_png_b64(24), 16), jserving._b64_to_img(_png_b64(24), 16))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import littlegan_tpu_torch\n"
        "for m in pkgutil.walk_packages(littlegan_tpu_torch.__path__, 'littlegan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'littlegan_tpu.'))"
        " or m == 'littlegan_tpu')\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
