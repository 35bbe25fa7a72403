"""Inference engine and HTTP server on one GPU: the port of littlegan_tpu/serving.py.

- ``InferenceEngine``: loads weights (a weights-only export or a train
  checkpoint written by either package's npz format, else a seeded fresh
  init), runs generator / adjuster / discriminator at a FIXED batch size
  (requests are padded to it) and returns f32 numpy arrays, the same
  contract as the JAX engine. It runs on the card unless the caller passes
  ``device="cpu"``; with no card and no device it raises.
- ``serve()``: a dependency-free stdlib HTTP JSON API:
    POST /generate      {"cond": [[...7 floats...], ...], "noise": optional, "seed": optional}
    POST /adjust        {"image_b64": <png/jpeg base64>, "cond": [[...]]}
    POST /discriminate  {"image_b64": ...}
    GET  /              (built-in demo page)
    GET  /healthz
    GET  /metrics       (Prometheus text exposition)
  Responses carry base64 JPEG images. Concurrent single-row requests to any
  endpoint are batched into one engine call (one DynamicBatcher per
  endpoint). SIGTERM/SIGINT drain the server; ``--reload-every`` hot-swaps
  newly saved checkpoints.

Run: ``python -m littlegan_tpu_torch.serving <exp> -e <env> --port 8600
--batch 8 --max-wait-ms 3 --reload-every 0``.
"""

from __future__ import annotations

import base64
import io
import json
import os
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from littlegan_tpu_torch.compat.jax_params import params_from_jax
from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models import LittleGAN, init_params
from littlegan_tpu_torch.training.checkpoint import eval_params, make_checkpointer
from littlegan_tpu_torch.utils.device import resolve_device
from littlegan_tpu_torch.utils.image import data_rescale, inverse_rescale


class InferenceEngine:
    def __init__(
        self,
        cfg: Config,
        params: Optional[Mapping[str, np.ndarray]] = None,
        batch_size: Optional[int] = None,
        device=None,
    ):
        """``params``: JAX-keyed arrays (``encoder/block1/conv/kernel``, ...)
        to serve; None loads them as :meth:`maybe_reload` would (checkpoint,
        else a seeded fresh init)."""
        self.cfg = cfg
        self.batch = batch_size or cfg.batch_size
        self.device = resolve_device(device)
        # hot-reload bookkeeping: which checkpoint the served weights came
        # from, so maybe_reload() acts only on genuinely new ones
        self._ckpt_token = self._latest_checkpoint(cfg) if cfg.restore else None
        model = self._load_model(cfg) if params is None else params_from_jax(params, LittleGAN(cfg))
        self.model = model.to(self.device).eval()

    @staticmethod
    def _latest_checkpoint(cfg: Config):
        """(subdir, tag, fingerprint) of the checkpoint ``_load_model`` would
        restore now, or None (weights-only export dir first)."""
        for sub in ("model", "checkpoint"):
            ck = make_checkpointer(cfg, os.path.join(cfg.result_dir, sub))
            tag = ck.latest_tag()
            if tag is not None:
                return (sub, tag, ck.tag_fingerprint(tag))
        return None

    @staticmethod
    def _load_model(cfg: Config) -> LittleGAN:
        """Weights-only export, else train checkpoint (its EMA generator
        parts when it has them), else a seeded fresh init with a loud
        warning: serving random weights must never be silent."""
        if not cfg.restore:
            print("serving fresh-init weights (restore=false)")
            return init_params(cfg, cfg.seed)
        for sub in ("model", "checkpoint"):
            ck = make_checkpointer(cfg, os.path.join(cfg.result_dir, sub))
            tag = ck.latest_tag()
            if tag is None:
                continue
            flat, has_ema = eval_params(ck.restore_flat(tag))
            if has_ema:
                print("serving EMA generator weights (checkpoint has ema subtrees)")
            elif cfg.ema_decay > 0 and sub == "checkpoint":
                print("WARNING: ema_decay set but the checkpoint has no ema subtrees — serving the live weights")
            return params_from_jax(flat, LittleGAN(cfg))
        print(
            f"WARNING: no checkpoint under {cfg.result_dir}/{{model,checkpoint}} — "
            "serving UNTRAINED (fresh-init) weights"
        )
        return init_params(cfg, cfg.seed)

    def maybe_reload(self) -> Optional[str]:
        """Swap in the latest checkpoint's weights if it changed since the
        served ones were loaded; returns the new tag, or None when current.
        A request in flight finishes on the model it started with (one
        attribute assignment swaps it). Never reloads a ``restore=false``
        engine."""
        if not self.cfg.restore:
            return None
        token = self._latest_checkpoint(self.cfg)
        if token is None or token == self._ckpt_token:
            return None
        self.model = self._load_model(self.cfg).to(self.device).eval()
        self._ckpt_token = token
        return f"{token[0]}/{token[1]}"

    def _pad(self, arr: np.ndarray) -> torch.Tensor:
        n = arr.shape[0]
        if n > self.batch:
            raise ValueError(f"request batch {n} > engine batch {self.batch}")
        arr = np.asarray(arr, np.float32)
        if n < self.batch:
            arr = np.concatenate([arr, np.zeros((self.batch - n, *arr.shape[1:]), np.float32)])
        return torch.from_numpy(arr).to(self.device)

    @staticmethod
    def _out(t: torch.Tensor, n: int) -> np.ndarray:
        return t.float().cpu().numpy()[:n]

    def generate(
        self, cond: np.ndarray, noise: Optional[np.ndarray] = None, seed: Optional[int] = None
    ) -> np.ndarray:
        """``seed=None`` draws fresh entropy per call; pass a seed (or noise)
        for reproducible samples."""
        n = cond.shape[0]
        if noise is None:
            noise = np.random.default_rng(seed).normal(size=(n, self.cfg.noise_dim))
        elif noise.shape[0] != n:
            raise ValueError(f"noise rows ({noise.shape[0]}) != cond rows ({n})")
        model = self.model
        with torch.inference_mode():
            return self._out(model.generator(self._pad(noise), self._pad(cond)), n)

    def adjust(self, image: np.ndarray, cond: np.ndarray) -> np.ndarray:
        n = image.shape[0]
        model = self.model
        with torch.inference_mode():
            return self._out(model.adjuster(self._pad(image), self._pad(cond)), n)

    def discriminate(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        n = image.shape[0]
        model = self.model
        with torch.inference_mode():
            pr, cond = model.discriminator(self._pad(image))
            return {"pr": self._out(pr, n), "cond": self._out(cond, n)}


class ServerMetrics:
    """Thread-safe serving metrics, exported as Prometheus text: requests by
    (endpoint, status code), cumulative latency histograms per endpoint,
    dynamic-batch fill histograms per batcher, an in-flight gauge, uptime and
    checkpoint reloads. All mutation goes through one lock."""

    # histogram upper bounds in milliseconds (cumulative; +Inf via _count)
    LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0, 4000.0)

    def __init__(self, engine_batch: int, start_time: Optional[float] = None):
        self._lock = threading.Lock()
        self._requests: Dict[tuple, int] = {}  # (endpoint, code) -> count
        self._lat_sum: Dict[str, float] = {}
        self._lat_count: Dict[str, int] = {}
        self._lat_buckets: Dict[str, List[int]] = {}
        self._batch_rows: Dict[str, int] = {}
        self._batch_dispatches: Dict[str, int] = {}
        self._batch_fill: Dict[str, List[int]] = {}  # endpoint -> count per fill 1..B
        self._inflight = 0
        self._ckpt_reloads = 0
        self._ckpt_tag = ""
        self.engine_batch = engine_batch
        self._start = time.time() if start_time is None else start_time

    def checkpoint_loaded(self, tag: str, reload: bool = True) -> None:
        with self._lock:
            self._ckpt_tag = tag
            if reload:
                self._ckpt_reloads += 1

    def request_started(self) -> None:
        with self._lock:
            self._inflight += 1

    def request_finished(self, endpoint: str, code: int, latency_ms: float) -> None:
        with self._lock:
            self._inflight -= 1
            key = (endpoint, int(code))
            self._requests[key] = self._requests.get(key, 0) + 1
            self._lat_sum[endpoint] = self._lat_sum.get(endpoint, 0.0) + latency_ms
            self._lat_count[endpoint] = self._lat_count.get(endpoint, 0) + 1
            buckets = self._lat_buckets.setdefault(endpoint, [0] * len(self.LATENCY_BUCKETS_MS))
            for i, bound in enumerate(self.LATENCY_BUCKETS_MS):
                if latency_ms <= bound:
                    buckets[i] += 1

    def batch_dispatched(self, endpoint: str, rows: int) -> None:
        """One engine call through a DynamicBatcher carried ``rows`` rows."""
        with self._lock:
            self._batch_rows[endpoint] = self._batch_rows.get(endpoint, 0) + rows
            self._batch_dispatches[endpoint] = self._batch_dispatches.get(endpoint, 0) + 1
            fill = self._batch_fill.setdefault(endpoint, [0] * self.engine_batch)
            fill[min(rows, self.engine_batch) - 1] += 1

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        with self._lock:
            lines = [
                "# HELP littlegan_requests_total HTTP requests by endpoint and status code",
                "# TYPE littlegan_requests_total counter",
            ]
            for (ep, code), n in sorted(self._requests.items()):
                lines.append(f'littlegan_requests_total{{endpoint="{ep}",code="{code}"}} {n}')
            lines += [
                "# HELP littlegan_request_latency_ms request wall latency (server side)",
                "# TYPE littlegan_request_latency_ms histogram",
            ]
            for ep in sorted(self._lat_count):
                for bound, n in zip(self.LATENCY_BUCKETS_MS, self._lat_buckets[ep]):
                    lines.append(f'littlegan_request_latency_ms_bucket{{endpoint="{ep}",le="{bound:g}"}} {n}')
                lines.append(
                    f'littlegan_request_latency_ms_bucket{{endpoint="{ep}",le="+Inf"}} {self._lat_count[ep]}'
                )
                lines.append(f'littlegan_request_latency_ms_sum{{endpoint="{ep}"}} {self._lat_sum[ep]:.3f}')
                lines.append(f'littlegan_request_latency_ms_count{{endpoint="{ep}"}} {self._lat_count[ep]}')
            lines += [
                "# HELP littlegan_batch_rows_total rows served through the dynamic batcher",
                "# TYPE littlegan_batch_rows_total counter",
            ]
            for ep, n in sorted(self._batch_rows.items()):
                lines.append(f'littlegan_batch_rows_total{{endpoint="{ep}"}} {n}')
            lines += [
                "# HELP littlegan_batch_dispatches_total engine calls made by the dynamic batcher",
                "# TYPE littlegan_batch_dispatches_total counter",
            ]
            for ep, n in sorted(self._batch_dispatches.items()):
                lines.append(f'littlegan_batch_dispatches_total{{endpoint="{ep}"}} {n}')
            lines += [
                "# HELP littlegan_batch_fill rows per batcher dispatch (1..engine batch)",
                "# TYPE littlegan_batch_fill histogram",
            ]
            for ep in sorted(self._batch_fill):
                cum = 0
                for rows0, n in enumerate(self._batch_fill[ep]):
                    cum += n
                    lines.append(f'littlegan_batch_fill_bucket{{endpoint="{ep}",le="{rows0 + 1}"}} {cum}')
                lines.append(f'littlegan_batch_fill_bucket{{endpoint="{ep}",le="+Inf"}} {cum}')
                lines.append(f'littlegan_batch_fill_sum{{endpoint="{ep}"}} {self._batch_rows.get(ep, 0)}')
                lines.append(f'littlegan_batch_fill_count{{endpoint="{ep}"}} {cum}')
            lines += [
                "# HELP littlegan_inflight_requests requests currently being handled",
                "# TYPE littlegan_inflight_requests gauge",
                f"littlegan_inflight_requests {self._inflight}",
                "# HELP littlegan_engine_batch fixed engine batch size",
                "# TYPE littlegan_engine_batch gauge",
                f"littlegan_engine_batch {self.engine_batch}",
                "# HELP littlegan_uptime_seconds seconds since the server started",
                "# TYPE littlegan_uptime_seconds gauge",
                f"littlegan_uptime_seconds {time.time() - self._start:.1f}",
                "# HELP littlegan_checkpoint_reloads_total hot checkpoint reloads since start",
                "# TYPE littlegan_checkpoint_reloads_total counter",
                f"littlegan_checkpoint_reloads_total {self._ckpt_reloads}",
            ]
            if self._ckpt_tag:
                lines += [
                    "# HELP littlegan_checkpoint_info currently-served checkpoint (info gauge)",
                    "# TYPE littlegan_checkpoint_info gauge",
                    f'littlegan_checkpoint_info{{tag="{self._ckpt_tag}"}} 1',
                ]
        return "\n".join(lines) + "\n"


class _Slot:
    __slots__ = ("rows", "done", "result", "error")

    def __init__(self, rows: tuple):
        self.rows = rows  # one array per row field (e.g. (noise, cond))
        self.done = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None


class DynamicBatcher:
    """Cross-request micro-batching for ONE engine entry point.

    Concurrent single-row requests ride one engine call instead of one padded
    call each: a collector thread gathers pending rows up to ``batch`` (or
    until ``max_wait_ms`` passes with a partial batch) and fans the results
    back out. Per-sample outputs are independent (the instance norm is per
    sample), so batched results equal per-request ones.

    ``compute(*stacked)`` receives one (N, ...) array per row field and
    returns a length-N sequence of per-row results.
    """

    def __init__(self, compute, batch: int, max_wait_ms: float = 3.0, name: str = "generate", on_batch=None):
        self.compute = compute
        self.batch = batch
        self.max_wait = max_wait_ms / 1000.0
        self._on_batch = on_batch  # observability hook: called (rows,) per dispatch
        self._lock = threading.Lock()
        self._pending: List[_Slot] = []
        self._kick = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True, name=f"lg-batcher-{name}")
        self._thread.start()

    def submit(self, *rows: np.ndarray):
        """Blocking: returns this request's per-row result."""
        slot = _Slot(rows)
        with self._lock:
            if self._stop:  # racing close(): fail fast, never hang on done
                raise RuntimeError("batcher is closed")
            self._pending.append(slot)
        self._kick.set()
        slot.done.wait()
        if slot.error is not None:
            raise slot.error
        return slot.result

    def _take_batch(self) -> List[_Slot]:
        with self._lock:
            batch = self._pending[: self.batch]
            del self._pending[: len(batch)]
            if not self._pending:
                self._kick.clear()
        return batch

    def _run(self) -> None:
        while not self._stop:
            if not self._kick.wait(timeout=0.1):
                continue
            deadline = time.monotonic() + self.max_wait
            while time.monotonic() < deadline:
                with self._lock:
                    if len(self._pending) >= self.batch:
                        break
                time.sleep(0.0005)
            batch = self._take_batch()
            if not batch:
                continue
            if self._on_batch is not None:
                try:
                    self._on_batch(len(batch))
                except Exception:
                    pass  # metrics must never take down the collector
            try:
                n_fields = len(batch[0].rows)
                stacked = [np.stack([s.rows[j] for s in batch]) for j in range(n_fields)]
                results = self.compute(*stacked)
                for i, s in enumerate(batch):
                    s.result = results[i]
                    s.done.set()
            except Exception:
                # one bad row must not poison its batch-mates: retry each
                # slot alone so only the offender gets the error
                for s in batch:
                    try:
                        s.result = self.compute(*[r[None] for r in s.rows])[0]
                    except Exception as e:
                        s.error = e
                    s.done.set()

    def close(self) -> None:
        with self._lock:
            self._stop = True
            pending = self._pending[:]
            self._pending.clear()
        for s in pending:  # a request that raced shutdown gets an error, not a hang
            s.error = RuntimeError("batcher is closed")
            s.done.set()
        self._kick.set()
        self._thread.join(timeout=2)


def make_batchers(
    engine: InferenceEngine, max_wait_ms: float = 3.0, metrics: Optional[ServerMetrics] = None
) -> Dict[str, DynamicBatcher]:
    """One DynamicBatcher per entry point; ``metrics`` (if given) records the
    batch fill of each dispatch."""

    def _disc(image):
        d = engine.discriminate(image)
        return list(zip(d["pr"], d["cond"]))

    def _hook(name: str):
        if metrics is None:
            return None
        return lambda rows: metrics.batch_dispatched(name, rows)

    b = engine.batch
    return {
        "generate": DynamicBatcher(
            lambda noise, cond: engine.generate(cond, noise), b, max_wait_ms, "generate", _hook("generate")
        ),
        "adjust": DynamicBatcher(
            lambda image, cond: engine.adjust(image, cond), b, max_wait_ms, "adjust", _hook("adjust")
        ),
        "discriminate": DynamicBatcher(_disc, b, max_wait_ms, "discriminate", _hook("discriminate")),
    }


def close_batchers(batchers: Optional[Dict[str, DynamicBatcher]]) -> None:
    for b in (batchers or {}).values():
        b.close()


# ------------------------------------------------------------- http layer ----


def _demo_page(cfg: Config, batch: int) -> str:
    """Self-contained demo page (GET /): attribute toggles -> /generate, image
    upload + toggles -> /adjust, upload -> /discriminate. Cond values are the
    training targets soft(+1)=0.98 / soft(-1)=-0.94."""
    from littlegan_tpu_torch.data import CELEBA_ATTR_NAMES

    names = [CELEBA_ATTR_NAMES[i] if 0 <= i < len(CELEBA_ATTR_NAMES) else f"attr{i}" for i in cfg.attr]
    boxes = "".join(
        f'<label class="a"><input type="checkbox" class="attr" data-i="{i}">{n}</label>'
        for i, n in enumerate(names)
    )
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>littlegan demo</title><style>
body{{font-family:system-ui,sans-serif;max-width:720px;margin:2em auto;padding:0 1em}}
.a{{display:inline-block;margin:.2em .6em .2em 0;white-space:nowrap}}
img{{image-rendering:auto;border:1px solid #ccc;margin:.5em .5em 0 0;max-width:256px}}
button{{margin:.4em .4em 0 0;padding:.4em 1em}}section{{margin-top:1.5em}}
pre{{background:#f4f4f4;padding:.6em;overflow-x:auto}}</style></head><body>
<h1>littlegan</h1>
<p>Conditional face generation + attribute adjustment, served on one GPU
(engine batch {batch}).</p>
<div>{boxes}</div>
<section><h3>Generate</h3>
<label>seed <input id="seed" type="number" placeholder="random"></label>
<button onclick="gen()">generate</button><div id="gout"></div></section>
<section><h3>Adjust / Discriminate</h3>
<input id="file" type="file" accept="image/*">
<button onclick="adj()">adjust to attrs</button>
<button onclick="disc()">discriminate</button>
<div id="aout"></div><pre id="dout" hidden></pre></section>
<script>
const ON=0.98, OFF=-0.94;
function cond(){{return [...document.querySelectorAll('.attr')].map(b=>b.checked?ON:OFF);}}
async function post(p,b){{const r=await fetch(p,{{method:'POST',body:JSON.stringify(b)}});
  const j=await r.json(); if(!r.ok) throw new Error(j.error||r.status); return j;}}
function show(el,j){{el.innerHTML=j.images.map(b=>`<img src="data:image/jpeg;base64,${{b}}">`).join('')
  +`<div>${{j.latency_ms}} ms</div>`;}}
async function gen(){{const b={{cond:[cond()]}};const s=document.getElementById('seed').value;
  if(s!=='')b.seed=+s; try{{show(gout,await post('/generate',b));}}catch(e){{gout.textContent=e;}}}}
function fileB64(){{return new Promise((ok,no)=>{{const f=document.getElementById('file').files[0];
  if(!f)return no(new Error('choose an image first'));const r=new FileReader();
  r.onload=()=>ok(r.result.split(',')[1]);r.onerror=no;r.readAsDataURL(f);}});}}
async function adj(){{try{{show(aout,await post('/adjust',{{image_b64:await fileB64(),cond:[cond()]}}));}}
  catch(e){{aout.textContent=e;}}}}
async function disc(){{try{{const j=await post('/discriminate',{{image_b64:await fileB64()}});
  dout.hidden=false;dout.textContent=JSON.stringify(j,null,1);}}catch(e){{dout.hidden=false;dout.textContent=e;}}}}
</script></body></html>"""


def _img_to_b64(img_pm1: np.ndarray) -> str:
    from PIL import Image

    arr = inverse_rescale(img_pm1).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:  # greyscale configs: PIL mode L
        arr = arr[:, :, 0]
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=95)
    return base64.b64encode(buf.getvalue()).decode()


def _b64_to_img(b64: str, dim: int, channels: int = 3) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    img = img.convert("L" if channels == 1 else "RGB")
    if img.size != (dim, dim):
        w, h = img.size
        if w != h:  # centre-crop to the short side first, as training ingests images
            s = min(w, h)
            img = img.crop(((w - s) // 2, (h - s) // 2, (w - s) // 2 + s, (h - s) // 2 + s))
        img = img.resize((dim, dim), Image.BILINEAR)
    arr = np.asarray(img, np.float32)
    if channels == 1:
        arr = arr[:, :, None]
    return data_rescale(arr)


def make_handler(
    engine: InferenceEngine,
    batchers: Optional[Dict[str, DynamicBatcher]] = None,
    metrics: Optional[ServerMetrics] = None,
):
    from http.server import BaseHTTPRequestHandler

    batchers = batchers or {}

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, content_type: str):
            self._last_code = code  # metrics: the status this request ended with
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code: int, payload: dict):
            self._send(code, json.dumps(payload).encode(), "application/json")

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, _demo_page(engine.cfg, engine.batch).encode(), "text/html; charset=utf-8")
            elif self.path == "/healthz":
                self._reply(200, {"status": "ok", "batch": engine.batch})
            elif self.path == "/metrics" and metrics is not None:
                self._send(200, metrics.render().encode(), "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if metrics is None:
                return self._do_post_inner()
            metrics.request_started()
            t0 = time.monotonic()
            self._last_code = 0  # connection died before any reply
            try:
                self._do_post_inner()
            finally:
                metrics.request_finished(
                    self.path.lstrip("/") or "unknown", self._last_code, (time.monotonic() - t0) * 1000.0
                )

        def _do_post_inner(self):
            cfg = engine.cfg
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                t0 = time.time()
                if self.path == "/generate":
                    cond = np.asarray(req["cond"], np.float32)
                    noise = np.asarray(req["noise"], np.float32) if "noise" in req else None
                    seed = int(req["seed"]) if "seed" in req else None
                    batcher = batchers.get("generate")
                    if batcher is not None and cond.shape == (1, cfg.cond_dim):
                        # shapes checked BEFORE joining the shared batch: a
                        # malformed row must fail alone, not poison its peers
                        if noise is None:
                            noise = np.random.default_rng(seed).normal(size=(1, cfg.noise_dim)).astype(np.float32)
                        if np.shape(noise) != (1, cfg.noise_dim):
                            raise ValueError(f"noise shape {np.shape(noise)} != (1, {cfg.noise_dim})")
                        imgs = batcher.submit(noise[0], cond[0])[None]
                    else:
                        imgs = engine.generate(cond, noise, seed=seed)
                    out = {"images": [_img_to_b64(i) for i in imgs]}
                elif self.path == "/adjust":
                    img = _b64_to_img(req["image_b64"], cfg.image_dim, cfg.image_channel)
                    cond = np.asarray(req["cond"], np.float32).reshape(1, -1)
                    if cond.shape[1] != cfg.cond_dim:
                        raise ValueError(f"cond width {cond.shape[1]} != {cfg.cond_dim}")
                    batcher = batchers.get("adjust")
                    if batcher is not None:
                        adj = batcher.submit(img, cond[0])
                    else:
                        adj = engine.adjust(img[None], cond)[0]
                    out = {"images": [_img_to_b64(adj)]}
                elif self.path == "/discriminate":
                    img = _b64_to_img(req["image_b64"], cfg.image_dim, cfg.image_channel)
                    batcher = batchers.get("discriminate")
                    if batcher is not None:
                        pr, dcond = batcher.submit(img)
                    else:
                        d = engine.discriminate(img[None])
                        pr, dcond = d["pr"][0], d["cond"][0]
                    out = {"pr": [pr.tolist()], "cond": [dcond.tolist()]}
                else:
                    return self._reply(404, {"error": "unknown path"})
                out["latency_ms"] = round((time.time() - t0) * 1000, 2)
                self._reply(200, out)
            except (KeyError, ValueError, TypeError, OSError, json.JSONDecodeError) as e:
                # OSError covers PIL's UnidentifiedImageError on bad image bytes
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # engine or batcher failure: reply 500, never hang up
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(
    cfg: Config,
    host: str = "0.0.0.0",
    port: int = 8600,
    batch_size: int = 8,
    max_wait_ms: float = 3.0,
    reload_every_s: float = 0.0,
    device=None,
    engine: Optional[InferenceEngine] = None,
    on_start: Optional[Callable] = None,
):
    """Threaded HTTP server with dynamic batching on all three entry points
    (``max_wait_ms <= 0`` disables the batchers), ``/metrics``, a demo page,
    SIGTERM/SIGINT drain (from the main thread) and optional checkpoint
    hot-reload every ``reload_every_s`` seconds.

    ``engine``: serve this engine instead of building one from ``cfg`` on
    ``device``. ``on_start(server)`` is called once the socket is bound
    (``server.server_address`` has the port; ``server.shutdown()`` drains
    it from another thread)."""
    import signal
    from http.server import ThreadingHTTPServer

    if engine is None:
        engine = InferenceEngine(cfg, batch_size=batch_size, device=device)
    metrics = ServerMetrics(engine.batch)
    if engine._ckpt_token is not None:
        metrics.checkpoint_loaded(f"{engine._ckpt_token[0]}/{engine._ckpt_token[1]}", reload=False)
    batchers = make_batchers(engine, max_wait_ms, metrics) if max_wait_ms > 0 else None
    server = ThreadingHTTPServer((host, port), make_handler(engine, batchers, metrics))

    stop_reload = threading.Event()
    if reload_every_s > 0:

        def _reloader():
            while not stop_reload.wait(reload_every_s):
                try:
                    tag = engine.maybe_reload()
                except Exception as e:  # a half-written checkpoint must not kill serving
                    print(f"littlegan-tpu-torch-serve: reload failed ({type(e).__name__}: {e})")
                    continue
                if tag is not None:
                    metrics.checkpoint_loaded(tag)
                    print(f"littlegan-tpu-torch-serve: hot-reloaded checkpoint {tag}")

        threading.Thread(target=_reloader, daemon=True, name="lg-ckpt-reload").start()

    def _drain(signum, frame):
        print(f"littlegan-tpu-torch-serve: signal {signum} — draining")
        # shutdown() blocks until serve_forever returns: never from its own thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    # signal() works only from the main thread; an embedded serve() relies
    # on its caller's shutdown() instead
    if threading.current_thread() is threading.main_thread():
        old_handlers = {s: signal.signal(s, _drain) for s in (signal.SIGTERM, signal.SIGINT)}
    else:
        old_handlers = {}
    print(
        f"littlegan-tpu-torch serving on {host}:{server.server_address[1]} ({engine.device}, "
        f"batch {engine.batch}, dynamic batching {'on' if batchers else 'off'}, /metrics on)",
        flush=True,
    )
    try:
        if on_start is not None:
            on_start(server)
        server.serve_forever()
    finally:
        stop_reload.set()
        for s, h in old_handlers.items():
            signal.signal(s, h)
        close_batchers(batchers)
        server.server_close()
        print("littlegan-tpu-torch-serve: drained, socket closed", flush=True)


def main(argv=None) -> int:
    from argparse import ArgumentParser

    from littlegan_tpu_torch.config import load_config

    p = ArgumentParser(prog="littlegan-tpu-torch-serve")
    p.add_argument("exp_name")
    p.add_argument("-e", "--env", default="sample")
    p.add_argument("--port", type=int, default=8600)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument(
        "--max-wait-ms", type=float, default=3.0,
        help="dynamic-batching window; <=0 disables cross-request batching",
    )
    p.add_argument(
        "--reload-every", type=float, default=0.0, metavar="SECONDS",
        help="poll the checkpoint dirs and hot-swap newly saved weights (0 disables)",
    )
    p.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    cfg = load_config(args.env, {"exp_name": args.exp_name, "mode": "serve"})
    serve(
        cfg,
        port=args.port,
        batch_size=args.batch,
        max_wait_ms=args.max_wait_ms,
        reload_every_s=args.reload_every,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
