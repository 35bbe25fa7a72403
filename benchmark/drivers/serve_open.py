"""Open-loop serving through the program's dynamic batchers.

Single-row requests arrive at a fixed rate, each timed from the moment it
was due to the moment its sender holds the answer, whatever the senders or
the server were doing meanwhile. The entry is
``serving.make_batchers(InferenceEngine)``: one ``DynamicBatcher`` per
endpoint over one engine, as ``serve()`` builds them, each request one
``DynamicBatcher.submit``. Traffic parameters:

- ``rate``: requests per second offered; ``shares``: each endpoint's
  share of them (``generate``, ``adjust``, ``discriminate``);
- ``engine_batch`` and ``max_wait_ms``: the engine's fixed batch and the
  batchers' collection wait;
- ``senders``: threads that send, each taking the next request due;
- ``image_pool``: distinct images the ``adjust`` and ``discriminate``
  requests carry, uint8 levels drawn from the seed;
- ``check_requests``: requests of the window the check compares, drawn
  from the seed; ``trace_seconds``: traffic traced after the window.

Every seed offers the same work: ``rate * seconds`` requests whose gaps
are the quantiles of the exponential distribution (Poisson arrivals) and
whose endpoints come in the stated shares, shuffled by the seed; each
``generate`` carries its own noise and attribute bits, each ``adjust``
its image and target bits.

Once the window has closed and the engine is freed, the plain float32
reference recomputes the sampled requests from the same inputs, and the
check compares, per endpoint in the mix, the worst gap of an answer's
value (a pixel in [-1, 1], or a probability) from the reference's, over
the sampled requests of that endpoint.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np

from benchmark import harness
from benchmark.drivers.train_graph import port_config
from benchmark.reference import littlegan as ref

ENDPOINTS = ("generate", "adjust", "discriminate")
SPANS = ("engine call", "batcher wait")  # an idle gap's name: the first span that covers it
WAIT_AFTER_S = 60.0  # how long past the window's close a late answer is waited for
TRACE_MARGIN_S = 5.0  # traffic offered past the traced window, which starts when the profiler has


def arrivals(n: int, rate: float, shares: Dict[str, float], rng: np.random.Generator):
    """(due times in seconds from the start, endpoint index) of ``n``
    requests: exponential gaps at their quantiles, endpoints in their
    shares, both in an order drawn from ``rng``."""
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng.shuffle(gaps)
    counts = [int(round(shares.get(e, 0.0) * n)) for e in ENDPOINTS]
    counts[int(np.argmax(counts))] += n - sum(counts)
    kinds = np.repeat(np.arange(len(ENDPOINTS)), counts)
    rng.shuffle(kinds)
    return np.cumsum(gaps), kinds


def soft_bits(rng: np.random.Generator, shape) -> np.ndarray:
    return np.where(rng.random(shape) < 0.5, ref.soft(1.0), ref.soft(-1.0)).astype(np.float32)


class Requests:
    """Every request's endpoint, due time and inputs."""

    def __init__(self, cfg: dict, tr: dict, seconds: float, extra_s: float, rng: np.random.Generator):
        rate = float(tr["rate"])
        self.n_window = int(round(rate * seconds))
        t1, k1 = arrivals(self.n_window, rate, tr["shares"], rng)
        n_extra = int(round(rate * extra_s))
        t2, k2 = arrivals(n_extra, rate, tr["shares"], rng) if n_extra else (np.zeros(0), np.zeros(0, int))
        self.due = np.concatenate([t1, seconds + t2])
        self.kind = np.concatenate([k1, k2]).astype(int)
        n, c, d = len(self.due), len(cfg["attr"]), cfg["image_dim"]
        self.noise = rng.standard_normal((n, cfg["noise_dim"])).astype(np.float32)
        self.cond = soft_bits(rng, (n, c))
        pool = rng.integers(0, 256, (tr.get("image_pool", 256), d, d, cfg.get("image_channel", 3)), np.uint8)
        self.images = pool.astype(np.float32) / 127.5 - 1.0
        self.image_of = rng.integers(0, len(self.images), n)

    def __len__(self):
        return len(self.due)

    def rows(self, i: int):
        """The rows ``DynamicBatcher.submit`` takes for request ``i``."""
        kind = ENDPOINTS[self.kind[i]]
        if kind == "generate":
            return self.noise[i], self.cond[i]
        if kind == "adjust":
            return self.images[self.image_of[i]], (self.cond[i] + 1.0) * 0.5
        return (self.images[self.image_of[i]],)


def rows_served(metrics_text: str) -> Dict[str, float]:
    """(rows, dispatches) summed over the endpoints, from ``ServerMetrics.render()``."""
    out = {"rows": 0.0, "dispatches": 0.0}
    for line in metrics_text.splitlines():
        if line.startswith("littlegan_batch_rows_total{"):
            out["rows"] += float(line.rsplit(" ", 1)[1])
        elif line.startswith("littlegan_batch_dispatches_total{"):
            out["dispatches"] += float(line.rsplit(" ", 1)[1])
    return out


def reference_answers(cfg: dict, p0, reqs: Requests, ids: List[int], device, precision=ref.F32, block: int = 64):
    """The reference's answer to each request in ``ids`` (numpy)."""
    import torch

    model = ref.Model.from_config(cfg, precision)
    out = {}
    with torch.no_grad():
        for kind in range(len(ENDPOINTS)):
            these = [i for i in ids if reqs.kind[i] == kind]
            for s in range(0, len(these), block):
                part = these[s:s + block]
                cols = [torch.as_tensor(np.stack(c), device=device) for c in zip(*(reqs.rows(i) for i in part))]
                if kind == 0:
                    res = model.generator(p0, *cols).cpu().numpy()
                elif kind == 1:
                    res = model.adjuster(p0, *cols).cpu().numpy()
                else:
                    pr, c = model.discriminator(p0, cols[0])
                    res = np.concatenate([pr.cpu().numpy(), c.cpu().numpy()], 1)
                out.update(zip(part, res))
    return out


def as_array(answer) -> np.ndarray:
    """One answer as a flat array; the discriminator's batcher answers (pr, cond)."""
    if isinstance(answer, tuple):
        return np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in answer])
    return np.asarray(answer, np.float32).reshape(-1)


def compare(reqs: Requests, got: Dict[int, object], want: Dict[int, np.ndarray]) -> Dict[str, float]:
    """Per endpoint in the sample, the worst absolute gap of a value and
    the worst root-mean-square gap of an answer."""
    out = {}
    for kind, name in enumerate(ENDPOINTS):
        ids = [i for i in want if reqs.kind[i] == kind and i in got]
        if not ids:
            continue
        gaps = [np.abs(as_array(got[i]) - want[i].reshape(-1)) for i in ids]
        out[f"{name}_max_gap"] = float(max(g.max() for g in gaps))
        out[f"{name}_rms_gap"] = float(max(np.sqrt(np.mean(g ** 2)) for g in gaps))
    return out


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from littlegan_tpu_torch.serving import InferenceEngine, ServerMetrics, close_batchers, make_batchers

    cfgd, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    cuda = dev.type == "cuda"
    cfg = port_config(cfgd, restore=False)
    gen = torch.Generator(device=dev).manual_seed(ctx.sub_seed(1))
    p0 = ref.init_params(ref.Model.from_config(cfgd).shapes(), gen, dev)
    engine = InferenceEngine(cfg, params={k: v.cpu().numpy() for k, v in p0.items()},
                             batch_size=tr["engine_batch"], device=dev)
    for name in ENDPOINTS:  # the harness's span around each engine call
        def timed(*a, _fn=getattr(engine, name), **kw):
            with ctx.spans.span("engine call", timed=True):
                return _fn(*a, **kw)
        setattr(engine, name, timed)
    metrics = ServerMetrics(engine.batch)
    batchers = make_batchers(engine, tr["max_wait_ms"], metrics)
    trace_s = float(tr.get("trace_seconds", 1.0)) if ctx.trace else 0.0
    extra_s = trace_s + TRACE_MARGIN_S if ctx.trace else 0.0
    rng = np.random.default_rng(ctx.sub_seed(2))
    reqs = Requests(cfgd, tr, ctx.seconds, extra_s, rng)
    sample = set(rng.choice(reqs.n_window, min(tr["check_requests"], reqs.n_window), replace=False).tolist())

    # warm-up: each endpoint of the mix, alone and with a full batch in flight
    used = sorted(set(reqs.kind.tolist()))
    for kind in used:
        probe = int(np.flatnonzero(reqs.kind == kind)[0])
        for _ in range(3):
            batchers[ENDPOINTS[kind]].submit(*reqs.rows(probe))
        threads = [threading.Thread(target=batchers[ENDPOINTS[kind]].submit, args=reqs.rows(probe))
                   for _ in range(tr["engine_batch"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.3f} s: {len(reqs)} requests, {reqs.n_window} in the window")

    latency = np.full(len(reqs), np.inf)
    late = np.zeros(len(reqs))
    answers: Dict[int, object] = {}
    nxt, lock = [0], threading.Lock()
    t0 = time.perf_counter() + 0.05

    def sender():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(reqs):
                return
            due = t0 + reqs.due[i]
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = time.perf_counter() - due
            try:
                with ctx.spans.span("batcher wait"):
                    answer = batchers[ENDPOINTS[reqs.kind[i]]].submit(*reqs.rows(i))
            except Exception as e:  # a failed request counts in `failed` and misses every latency
                ctx.log(f"request {i} failed: {type(e).__name__}: {e}")
                continue
            latency[i] = (time.perf_counter() - due) * 1e3
            if i in sample:
                answers[i] = answer

    senders = [threading.Thread(target=sender, daemon=True) for _ in range(tr["senders"])]
    for t in senders:
        t.start()
    time.sleep(max(0.0, t0 - time.perf_counter()))
    before = rows_served(metrics.render())
    time.sleep(max(0.0, t0 + ctx.seconds - time.perf_counter()))
    after = rows_served(metrics.render())
    trace = None
    if ctx.trace:
        trace = harness.profiled(ctx.spans, lambda: time.sleep(trace_s))
    for t in senders:
        t.join(timeout=max(1.0, t0 + ctx.seconds + extra_s + WAIT_AFTER_S - time.perf_counter()))
    close_batchers(batchers)
    if cuda:
        torch.cuda.synchronize(dev)
    win = slice(0, reqs.n_window)
    failed = int(np.sum(~np.isfinite(latency[win])))
    lw = late[win]
    ctx.log(f"generator lateness ms: p50 {np.percentile(lw, 50) * 1e3:.3f} p99 {np.percentile(lw, 99) * 1e3:.3f} "
            f"max {lw.max() * 1e3:.3f}; {failed} of {reqs.n_window} failed")
    readings = {
        "kind": "serve", "setup_s": setup_s, "latencies_ms": latency[win].tolist(),
        "engine_call_s": ctx.spans.durations("engine call", t0, t0 + ctx.seconds),
        "batch_rows": after["rows"] - before["rows"], "batch_dispatches": after["dispatches"] - before["dispatches"],
        "config": cfgd, "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }
    if trace is not None:
        readings.update(trace=trace, idle_gaps=trace.idle_gaps(SPANS, "no request"))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    del engine, batchers
    if cuda:
        torch.cuda.empty_cache()
    ref.no_tf32()
    want = reference_answers(cfgd, p0, reqs, sorted(sample), dev)
    nums = compare(reqs, answers, want)
    ctx.log(f"check: {len(answers)} of {len(sample)} sampled requests answered; readings {nums}")
    if ctx.controls:  # the fp8 reference in the program's place; answers swapped between requests
        readings["program"] = nums
        fp8 = reference_answers(cfgd, p0, reqs, sorted(sample), dev, ref.Precision("fp8"))
        readings["control"] = compare(reqs, fp8, want)
        swapped = {}
        for kind in range(len(ENDPOINTS)):  # each answer handed to the next request of its endpoint
            ids = [i for i in sorted(answers) if reqs.kind[i] == kind]
            swapped.update(zip(ids, [answers[i] for i in ids[1:] + ids[:1]]))
        readings["swapped"] = compare(reqs, swapped, want)
    checks = [(name, nums.get(name, float("inf")), float(lim)) for name, lim in ctx.cell.limits.items()]
    return harness.Outcome(reqs.n_window, failed, readings, checks, peak)
