"""Self-contained HTML experiment report (``report`` CLI mode), the port's
copy of littlegan_tpu/report.py (host only).

The reference links an EXTERNAL report site for its results
(reference README.md:2-7 -> ixarea/littlegan-report); here the framework
generates the report itself from a run's own artifacts — no server, no
dependencies, one portable file at ``result/<exp>/report.html``:

- loss curves (loss/gen, loss/disc, loss/adj) read from the run's own
  TensorBoard event files via the dependency-free reader
  (utils/tensorboard.py::read_scalars — the same format the from-scratch
  writer emits, TF-oracle cross-checked),
- headline stat tiles (epochs, steps, final losses),
- the latest sample grids (train/gen, test/gen, test/adj) inlined base64,
- evaluation history (evaluate/fid-*.log lines, when present),
- the merged run config (config.json — provenance dump, reference
  eager_trainer.py:240-241).

Chart styling follows the repo-wide dataviz method: one axis, thin 2 px
lines, fixed categorical slot order (never cycled), direct labels + legend,
recessive grid, text in ink tokens (never series colors), crosshair+tooltip
hover layer, and a SELECTED dark mode (dark-surface steps of the same hues,
not an automatic flip).
"""

from __future__ import annotations

import base64
import html
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from littlegan_tpu_torch.config import Config

# Categorical slots 1-3 (validated all-pairs in both modes): blue/orange/aqua.
_SERIES = [
    ("loss/gen", "Generator", "#2a78d6", "#3987e5"),
    ("loss/disc", "Discriminator", "#eb6834", "#d95926"),
    ("loss/adj", "Adjuster", "#1baf7a", "#199e70"),
]
_MAX_POINTS = 600  # per series, stride-downsampled (SVG + tooltip payload size)


def _downsample(points: List[Tuple[int, float]]) -> List[Tuple[int, float]]:
    if len(points) <= _MAX_POINTS:
        return points
    stride = -(-len(points) // _MAX_POINTS)
    kept = points[::stride]
    if kept[-1] != points[-1]:
        kept.append(points[-1])  # the final value is a headline — keep it exact
    return kept


def _nice_ticks(lo: float, hi: float, n: int = 5) -> List[float]:
    import math

    span = (hi - lo) or 1.0
    raw = span / max(1, n - 1)
    mag = 10.0 ** math.floor(math.log10(raw))
    for mult in (1, 2, 2.5, 5, 10):
        if raw <= mult * mag:
            step = mult * mag
            break
    else:
        step = raw
    first = step * (lo // step)
    ticks = []
    t = first
    while t <= hi + step * 1e-9:
        if t >= lo - step * 1e-9:
            ticks.append(round(t, 10))
        t += step
    return ticks or [lo, hi]


def _loss_chart_svg(series: Dict[str, List[Tuple[int, float]]]) -> str:
    """One-axis multi-line SVG + embedded data for the hover layer."""
    present = [(tag, label, lt, dk) for tag, label, lt, dk in _SERIES if series.get(tag)]
    if not present:
        return "<p class='muted'>No scalar events found under log/.</p>"
    data = {tag: _downsample(series[tag]) for tag, *_ in present}
    xs = [s for pts in data.values() for s, _ in pts]
    ys = [v for pts in data.values() for _, v in pts]
    x0, x1 = min(xs), max(xs) or 1
    ticks = _nice_ticks(min(ys), max(ys))
    y0, y1 = min(ticks[0], min(ys)), max(ticks[-1], max(ys))
    W, H, L, R, T, B = 920, 320, 56, 120, 14, 30  # plot box + label gutters
    pw, ph = W - L - R, H - T - B
    sx = lambda s: L + (s - x0) / max(1, x1 - x0) * pw
    sy = lambda v: T + (1 - (v - y0) / ((y1 - y0) or 1)) * ph

    grid = "".join(
        f'<line x1="{L}" x2="{L + pw}" y1="{sy(t):.1f}" y2="{sy(t):.1f}" class="grid"/>'
        f'<text x="{L - 8}" y="{sy(t):.1f}" class="tick" text-anchor="end" dy="0.32em">{t:g}</text>'
        for t in ticks
    )
    xticks = "".join(
        f'<text x="{sx(s):.1f}" y="{H - 8}" class="tick" text-anchor="middle">{s}</text>'
        for s in sorted({x0, (x0 + x1) // 2, x1})
    )
    lines, labels = [], []
    for i, (tag, label, _, _) in enumerate(present):
        pts = data[tag]
        path = " ".join(f"{sx(s):.1f},{sy(v):.1f}" for s, v in pts)
        lines.append(
            f'<polyline points="{path}" fill="none" class="s{i}" stroke-width="2" '
            f'stroke-linejoin="round" stroke-linecap="round"/>'
        )
        # direct label at the line end, in ink (identity carried by the chip)
        ly = sy(pts[-1][1])
        labels.append(
            f'<circle cx="{L + pw + 6}" cy="{ly:.1f}" r="4" class="f{i}"/>'
            f'<text x="{L + pw + 14}" y="{ly:.1f}" dy="0.32em" class="dlabel">{label}</text>'
        )
    payload = {
        "series": [
            {"tag": tag, "label": label, "pts": data[tag]} for tag, label, _, _ in present
        ],
        "box": [L, T, pw, ph], "x": [x0, x1], "y": [y0, y1],
    }
    return f"""
<figure class="chart">
 <svg id="losschart" viewBox="0 0 {W} {H}" role="img" aria-label="training loss curves">
  {grid}{xticks}
  {''.join(lines)}
  {''.join(labels)}
  <line id="xhair" y1="{T}" y2="{T + ph}" class="xhair" visibility="hidden"/>
 </svg>
 <div id="tip" class="tip" hidden></div>
 <figcaption class="muted">Per-step training losses (step = optimizer batch; the
 adjuster starts after batch 10 of each epoch, so its curve has per-epoch gaps).</figcaption>
</figure>
<script>
const D={json.dumps(payload)};
const svg=document.getElementById('losschart'),tip=document.getElementById('tip'),
      xh=document.getElementById('xhair');
svg.addEventListener('mousemove',e=>{{
  const r=svg.getBoundingClientRect(),[L,T,pw,ph]=D.box,[x0,x1]=D.x;
  const fx=(e.clientX-r.left)*({W}/r.width);
  if(fx<L||fx>L+pw){{tip.hidden=true;xh.setAttribute('visibility','hidden');return;}}
  const step=x0+(fx-L)/pw*(x1-x0);
  let rows='';
  for(const s of D.series){{
    let best=s.pts[0];
    for(const p of s.pts) if(Math.abs(p[0]-step)<Math.abs(best[0]-step)) best=p;
    rows+=`<div><b>${{s.label}}</b> ${{best[1].toFixed(4)}} <span class="muted">@ ${{best[0]}}</span></div>`;
  }}
  xh.setAttribute('x1',fx);xh.setAttribute('x2',fx);xh.setAttribute('visibility','visible');
  tip.innerHTML=`<div class="muted">step ~${{Math.round(step)}}</div>`+rows;
  tip.hidden=false;
  tip.style.left=Math.min(e.clientX-r.left+14,r.width-170)+'px';
  tip.style.top=(e.clientY-r.top+12)+'px';
}});
svg.addEventListener('mouseleave',()=>{{tip.hidden=true;xh.setAttribute('visibility','hidden');}});
</script>"""


def _img_tag(path: str, caption: str) -> str:
    with open(path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    ext = "png" if path.lower().endswith(".png") else "jpeg"
    return (
        f'<figure class="grid"><img src="data:image/{ext};base64,{b64}" alt="{html.escape(caption)}">'
        f"<figcaption class='muted'>{html.escape(caption)}</figcaption></figure>"
    )


def _latest_images(dirpath: str, n: int = 2) -> List[str]:
    if not os.path.isdir(dirpath):
        return []
    files = [
        os.path.join(dirpath, f)
        for f in os.listdir(dirpath)
        if f.lower().endswith((".jpg", ".png"))
    ]
    return sorted(files, key=os.path.getmtime)[-n:]


def _stat_tiles(stats: Sequence[Tuple[str, str]]) -> str:
    return "<div class='tiles'>" + "".join(
        f"<div class='tile'><div class='tval'>{html.escape(v)}</div>"
        f"<div class='tlabel muted'>{html.escape(k)}</div></div>"
        for k, v in stats
    ) + "</div>"


def generate_report(cfg: Config, out_path: Optional[str] = None) -> str:
    """Render ``result/<exp>/report.html`` from the run's artifacts."""
    from littlegan_tpu_torch.utils.tensorboard import read_scalars

    rd = cfg.result_dir
    logdir = os.path.join(rd, "log")
    series = read_scalars(logdir) if os.path.isdir(logdir) else {}

    # headline numbers
    status_path = os.path.join(rd, "checkpoint", "status.json")
    epoch = step = None
    if os.path.isfile(status_path):
        with open(status_path) as f:
            st = json.load(f)
        epoch, step = st.get("epoch"), st.get("step")
    tiles: List[Tuple[str, str]] = [("experiment", cfg.exp_name)]
    if epoch is not None:
        tiles.append(("epochs completed", str(max(0, int(epoch) - 1))))
    if step is not None:
        tiles.append(("optimizer steps", f"{int(step):,}"))
    for tag, label, _, _ in _SERIES:
        pts = series.get(tag)
        if pts:
            tail = [v for _, v in pts[-10:]]
            tiles.append((f"final {label.lower()} loss", f"{sum(tail) / len(tail):.4f}"))

    # sample grids (latest of each artifact family)
    grids = []
    for sub, cap in (
        (("train", "gen"), "training samples (freq_gen cadence)"),
        (("test", "gen"), "fixture samples (freq_test cadence)"),
        (("test", "adj"), "fixture adjuster output"),
    ):
        for p in _latest_images(os.path.join(rd, *sub), n=1):
            grids.append(_img_tag(p, f"{'/'.join(sub)}/{os.path.basename(p)} — {cap}"))

    # eval history
    eval_rows = []
    for log in ("fid-gen.log", "fid-adj.log"):
        p = os.path.join(rd, "evaluate", log)
        if os.path.isfile(p):
            with open(p) as f:
                body = html.escape(f.read().strip())
            eval_rows.append(f"<h3>{log}</h3><pre>{body}</pre>")

    # merged config (provenance dump)
    cfg_path = os.path.join(rd, "config.json")
    cfg_html = ""
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            merged = json.load(f)
        rows = "".join(
            f"<tr><td>{html.escape(str(k))}</td><td>{html.escape(json.dumps(v))}</td></tr>"
            for k, v in sorted(merged.items())
        )
        cfg_html = f"<table class='cfg'><tbody>{rows}</tbody></table>"

    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    doc = f"""<!doctype html><html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>littlegan-tpu — {html.escape(cfg.exp_name)}</title>
<style>
.viz-root{{
 color-scheme:light;
 --surface-1:#ffffff;--ink-1:#1a1a19;--ink-2:#5d5c54;--grid:#e8e7e0;
 --s0:#2a78d6;--s1:#eb6834;--s2:#1baf7a;
 background:var(--surface-1);color:var(--ink-1);
 font:15px/1.5 system-ui,sans-serif;max-width:980px;margin:0 auto;padding:1.5em 1em 4em;
}}
@media (prefers-color-scheme: dark){{
 :root:where(:not([data-theme="light"])) .viz-root{{
  color-scheme:dark;
  --surface-1:#1a1a19;--ink-1:#ffffff;--ink-2:#c3c2b7;--grid:#33322e;
  --s0:#3987e5;--s1:#d95926;--s2:#199e70;
 }}
}}
.muted{{color:var(--ink-2)}}
h1{{font-size:1.5em;margin:.2em 0}}h2{{font-size:1.15em;margin-top:2em}}
.tiles{{display:flex;flex-wrap:wrap;gap:12px;margin:1em 0}}
.tile{{border:1px solid var(--grid);border-radius:8px;padding:.7em 1.1em;min-width:120px}}
.tval{{font-size:1.45em;font-weight:600;font-variant-numeric:tabular-nums}}
.tlabel{{font-size:.82em}}
.chart{{margin:1em 0;position:relative}}
svg{{width:100%;height:auto}}
.grid{{stroke:var(--grid);stroke-width:1}}
.tick{{fill:var(--ink-2);font-size:11px}}
.dlabel{{fill:var(--ink-1);font-size:12px}}
.s0{{stroke:var(--s0)}}.s1{{stroke:var(--s1)}}.s2{{stroke:var(--s2)}}
.f0{{fill:var(--s0)}}.f1{{fill:var(--s1)}}.f2{{fill:var(--s2)}}
.xhair{{stroke:var(--ink-2);stroke-width:1;stroke-dasharray:3 3}}
.tip{{position:absolute;background:var(--surface-1);border:1px solid var(--grid);
 border-radius:6px;padding:.4em .7em;font-size:.85em;pointer-events:none;
 box-shadow:0 2px 8px rgba(0,0,0,.12);min-width:150px}}
.legend{{display:flex;gap:1.2em;font-size:.9em;margin:.3em 0}}
.legend span::before{{content:"";display:inline-block;width:10px;height:10px;
 border-radius:3px;margin-right:6px;vertical-align:-1px}}
.legend .l0::before{{background:var(--s0)}}.legend .l1::before{{background:var(--s1)}}
.legend .l2::before{{background:var(--s2)}}
figure.grid{{margin:1em 0}}figure.grid img{{max-width:100%;border:1px solid var(--grid);border-radius:6px}}
table.cfg{{border-collapse:collapse;font-size:.85em;width:100%}}
table.cfg td{{border-top:1px solid var(--grid);padding:.3em .6em;font-family:ui-monospace,monospace}}
pre{{background:none;border:1px solid var(--grid);border-radius:6px;padding:.6em;overflow-x:auto;font-size:.85em}}
</style></head><body class="viz-root">
<h1>littlegan-tpu · {html.escape(cfg.exp_name)}</h1>
<p class="muted">Generated {stamp} · env <code>{html.escape(cfg.env)}</code> ·
{cfg.image_dim}×{cfg.image_dim}, batch {cfg.batch_size}, {cfg.cond_dim} attributes</p>
{_stat_tiles(tiles)}
<h2>Training losses</h2>
<div class="legend"><span class="l0">Generator</span><span class="l1">Discriminator</span><span class="l2">Adjuster</span></div>
{_loss_chart_svg(series)}
<h2>Sample grids</h2>
{''.join(grids) or "<p class='muted'>No sample grids yet (train with freq_gen/freq_test &gt; 0).</p>"}
<h2>Evaluation</h2>
{''.join(eval_rows) or "<p class='muted'>No evaluation logs yet (run evaluate-sample, then evaluate).</p>"}
<h2>Config</h2>
{cfg_html or "<p class='muted'>config.json not found.</p>"}
</body></html>"""

    out_path = out_path or os.path.join(rd, "report.html")
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        f.write(doc)
    os.replace(tmp, out_path)
    print(f"report: {out_path}")
    return out_path


def serve_report(
    cfg: Config,
    port: int = 8600,
    max_requests: Optional[int] = None,
    on_bound=None,
) -> int:
    """Serve the experiment report over HTTP, REGENERATED on every request
    (fresh event-file read), so a browser refresh tracks a live run.

    This is the ``visual`` mode's fallback when the tensorboard binary is
    absent (the reference spawns tensorboard unconditionally, main.py:34-36;
    this container, for one, has no tensorboard executable). ``port=0``
    binds an ephemeral port; the bound port is returned. ``max_requests``
    (tests) serves N requests then returns instead of blocking forever;
    ``on_bound`` (tests) is called with the bound port before serving.
    """
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            try:
                path = generate_report(cfg)
                with open(path, "rb") as f:
                    body = f.read()
                code, ctype = 200, "text/html; charset=utf-8"
            except Exception as e:  # noqa: BLE001 — render the failure, keep serving
                body = f"report generation failed: {type(e).__name__}: {e}".encode()
                code, ctype = 500, "text/plain; charset=utf-8"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet per-request stderr lines
            pass

    srv = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
    bound = srv.server_address[1]
    if on_bound is not None:
        on_bound(bound)
    print(
        f"serving the experiment report at http://localhost:{bound}/ "
        "(regenerated per request; Ctrl-C to stop)"
    )
    try:
        if max_requests is None:
            srv.serve_forever()
        else:
            for _ in range(max_requests):
                srv.handle_request()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return bound
