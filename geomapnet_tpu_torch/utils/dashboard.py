"""Live training dashboard: the reference's visdom windows, zero-dependency.

A copy of :mod:`geomapnet_tpu.utils.dashboard` (stdlib only; that package
cannot be imported without jax); tests/test_torch_import_isolation.py pins
``read_metrics`` and ``list_experiments`` to the originals.

The upstream trainer pushes train/val loss, log10(lr) and the learnable
criterion parameters to a visdom server as it trains (upstream
common/train.py:120-141 window setup, :252-311 the per-epoch updateTrace
calls). The port's Trainer streams every one of those quantities to
``logs/<exp>/metrics.jsonl`` (utils/logger.py::MetricsWriter), so the live
dashboard needs no hook inside the train loop:
this module serves a self-contained HTML page (hand-rolled SVG, no CDN —
training hosts have no egress) that polls the JSONL tail every 2 s. It
therefore works identically on a live run and on a finished log directory.

Charts, matching the reference's three windows plus one:

- loss: train + val curves (``loss_win``)
- learning rate: log10(lr) (``lr_win``)
- criterion parameters: sax/saq/srx/srq trajectories (``criterion_param_win``)
- step timing: data/batch time averages (the reference prints these but
  never plots them)

Usage::

    python -m geomapnet_tpu_torch.cli.dashboard --logdir logs --port 8097

(8097 is visdom's default port.) ``--logdir`` may point at one experiment
directory or at a root containing many; the page offers a selector.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

__all__ = [
    "read_metrics",
    "list_experiments",
    "make_server",
    "serve_forever",
]

MAX_ROWS = 4000  # per kind, evenly thinned beyond this (first+last kept)


def read_metrics(path: str | Path, limit: int = MAX_ROWS) -> list[dict]:
    """Parse a metrics.jsonl, tolerating a partially-written last line.

    The file is being appended by a live Trainer; a torn tail line (or any
    corrupt line) is skipped rather than fatal. Rows are thinned per
    ``kind`` to ``limit`` points, always keeping each kind's first and last
    row, and returned in file order.
    """
    rows: list[tuple[int, dict]] = []
    try:
        text = Path(path).read_text()
    except OSError:
        return []
    for i, line in enumerate(text.splitlines()):
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if isinstance(row, dict):
            rows.append((i, row))

    by_kind: dict[str, list[tuple[int, dict]]] = {}
    for i, row in rows:
        by_kind.setdefault(str(row.get("kind", "metrics")), []).append((i, row))
    kept: list[tuple[int, dict]] = []
    for group in by_kind.values():
        if len(group) <= limit:
            kept.extend(group)
        else:
            stride = (len(group) - 1) / (limit - 1)
            idx = sorted({round(j * stride) for j in range(limit)})
            kept.extend(group[j] for j in idx)
    kept.sort(key=lambda t: t[0])
    return [row for _, row in kept]


def list_experiments(root: str | Path) -> dict[str, Path]:
    """Map experiment name -> metrics.jsonl under ``root``.

    ``root`` itself (if it holds a metrics.jsonl) and each immediate child
    directory count as experiments — the layout ``logs/<experiment>/`` the
    Trainer writes (train/loop.py).
    """
    root = Path(root)
    found: dict[str, Path] = {}
    own = root / "metrics.jsonl"
    if own.is_file():
        found[root.resolve().name or "metrics"] = own
    if root.is_dir():
        for child in sorted(root.iterdir()):
            m = child / "metrics.jsonl"
            if child.is_dir() and m.is_file():
                found[child.name] = m
    return found


class _Handler(BaseHTTPRequestHandler):
    root: Path  # set by make_server on the subclass

    def log_message(self, *args):  # quiet by default; it's a poll loop
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        url = urlparse(self.path)
        if url.path == "/":
            self._send(200, PAGE.encode(), "text/html; charset=utf-8")
        elif url.path == "/data":
            exps = list_experiments(self.root)
            names = list(exps)
            want = parse_qs(url.query).get("exp", [None])[0]
            exp = want if want in exps else (names[0] if names else None)
            rows = read_metrics(exps[exp]) if exp else []
            body = json.dumps(
                {"experiments": names, "exp": exp, "rows": rows}
            ).encode()
            self._send(200, body, "application/json")
        else:
            self._send(404, b"not found", "text/plain")


def make_server(logdir: str | Path, port: int = 8097,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Build (but don't start) the dashboard HTTP server; port 0 = ephemeral."""
    handler = type("Handler", (_Handler,), {"root": Path(logdir)})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever(logdir: str | Path, port: int = 8097,
                  host: str = "127.0.0.1",
                  background: bool = False) -> ThreadingHTTPServer:
    srv = make_server(logdir, port, host)
    print(f"dashboard: http://{host}:{srv.server_address[1]}/ "
          f"(watching {logdir})")
    if background:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    else:
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            srv.shutdown()
    return srv


# Self-contained page: CSS custom properties carry the validated palette
# (light + dark steps of the same hues); charts are hand-rolled SVG with a
# crosshair tooltip; identity is never color-alone (legend + direct end
# labels). Polls /data every 2s.
PAGE = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>geomapnet_tpu training dashboard</title>
<style>
  :root {
    color-scheme: light;
    --surface: #fcfcfb; --card: #ffffff; --border: #e4e3df;
    --text-primary: #0b0b0b; --text-secondary: #52514e; --grid: #ececea;
    --s1: #2a78d6; --s2: #eb6834; --s3: #1baf7a; --s4: #eda100;
  }
  @media (prefers-color-scheme: dark) {
    :root:not([data-theme="light"]) {
      color-scheme: dark;
      --surface: #1a1a19; --card: #222221; --border: #3a3937;
      --text-primary: #ffffff; --text-secondary: #c3c2b7; --grid: #2e2e2c;
      --s1: #3987e5; --s2: #d95926; --s3: #199e70; --s4: #c98500;
    }
  }
  :root[data-theme="dark"] {
    color-scheme: dark;
    --surface: #1a1a19; --card: #222221; --border: #3a3937;
    --text-primary: #ffffff; --text-secondary: #c3c2b7; --grid: #2e2e2c;
    --s1: #3987e5; --s2: #d95926; --s3: #199e70; --s4: #c98500;
  }
  body { margin: 0; background: var(--surface); color: var(--text-primary);
         font: 13px/1.45 system-ui, sans-serif; }
  header { display: flex; gap: 12px; align-items: baseline;
           padding: 10px 16px; border-bottom: 1px solid var(--border); }
  header h1 { font-size: 15px; margin: 0; font-weight: 600; }
  header .meta { color: var(--text-secondary); }
  header select, header button {
    font: inherit; color: inherit; background: var(--card);
    border: 1px solid var(--border); border-radius: 6px; padding: 2px 8px; }
  #grid { display: grid; grid-template-columns: repeat(auto-fit, minmax(420px, 1fr));
          gap: 14px; padding: 14px 16px; }
  .card { background: var(--card); border: 1px solid var(--border);
          border-radius: 10px; padding: 10px 12px 6px; }
  .card h2 { font-size: 13px; font-weight: 600; margin: 0 0 2px; }
  .legend { display: flex; gap: 14px; margin: 2px 0 4px;
            color: var(--text-secondary); flex-wrap: wrap; }
  .legend span::before { content: ""; display: inline-block; width: 10px;
    height: 10px; border-radius: 3px; margin-right: 5px;
    background: var(--c); vertical-align: -1px; }
  svg text { fill: var(--text-secondary); font: 11px system-ui, sans-serif; }
  svg .grid { stroke: var(--grid); stroke-width: 1; }
  svg .axis { stroke: var(--border); stroke-width: 1; }
  svg .line { fill: none; stroke-width: 2; stroke-linejoin: round; }
  svg .cross { stroke: var(--text-secondary); stroke-dasharray: 3 3;
               stroke-width: 1; }
  svg .endlab { font-weight: 600; }
  #tip { position: fixed; pointer-events: none; background: var(--card);
         border: 1px solid var(--border); border-radius: 6px;
         padding: 5px 8px; display: none; box-shadow: 0 2px 8px #0003;
         z-index: 9; }
  #tip b { font-weight: 600; }
  .empty { color: var(--text-secondary); padding: 30px 0 36px;
           text-align: center; }
</style>
</head>
<body>
<header>
  <h1>geomapnet_tpu training</h1>
  <select id="exp"></select>
  <span class="meta" id="meta">connecting&hellip;</span>
  <span style="flex:1"></span>
  <button id="theme" title="toggle light/dark">&#9681;</button>
</header>
<div id="grid"></div>
<div id="tip"></div>
<script>
"use strict";
const GRID = document.getElementById("grid");
const TIP = document.getElementById("tip");
const SEL = document.getElementById("exp");
const META = document.getElementById("meta");
let cur = null, paused = false;

document.getElementById("theme").onclick = () => {
  const r = document.documentElement;
  const dark = getComputedStyle(r).colorScheme.includes("dark");
  r.dataset.theme = dark ? "light" : "dark";
  if (last) render(last);
};
SEL.onchange = () => { cur = SEL.value; tick(); };

function cssVar(n) {
  return getComputedStyle(document.documentElement).getPropertyValue(n).trim();
}
function fmt(v) {
  if (!isFinite(v)) return String(v);
  const a = Math.abs(v);
  if (a !== 0 && (a < 1e-3 || a >= 1e5)) return v.toExponential(2);
  return +v.toFixed(4) + "";
}
function niceTicks(lo, hi, n) {
  if (!(hi > lo)) { hi = lo + 1; lo -= 1; }
  const span = hi - lo, step0 = span / Math.max(1, n);
  const mag = Math.pow(10, Math.floor(Math.log10(step0)));
  const step = [1, 2, 5, 10].map(m => m * mag).find(s => span / s <= n) || mag * 10;
  const t = [];
  for (let v = Math.ceil(lo / step) * step; v <= hi + 1e-9 * span; v += step)
    t.push(v);
  return t;
}

// series: [{name, colorVar, x:[], y:[]}] — draws one SVG chart card
function chart(card, series, yLabel) {
  const W = card.clientWidth - 26, H = 220;
  const ml = 54, mr = 64, mt = 8, mb = 24;
  const pts = series.filter(s => s.x.length);
  if (!pts.length) {
    card.querySelector(".plot").innerHTML =
      '<div class="empty">no data yet</div>';
    return;
  }
  let x0 = 1/0, x1 = -1/0, y0 = 1/0, y1 = -1/0;
  for (const s of pts) for (let i = 0; i < s.x.length; i++) {
    x0 = Math.min(x0, s.x[i]); x1 = Math.max(x1, s.x[i]);
    y0 = Math.min(y0, s.y[i]); y1 = Math.max(y1, s.y[i]);
  }
  if (x0 === x1) { x0 -= 1; x1 += 1; }
  if (y0 === y1) { y0 -= 1; y1 += 1; }
  const pad = (y1 - y0) * 0.06; y0 -= pad; y1 += pad;
  const sx = v => ml + (v - x0) / (x1 - x0) * (W - ml - mr);
  const sy = v => mt + (y1 - v) / (y1 - y0) * (H - mt - mb);
  let g = "";
  for (const t of niceTicks(y0, y1, 5)) {
    g += `<line class="grid" x1="${ml}" x2="${W - mr}" y1="${sy(t)}" y2="${sy(t)}"/>` +
         `<text x="${ml - 6}" y="${sy(t) + 3}" text-anchor="end">${fmt(t)}</text>`;
  }
  for (const t of niceTicks(x0, x1, 6)) {
    g += `<text x="${sx(t)}" y="${H - 7}" text-anchor="middle">${fmt(t)}</text>`;
  }
  g += `<line class="axis" x1="${ml}" x2="${W - mr}" y1="${H - mb}" y2="${H - mb}"/>`;
  for (const s of pts) {
    const d = s.x.map((v, i) =>
      `${i ? "L" : "M"}${sx(v).toFixed(1)},${sy(s.y[i]).toFixed(1)}`).join("");
    const col = cssVar(s.colorVar);
    g += `<path class="line" stroke="${col}" d="${d}"/>`;
    const li = s.x.length - 1;
    g += `<text class="endlab" x="${sx(s.x[li]) + 5}" y="${sy(s.y[li]) + 4}"` +
         ` style="fill:${col}">${fmt(s.y[li])}</text>`;
  }
  g += `<line class="cross" y1="${mt}" y2="${H - mb}" x1="-9" x2="-9"/>`;
  const svg = card.querySelector(".plot");
  svg.innerHTML = `<svg width="${W}" height="${H}" role="img"
    aria-label="${yLabel}">${g}</svg>`;
  const el = svg.firstElementChild;
  const crossEl = el.querySelector(".cross");
  el.onmousemove = ev => {
    const r = el.getBoundingClientRect();
    const xv = x0 + (ev.clientX - r.left - ml) / (W - ml - mr) * (x1 - x0);
    let best = null;
    for (const s of pts) {
      let lo = 0, hi = s.x.length - 1;
      while (hi - lo > 1) {
        const m = (lo + hi) >> 1;
        if (s.x[m] < xv) lo = m; else hi = m;
      }
      const i = Math.abs(s.x[lo] - xv) < Math.abs(s.x[hi] - xv) ? lo : hi;
      if (!best || Math.abs(s.x[i] - xv) < Math.abs(best.xv - xv))
        best = { xv: s.x[i] };
    }
    if (!best) return;
    crossEl.setAttribute("x1", sx(best.xv));
    crossEl.setAttribute("x2", sx(best.xv));
    let html = `<b>step ${fmt(best.xv)}</b>`;
    for (const s of pts) {
      const i = s.x.indexOf(best.xv);
      const j = i >= 0 ? i : nearest(s.x, best.xv);
      html += `<br><span style="color:${cssVar(s.colorVar)}">&#9632;</span> ` +
              `${s.name}: ${fmt(s.y[j])}`;
    }
    TIP.innerHTML = html;
    TIP.style.display = "block";
    TIP.style.left = Math.min(ev.clientX + 14, innerWidth - 170) + "px";
    TIP.style.top = (ev.clientY + 12) + "px";
  };
  el.onmouseleave = () => {
    TIP.style.display = "none"; crossEl.setAttribute("x1", -9);
    crossEl.setAttribute("x2", -9);
  };
}
function nearest(xs, v) {
  let bi = 0, bd = 1/0;
  for (let i = 0; i < xs.length; i++) {
    const d = Math.abs(xs[i] - v); if (d < bd) { bd = d; bi = i; }
  }
  return bi;
}

function card(title, names, colorVars) {
  const div = document.createElement("div");
  div.className = "card";
  const leg = names.length > 1
    ? `<div class="legend">` + names.map((n, i) =>
        `<span style="--c:var(${colorVars[i]})">${n}</span>`).join("") +
      `</div>`
    : "";
  div.innerHTML = `<h2>${title}</h2>${leg}<div class="plot"></div>`;
  GRID.appendChild(div);
  return div;
}

const CARDS = {
  loss: card("Loss", ["train", "val"], ["--s1", "--s2"]),
  lr: card("Learning rate — log10(lr)", ["log10(lr)"], ["--s1"]),
  crit: card("Criterion parameters", ["sax", "saq", "srx", "srq"],
             ["--s1", "--s2", "--s3", "--s4"]),
  time: card("Step timing (s, running avg)", ["data", "batch"],
             ["--s1", "--s2"]),
};

let last = null;
function render(data) {
  const tr = data.rows.filter(r => r.kind === "train");
  const va = data.rows.filter(r => r.kind === "val");
  const xs = rows => rows.map(r => r.step ?? r.epoch ?? 0);
  const pick = (rows, f) => {
    const x = [], y = [];
    rows.forEach(r => {
      if (typeof r[f] === "number" && isFinite(r[f])) {
        x.push(r.step ?? r.epoch ?? 0); y.push(r[f]);
      }
    });
    return { x, y };
  };
  const lr = pick(tr, "lr");
  chart(CARDS.loss, [
    { name: "train", colorVar: "--s1", ...pick(tr, "loss") },
    { name: "val", colorVar: "--s2", ...pick(va, "loss") },
  ], "loss");
  chart(CARDS.lr, [{ name: "log10(lr)", colorVar: "--s1", x: lr.x,
                     y: lr.y.map(v => Math.log10(Math.max(v, 1e-30))) }],
        "log10 learning rate");
  chart(CARDS.crit, ["sax", "saq", "srx", "srq"].map((k, i) => (
    { name: k, colorVar: `--s${i + 1}`, ...pick(tr, k) })), "criterion");
  chart(CARDS.time, [
    { name: "data", colorVar: "--s1", ...pick(tr, "data_time") },
    { name: "batch", colorVar: "--s2", ...pick(tr, "batch_time") },
  ], "seconds");
}

async function tick() {
  try {
    const q = cur ? "?exp=" + encodeURIComponent(cur) : "";
    const data = await (await fetch("/data" + q)).json();
    last = data;
    cur = data.exp;
    if (SEL.length !== data.experiments.length ||
        [...SEL.options].some((o, i) => o.value !== data.experiments[i])) {
      SEL.innerHTML = data.experiments.map(e =>
        `<option${e === cur ? " selected" : ""}>${e}</option>`).join("");
    }
    SEL.value = cur ?? "";
    META.textContent = data.exp
      ? `${data.exp} — ${data.rows.length} rows, ` +
        new Date().toLocaleTimeString()
      : "no metrics.jsonl found";
    render(data);
  } catch (e) {
    META.textContent = "poll failed: " + e;
  }
}
tick();
setInterval(() => { if (!document.hidden) tick(); }, 2000);
</script>
</body>
</html>
"""
