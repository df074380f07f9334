"""The live training dashboard (the JAX package's
``utils/plot_server.py``, its stand-in for the reference's visdom display):
a standard-library ``ThreadingHTTPServer`` on a daemon thread serving one
page that reads what the ``Visualizer`` already writes, the
``loss_history.jsonl`` records and the HTML gallery's newest
``web/images/epochNNN_<label>.png`` files, polling every 2 s.

``--display_id 1`` (display_id > 0, the reference's convention) turns it
on, serving on ``--display_port`` (default 8097) at ``--display_host``
(default 127.0.0.1, loopback only: the page is unauthenticated).  A port
that cannot be bound prints a warning and training goes on without the
display.  Endpoints: ``/`` the page, ``/history`` the parsed records (the
appended tail parsed once, a torn last line left for the next poll),
``/images`` the newest epoch's names, ``/images/<name>`` one of them (the
gallery's names only).  The page draws one small chart a loss, each on its
own axis, and a table of the latest records.
"""

from __future__ import annotations

import html as _html
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

_EPOCH_IMG = re.compile(r"^epoch(\d{3,})_([A-Za-z0-9_]+)\.png$")

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>%NAME% — dfmir_tpu</title>
<style>
.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f0efec;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e4e3df; --series-1: #2a78d6;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #262625;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #32312f; --series-1: #3987e5;
  }
}
:root[data-theme="dark"] .viz-root {
  color-scheme: dark;
  --surface-1: #1a1a19; --surface-2: #262625;
  --text-primary: #ffffff; --text-secondary: #c3c2b7;
  --grid: #32312f; --series-1: #3987e5;
}
body { margin: 0; }
.viz-root {
  font: 13px/1.45 system-ui, -apple-system, sans-serif;
  background: var(--surface-1); color: var(--text-primary);
  min-height: 100vh; padding: 16px 20px;
}
h1 { font-size: 16px; font-weight: 600; margin: 0 0 2px; }
.sub { color: var(--text-secondary); margin-bottom: 14px; }
.controls { display: flex; gap: 8px; align-items: center;
  margin: 0 0 12px; }
.controls button {
  font: inherit; color: var(--text-primary);
  background: var(--surface-2); border: 1px solid var(--grid);
  border-radius: 6px; padding: 3px 10px; cursor: pointer;
}
.controls button[aria-pressed="true"] {
  border-color: var(--series-1); font-weight: 600;
}
.grid { display: grid; gap: 14px;
  grid-template-columns: repeat(auto-fill, minmax(300px, 1fr)); }
.card { background: var(--surface-1); border: 1px solid var(--grid);
  border-radius: 8px; padding: 10px 12px 6px; }
.card h2 { font-size: 12px; font-weight: 600; margin: 0;
  color: var(--text-secondary); text-transform: none; }
.card .latest { font-size: 18px; font-weight: 600; margin: 0 0 4px; }
svg { display: block; width: 100%; height: 120px; }
.tip { position: fixed; pointer-events: none; z-index: 10;
  background: var(--surface-2); border: 1px solid var(--grid);
  border-radius: 6px; padding: 5px 9px; display: none; }
.tip .v { font-weight: 600; }
.tip .k { color: var(--text-secondary); }
table { border-collapse: collapse; margin-top: 10px; width: 100%;
  font-variant-numeric: tabular-nums; }
th, td { text-align: right; padding: 3px 10px;
  border-bottom: 1px solid var(--grid); }
th { color: var(--text-secondary); font-weight: 600; }
#imgs { display: flex; flex-wrap: wrap; gap: 10px; margin-top: 6px; }
#imgs figure { margin: 0; }
#imgs img { width: %WINSIZE%px; max-width: 100%;
  border: 1px solid var(--grid); border-radius: 6px; display: block; }
#imgs figcaption { color: var(--text-secondary); font-size: 12px;
  text-align: center; padding-top: 2px; }
section { margin-top: 22px; }
.hidden { display: none; }
</style></head>
<body class="viz-root">
<h1>%NAME%</h1>
<div class="sub" id="status">waiting for loss_history.jsonl…</div>
<div class="controls">
  <button id="btn-charts" aria-pressed="true">Charts</button>
  <button id="btn-table" aria-pressed="false">Table</button>
</div>
<div class="grid" id="charts"></div>
<div id="table" class="hidden"></div>
<section><h1>Latest visuals</h1><div id="imgs"></div></section>
<div class="tip" id="tip"></div>
<script>
"use strict";
const fmt = v => {
  if (!isFinite(v)) return String(v);
  const a = Math.abs(v);
  if (a !== 0 && (a < 1e-3 || a >= 1e5)) return v.toExponential(3);
  return String(parseFloat(v.toPrecision(4)));
};
let records = [];
const charts = {};            // key -> {card, svg, latestEl}

function makeChart(key) {
  const card = document.createElement('div'); card.className = 'card';
  const h = document.createElement('h2'); h.textContent = key;
  const latest = document.createElement('div'); latest.className = 'latest';
  const svg = document.createElementNS('http://www.w3.org/2000/svg', 'svg');
  card.append(h, latest, svg);
  document.getElementById('charts').append(card);
  charts[key] = {card, svg, latestEl: latest, pts: []};
  attachHover(svg, key);
  return charts[key];
}

function drawChart(key, xs, ys) {
  const c = charts[key] || makeChart(key);
  c.latestEl.textContent = fmt(ys[ys.length - 1]);
  // coordinate system = rendered size, so text is never stretched
  const W = Math.max(c.svg.clientWidth || 320, 100), H = 120;
  c.svg.setAttribute('viewBox', `0 0 ${W} ${H}`);
  c.W = W;
  const padL = 2, padR = 10, padT = 12, padB = 10;
  let lo = Math.min(...ys), hi = Math.max(...ys);
  if (hi - lo < 1e-12) { hi += 1; lo -= 1; }
  const x0 = xs[0], x1 = xs[xs.length - 1] || 1;
  const sx = x => padL + (x - x0) / Math.max(x1 - x0, 1e-12)
      * (W - padL - padR);
  const sy = y => padT + (hi - y) / (hi - lo) * (H - padT - padB);
  c.pts = xs.map((x, i) => [sx(x), sy(ys[i]), xs[i], ys[i]]);
  let g = '';
  // recessive hairline grid: 3 horizontal lines
  for (let i = 0; i <= 2; i++) {
    const y = padT + i * (H - padT - padB) / 2;
    g += `<line x1="${padL}" y1="${y}" x2="${W - padR}" y2="${y}"
      stroke="var(--grid)" stroke-width="1"
      vector-effect="non-scaling-stroke"/>`;
    const val = hi - i * (hi - lo) / 2;
    if (i !== 2) g += `<text x="${padL + 2}" y="${y + 11}" font-size="9"
      fill="var(--text-secondary)">${fmt(val)}</text>`;
  }
  const path = c.pts.map((p, i) =>
      (i ? 'L' : 'M') + p[0].toFixed(1) + ' ' + p[1].toFixed(1)).join('');
  g += `<path d="${path}" fill="none" stroke="var(--series-1)"
    stroke-width="2" stroke-linejoin="round" stroke-linecap="round"
    vector-effect="non-scaling-stroke"/>`;
  const last = c.pts[c.pts.length - 1];
  g += `<circle cx="${last[0]}" cy="${last[1]}" r="4"
    fill="var(--series-1)" stroke="var(--surface-1)" stroke-width="2"/>`;
  g += `<line class="xhair" x1="0" y1="${padT}" x2="0" y2="${H - padB}"
    stroke="var(--text-secondary)" stroke-width="1" visibility="hidden"
    vector-effect="non-scaling-stroke"/>`;
  c.svg.innerHTML = g;
}

const tip = document.getElementById('tip');
function attachHover(svg, key) {
  svg.addEventListener('pointermove', ev => {
    const c = charts[key];
    if (!c || !c.pts.length) return;
    const r = svg.getBoundingClientRect();
    const mx = (ev.clientX - r.left) / r.width * (c.W || 320);
    let best = c.pts[0], bd = Infinity;
    for (const p of c.pts) {
      const d = Math.abs(p[0] - mx);
      if (d < bd) { bd = d; best = p; }
    }
    const xh = svg.querySelector('.xhair');
    if (xh) { xh.setAttribute('x1', best[0]);
              xh.setAttribute('x2', best[0]);
              xh.setAttribute('visibility', 'visible'); }
    tip.replaceChildren();
    const v = document.createElement('div'); v.className = 'v';
    v.textContent = fmt(best[3]);
    const k = document.createElement('div'); k.className = 'k';
    k.textContent = key + ' · ' + best[2].toFixed(2) + ' epochs';
    tip.append(v, k);
    tip.style.display = 'block';
    tip.style.left = Math.min(ev.clientX + 14,
                              innerWidth - 160) + 'px';
    tip.style.top = (ev.clientY + 14) + 'px';
  });
  svg.addEventListener('pointerleave', () => {
    tip.style.display = 'none';
    const xh = svg.querySelector('.xhair');
    if (xh) xh.setAttribute('visibility', 'hidden');
  });
}

function drawTable() {
  const el = document.getElementById('table');
  el.replaceChildren();
  if (!records.length) return;
  const keys = Object.keys(records[records.length - 1].losses);
  const tbl = document.createElement('table');
  const hr = document.createElement('tr');
  for (const h of ['epoch', 'progress'].concat(keys)) {
    const th = document.createElement('th'); th.textContent = h;
    hr.append(th);
  }
  tbl.append(hr);
  for (const rec of records.slice(-50).reverse()) {
    const tr = document.createElement('tr');
    for (const v of [rec.epoch, rec.counter_ratio.toFixed(3)].concat(
        keys.map(k => fmt(rec.losses[k])))) {
      const td = document.createElement('td'); td.textContent = v;
      tr.append(td);
    }
    tbl.append(tr);
  }
  el.append(tbl);
}

async function refresh() {
  try {
    const r = await fetch('history');
    records = await r.json();
  } catch (e) { return; }
  if (!records.length) return;
  const last = records[records.length - 1];
  document.getElementById('status').textContent =
      `epoch ${last.epoch} · ${records.length} records`;
  const xs = records.map(r => r.epoch - 1 + r.counter_ratio);
  const keys = new Set();
  records.forEach(r => Object.keys(r.losses).forEach(k => keys.add(k)));
  for (const key of keys) {
    const xk = [], yk = [];
    records.forEach((r, i) => {
      if (key in r.losses && isFinite(r.losses[key])) {
        xk.push(xs[i]); yk.push(r.losses[key]);
      }
    });
    if (yk.length) drawChart(key, xk, yk);
  }
  drawTable();
}

async function refreshImages() {
  let names;
  try { names = await (await fetch('images')).json(); }
  catch (e) { return; }
  const box = document.getElementById('imgs');
  box.replaceChildren();
  for (const n of names) {
    const fig = document.createElement('figure');
    const img = document.createElement('img');
    img.src = 'images/' + encodeURIComponent(n) + '?t=' + Date.now();
    img.alt = n;
    const cap = document.createElement('figcaption');
    cap.textContent = n.replace(/^epoch\\d+_/, '').replace(/\\.png$/, '');
    fig.append(img, cap);
    box.append(fig);
  }
}

const bC = document.getElementById('btn-charts');
const bT = document.getElementById('btn-table');
function setView(table) {
  document.getElementById('charts').classList.toggle('hidden', table);
  document.getElementById('table').classList.toggle('hidden', !table);
  bC.setAttribute('aria-pressed', String(!table));
  bT.setAttribute('aria-pressed', String(table));
}
bC.addEventListener('click', () => setView(false));
bT.addEventListener('click', () => setView(true));

refresh(); refreshImages();
setInterval(refresh, 2000);
setInterval(refreshImages, 5000);
</script></body></html>
"""


def _latest_epoch_images(img_dir: str):
    """Names of the newest epoch's gallery images, label-sorted."""
    try:
        names = os.listdir(img_dir)
    except OSError:
        return []
    by_epoch = {}
    for n in names:
        m = _EPOCH_IMG.match(n)
        if m:
            by_epoch.setdefault(int(m.group(1)), []).append(n)
    if not by_epoch:
        return []
    return sorted(by_epoch[max(by_epoch)])


class _Handler(BaseHTTPRequestHandler):
    expr_dir = "."
    page = b""
    # /history incremental-parse cache, shared per handler class (one per
    # server): long trainings append millions of lines; re-parsing the
    # whole file every 2 s poll per client grows without bound.  Parse
    # only the appended tail, keyed on (size, mtime_ns); on truncation or
    # rewrite start over.
    _hist_lock = threading.Lock()
    _hist_key = None      # (st_size, st_mtime_ns) of the last parse
    _hist_offset = 0      # byte offset of the first unparsed line
    _hist_records = None  # parsed records list

    def log_message(self, *a):  # quiet: training console stays clean
        pass

    def _history_json(self) -> bytes:
        cls = type(self)
        hist_path = os.path.join(self.expr_dir, "loss_history.jsonl")
        with cls._hist_lock:
            try:
                st = os.stat(hist_path)
                key = (st.st_size, st.st_mtime_ns)
            except OSError:
                return b"[]"
            if cls._hist_records is None or st.st_size < cls._hist_offset:
                cls._hist_records, cls._hist_offset = [], 0
                cls._hist_key = None
            if key != cls._hist_key:
                try:
                    with open(hist_path) as f:
                        f.seek(cls._hist_offset)
                        for line in f:
                            if not line.endswith("\n"):
                                break  # torn tail write; next poll gets it
                            cls._hist_offset += len(line.encode())
                            line = line.strip()
                            if line:
                                try:
                                    cls._hist_records.append(
                                        json.loads(line))
                                except json.JSONDecodeError:
                                    pass
                    cls._hist_key = key
                except OSError:
                    pass
            return json.dumps(cls._hist_records).encode()

    def _send(self, code, ctype, body):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?")[0]
        if path in ("/", "/index.html"):
            return self._send(200, "text/html; charset=utf-8", self.page)
        if path == "/history":
            return self._send(200, "application/json",
                              self._history_json())
        img_dir = os.path.join(self.expr_dir, "web", "images")
        if path == "/images":
            return self._send(200, "application/json",
                              json.dumps(_latest_epoch_images(img_dir))
                              .encode())
        if path.startswith("/images/"):
            name = os.path.basename(path[len("/images/"):])
            if _EPOCH_IMG.match(name):  # whitelist: no traversal
                try:
                    with open(os.path.join(img_dir, name), "rb") as f:
                        return self._send(200, "image/png", f.read())
                except OSError:
                    pass
        return self._send(404, "text/plain", b"not found")


def start_plot_server(expr_dir: str, name: str, port: int = 8097,
                      host: str = "127.0.0.1",
                      winsize: int = 256) -> Optional[
                          Tuple[ThreadingHTTPServer, threading.Thread]]:
    """Serve the live dashboard for ``expr_dir`` on a daemon thread.

    Binds loopback by default (the dashboard is unauthenticated; pass
    ``--display_host 0.0.0.0`` to expose it).  Returns (server, thread),
    or None if the port could not be bound (training proceeds without the
    display, like the reference's visdom fallback at
    util/visualizer.py:99-104)."""
    handler = type("Handler", (_Handler,), {
        "expr_dir": expr_dir,
        "page": (_PAGE.replace("%NAME%", _html.escape(name))
                 .replace("%WINSIZE%", str(winsize)).encode()),
    })
    try:
        server = ThreadingHTTPServer((host, port), handler)
    except OSError as e:
        print(f"could not start display server on port {port}: {e}; "
              "continuing without live display")
        return None
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    print(f"live dashboard: http://localhost:{port}/ "
          f"(experiment {name})")
    return server, thread
