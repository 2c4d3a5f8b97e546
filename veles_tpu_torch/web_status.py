"""The web status dashboard (``veles_tpu/web_status.py``).

    python -m veles_tpu_torch.web_status [--host HOST] [--port PORT]

One process serves a fleet of runs: every launcher started with
``--web-status`` POSTs its status JSON to ``/update`` every
``root.common.web.notification_interval`` seconds
(``Launcher._start_status_notifier``), its log records to ``/logs``
(:class:`WebStatusLogHandler`) and its events to ``/events``
(:class:`WebStatusEventSink`); the serving frontend's
``report_to`` and ``sched serve --status-url`` push their blobs to
``/update`` too. Tools POST queries to ``/service`` (``{"request":
"workflows"|"logs"|"events", ...}``, the JAX package's protocol); a run
silent for ``GARBAGE_TIMEOUT`` seconds is dropped. People read
``/status.html``, ``/logs.html``, ``/slaves.html``, ``/frontend.html``
(the command composer over ``/catalog``), ``/workflow.html`` and
``/timeline.html``; the JSON endpoints ``/jobs.json``,
``/history.json``, ``/cluster.json``, ``/alerts.json``,
``/profile.json``, ``/metrics.json`` and ``/metrics`` read the port's
telemetry (``telemetry/``). The stores are bounded in-memory deques.
It imports the standard library and the port's telemetry only.
"""


import argparse
import collections
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from veles_tpu_torch.config import root
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.telemetry import alerts, federation, profiler
from veles_tpu_torch.telemetry.registry import get_registry
from veles_tpu_torch.telemetry.timeseries import get_history

GARBAGE_TIMEOUT = 60

_STATUS_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu_torch status</title><style>
body { font-family: sans-serif; margin: 2em; background: #fafafa; }
table { border-collapse: collapse; min-width: 60em; }
th, td { border: 1px solid #ccc; padding: 0.4em 0.8em; text-align: left; }
th { background: #eee; }
.dead { color: #999; }
</style></head><body>
<h1>veles_tpu_torch workflows</h1>
<p><a href="/workflow.html">graph view</a> ·
<a href="/timeline.html">event timeline</a> ·
<a href="/slaves.html">slave stats</a> ·
<a href="/logs.html">logs</a> ·
<a href="/frontend.html">command composer</a> ·
<a href="/metrics">metrics</a> ·
<a href="/profile.json">profile</a> ·
<a href="/cluster.json">cluster</a> ·
<a href="/alerts.json">alerts</a> ·
<a href="/jobs.json">jobs</a></p>
<div id="perf" style="margin-bottom:1em"></div>
<table id="wf"><thead><tr>
<th>id</th><th>name</th><th>mode</th><th>master</th><th>uptime</th>
<th>slaves</th><th>units</th><th>serving</th><th>perf</th>
<th>stopped</th>
</tr></thead><tbody></tbody></table>
<h2 id="jobs-h" style="display:none">scheduled jobs</h2>
<table id="jobs" style="display:none"><thead><tr>
<th>id</th><th>name</th><th>tenant</th><th>qos</th><th>state</th>
<th>world</th><th>preempts</th><th>resume s</th>
<th>loss</th><th>MFU</th><th>error</th>
</tr></thead><tbody></tbody></table>
<script>
function servingCell(s) {
  if (!s) return "";
  const model = s.model && s.model.name
    ? s.model.name + " v" + s.model.version + " · " : "";
  return model + (s.qps || 0) + " qps · q" + (s.queue_depth || 0) +
    " · p95 " + (s.p95_ms || 0) + "ms" +
    (s.rejected_total ? " · " + s.rejected_total + " shed" : "");
}
function perfCell(p) {
  if (!p) return "";
  let parts = [];
  if (p.mfu) parts.push("MFU " + (p.mfu * 100).toFixed(1) + "%");
  if (p.flight_record) parts.push("flight: " + p.flight_record);
  return parts.join(" · ");
}
function fmtGB(b) { return (b / 1073741824).toFixed(2) + " GB"; }
function renderPerf(p) {
  const div = document.getElementById("perf");
  let html = "";
  if (p.step_mfu)
    html += "<b>step MFU " + (p.step_mfu * 100).toFixed(1) + "%</b>";
  const mem = p.memory || {};
  const devs = Object.entries(mem.devices || {});
  if (devs.length) {
    html += "<table><thead><tr><th>device</th><th>HBM live</th>" +
      "<th>HBM peak</th><th>limit</th></tr></thead><tbody>";
    for (const [d, m] of devs)
      html += "<tr><td>" + d + "</td><td>" + fmtGB(m.live_bytes || 0) +
        "</td><td>" + fmtGB(m.peak_bytes || 0) + "</td><td>" +
        fmtGB(m.limit_bytes || 0) + "</td></tr>";
    html += "</tbody></table>";
  }
  // per-op roofline rows from the cost book — offload:h2d/g* and
  // offload:d2h/g* rows surface out-of-core transfer traffic here
  const ops = (p.ops || []).filter(o => o.p50_ms != null)
    .sort((a, b) => (b.p50_ms || 0) - (a.p50_ms || 0)).slice(0, 12);
  if (ops.length) {
    html += "<table style='margin-top:0.5em'><thead><tr><th>op</th>" +
      "<th>p50 ms</th><th>MB</th><th>GB/s</th><th>bound</th>" +
      "</tr></thead><tbody>";
    for (const o of ops)
      html += "<tr><td>" + o.op + "</td><td>" +
        (o.p50_ms || 0).toFixed(2) + "</td><td>" +
        (o.bytes != null ? (o.bytes / 1e6).toFixed(2) : "") +
        "</td><td>" +
        (o.achieved_gbps != null ? o.achieved_gbps.toFixed(1) : "") +
        "</td><td>" + (o.bound || "") + "</td></tr>";
    html += "</tbody></table>";
  }
  const phases = Object.entries(p.phases_ms || {});
  if (phases.length) {
    // startup-phase bar: one stacked strip, widths proportional
    const total = phases.reduce((a, kv) => a + kv[1], 0);
    const hues = [210, 30, 120, 275, 0, 55];
    html += "<div style='margin-top:0.5em'>startup phases (" +
      (total / 1000).toFixed(1) + "s): </div>" +
      "<div style='display:flex;width:40em;height:1.4em;" +
      "border:1px solid #ccc'>";
    phases.forEach(([name, ms], i) => {
      const w = Math.max(100.0 * ms / Math.max(total, 1e-9), 0.5);
      html += "<div title='" + name + ": " + ms.toFixed(0) +
        "ms' style='width:" + w + "%;background:hsl(" +
        hues[i % hues.length] + ",55%,70%)'></div>";
    });
    html += "</div><div style='font-size:0.85em;color:#555'>" +
      phases.map(([n, ms]) => n + " " + ms.toFixed(0) + "ms")
        .join(" · ") + "</div>";
  }
  if (p.flight_record)
    html += "<div style='margin-top:0.5em'>last flight record: " +
      "<code>" + p.flight_record + "</code></div>";
  div.innerHTML = html;
}
async function refreshPerf() {
  try {
    const resp = await fetch("/profile.json");
    renderPerf(await resp.json());
  } catch (e) {}
}
async function refresh() {
  const resp = await fetch("/service", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify({request: "workflows",
      args: ["name", "mode", "master", "time", "slaves", "units",
             "serving", "perf", "stopped"]})});
  const data = await resp.json();
  const tbody = document.querySelector("#wf tbody");
  tbody.innerHTML = "";
  for (const [mid, wf] of Object.entries(data.result || {})) {
    const tr = document.createElement("tr");
    const slaves = wf.slaves ? Object.keys(wf.slaves).length : 0;
    for (const v of [mid.slice(0, 8), wf.name, wf.mode, wf.master,
                     Math.round(wf.time) + "s", slaves, wf.units,
                     servingCell(wf.serving), perfCell(wf.perf),
                     wf.stopped]) {
      const td = document.createElement("td");
      td.textContent = v === undefined ? "" : String(v);
      tr.appendChild(td);
    }
    tbody.appendChild(tr);
  }
}
const HIST = {};   // "family|job" -> [[t, v], ...]
function sparkline(points, width, height) {
  if (!points || points.length < 2) return "";
  const ts = points.map(p => p[0]), vs = points.map(p => p[1]);
  const t0 = Math.min(...ts), t1 = Math.max(...ts);
  const v0 = Math.min(...vs), v1 = Math.max(...vs);
  const sx = t => (t1 > t0 ? (t - t0) / (t1 - t0) : 0) *
    (width - 2) + 1;
  const sy = v => height - 1 -
    (v1 > v0 ? (v - v0) / (v1 - v0) : 0.5) * (height - 2);
  // lift the pen across a gap over 5x the median spacing — a
  // preemption window stays VISIBLE instead of being bridged
  const gaps = [];
  for (let i = 1; i < ts.length; i++) gaps.push(ts[i] - ts[i - 1]);
  gaps.sort((a, b) => a - b);
  const lift = gaps.length
    ? gaps[Math.floor(gaps.length / 2)] * 5 : 1e9;
  let d = "", pen = false;
  for (let i = 0; i < points.length; i++) {
    if (i && ts[i] - ts[i - 1] > lift) pen = false;
    d += (pen ? "L" : "M") + sx(ts[i]).toFixed(1) + " " +
      sy(vs[i]).toFixed(1) + " ";
    pen = true;
  }
  return "<svg width='" + width + "' height='" + height +
    "'><path d='" + d + "' fill='none' stroke='#36c'/></svg>";
}
async function refreshHist() {
  try {
    const resp = await fetch("/history.json?series=veles_sched_job_");
    const data = await resp.json();
    for (const s of data.series || [])
      HIST[s.name + "|" + (s.labels.job || "")] = s.points;
  } catch (e) {}
}
function liveCell(family, jobId) {
  const pts = HIST[family + "|" + jobId];
  const last = pts && pts.length ? pts[pts.length - 1][1] : null;
  return sparkline(pts, 90, 18) +
    (last == null ? "" : " " + (+last).toFixed(3));
}
async function refreshJobs() {
  try {
    await refreshHist();
    const resp = await fetch("/jobs.json");
    const jobs = (await resp.json()).jobs || [];
    const show = jobs.length ? "" : "none";
    document.getElementById("jobs-h").style.display = show;
    document.getElementById("jobs").style.display = show;
    const tbody = document.querySelector("#jobs tbody");
    tbody.innerHTML = "";
    for (const j of jobs) {
      const tr = document.createElement("tr");
      if (j.state === "done" || j.state === "failed")
        tr.className = "dead";
      for (const v of [j.id, j.name, j.tenant, j.qos, j.state,
                       j.world, j.preemptions,
                       j.preempt_resume_s == null ? ""
                         : j.preempt_resume_s.toFixed(2)]) {
        const td = document.createElement("td");
        td.textContent = v === undefined || v === null ? "" : String(v);
        tr.appendChild(td);
      }
      for (const family of ["veles_sched_job_loss",
                            "veles_sched_job_mfu"]) {
        const td = document.createElement("td");
        td.innerHTML = liveCell(family, j.id);
        tr.appendChild(td);
      }
      const td = document.createElement("td");
      td.textContent = j.error == null ? "" : String(j.error);
      tr.appendChild(td);
      tbody.appendChild(tr);
    }
  } catch (e) {}
}
refresh(); setInterval(refresh, 2000);
refreshPerf(); setInterval(refreshPerf, 5000);
refreshJobs(); setInterval(refreshJobs, 2000);
</script></body></html>"""

_SLAVES_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu_torch slave stats</title><style>
body { font-family: sans-serif; margin: 2em; background: #fafafa; }
table { border-collapse: collapse; min-width: 60em; }
th, td { border: 1px solid #ccc; padding: 0.4em 0.8em; text-align: left; }
th { background: #eee; }
.stale { color: #b00; }
</style></head><body>
<h1>slave stats</h1>
<p><a href="/status.html">&larr; workflows</a></p>
<table id="sl"><thead><tr>
<th>master</th><th>slave</th><th>state</th><th>power</th>
<th>jobs done</th><th>in flight</th><th>last seen (s)</th>
</tr></thead><tbody></tbody></table>
<script>
async function refresh() {
  const resp = await fetch("/service", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify({request: "workflows",
      args: ["name", "slaves"]})});
  const data = await resp.json();
  const tbody = document.querySelector("#sl tbody");
  tbody.innerHTML = "";
  for (const [mid, wf] of Object.entries(data.result || {})) {
    for (const [sid, s] of Object.entries(wf.slaves || {})) {
      const tr = document.createElement("tr");
      if ((s.age || 0) > 10) tr.className = "stale";
      for (const v of [wf.name || mid.slice(0, 8), sid, s.state,
                       s.power, s.jobs_done, s.in_flight, s.age]) {
        const td = document.createElement("td");
        td.textContent = v === undefined ? "" : String(v);
        tr.appendChild(td);
      }
      tbody.appendChild(tr);
    }
  }
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""

_LOGS_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu_torch logs</title><style>
body { font-family: monospace; margin: 2em; background: #fafafa; }
table { border-collapse: collapse; width: 100%; }
th, td { border: 1px solid #ccc; padding: 0.2em 0.6em; text-align: left; }
th { background: #eee; }
.ERROR, .CRITICAL { color: #b00; } .WARNING { color: #b70; }
</style></head><body>
<h1>veles_tpu_torch logs &amp; events</h1>
<table id="logs"><thead><tr>
<th>time</th><th>session</th><th>level</th><th>node</th><th>message</th>
</tr></thead><tbody></tbody></table>
<script>
async function refresh() {
  const resp = await fetch("/service", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify({request: "logs", find: {}})});
  const data = await resp.json();
  const tbody = document.querySelector("#logs tbody");
  tbody.innerHTML = "";
  for (const rec of (data.result || []).slice(-500).reverse()) {
    const tr = document.createElement("tr");
    tr.className = rec.levelname || "";
    for (const v of [new Date((rec.created || 0) * 1000).toISOString(),
                     (rec.session || "").slice(0, 8), rec.levelname,
                     rec.node, rec.message]) {
      const td = document.createElement("td");
      td.textContent = v === undefined ? "" : String(v);
      tr.appendChild(td);
    }
    tbody.appendChild(tr);
  }
}
refresh(); setInterval(refresh, 3000);
</script></body></html>"""


_FRONTEND_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu_torch frontend</title><style>
body { font-family: sans-serif; margin: 2em; background: #fafafa;
       max-width: 70em; }
code, #cmd { font-family: monospace; background: #eee; padding: 0.5em;
             display: block; margin: 1em 0; white-space: pre-wrap; }
.arg { margin: 0.25em 0; } .arg input { margin-left: 0.5em; }
h2 { margin-top: 1.5em; } .doc { color: #666; font-size: 0.9em; }
table { border-collapse: collapse; } td, th { border: 1px solid #ccc;
padding: 0.3em 0.6em; text-align: left; }
</style></head><body>
<h1>veles_tpu_torch command composer</h1>
<p>Build a <code style="display:inline">python -m veles_tpu_torch</code>
command line from the registered options; the unit catalog below is
what <code style="display:inline">generate_frontend</code> exports.</p>
<div class="arg">workflow file: <input id="wf" size="40"
     value="workflow.py"></div>
<div class="arg">config file: <input id="cfg" size="40"></div>
<div id="args"></div>
<code id="cmd"></code>
<h2>Registered units</h2>
<table id="units"><thead><tr><th>unit</th><th>module</th><th>group</th>
<th>doc</th></tr></thead><tbody></tbody></table>
<script>
let catalog = {arguments: [], units: {}};
function rebuild() {
  let cmd = "python -m veles_tpu_torch";
  for (const arg of catalog.arguments) {
    if (arg.kind === "positional") continue;  // wf/cfg inputs cover these
    const el = document.getElementById("arg-" + arg.dest);
    if (!el) continue;
    if (arg.kind === "flag") {
      if (el.checked) cmd += " " + arg.flags[0];
      continue;
    }
    if (!el.value || el.value === String(arg.default)) continue;
    cmd += " " + arg.flags[0] + " " + el.value;
  }
  cmd += " " + document.getElementById("wf").value;
  const cfg = document.getElementById("cfg").value;
  if (cfg) cmd += " " + cfg;
  document.getElementById("cmd").textContent = cmd;
}
async function load() {
  const resp = await fetch("/catalog");
  catalog = await resp.json();
  const argsDiv = document.getElementById("args");
  for (const arg of catalog.arguments) {
    if (arg.kind === "positional") continue;
    const div = document.createElement("div");
    div.className = "arg";
    const label = document.createElement("label");
    label.textContent = arg.flags.join(", ");
    label.title = arg.help;
    let input;
    if (arg.kind === "flag") {
      input = document.createElement("input");
      input.type = "checkbox";
    } else if (arg.choices && arg.choices.length) {
      input = document.createElement("select");
      const blank = document.createElement("option");
      blank.value = "";
      blank.textContent = "(default)";
      input.appendChild(blank);
      for (const c of arg.choices) {
        const opt = document.createElement("option");
        opt.value = c;
        opt.textContent = c;
        input.appendChild(opt);
      }
    } else {
      input = document.createElement("input");
      input.placeholder = arg.default === null ? "" : String(arg.default);
    }
    input.id = "arg-" + arg.dest;
    input.addEventListener("input", rebuild);
    input.addEventListener("change", rebuild);
    div.appendChild(label); div.appendChild(input);
    if (arg.help) {
      const doc = document.createElement("span");
      doc.className = "doc";
      doc.textContent = " — " + arg.help;
      div.appendChild(doc);
    }
    argsDiv.appendChild(div);
  }
  const tbody = document.querySelector("#units tbody");
  for (const [name, unit] of Object.entries(catalog.units)) {
    const tr = document.createElement("tr");
    for (const v of [name, unit.module, unit.view_group, unit.doc]) {
      const td = document.createElement("td");
      td.textContent = v || "";
      tr.appendChild(td);
    }
    tbody.appendChild(tr);
  }
  document.getElementById("wf").addEventListener("input", rebuild);
  document.getElementById("cfg").addEventListener("input", rebuild);
  rebuild();
}
load();
</script></body></html>"""


#: shared HTML-escaping helper for every inline page that builds markup
#: via innerHTML from unauthenticated POST data (one definition so a
#: future hardening fix cannot miss a copy)
_ESC_JS = """function esc(s) {
  return String(s).replace(/[&<>"']/g, c => ({"&": "&amp;",
    "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;"}[c]));
}"""


_WORKFLOW_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu_torch workflow graph</title><style>
body { font-family: sans-serif; margin: 2em; background: #fafafa; }
svg { background: #fff; border: 1px solid #ccc; }
text { font-size: 11px; font-family: sans-serif; }
.node rect { fill: #e8eef7; stroke: #5b7db1; rx: 4; }
.node.PLUMBING rect { fill: #f4f4f4; stroke: #999; }
.node.SERVICE rect, .node.PLOTTER rect { fill: #f1e8f7; stroke: #8b5bb1; }
.node.TRAINER rect { fill: #e8f7ec; stroke: #4d9a63; }
.edge { stroke: #888; fill: none; marker-end: url(#arrow); }
select { margin-bottom: 1em; }
</style></head><body>
<h1>workflow graph</h1>
<select id="master"></select>
<div id="view"></div>
<script>
// layered layout (Sugiyama-lite): BFS ranks from the roots, then
// order-within-rank by mean parent position — the role the
// reference's viz.js svg_view.js played, without the 2MB dependency
function layout(nodes, edges) {
  const succ = new Map(nodes.map(n => [n.id, []]));
  const indeg = new Map(nodes.map(n => [n.id, 0]));
  for (const [s, d] of edges) {
    succ.get(s).push(d);
    indeg.set(d, indeg.get(d) + 1);
  }
  const rank = new Map();
  let frontier = nodes.filter(n => indeg.get(n.id) === 0).map(n => n.id);
  if (!frontier.length && nodes.length) frontier = [nodes[0].id];
  let depth = 0;
  const seen = new Set(frontier);
  while (frontier.length) {
    for (const id of frontier) rank.set(id, depth);
    const next = [];
    for (const id of frontier)
      for (const d of succ.get(id) || [])
        if (!seen.has(d)) { seen.add(d); next.push(d); }
    frontier = next; depth++;
  }
  for (const n of nodes) if (!rank.has(n.id)) rank.set(n.id, depth);
  const layers = [];
  for (const n of nodes) {
    const r = rank.get(n.id);
    (layers[r] = layers[r] || []).push(n);
  }
  const pos = new Map();
  layers.forEach((layer, r) => {
    layer.forEach((n, i) => pos.set(n.id,
      {x: 40 + i * 170 + (r % 2) * 40, y: 40 + r * 80}));
  });
  return pos;
}
//__ESC__
function render(graph) {
  const pos = layout(graph.nodes, graph.edges);
  const w = Math.max(...[...pos.values()].map(p => p.x)) + 200;
  const h = Math.max(...[...pos.values()].map(p => p.y)) + 80;
  let svg = `<svg width="${w}" height="${h}">
    <defs><marker id="arrow" viewBox="0 0 10 10" refX="9" refY="5"
      markerWidth="7" markerHeight="7" orient="auto-start-reverse">
      <path d="M 0 0 L 10 5 L 0 10 z" fill="#888"/></marker></defs>`;
  for (const [s, d] of graph.edges) {
    const a = pos.get(s), b = pos.get(d);
    if (!a || !b) continue;
    const my = (a.y + b.y) / 2;
    svg += `<path class="edge" d="M ${a.x + 65} ${a.y + 36}
      C ${a.x + 65} ${my}, ${b.x + 65} ${my}, ${b.x + 65} ${b.y}"/>`;
  }
  for (const n of graph.nodes) {
    const p = pos.get(n.id);
    svg += `<g class="node ${esc(n.group || "")}"
      transform="translate(${p.x},${p.y})">
      <rect width="130" height="36"/>
      <text x="65" y="15" text-anchor="middle">${esc(n.type)}</text>
      <text x="65" y="29" text-anchor="middle"
        fill="#555">${esc(n.name)}</text>
      </g>`;
  }
  document.getElementById("view").innerHTML = svg + "</svg>";
}
async function refresh() {
  const resp = await fetch("/service", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify({request: "workflows",
                          args: ["name", "graph"]})});
  const data = await resp.json();
  const sel = document.getElementById("master");
  const current = sel.value;
  sel.innerHTML = "";
  for (const [mid, wf] of Object.entries(data.result || {})) {
    if (!wf.graph) continue;
    const opt = document.createElement("option");
    opt.value = mid;
    opt.textContent = mid.slice(0, 8) + "  " + (wf.name || "");
    sel.appendChild(opt);
  }
  if (current) sel.value = current;
  const pick = (data.result || {})[sel.value];
  if (pick && pick.graph) render(pick.graph);
}
document.getElementById("master").addEventListener("change", refresh);
refresh(); setInterval(refresh, 5000);
</script></body></html>"""

_TIMELINE_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu_torch timeline</title><style>
body { font-family: sans-serif; margin: 2em; background: #fafafa; }
svg { background: #fff; border: 1px solid #ccc; }
text { font-size: 10px; font-family: monospace; }
rect.bar { fill: #5b7db1; opacity: 0.8; }
rect.bar:hover { opacity: 1; }
line.single { stroke: #b14d4d; stroke-width: 2; }
</style></head><body>
<h1>event timeline</h1>
<p>begin/end trace records per instance (the role of the reference's
Rickshaw logs view); newest 60s window, refreshed live.</p>
<div id="view"></div>
<script>
//__ESC__
async function refresh() {
  const resp = await fetch("/service", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify({request: "events", find: {}})});
  const data = await resp.json();
  const events = data.result || [];
  if (!events.length) {
    document.getElementById("view").textContent = "no events yet";
    return;
  }
  const tmax = Math.max(...events.map(e => e.time || 0));
  const tmin = Math.max(Math.min(...events.map(e => e.time || 0)),
                        tmax - 60);
  const lanes = new Map();   // instance -> lane index
  const open = new Map();    // instance:name -> begin time
  const bars = [], singles = [];
  for (const ev of events) {
    if (ev.time < tmin - 60) continue;
    if (!lanes.has(ev.instance)) lanes.set(ev.instance, lanes.size);
    const key = ev.instance + ":" + ev.name;
    if (ev.type === "begin") open.set(key, ev.time);
    else if (ev.type === "end" && open.has(key)) {
      bars.push({lane: lanes.get(ev.instance), name: ev.name,
                 t0: open.get(key), t1: ev.time});
      open.delete(key);
    } else if (ev.type === "single")
      singles.push({lane: lanes.get(ev.instance), name: ev.name,
                    t: ev.time});
  }
  const W = 1100, laneH = 22, left = 240;
  const H = lanes.size * laneH + 40;
  const x = t => left + (W - left - 20) *
    (t - tmin) / Math.max(tmax - tmin, 1e-3);
  let svg = `<svg width="${W}" height="${H}">`;
  for (const [inst, lane] of lanes) {
    svg += `<text x="4" y="${30 + lane * laneH + 12}">` +
      esc(inst.split("@")[0].slice(0, 30)) + `</text>`;
    svg += `<line x1="${left}" y1="${30 + lane * laneH + laneH - 2}"
      x2="${W - 10}" y2="${30 + lane * laneH + laneH - 2}"
      stroke="#eee"/>`;
  }
  for (const b of bars) {
    if (b.t1 < tmin) continue;
    const x0 = x(Math.max(b.t0, tmin));
    svg += `<rect class="bar" x="${x0}" y="${30 + b.lane * laneH + 2}"
      width="${Math.max(x(b.t1) - x0, 1.5)}" height="${laneH - 6}">
      <title>${esc(b.name)}: ${((b.t1 - b.t0) * 1000).toFixed(1)}ms</title>
      </rect>`;
  }
  for (const s of singles) {
    if (s.t < tmin) continue;
    svg += `<line class="single" x1="${x(s.t)}" x2="${x(s.t)}"
      y1="${30 + s.lane * laneH + 2}" y2="${30 + s.lane * laneH + laneH - 4}">
      <title>${esc(s.name)}</title></line>`;
  }
  svg += `<text x="${left}" y="16">${new Date(tmin * 1000)
    .toISOString()}</text>
    <text x="${W - 200}" y="16">${new Date(tmax * 1000)
    .toISOString()}</text>`;
  document.getElementById("view").innerHTML = svg + "</svg>";
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""

_WORKFLOW_PAGE = _WORKFLOW_PAGE.replace("//__ESC__", _ESC_JS)
_TIMELINE_PAGE = _TIMELINE_PAGE.replace("//__ESC__", _ESC_JS)


def _match(record, query):
    """MongoDB-lite ``find``: top-level equality (+ $in / $gte / $lte)."""
    for key, cond in query.items():
        value = record.get(key)
        if isinstance(cond, dict):
            if "$in" in cond and value not in cond["$in"]:
                return False
            if "$gte" in cond and not (value is not None
                                       and value >= cond["$gte"]):
                return False
            if "$lte" in cond and not (value is not None
                                       and value <= cond["$lte"]):
                return False
        elif value != cond:
            return False
    return True


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        self.server.owner.debug("http: " + fmt, *args)

    def _reply(self, body, code=200, ctype="application/json"):
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode("utf-8")
        elif isinstance(body, str):
            body = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            length = 0
        raw = self.rfile.read(length)
        try:
            return json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None

    def do_GET(self):
        self.server.owner.count_request(self.path)
        if self.path in ("", "/", "/status.html"):
            self._reply(_STATUS_PAGE, ctype="text/html; charset=utf-8")
        elif self.path.startswith("/profile.json"):
            self._reply(profiler.profile_report())
        elif self.path.startswith("/cluster.json"):
            self._reply(self.server.owner.cluster_report())
        elif self.path.startswith("/alerts.json"):
            self._reply(alerts.get_engine().report())
        elif self.path.startswith("/jobs.json"):
            self._reply(self.server.owner.jobs_report())
        elif self.path.startswith("/history.json"):
            query = parse_qs(urlsplit(self.path).query)
            try:
                self._reply(get_history().query(
                    series=(query.get("series") or [None])[0],
                    since=(query.get("since") or [None])[0]))
            except (TypeError, ValueError):
                self._reply({"error": "bad since cursor"}, code=400)
        elif self.path.startswith("/metrics.json"):
            # cluster-wide: local registry + federated slave series
            self._reply(federation.cluster_snapshot())
        elif self.path.startswith("/metrics"):
            self._reply(federation.render_cluster_prometheus(),
                        ctype="text/plain; version=0.0.4")
        elif self.path.startswith("/logs.html"):
            self._reply(_LOGS_PAGE, ctype="text/html; charset=utf-8")
        elif self.path.startswith("/slaves.html"):
            self._reply(_SLAVES_PAGE, ctype="text/html; charset=utf-8")
        elif self.path.startswith("/frontend.html"):
            self._reply(_FRONTEND_PAGE, ctype="text/html; charset=utf-8")
        elif self.path.startswith("/workflow.html"):
            self._reply(_WORKFLOW_PAGE, ctype="text/html; charset=utf-8")
        elif self.path.startswith("/timeline.html"):
            self._reply(_TIMELINE_PAGE, ctype="text/html; charset=utf-8")
        elif self.path.startswith("/catalog"):
            try:
                body = json.dumps(self.server.owner.catalog(),
                                  default=str)
            except Exception as e:
                self._reply({"error": str(e) or type(e).__name__},
                            code=500)
            else:
                self._reply(body.encode("utf-8"))
        else:
            self._reply({"error": "not found"}, code=404)

    def do_POST(self):
        self.server.owner.count_request(self.path)
        data = self._body()
        if data is None:
            self._reply({"error": "bad json"}, code=400)
            return
        server = self.server.owner
        try:
            if self.path == "/update":
                server.receive_update(data)
                self._reply({"result": "ok"})
            elif self.path == "/service":
                self._reply(server.receive_request(data))
            elif self.path == "/logs":
                server.receive_logs(data)
                self._reply({"result": "ok"})
            elif self.path == "/events":
                server.receive_events(data)
                self._reply({"result": "ok"})
            else:
                self._reply({"error": "not found"}, code=404)
        except (KeyError, TypeError, ValueError) as e:
            self._reply({"error": str(e) or type(e).__name__}, code=400)


class WebStatusServer(Logger):
    """The dashboard process (``veles/web_status.py:113``)."""

    def __init__(self, host=None, port=None, max_records=100000):
        super(WebStatusServer, self).__init__()
        self.masters = {}
        self.logs = collections.deque(maxlen=max_records)
        self.events = collections.deque(maxlen=max_records)
        self._lock = threading.Lock()
        self._catalog = None
        self._catalog_lock = threading.Lock()
        self._server = ThreadingHTTPServer(
            (host if host is not None else root.common.web.host,
             port if port is not None else root.common.web.port),
            _Handler)
        self._server.owner = self
        self._server.daemon_threads = True
        self.address = self._server.server_address
        self._thread = None
        # own telemetry: the dashboard process always exposes at least
        # its request counter at /metrics (Prometheus text)
        registry = get_registry()
        self._m_requests = registry.counter(
            "veles_webstatus_http_requests_total",
            "Dashboard HTTP requests", labels=("path",))
        self._m_updates = registry.counter(
            "veles_webstatus_updates_total",
            "Master status updates received")
        self._m_records = registry.counter(
            "veles_webstatus_records_total",
            "Log/event records received", labels=("kind",))
        # the SLO engine evaluates continuously while a dashboard is
        # up, so /alerts.json and veles_alerts_active are live even in
        # a process that has no coordinator ticking them
        alerts.get_engine().start()

    #: the routes the handler actually serves — anything else counts as
    #: "other": a port scanner probing random paths must not mint an
    #: unbounded set of labeled series in a long-lived dashboard
    KNOWN_PATHS = frozenset([
        "/", "/status.html", "/logs.html", "/slaves.html",
        "/frontend.html", "/workflow.html", "/timeline.html", "/catalog",
        "/metrics", "/metrics.json", "/profile.json", "/cluster.json",
        "/alerts.json", "/jobs.json", "/history.json", "/update",
        "/service", "/logs", "/events"])

    def count_request(self, path):
        path = path.split("?")[0] or "/"
        if path not in self.KNOWN_PATHS:
            path = "other"
        self._m_requests.labels(path=path).inc()

    @property
    def port(self):
        return self.address[1]

    def catalog(self):
        """Unit/argument catalog for the composer page (lazy, cached).

        Uses its own lock: generate() imports the whole unit registry
        (seconds), and self._lock also serializes receive_update from
        live masters — the first page load must not stall them."""
        with self._catalog_lock:
            if self._catalog is None:
                from veles_tpu_torch.scripts.generate_frontend import generate
                self._catalog = generate()
            return self._catalog

    # -- receiving ---------------------------------------------------------

    def cluster_report(self):
        """The ``/cluster.json`` body: this process's federated view
        (live when the dashboard is embedded in the master) plus the
        health tables remote masters POSTed with their status."""
        report = federation.cluster_report()
        with self._lock:
            masters = {mid: master.get("cluster")
                       for mid, master in self.masters.items()
                       if master.get("cluster")}
        if masters:
            report["masters"] = masters
        return report

    def jobs_report(self):
        """The ``/jobs.json`` body: every pushed scheduler's job
        table (a ``sched serve --status-url`` push embeds its
        ``jobs`` list in the periodic ``/update`` blob)."""
        jobs = []
        with self._lock:
            for mid, master in self.masters.items():
                for job in master.get("jobs") or ():
                    jobs.append(dict(job, scheduler=mid))
        return {"jobs": jobs}

    #: pushed job-row live metrics fed into the history store (the
    #: scheduler is a DIFFERENT process; its pushes are the only
    #: source this dashboard's sparklines have)
    _JOB_HISTORY = (("loss", "veles_sched_job_loss"),
                    ("samples_per_s", "veles_sched_job_samples_per_s"),
                    ("mfu", "veles_sched_job_mfu"))

    def _record_job_history(self, jobs):
        history = get_history()
        for job in jobs:
            if not isinstance(job, dict):
                continue
            if job.get("state") != "running":
                continue   # a preemption gap must stay visible
            metrics = job.get("metrics") or {}
            job_id = str(job.get("id"))
            tenant = str(job.get("tenant"))
            for key, family in self._JOB_HISTORY:
                value = metrics.get(key)
                if isinstance(value, (int, float)):
                    history.record(family,
                                   {"job": job_id, "tenant": tenant},
                                   value)

    def receive_update(self, data):
        """A master's periodic status (``web_status.py:244-251``)."""
        mid = data["id"]
        with self._lock:
            self.masters[mid] = dict(data, last_update=time.time())
        self._m_updates.inc()
        jobs = data.get("jobs")
        if jobs:
            self._record_job_history(jobs)
        self.debug("master %s yielded an update", mid)

    @staticmethod
    def _validated(records):
        # a single non-dict record would poison every later /service
        # query (_match does record.get), so reject the batch up front
        if isinstance(records, dict):
            raise ValueError("records must be a list of objects")
        records = list(records)
        if not all(isinstance(rec, dict) for rec in records):
            raise ValueError("every record must be a JSON object")
        return records

    def receive_logs(self, data):
        records = data["logs"] if isinstance(data, dict) else data
        records = self._validated(records)
        with self._lock:
            self.logs.extend(records)
        self._m_records.labels(kind="logs").inc(len(records))

    def receive_events(self, data):
        records = data["events"] if isinstance(data, dict) else data
        records = self._validated(records)
        with self._lock:
            self.events.extend(records)
        self._m_records.labels(kind="events").inc(len(records))

    def receive_request(self, data):
        """The ``/service`` protocol (``web_status.py:197-242``)."""
        rtype = data["request"]
        if rtype == "workflows":
            args = data.get("args", [])
            ret, garbage = {}, []
            now = time.time()
            with self._lock:
                for mid, master in self.masters.items():
                    if now - master["last_update"] > GARBAGE_TIMEOUT:
                        garbage.append(mid)
                        continue
                    ret[mid] = {item: master.get(item) for item in args}
                for mid in garbage:
                    self.info("removing the garbage collected master %s", mid)
                    del self.masters[mid]
            return {"request": rtype, "result": ret}
        if rtype in ("logs", "events"):
            query = data.get("find")
            if query is None:
                raise ValueError("only 'find' queries are supported")
            store = self.logs if rtype == "logs" else self.events
            with self._lock:
                result = [rec for rec in store if _match(rec, query)]
            return {"request": rtype, "result": result}
        return {"request": rtype, "result": None}

    # -- lifecycle ---------------------------------------------------------

    def run(self):
        """Serve until :meth:`stop` (blocking, like the reference)."""
        # local registry history (request counters etc.); the job
        # sparklines are fed by _record_job_history instead
        get_history().start()
        self.info("HTTP server is running on %s:%d", *self.address)
        self._server.serve_forever()

    def start(self):
        """Serve on a daemon thread (for embedding/tests)."""
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="web-status")
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


class WebStatusEventSink(object):
    """Live event feed to the dashboard timeline: batches trace records
    and POSTs them to ``/events`` (register with
    :func:`veles_tpu_torch.logger.add_event_sink`)."""

    def __init__(self, address=None, session_id=None,
                 flush_interval=1.0):
        if address is None:
            address = (root.common.web.host, root.common.web.port)
        self.url = "http://%s:%d/events" % tuple(address)
        self.session_id = session_id or str(time.time())
        self._buffer = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._flusher = threading.Thread(
            target=self._flush_loop, args=(flush_interval,), daemon=True,
            name="web-status-events")
        self._flusher.start()

    def write(self, record):
        with self._lock:
            self._buffer.append(record)

    def _flush_once(self):
        import urllib.request
        with self._lock:
            batch, self._buffer = self._buffer, []
        if not batch:
            return
        try:
            req = urllib.request.Request(
                self.url, data=json.dumps({"events": batch},
                                          default=str).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=2.0)
        except Exception:
            with self._lock:  # keep for the next attempt, bounded
                self._buffer = (batch + self._buffer)[-10000:]

    def _flush_loop(self, interval):
        while not self._stop.wait(interval):
            self._flush_once()

    def close(self):
        self._stop.set()
        self._flusher.join(timeout=5)
        self._flush_once()


class WebStatusLogHandler(logging.Handler):
    """Duplicates log records to the dashboard (the reference's
    MongoLogHandler, ``veles/logger.py:292``, minus Mongo).

    It POSTs from a thread of its own, so what that thread logs, what
    the HTTP client logs and what the dashboard's own server logs (when
    it runs in the same process) never feed back into it: a record of
    the flusher thread, or of a logger under ``QUIET_LOGGERS``, is
    dropped."""

    #: loggers whose records the handler drops: the HTTP client's and
    #: the dashboard server's, which log the handler's own POSTs
    QUIET_LOGGERS = ("urllib", "urllib3", "http.client", "WebStatusServer")

    def __init__(self, address=None, session=None, node=None,
                 flush_interval=1.0):
        super(WebStatusLogHandler, self).__init__()
        if address is None:
            address = (root.common.web.host, root.common.web.port)
        self.url = "http://%s:%d/logs" % tuple(address)
        self.session = session
        self.node = node
        self._buffer = []
        self._lock2 = threading.Lock()
        self._stop = threading.Event()
        self._flusher = threading.Thread(
            target=self._flush_loop, args=(flush_interval,), daemon=True,
            name="web-status-logs")
        self._flusher.start()

    def _feeds_back(self, record):
        if record.thread == self._flusher.ident:
            return True
        name = record.name
        return any(name == quiet or name.startswith(quiet + ".")
                   for quiet in self.QUIET_LOGGERS)

    def emit(self, record):
        if self._feeds_back(record):
            return
        doc = {
            "session": self.session,
            "node": self.node,
            "levelname": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
            "created": record.created,
        }
        with self._lock2:
            self._buffer.append(doc)

    def _flush_once(self):
        import urllib.request
        with self._lock2:
            batch, self._buffer = self._buffer, []
        if not batch:
            return
        try:
            req = urllib.request.Request(
                self.url, data=json.dumps({"logs": batch}).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=2.0)
        except Exception:
            with self._lock2:  # keep for the next attempt, bounded
                self._buffer = (batch + self._buffer)[-10000:]

    def _flush_loop(self, interval):
        while not self._stop.wait(interval):
            self._flush_once()

    def close(self):
        self._stop.set()
        self._flusher.join(timeout=5)
        # the last records before shutdown are usually the ones that
        # explain it — flush them instead of dropping the buffer
        self._flush_once()
        super(WebStatusLogHandler, self).close()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="veles_tpu_torch web status dashboard")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    args = parser.parse_args(argv)
    server = WebStatusServer(host=args.host, port=args.port)
    try:
        server.run()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
