"""Read-only web dashboard served by the control plane.

The reference ships a full web UI; this is the compact equivalent for
the single-process control plane: one self-contained HTML page (no
assets, no build step) that polls the existing JSON API — status
tiles, a runs table, and a per-run detail pane (status history, last
metrics, log tail).  Served at ``GET /`` and ``GET /ui`` WITHOUT auth
(the page is static and data-free); its JavaScript calls ``/api/v1``
with the bearer token the operator pastes into the token field
(persisted in localStorage), so a token-gated deployment stays gated.

Design notes (dataviz method): the data's job here is identity +
state, so the form is a table plus stat tiles — not charts; status is
never color-alone (each state renders a dot AND its word); all text
wears neutral ink.

The port's own copy of ``polyaxon_tpu/scheduler/dashboard.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

DASHBOARD_HTML = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>polyaxon-tpu — runs</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
:root {
  --ink: #1a1a1a; --ink2: #555; --ink3: #888;
  --surface: #fafaf8; --card: #ffffff; --line: #e4e2dd;
  --ok: #1a7f37; --warn: #b08800; --bad: #b42318; --run: #175cd3;
}
@media (prefers-color-scheme: dark) {
  :root { --ink: #ececec; --ink2: #b5b5b5; --ink3: #8a8a8a;
          --surface: #161614; --card: #201f1d; --line: #3a3834;
          --ok: #4cc38a; --warn: #d4b106; --bad: #f97066;
          --run: #84adff; }
}
* { box-sizing: border-box; }
body { margin: 0; background: var(--surface); color: var(--ink);
       font: 14px/1.45 system-ui, sans-serif; }
header { display: flex; align-items: baseline; gap: 16px;
         padding: 14px 20px; border-bottom: 1px solid var(--line); }
header h1 { font-size: 16px; margin: 0; }
header .sub { color: var(--ink3); font-size: 12px; }
header input { margin-left: auto; width: 220px; padding: 4px 8px;
               border: 1px solid var(--line); border-radius: 6px;
               background: var(--card); color: var(--ink); }
main { padding: 16px 20px; max-width: 1100px; margin: 0 auto; }
.tiles { display: flex; gap: 12px; flex-wrap: wrap; margin: 0 0 16px; }
.tile { background: var(--card); border: 1px solid var(--line);
        border-radius: 8px; padding: 10px 16px; min-width: 110px; }
.tile .n { font-size: 22px; font-weight: 600; }
.tile .k { color: var(--ink2); font-size: 12px; }
table { width: 100%; border-collapse: collapse; background: var(--card);
        border: 1px solid var(--line); border-radius: 8px;
        overflow: hidden; }
th { text-align: left; color: var(--ink2); font-weight: 500;
     font-size: 12px; padding: 8px 12px;
     border-bottom: 1px solid var(--line); }
td { padding: 7px 12px; border-bottom: 1px solid var(--line);
     font-variant-numeric: tabular-nums; }
tr:last-child td { border-bottom: 0; }
tr.row:hover { background: color-mix(in oklab, var(--card) 92%,
               var(--ink) 8%); cursor: pointer; }
.status { white-space: nowrap; }
.dot { display: inline-block; width: 8px; height: 8px;
       border-radius: 50%; margin-right: 6px; }
.s-succeeded .dot { background: var(--ok); }
.s-running .dot, .s-compiled .dot { background: var(--run); }
.s-failed .dot, .s-upstream_failed .dot { background: var(--bad); }
.s-stopped .dot, .s-skipped .dot { background: var(--ink3); }
.s-queued .dot, .s-created .dot, .s-scheduled .dot,
.s-warning .dot { background: var(--warn); }
.muted { color: var(--ink3); }
#detail { margin-top: 16px; background: var(--card);
          border: 1px solid var(--line); border-radius: 8px;
          padding: 14px 16px; display: none; }
#detail h2 { font-size: 14px; margin: 0 0 8px; }
#detail pre { background: var(--surface); border: 1px solid var(--line);
              border-radius: 6px; padding: 10px; overflow: auto;
              max-height: 260px; font-size: 12px; }
#err { color: var(--bad); font-size: 12px; padding: 8px 0; }
</style></head><body>
<header>
  <h1>polyaxon-tpu</h1>
  <span class="sub" id="meta">runs</span>
  <input id="token" type="password"
         placeholder="API token (blank if open)">
</header>
<main>
  <div id="err"></div>
  <div class="tiles" id="tiles"></div>
  <table id="runs"><thead><tr>
    <th>run</th><th>name</th><th>status</th><th>queue</th>
    <th>kind</th><th>metrics</th>
  </tr></thead><tbody></tbody></table>
  <div id="detail"></div>
</main>
<script>
"use strict";
const $ = (s) => document.querySelector(s);
// EVERY API-sourced string goes through esc() before touching
// innerHTML: run names/reasons/messages are arbitrary user input and
// the bearer token lives in localStorage (stored-XSS target).
const esc = (x) => String(x ?? "").replace(/[&<>"']/g, c => ({
  "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;",
  "'": "&#39;"}[c]));
const tokenEl = $("#token");
tokenEl.value = localStorage.getItem("ptpu-token") || "";
tokenEl.addEventListener("change", () => {
  localStorage.setItem("ptpu-token", tokenEl.value); refresh();
});
async function api(path) {
  const headers = {};
  if (tokenEl.value) headers["Authorization"] = "Bearer " + tokenEl.value;
  const r = await fetch("/api/v1" + path, {headers});
  if (!r.ok) throw new Error(path + " -> HTTP " + r.status);
  return r.json();
}

function statusCell(s) {
  s = /^[a-z_]+$/.test(s || "") ? s : "created";
  return `<span class="status s-${s}"><span class="dot"></span>${s}</span>`;
}

function fmtTime(t) {
  if (!t) return "";
  const d = typeof t === "number" ? new Date(t * 1000) : new Date(t);
  return isNaN(d) ? esc(t) : d.toISOString().replace("T", " ").slice(0, 19);
}

function fmtMetrics(m) {
  const keys = Object.keys(m || {}).filter(
    k => !k.startsWith("_") && m[k] !== null && m[k] !== undefined);
  return keys.slice(0, 3).map(k => {
    let v = m[k]; if (typeof v === "number" && !Number.isInteger(v))
      v = v.toPrecision(4);
    return `${esc(k)}=${esc(v)}`;
  }).join("  ") || "—";
}

async function refresh() {
  try {
    const runs = await api("/runs?sort=-created_at&limit=100&metrics=1");
    $("#err").textContent = "";
    const counts = {};
    for (const r of runs) {
      const s = r.status || "created";
      counts[s] = (counts[s] || 0) + 1;
    }
    $("#tiles").innerHTML = Object.entries(counts).map(([s, n]) =>
      `<div class="tile"><div class="n">${Number(n)}</div>
       <div class="k">${statusCell(s)}</div></div>`).join("") ||
      '<div class="tile"><div class="n">0</div><div class="k">runs' +
      '</div></div>';
    $("#meta").textContent = runs.length + " runs";
    const rows = runs.map((r, i) =>
      `<tr class="row" data-u="${esc(r.uuid)}">
        <td class="muted">${esc((r.uuid || "").slice(0, 8))}</td>
        <td>${esc(r.name)}</td><td>${statusCell(r.status)}</td>
        <td>${esc(r.queue || "default")}</td>
        <td class="muted">${esc(r.kind)}</td>
        <td>${fmtMetrics(r.last_metrics)}</td>
      </tr>`);
    $("#runs tbody").innerHTML = rows.join("") ||
      '<tr><td colspan="6" class="muted">no runs yet</td></tr>';
    for (const tr of document.querySelectorAll("tr.row"))
      tr.addEventListener("click", () => showDetail(tr.dataset.u));
  } catch (e) { $("#err").textContent = String(e); }
}

async function showDetail(u) {
  const el = $("#detail"); el.style.display = "block";
  el.innerHTML = `<h2>${esc(u)}</h2><p class="muted">loading…</p>`;
  try {
    const [statuses, logs] = await Promise.all([
      api(`/runs/${encodeURIComponent(u)}/statuses`),
      // offsets={} selects the per-replica incremental form.
      api(`/runs/${encodeURIComponent(u)}/logs?offsets=%7B%7D`)
        .catch(() => ({replicas: {}})),
    ]);
    const hist = statuses.map(c =>
      `<tr><td>${statusCell(c.type)}</td>
       <td class="muted">${esc(c.reason)}</td>
       <td>${esc(c.message)}</td>
       <td class="muted">${fmtTime(c.last_transition_time)}</td>
      </tr>`).join("");
    let logText = "";
    for (const [rep, blob] of Object.entries(logs.replicas || {}))
      logText += `--- ${rep} ---\\n` +
        (blob.logs || "").split("\\n").slice(-40).join("\\n") + "\\n";
    el.innerHTML = `<h2>${esc(u)}</h2>
      <table><thead><tr><th>status</th><th>reason</th><th>message</th>
      <th>at</th></tr></thead><tbody>${hist}</tbody></table>
      <h2 style="margin-top:12px">logs (tail)</h2>
      <pre>${esc(logText) || "(no logs)"}</pre>`;
  } catch (e) {
    el.innerHTML = `<h2>${esc(u)}</h2><div id="err">${esc(e)}</div>`;
  }
}

// Self-re-arming + an inflight guard: the next cycle starts 5 s
// after the previous one FINISHES, hidden tabs stop polling, and the
// visibility kick can never overlap a running refresh.
let inflight = false;
async function refreshOnce() {
  if (inflight) return;
  inflight = true;
  try { await refresh(); } finally { inflight = false; }
}
(async function loop() {
  if (!document.hidden) await refreshOnce();
  setTimeout(loop, 5000);
})();
document.addEventListener("visibilitychange", () => {
  if (!document.hidden) refreshOnce();
});
</script></body></html>
"""
