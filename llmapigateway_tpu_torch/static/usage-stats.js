/* Usage-stats SPA logic. Counterpart of the reference's static/usage-stats.js:
   period aggregate tables with per-bucket grouping and the derived Cost/Million
   column (cost / total_tokens * 1e6 — usage-stats.js:80-85 in the reference),
   paginated raw-records tab (25/page), dark mode — plus the serving
   columns (p50/p95 TTFT, avg tok/s) this framework's usage schema records. */
"use strict";

const $ = (id) => document.getElementById(id);
const PAGE_SIZE = 25;

function apiKey() { return $("api-key").value.trim(); }
function authHeaders() {
  const k = apiKey();
  return k ? { Authorization: "Bearer " + k } : {};
}

/* theme + key persistence (shared localStorage keys with the editor).
   gw-theme carries the editor's 5 theme names; this page only has
   light/dark chrome, so map dark-family themes to dark and NEVER write
   the key back except from an explicit toggle here — a plain page load
   must not clobber a richer saved editor theme. */
const DARK_THEMES = ["dark", "midnight", "contrast"];
if (DARK_THEMES.includes(localStorage.getItem("gw-theme"))) {
  document.body.classList.add("dark");
}
$("theme-toggle").addEventListener("click", () => {
  document.body.classList.toggle("dark");
  localStorage.setItem(
    "gw-theme", document.body.classList.contains("dark") ? "dark" : "light");
});
$("api-key").value = localStorage.getItem("gw-api-key") || "";
$("api-key").addEventListener("change", () => {
  localStorage.setItem("gw-api-key", apiKey());
  loadAgg();
  loadRaw();
});

/* tabs */
$("tabs").addEventListener("click", (ev) => {
  const btn = ev.target.closest("button[data-tab]");
  if (!btn) return;
  document.querySelectorAll("#tabs button").forEach(
    (b) => b.classList.toggle("active", b === btn));
  document.querySelectorAll(".panel").forEach(
    (p) => p.classList.toggle("active", p.id === "panel-" + btn.dataset.tab));
});

/* formatting */
const fmtInt = (v) => (v == null ? "—" : Number(v).toLocaleString("en-US"));
const fmtCost = (v) => (v == null ? "—" : Number(v).toFixed(4));
const fmt1 = (v) => (v == null ? "—" : Number(v).toFixed(1));
function costPerMillion(cost, total) {
  if (!cost || !total) return "—";
  return (cost / total * 1e6).toFixed(3);
}
function td(text, cls) {
  const el = document.createElement("td");
  el.textContent = text;
  if (cls) el.className = cls;
  return el;
}

/* ---------------- aggregated tab ---------------- */
let currentPeriod = "day";

const BUCKET_LABEL = {
  hour: (b) => `${b}:00`,
  day: (b) => b,
  week: (b) => `week ${b}`,
  month: (b) => b,
};

async function loadAgg() {
  const status = $("status-agg");
  status.textContent = "loading…";
  status.className = "status";
  try {
    const resp = await fetch("/v1/api/usage-stats/" + currentPeriod,
                             { headers: authHeaders() });
    if (!resp.ok) {
      status.textContent = resp.status === 401 || resp.status === 403
        ? "auth failed — set the gateway API key (top right)"
        : `load failed (${resp.status})`;
      status.className = "status err";
      return;
    }
    const { data } = await resp.json();
    renderAgg(data || []);
    status.textContent = `${data.length} row(s), period = ${currentPeriod}`;
  } catch (e) {
    status.textContent = "load failed: " + e;
    status.className = "status err";
  }
}

function renderAgg(rows) {
  const body = $("agg-body");
  body.textContent = "";
  if (!rows.length) {
    const tr = document.createElement("tr");
    const cell = td("no usage recorded in this window", "empty");
    cell.colSpan = 12;
    tr.appendChild(cell);
    body.appendChild(tr);
    return;
  }
  /* rows arrive newest-bucket first, grouped (bucket, model); render a
     bucket header row, then per-model rows, then a bucket total row. */
  const buckets = new Map();
  for (const r of rows) {
    if (!buckets.has(r.period)) buckets.set(r.period, []);
    buckets.get(r.period).push(r);
  }
  for (const [bucket, group] of buckets) {
    const hdr = document.createElement("tr");
    hdr.className = "bucket";
    const cell = td(BUCKET_LABEL[currentPeriod](bucket));
    cell.colSpan = 12;
    hdr.appendChild(cell);
    body.appendChild(hdr);

    const tot = { requests: 0, prompt: 0, completion: 0, reasoning: 0,
                  cached: 0, total: 0, cost: 0 };
    for (const r of group) {
      const tr = document.createElement("tr");
      tr.appendChild(td(r.model || "—", "model"));
      tr.appendChild(td(fmtInt(r.requests)));
      tr.appendChild(td(fmtInt(r.prompt_tokens)));
      tr.appendChild(td(fmtInt(r.completion_tokens)));
      tr.appendChild(td(fmtInt(r.reasoning_tokens)));
      tr.appendChild(td(fmtInt(r.cached_tokens)));
      tr.appendChild(td(fmtInt(r.total_tokens)));
      tr.appendChild(td(fmtCost(r.cost)));
      tr.appendChild(td(costPerMillion(r.cost, r.total_tokens)));
      tr.appendChild(td(fmt1(r.ttft_p50_ms)));
      tr.appendChild(td(fmt1(r.ttft_p95_ms)));
      tr.appendChild(td(fmt1(r.avg_tokens_per_sec)));
      body.appendChild(tr);
      tot.requests += r.requests || 0;
      tot.prompt += r.prompt_tokens || 0;
      tot.completion += r.completion_tokens || 0;
      tot.reasoning += r.reasoning_tokens || 0;
      tot.cached += r.cached_tokens || 0;
      tot.total += r.total_tokens || 0;
      tot.cost += r.cost || 0;
    }
    if (group.length > 1) {
      const tr = document.createElement("tr");
      tr.className = "total";
      tr.appendChild(td("total"));
      tr.appendChild(td(fmtInt(tot.requests)));
      tr.appendChild(td(fmtInt(tot.prompt)));
      tr.appendChild(td(fmtInt(tot.completion)));
      tr.appendChild(td(fmtInt(tot.reasoning)));
      tr.appendChild(td(fmtInt(tot.cached)));
      tr.appendChild(td(fmtInt(tot.total)));
      tr.appendChild(td(fmtCost(tot.cost)));
      tr.appendChild(td(costPerMillion(tot.cost, tot.total)));
      tr.appendChild(td("—"));
      tr.appendChild(td("—"));
      tr.appendChild(td("—"));
      body.appendChild(tr);
    }
  }
}

$("periods").addEventListener("click", (ev) => {
  const btn = ev.target.closest("button[data-period]");
  if (!btn) return;
  currentPeriod = btn.dataset.period;
  document.querySelectorAll("#periods button").forEach(
    (b) => b.classList.toggle("active", b === btn));
  loadAgg();
});

/* ---------------- raw records tab ---------------- */
let rawOffset = 0;
let rawTotal = 0;

async function loadRaw() {
  const status = $("status-raw");
  status.textContent = "loading…";
  status.className = "status";
  try {
    const resp = await fetch(
      `/v1/api/usage-records?limit=${PAGE_SIZE}&offset=${rawOffset}`,
      { headers: authHeaders() });
    if (!resp.ok) {
      status.textContent = resp.status === 401 || resp.status === 403
        ? "auth failed — set the gateway API key (top right)"
        : `load failed (${resp.status})`;
      status.className = "status err";
      return;
    }
    const { records, total } = await resp.json();
    rawTotal = total;
    renderRaw(records || []);
    const page = Math.floor(rawOffset / PAGE_SIZE) + 1;
    const pages = Math.max(1, Math.ceil(total / PAGE_SIZE));
    $("raw-page").textContent = `page ${page} / ${pages} (${total} records)`;
    $("raw-prev").disabled = rawOffset === 0;
    $("raw-next").disabled = rawOffset + PAGE_SIZE >= total;
    status.textContent = "";
  } catch (e) {
    status.textContent = "load failed: " + e;
    status.className = "status err";
  }
}

function renderRaw(records) {
  const body = $("raw-body");
  body.textContent = "";
  if (!records.length) {
    const tr = document.createElement("tr");
    const cell = td("no records", "empty");
    cell.colSpan = 11;
    tr.appendChild(cell);
    body.appendChild(tr);
    return;
  }
  for (const r of records) {
    const tr = document.createElement("tr");
    tr.appendChild(td(r.timestamp || "—"));
    tr.appendChild(td(r.provider || "—", "model"));
    tr.appendChild(td(r.model || "—", "model"));
    tr.appendChild(td(fmtInt(r.prompt_tokens)));
    tr.appendChild(td(fmtInt(r.completion_tokens)));
    tr.appendChild(td(fmtInt(r.reasoning_tokens)));
    tr.appendChild(td(fmtInt(r.cached_tokens)));
    tr.appendChild(td(fmtInt(r.total_tokens)));
    tr.appendChild(td(fmtCost(r.cost)));
    tr.appendChild(td(fmt1(r.ttft_ms)));
    tr.appendChild(td(fmt1(r.tokens_per_sec)));
    body.appendChild(tr);
  }
}

$("raw-prev").addEventListener("click", () => {
  rawOffset = Math.max(0, rawOffset - PAGE_SIZE);
  loadRaw();
});
$("raw-next").addEventListener("click", () => {
  if (rawOffset + PAGE_SIZE < rawTotal) {
    rawOffset += PAGE_SIZE;
    loadRaw();
  }
});

loadAgg();
loadRaw();
