/* Config editor SPA logic. Counterpart of the reference's static/editor.js
   (CodeMirror json5 editor, tabs, load/save via /v1/config/*, pydantic-error
   rendering, agent-config downloads) — rebuilt dependency-free: a plain
   textarea with a line-number gutter and a small built-in JSON5 checker,
   since the zero-egress deployment cannot load CodeMirror from a CDN. */
"use strict";

/* ---------------- tiny JSON5 syntax checker (lint only) ----------------
   Tolerates: // and block comments, trailing commas, single-quoted strings,
   unquoted identifier keys, +/-/leading-dot numbers, Infinity/NaN.
   Returns null on success or {line, col, message} on the first error. */
function json5Check(text) {
  let i = 0;
  const n = text.length;
  function err(message) {
    const upto = text.slice(0, i);
    const line = upto.split("\n").length;
    const col = i - upto.lastIndexOf("\n");
    return { line, col, message };
  }
  function ws() {
    for (;;) {
      while (i < n && /[\s]/.test(text[i])) i++;
      if (text[i] === "/" && text[i + 1] === "/") {
        while (i < n && text[i] !== "\n") i++;
      } else if (text[i] === "/" && text[i + 1] === "*") {
        i += 2;
        while (i < n && !(text[i] === "*" && text[i + 1] === "/")) i++;
        if (i >= n) return "unterminated block comment";
        i += 2;
      } else {
        return null;
      }
    }
  }
  function string(quote) {
    i++; // opening quote
    while (i < n) {
      const c = text[i];
      if (c === "\\") { i += 2; continue; }
      if (c === quote) { i++; return null; }
      if (c === "\n") return "unterminated string (newline in string)";
      i++;
    }
    return "unterminated string";
  }
  function value() {
    const e = ws();
    if (e) return e;
    if (i >= n) return "unexpected end of input";
    const c = text[i];
    if (c === "{") return object();
    if (c === "[") return array();
    if (c === '"' || c === "'") {
      const s = string(c);
      return s ? err(s) : null;
    }
    const m = /^(?:[+-]?(?:Infinity|NaN|0x[0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)|true|false|null)/
      .exec(text.slice(i));
    if (m) { i += m[0].length; return null; }
    return err(`unexpected character ${JSON.stringify(c)}`);
  }
  function object() {
    i++; // {
    for (;;) {
      let e = ws();
      if (e) return e;
      if (i >= n) return err("unterminated object");
      if (text[i] === "}") { i++; return null; }
      // key: quoted string or identifier
      if (text[i] === '"' || text[i] === "'") {
        const s = string(text[i]);
        if (s) return err(s);
      } else {
        const m = /^[$A-Za-z_][$\w]*/.exec(text.slice(i));
        if (!m) return err("expected object key");
        i += m[0].length;
      }
      e = ws();
      if (e) return e;
      if (text[i] !== ":") return err("expected ':' after object key");
      i++;
      e = value();
      if (e) return e;
      e = ws();
      if (e) return e;
      if (text[i] === ",") { i++; continue; }
      if (text[i] === "}") { i++; return null; }
      return err("expected ',' or '}' in object");
    }
  }
  function array() {
    i++; // [
    for (;;) {
      let e = ws();
      if (e) return e;
      if (i >= n) return err("unterminated array");
      if (text[i] === "]") { i++; return null; }
      e = value();
      if (e) return e;
      e = ws();
      if (e) return e;
      if (text[i] === ",") { i++; continue; }
      if (text[i] === "]") { i++; return null; }
      return err("expected ',' or ']' in array");
    }
  }
  let e = value();
  if (e) return typeof e === "string" ? err(e) : e;
  e = ws();
  if (e) return e;
  if (i < n) return err("trailing content after top-level value");
  return null;
}

/* ---------------- JSON5 syntax highlighter (overlay) ----------------
   Tokenizes the buffer into HTML spans rendered in a <pre> positioned
   behind the transparent-text textarea — caret/selection/undo stay native
   to the textarea while colors come from the overlay. One master regex,
   alternatives ordered: comments first (so strings inside comments don't
   tokenize), then strings (key vs value decided by a ':' lookahead),
   numbers, keywords, punctuation. */
const TOKEN_RE = new RegExp(
  [
    "(\\/\\/[^\\n]*|\\/\\*[\\s\\S]*?\\*\\/)",                 // 1 comment
    "(\"(?:\\\\.|[^\"\\\\\\n])*\"?|'(?:\\\\.|[^'\\\\\\n])*'?)", // 2 string
    "([+-]?(?:Infinity|NaN|0x[0-9a-fA-F]+|(?:\\d+\\.?\\d*|\\.\\d+)(?:[eE][+-]?\\d+)?))", // 3 number
    "\\b(true|false|null)\\b",                                  // 4 keyword
    "([{}\\[\\],:])",                                           // 5 punct
  ].join("|"), "g");

function escapeHtml(s) {
  return s.replace(/&/g, "&amp;").replace(/</g, "&lt;").replace(/>/g, "&gt;");
}

// Sticky (O(1), no buffer copy) "is the next non-space char a ':'" probe —
// decides string-token key-vs-value without slicing the document tail per
// token (which would make every keystroke's re-highlight O(n^2)).
const COLON_AHEAD = /\s*:/y;

function highlightJson5(text) {
  let out = "";
  let last = 0;
  TOKEN_RE.lastIndex = 0;
  for (let m; (m = TOKEN_RE.exec(text)); ) {
    out += escapeHtml(text.slice(last, m.index));
    last = m.index + m[0].length;
    let cls = "tok-punct";
    if (m[1] !== undefined) cls = "tok-comment";
    else if (m[2] !== undefined) {
      COLON_AHEAD.lastIndex = last;
      cls = COLON_AHEAD.test(text) ? "tok-key" : "tok-string";
    } else if (m[3] !== undefined) cls = "tok-number";
    else if (m[4] !== undefined) cls = "tok-keyword";
    out += `<span class="${cls}">${escapeHtml(m[0])}</span>`;
  }
  out += escapeHtml(text.slice(last));
  return out;
}

/* ---------------- helpers ---------------- */
const $ = (id) => document.getElementById(id);

function apiKey() { return $("api-key").value.trim(); }
function authHeaders() {
  const k = apiKey();
  return k ? { Authorization: "Bearer " + k } : {};
}

function setStatus(el, text, cls) {
  el.textContent = text;
  el.className = "status" + (cls ? " " + cls : "");
}

/* ---------------- theme + key persistence ---------------- */
const THEMES = ["light", "dark", "solarized", "midnight", "contrast"];
function applyTheme(name) {
  if (!THEMES.includes(name)) name = "light";
  document.body.dataset.theme = name;
  document.body.classList.toggle("dark",
    name === "dark" || name === "midnight");   // back-compat for page chrome
  $("theme-select").value = name;
  localStorage.setItem("gw-theme", name);
}
applyTheme(localStorage.getItem("gw-theme") || "light");
$("theme-select").addEventListener("change",
  (ev) => applyTheme(ev.target.value));
$("api-key").value = localStorage.getItem("gw-api-key") || "";
$("api-key").addEventListener("change", () => {
  localStorage.setItem("gw-api-key", apiKey());
});

/* ---------------- tabs ---------------- */
$("tabs").addEventListener("click", (ev) => {
  const btn = ev.target.closest("button[data-tab]");
  if (!btn) return;
  document.querySelectorAll("#tabs button").forEach(
    (b) => b.classList.toggle("active", b === btn));
  document.querySelectorAll(".panel").forEach(
    (p) => p.classList.toggle("active", p.id === "panel-" + btn.dataset.tab));
});

/* ---------------- editor panes ---------------- */
const ENDPOINTS = {
  rules: "/v1/config/models-rules",
  providers: "/v1/config/providers",
};
const original = { rules: "", providers: "" };
const errPos = { rules: null, providers: null };   // {line, col} | null
const lintTimers = {};

function syncGutter(which) {
  const ta = $("editor-" + which);
  const lines = ta.value.split("\n").length || 1;
  const gutter = $("gutter-" + which);
  const bad = errPos[which] ? errPos[which].line : 0;
  gutter.innerHTML = Array.from({ length: lines }, (_, k) =>
    k + 1 === bad ? `<span class="ln-err">${k + 1}</span>` : String(k + 1)
  ).join("\n");
  gutter.scrollTop = ta.scrollTop;
}

function render(which) {
  const ta = $("editor-" + which);
  // Trailing newline keeps the overlay's scrollHeight matching the
  // textarea's when the caret sits on a fresh last line.
  $("hl-" + which).innerHTML = highlightJson5(ta.value) + "\n";
}

function syncScroll(which) {
  const ta = $("editor-" + which);
  $("gutter-" + which).scrollTop = ta.scrollTop;
  const hl = $("hl-" + which);
  hl.scrollTop = ta.scrollTop;
  hl.scrollLeft = ta.scrollLeft;
}

/* Shared check-and-mark core: run the syntax checker, update errPos, the
   error box, and the gutter marker. Every buffer-mutating path goes
   through checkAndMark (directly or via the debounced liveLint). */
function checkAndMark(which) {
  const e = json5Check($("editor-" + which).value);
  errPos[which] = e ? { line: e.line, col: e.col } : null;
  showErrors(which,
    e ? [`line ${e.line}, col ${e.col}: ${e.message}`] : null);
  syncGutter(which);
  return e;
}

/* Lint-as-you-type: debounced — the explicit "Check syntax" button stays
   for a loud pass/fail status. */
function liveLint(which) {
  clearTimeout(lintTimers[which]);
  lintTimers[which] = setTimeout(() => checkAndMark(which), 250);
}

/* The one entry point after ANY buffer mutation: gutter, overlay, lint. */
function refresh(which, { immediate = false } = {}) {
  syncGutter(which);
  render(which);
  if (immediate) checkAndMark(which);
  else liveLint(which);
}

function showErrors(which, errors) {
  const box = $("errors-" + which);
  if (errors && errors.length) {
    box.textContent = errors.join("\n");
    box.classList.add("visible");
  } else {
    box.textContent = "";
    box.classList.remove("visible");
  }
}

async function loadFile(which) {
  const status = $("status-" + which);
  setStatus(status, "loading…");
  try {
    const resp = await fetch(ENDPOINTS[which], { headers: authHeaders() });
    if (!resp.ok) {
      const body = await resp.text();
      setStatus(status, `load failed (${resp.status}): ${body.slice(0, 200)}`, "err");
      return;
    }
    const text = await resp.text();
    original[which] = text;
    $("editor-" + which).value = text;
    // immediate: a stale error marker must not linger on fresh content
    // for the lint debounce interval.
    refresh(which, { immediate: true });
    setStatus(status, "loaded", "ok");
  } catch (e) {
    setStatus(status, "load failed: " + e, "err");
  }
}

function lint(which) {
  const e = checkAndMark(which);
  setStatus($("status-" + which),
            e ? "syntax error" : "syntax OK", e ? "err" : "ok");
  return !e;
}

async function saveFile(which) {
  if (!lint(which)) return;
  const status = $("status-" + which);
  setStatus(status, "saving…");
  try {
    const resp = await fetch(ENDPOINTS[which], {
      method: "POST",
      headers: { "Content-Type": "text/plain", ...authHeaders() },
      body: $("editor-" + which).value,
    });
    const body = await resp.json().catch(() => ({}));
    if (resp.ok) {
      original[which] = $("editor-" + which).value;
      showErrors(which, null);
      setStatus(status,
        `saved & reloaded (config v${body.config_version ?? "?"})`, "ok");
    } else if (resp.status === 400 && body.errors) {
      showErrors(which, body.errors);
      setStatus(status, body.detail || "validation failed", "err");
    } else if (resp.status === 401 || resp.status === 403) {
      setStatus(status, "auth failed — set the gateway API key (top right)", "err");
    } else {
      setStatus(status, `save failed (${resp.status}): ${body.detail || ""}`, "err");
    }
  } catch (e) {
    setStatus(status, "save failed: " + e, "err");
  }
}

for (const which of ["rules", "providers"]) {
  const ta = $("editor-" + which);
  ta.addEventListener("input", () => refresh(which));
  ta.addEventListener("scroll", () => syncScroll(which));
  ta.addEventListener("keydown", (ev) => {   // Tab inserts two spaces
    if (ev.key === "Tab") {
      ev.preventDefault();
      const s = ta.selectionStart;
      ta.setRangeText("  ", s, ta.selectionEnd, "end");
      refresh(which);
    }
  });
  // Click the error message → jump the caret to the reported position.
  $("errors-" + which).addEventListener("click", () => {
    const p = errPos[which];
    if (!p) return;
    const lines = ta.value.split("\n");
    let idx = 0;
    for (let l = 0; l < p.line - 1 && l < lines.length; l++) {
      idx += lines[l].length + 1;
    }
    idx += Math.max(0, p.col - 1);
    ta.focus();
    ta.setSelectionRange(idx, idx);
  });
  $("save-" + which).addEventListener("click", () => saveFile(which));
  $("lint-" + which).addEventListener("click", () => lint(which));
  $("revert-" + which).addEventListener("click", () => {
    ta.value = original[which];
    refresh(which, { immediate: true });
    setStatus($("status-" + which), "reverted", "ok");
  });
  loadFile(which);
}

window.addEventListener("beforeunload", (ev) => {
  if ($("editor-rules").value !== original.rules ||
      $("editor-providers").value !== original.providers) {
    ev.preventDefault();
  }
});

/* ---------------- agents integration ---------------- */
const AGENT_ENDPOINTS = {
  oc: { url: "/v1/models/AsOpenCodeFormat", file: "opencode.json" },
  gh: { url: "/v1/models/AsGitHubCopilotFormat", file: "chatLanguageModels.json" },
};

async function fetchAgentConfig(kind) {
  const include = $(kind + "-fallback").checked ? "true" : "false";
  const { url } = AGENT_ENDPOINTS[kind];
  const resp = await fetch(`${url}?includefallbackmodels=${include}`,
                           { headers: authHeaders() });
  if (!resp.ok) throw new Error(`HTTP ${resp.status}`);
  return await resp.json();
}

function download(filename, data) {
  const blob = new Blob([JSON.stringify(data, null, 2)],
                        { type: "application/json" });
  const a = document.createElement("a");
  a.href = URL.createObjectURL(blob);
  a.download = filename;
  a.click();
  URL.revokeObjectURL(a.href);
}

for (const kind of ["oc", "gh"]) {
  $(kind + "-preview").addEventListener("click", async () => {
    const status = $("status-agents");
    try {
      const data = await fetchAgentConfig(kind);
      const pre = $("agents-preview");
      pre.textContent = JSON.stringify(data, null, 2);
      pre.style.display = "block";
      setStatus(status, "", "");
    } catch (e) {
      setStatus(status, "fetch failed: " + e, "err");
    }
  });
  $(kind + "-download").addEventListener("click", async () => {
    const status = $("status-agents");
    try {
      download(AGENT_ENDPOINTS[kind].file, await fetchAgentConfig(kind));
      setStatus(status, "downloaded " + AGENT_ENDPOINTS[kind].file, "ok");
    } catch (e) {
      setStatus(status, "download failed: " + e, "err");
    }
  });
}
