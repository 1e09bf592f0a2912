"use strict";
/* Operator dashboard SPA (reference: sentinel-dashboard AngularJS webapp —
   app list, machine discovery, realtime per-resource charts, rule editors
   for every rule family, cluster topology/assign — rebuilt dependency-free
   against the Python dashboard's REST surface). */

// ------------------------------------------------------------------ helpers
const $ = (sel) => document.querySelector(sel);

function h(tag, attrs = {}, children = []) {
  const e = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs)) {
    if (k === "class") e.className = v;
    else if (k.startsWith("on")) e[k] = v;
    else if (k === "html") e.innerHTML = v;
    else e.setAttribute(k, v);
  }
  for (const c of [].concat(children)) {
    if (c == null) continue;
    e.appendChild(typeof c === "string" ? document.createTextNode(c) : c);
  }
  return e;
}

async function api(path, opts) {
  const r = await fetch(path, opts);
  const j = await r.json();
  if (j && j.code === 401) { showLogin(true); return null; }
  return j;
}
const post = (path, body, method = "POST") => api(path, {
  method, body: body === undefined ? undefined : JSON.stringify(body),
  headers: { "Content-Type": "application/json" } });

function getPath(obj, path) {
  return path.split(".").reduce((o, k) => (o == null ? o : o[k]), obj);
}
function setPath(obj, path, v) {
  const ks = path.split("."), last = ks.pop();
  let o = obj;
  for (const k of ks) o = (o[k] = o[k] || {});
  o[last] = v;
}

// ------------------------------------------------------------------ state
const S = {
  apps: [], app: null, view: "metrics", timer: null,
  machines: [], machineSel: "", range: 300, chartData: {},
  openOrigins: new Set(),   // resources with the origin drill-down expanded
};

function setRefresh(fn, ms) {
  clearInterval(S.timer);
  if (fn) { S.timer = setInterval(fn, ms); }
}

// ------------------------------------------------------------------ auth
function showLogin(on) {
  $("#login").style.display = on ? "" : "none";
  $("#app").style.display = on ? "none" : "flex";
  if (on) setRefresh(null);
}
async function doLogin(ev) {
  ev.preventDefault();
  // raw fetch: api() would swallow the 401 envelope of a bad password
  const r = await fetch("/auth/login", { method: "POST",
    body: JSON.stringify({ username: $("#u").value, password: $("#p").value }),
    headers: { "Content-Type": "application/json" } });
  const j = await r.json();
  if (!j.success) { $("#lerr").textContent = j.msg; return false; }
  $("#who").textContent = j.data.username;
  showLogin(false); boot();
  return false;
}
async function doLogout() {
  await post("/auth/logout", {});
  showLogin(true);
}

// ------------------------------------------------------------------ router
const RULE_VIEWS = ["flow", "degrade", "paramFlow", "system", "authority",
                    "gatewayFlow", "gatewayApi"];
const VIEW_TITLES = {
  metrics: "Realtime Metrics", resources: "Resource View",
  machines: "Machine List", cluster: "Cluster Management",
  tree: "Node Tree", telemetry: "Runtime Telemetry",
  hotkeys: "Hot Resources", control: "Overload Control",
  flow: "Flow Rules", degrade: "Degrade Rules", paramFlow: "Param Flow Rules",
  system: "System Rules", authority: "Authority Rules",
  gatewayFlow: "Gateway Flow Rules", gatewayApi: "API Definitions",
};

function nav(app, view) {
  location.hash = `#/${encodeURIComponent(app)}/${view}`;
}
function route() {
  const m = location.hash.match(/^#\/([^/]+)\/([^/]+)/);
  if (m) {
    S.app = decodeURIComponent(m[1]);
    S.view = VIEW_TITLES[m[2]] ? m[2] : "metrics";
  }
  render();
}
window.addEventListener("hashchange", route);

// ------------------------------------------------------------------ boot
async function boot() {
  const j = await api("/app/names.json");
  if (!j) return;
  S.apps = j.data || [];
  if (!S.app || !S.apps.includes(S.app)) S.app = S.apps[0] || null;
  route();
}

// ------------------------------------------------------------------ sidebar
function renderSidebar() {
  const navEl = $("#nav");
  navEl.innerHTML = "";
  navEl.appendChild(h("h4", {}, "Applications"));
  for (const a of S.apps) {
    navEl.appendChild(h("div", {
      class: "item" + (a === S.app ? " sel" : ""),
      onclick: () => nav(a, S.view) }, a));
  }
  if (!S.app) {
    navEl.appendChild(h("div", { class: "dim" },
      "no apps yet — waiting for heartbeats"));
    return;
  }
  const menu = [["metrics", "Realtime Metrics"], ["resources", "Resource View"],
                ["tree", "Node Tree"], ["telemetry", "Telemetry"],
                ["hotkeys", "Hot Resources"],
                ["control", "Overload Control"],
                ["machines", "Machine List"], ["cluster", "Cluster"]];
  navEl.appendChild(h("h4", {}, "Monitor"));
  for (const [v, label] of menu) {
    navEl.appendChild(h("div", {
      class: "item" + (v === S.view ? " sel" : ""),
      onclick: () => nav(S.app, v) }, label));
  }
  navEl.appendChild(h("h4", {}, "Rules"));
  for (const v of RULE_VIEWS) {
    navEl.appendChild(h("div", {
      class: "item" + (v === S.view ? " sel" : ""),
      onclick: () => nav(S.app, v) }, VIEW_TITLES[v]));
  }
}

// ------------------------------------------------------------------ render
function render() {
  renderSidebar();
  const c = $("#content");
  c.innerHTML = "";
  setRefresh(null);
  if (!S.app) { c.appendChild(h("div", { class: "empty" }, "No applications registered. Start an agent with a HeartbeatSender pointed at this dashboard.")); return; }
  if (S.view === "metrics") return viewMetrics(c);
  if (S.view === "resources") return viewResources(c);
  if (S.view === "machines") return viewMachines(c);
  if (S.view === "cluster") return viewCluster(c);
  if (S.view === "tree") return viewTree(c);
  if (S.view === "telemetry") return viewTelemetry(c);
  if (S.view === "hotkeys") return viewHotKeys(c);
  if (S.view === "control") return viewControl(c);
  return viewRules(c, S.view);
}

// ------------------------------------------------------------------ charts
function drawChart(cv, pts, hover) {
  const dpr = window.devicePixelRatio || 1;
  const W = cv.width = cv.clientWidth * dpr, H = cv.height = 170 * dpr;
  const ctx = cv.getContext("2d");
  ctx.clearRect(0, 0, W, H);
  const padL = 44 * dpr, padR = 44 * dpr, padT = 8 * dpr, padB = 20 * dpr;
  const plotW = W - padL - padR, plotH = H - padT - padB;
  ctx.font = `${11 * dpr}px system-ui`;
  if (!pts.length) {
    ctx.fillStyle = "#7f8ea0";
    ctx.fillText("no data in range", padL, H / 2);
    return null;
  }
  const qMax = Math.max(1, ...pts.map(e => Math.max(e.passQps, e.blockQps)));
  const rMax = Math.max(1, ...pts.map(e => e.rt));
  const t0 = pts[0].timestamp, t1 = pts[pts.length - 1].timestamp;
  const x = (t) => padL + (t1 === t0 ? plotW / 2
                                     : (t - t0) * plotW / (t1 - t0));
  const yQ = (v) => padT + plotH - v * plotH / qMax;
  const yR = (v) => padT + plotH - v * plotH / rMax;
  // gridlines + axes labels
  ctx.strokeStyle = "#2a3442"; ctx.fillStyle = "#7f8ea0";
  ctx.lineWidth = 1;
  for (let i = 0; i <= 4; i++) {
    const gy = padT + plotH * i / 4;
    ctx.beginPath(); ctx.moveTo(padL, gy); ctx.lineTo(W - padR, gy);
    ctx.stroke();
    ctx.textAlign = "right";
    ctx.fillText(String(Math.round(qMax * (4 - i) / 4)), padL - 5 * dpr,
                 gy + 4 * dpr);
    ctx.textAlign = "left";
    ctx.fillText(String(Math.round(rMax * (4 - i) / 4)), W - padR + 5 * dpr,
                 gy + 4 * dpr);
  }
  // x time labels
  ctx.textAlign = "center";
  for (let i = 0; i <= 3; i++) {
    const t = t0 + (t1 - t0) * i / 3;
    ctx.fillText(new Date(t).toTimeString().slice(0, 8),
                 x(t), H - 5 * dpr);
  }
  const line = (key, color, yf) => {
    ctx.beginPath(); ctx.strokeStyle = color; ctx.lineWidth = 2 * dpr;
    pts.forEach((e, i) => i ? ctx.lineTo(x(e.timestamp), yf(e[key]))
                            : ctx.moveTo(x(e.timestamp), yf(e[key])));
    ctx.stroke();
  };
  line("passQps", "#3fb97f", yQ);
  line("blockQps", "#e06c5c", yQ);
  line("rt", "#4da3ff", yR);
  if (hover != null) {
    const hx = x(hover.timestamp);
    ctx.strokeStyle = "#7f8ea0"; ctx.lineWidth = 1;
    ctx.setLineDash([3 * dpr, 3 * dpr]);
    ctx.beginPath(); ctx.moveTo(hx, padT); ctx.lineTo(hx, padT + plotH);
    ctx.stroke(); ctx.setLineDash([]);
  }
  return { x, t0, t1, padL, padR, dpr };
}

function attachTooltip(cv, getPts) {
  cv.onmousemove = (ev) => {
    const pts = getPts();
    if (!pts.length) return;
    const rect = cv.getBoundingClientRect();
    const dpr = window.devicePixelRatio || 1;
    const mx = (ev.clientX - rect.left) * dpr;
    let best = null, bestD = Infinity;
    const geo = drawChart(cv, pts, null);
    if (!geo) return;
    for (const p of pts) {
      const d = Math.abs(geo.x(p.timestamp) - mx);
      if (d < bestD) { bestD = d; best = p; }
    }
    drawChart(cv, pts, best);
    let tip = $("#tooltip");
    if (!tip) { tip = h("div", { id: "tooltip", class: "tooltip" }); document.body.appendChild(tip); }
    tip.innerHTML =
      `<b>${new Date(best.timestamp).toTimeString().slice(0, 8)}</b><br>` +
      `pass ${best.passQps} · block ${best.blockQps} · ` +
      `ok ${best.successQps} · err ${best.exceptionQps}<br>` +
      `rt ${best.rt} ms` + (best.count > 1 ? ` · ${best.count} machines` : "");
    tip.style.left = (ev.clientX + 14) + "px";
    tip.style.top = (ev.clientY + 10) + "px";
    tip.style.display = "";
  };
  cv.onmouseleave = () => {
    const tip = $("#tooltip");
    if (tip) tip.style.display = "none";
    drawChart(cv, getPts(), null);
  };
}

// ------------------------------------------------------------------ metrics
async function viewMetrics(c) {
  const head = h("div", { class: "card" }, [
    h("h3", {}, [
      h("span", {}, `Realtime Metrics — ${S.app}`),
      h("span", { class: "toolbar" }, [
        h("span", { class: "legend", html:
          '<i style="background:#3fb97f"></i>pass' +
          '<i style="background:#e06c5c"></i>block' +
          '<i style="background:#4da3ff"></i>rt (ms, right axis)' }),
        (() => {
          const sel = h("select", { onchange: (e) => {
            S.range = +e.target.value; refresh(); } },
            [[60, "last 1 min"], [300, "last 5 min"]].map(([v, l]) =>
              h("option", v === S.range ? { value: v, selected: "" }
                                        : { value: v }, l)));
          return sel;
        })(),
      ]),
    ]),
  ]);
  const box = h("div", {});
  c.appendChild(head); c.appendChild(box);
  const cards = {};   // resource -> {cv}
  async function refresh() {
    const j = await api(`/metric/resources.json?app=${encodeURIComponent(S.app)}`);
    if (!j) return;
    const end = Date.now(), start = end - S.range * 1000;
    const resources = (j.data || []).slice(0, 12);
    if (!resources.length && !box.childElementCount) {
      box.appendChild(h("div", { class: "empty" },
        "no metrics yet — traffic appears here within ~10 s of the fetcher polling agents"));
    }
    for (const res of resources) {
      if (!cards[res]) {
        const cv = h("canvas", { class: "chart" });
        box.appendChild(h("div", { class: "card" }, [
          h("h3", {}, [h("span", {}, res)]), cv]));
        cards[res] = { cv };
        attachTooltip(cv, () => S.chartData[res] || []);
      }
      const m = await api(`/metric/queryByAppAndResource.json?app=${encodeURIComponent(S.app)}&identity=${encodeURIComponent(res)}&startTime=${start}&endTime=${end}`);
      if (m) {
        S.chartData[res] = m.data || [];
        drawChart(cards[res].cv, S.chartData[res], null);
      }
    }
  }
  await refresh();
  setRefresh(refresh, 5000);
}

// ------------------------------------------------------------------ machines
function heartbeatAge(m) {
  return Math.max(0, Math.round((Date.now() - m.lastHeartbeat) / 1000));
}
async function loadMachines() {
  const j = await api(`/app/${encodeURIComponent(S.app)}/machines.json`);
  S.machines = j ? (j.data || []) : [];
  return S.machines;
}
async function viewMachines(c) {
  const tbody = h("tbody", {});
  const sysBox = h("div", {});
  c.appendChild(sysBox);
  c.appendChild(h("div", { class: "card" }, [
    h("h3", {}, [h("span", {}, `Machines — ${S.app}`)]),
    h("table", {}, [h("thead", {}, h("tr", {}, [
      "hostname", "ip:port", "sentinel version", "heartbeat age", "status",
      "",
    ].map(t => h("th", {}, t)))), tbody]),
  ]));
  async function refreshSystem() {
    // adaptive-protection live gauges per healthy machine (systemStatus);
    // fetched in parallel so one slow agent can't stall the rest
    const healthy = S.machines.filter(x => x.healthy);
    const results = await Promise.all(healthy.map(m =>
      api(`/systemStatus.json?ip=${m.ip}&port=${m.port}`)));
    const rows = [];
    for (let i = 0; i < healthy.length; i++) {
      const m = healthy[i], j = results[i];
      if (!j || !j.success || !j.data) continue;
      const s = j.data;
      rows.push(h("tr", {}, [
        h("td", {}, `${m.ip}:${m.port}`),
        h("td", { class: "num" }, String(s.qps ?? "—")),
        h("td", { class: "num" }, String(s.thread ?? "—")),
        h("td", { class: "num" },
          s.rt != null ? Number(s.rt).toFixed(2) : "—"),
        h("td", { class: "num" },
          s.load != null && s.load >= 0 ? s.load.toFixed(2) : "—"),
        h("td", { class: "num" },
          s.cpuUsage != null && s.cpuUsage >= 0
            ? (s.cpuUsage * 100).toFixed(1) + " %" : "—"),
      ]));
    }
    sysBox.innerHTML = "";
    if (rows.length) {
      sysBox.appendChild(h("div", { class: "card" }, [
        h("h3", {}, [h("span", {}, "System status"),
          h("span", { class: "sub" },
            "inbound QPS · concurrency · avg RT · load1 · CPU (SystemSlot inputs)")]),
        h("table", {}, [h("thead", {}, h("tr", {},
          ["machine", "qps", "threads", "rt ms", "load1", "cpu"].map(t =>
            h("th", {}, t)))), h("tbody", {}, rows)]),
      ]));
    }
  }
  async function refresh() {
    await loadMachines();
    refreshSystem();
    tbody.innerHTML = "";
    for (const m of S.machines) {
      tbody.appendChild(h("tr", {}, [
        h("td", {}, m.hostname || "—"),
        h("td", {}, `${m.ip}:${m.port}`),
        h("td", {}, m.version || "—"),
        h("td", {}, `${heartbeatAge(m)} s ago`),
        h("td", {}, h("span", {
          class: "badge " + (m.healthy ? "ok" : "bad") },
          m.healthy ? "healthy" : "lost")),
        h("td", {}, h("button", { class: "sm danger", onclick: async () => {
          if (!confirm(`Remove ${m.ip}:${m.port}? It re-registers on its next heartbeat if still alive.`)) return;
          await post(`/app/${encodeURIComponent(S.app)}/machine/remove.json`,
                     { ip: m.ip, port: m.port });
          refresh();
        } }, "remove")),
      ]));
    }
    if (!S.machines.length) {
      tbody.appendChild(h("tr", {}, h("td", { colspan: 6, class: "dim" },
        "no machines")));
    }
  }
  await refresh();
  setRefresh(refresh, 5000);
}

// ------------------------------------------------------------------ telemetry
// Runtime self-telemetry (agent `obs` command → /obs/telemetry.json):
// decision counters, latency histograms, recent spans + block events
// (docs/OBSERVABILITY.md).
async function viewTelemetry(c) {
  await loadMachines();
  const sel = machineSelector(() => refresh());
  const body = h("div", {});
  c.appendChild(h("div", { class: "card" }, [
    h("h3", {}, [h("span", {}, `Runtime Telemetry — ${S.app}`),
                 h("span", { class: "toolbar" }, [
                   h("span", { class: "sub" }, "machine"), sel])]),
    body,
  ]));
  const fmtMs = (v) => v == null ? "—" : Number(v).toFixed(3);
  const fmtUs = (ns) => (ns / 1000).toFixed(1) + " µs";
  function histRows(label, s) {
    if (!s) return null;
    return h("tr", {}, [
      h("td", {}, label),
      h("td", { class: "num" }, String(s.count ?? 0)),
      h("td", { class: "num" }, fmtMs(s.p50_ms)),
      h("td", { class: "num" }, fmtMs(s.p95_ms)),
      h("td", { class: "num" }, fmtMs(s.p99_ms)),
      h("td", { class: "num" },
        s.max_ns != null ? fmtMs(s.max_ns / 1e6) : "—"),
    ]);
  }
  function counterTable(title, sub, rows) {
    return h("div", { class: "card" }, [
      h("h3", {}, [h("span", {}, title),
                   h("span", { class: "sub" }, sub)]),
      rows.length
        ? h("table", {}, [h("thead", {}, h("tr", {},
            ["counter", "count"].map(t => h("th", {}, t)))),
            h("tbody", {}, rows.map(([k, v]) => h("tr", {}, [
              h("td", {}, k),
              h("td", { class: "num" }, String(v))])))])
        : h("span", { class: "dim" }, "no events yet"),
    ]);
  }
  async function refresh() {
    if (!S.machineSel) {
      body.innerHTML = "";
      body.appendChild(h("span", { class: "dim" }, "no healthy machine"));
      return;
    }
    const [ip, port] = S.machineSel.split(":");
    const j = await api(`/obs/telemetry.json?ip=${ip}&port=${port}`);
    body.innerHTML = "";
    if (!j || !j.success) {
      body.appendChild(h("span", { class: "bad" }, j ? j.msg : "error"));
      return;
    }
    const d = j.data || {};
    if (!d.enabled) {
      body.appendChild(h("span", { class: "dim" },
        "observability disabled on this agent (SENTINEL_OBS_DISABLE)"));
      return;
    }
    body.appendChild(h("span", { class: "sub" },
      `sampling 1/${Math.max(1, Math.round(1 / (d.sample || 1)))} · ` +
      `host threads elided: ${d.threadsElided ? "yes" : "no"}`));
    const hist = d.hist || {};
    body.appendChild(h("div", { class: "card" }, [
      h("h3", {}, [h("span", {}, "Latency"),
        h("span", { class: "sub" },
          "log-bucketed histograms (obs/hist.py) — ms")]),
      h("table", {}, [h("thead", {}, h("tr", {},
        ["stage", "count", "p50", "p95", "p99", "max"].map(t =>
          h("th", {}, t)))),
        h("tbody", {}, [
          histRows("entry → verdict", hist.entry_to_verdict),
          histRows("dispatch device time", hist.dispatch_device),
        ])]),
    ]));
    const counts = d.counters || {};
    const groups = { "split_route.": [], "compile_cache.": [],
                     "occupy.": [], "block_reason.": [] };
    for (const k of Object.keys(counts).sort()) {
      for (const p of Object.keys(groups)) {
        if (k.startsWith(p)) groups[p].push([k.slice(p.length), counts[k]]);
      }
    }
    body.appendChild(counterTable("Split routing",
      "dispatch-path decisions per batch", groups["split_route."]));
    body.appendChild(counterTable("Compile cache",
      "decide-program fetch hits/misses/retries", groups["compile_cache."]));
    body.appendChild(counterTable("Occupy bookings",
      "priority occupy lifecycle", groups["occupy."]));
    body.appendChild(counterTable("Block reasons",
      "denials by verdict code name", groups["block_reason."]));
    const spans = d.spans || [];
    body.appendChild(h("div", { class: "card" }, [
      h("h3", {}, [h("span", {}, "Recent spans"),
        h("span", { class: "sub" },
          "sampled batch-lifecycle traces (newest last)")]),
      spans.length
        ? h("table", {}, [h("thead", {}, h("tr", {},
            ["trace", "span", "duration", "rows", "note"].map(t =>
              h("th", {}, t)))),
            h("tbody", {}, spans.slice(-40).map(s => h("tr", {}, [
              h("td", { class: "num" }, String(s.trace)),
              h("td", {}, s.name),
              h("td", { class: "num" }, fmtUs(s.dur_ns)),
              h("td", { class: "num" }, String(s.n || "")),
              h("td", { class: "dim" }, s.note || ""),
            ])))])
        : h("span", { class: "dim" }, "no sampled spans yet"),
    ]));
    const evs = d.block_events || [];
    body.appendChild(h("div", { class: "card" }, [
      h("h3", {}, [h("span", {}, "Recent block events"),
        h("span", { class: "sub" },
          "sampled denial records (obs/eventlog.py)")]),
      evs.length
        ? h("table", {}, [h("thead", {}, h("tr", {},
            ["time", "resource", "origin", "reason", "count"].map(t =>
              h("th", {}, t)))),
            h("tbody", {}, evs.map(e => h("tr", {}, [
              h("td", {}, new Date(e.ms).toTimeString().slice(0, 8)),
              h("td", {}, e.resource),
              h("td", {}, e.origin || "—"),
              h("td", {}, e.reason_name || String(e.reason)),
              h("td", { class: "num" }, String(e.count)),
            ])))])
        : h("span", { class: "dim" }, "no sampled block events yet"),
    ]));
  }
  await refresh();
  setRefresh(refresh, 5000);
}

// ------------------------------------------------------------------ hot keys
// Device-resident hot-resource telemetry (agent `topk` command →
// /obs/topk.json): sharded top-K by rolling pass+block QPS + the
// engine-wide per-second timeline ring (obs/telemetry.py).
async function viewHotKeys(c) {
  await loadMachines();
  const sel = machineSelector(() => refresh());
  const body = h("div", {});
  c.appendChild(h("div", { class: "card" }, [
    h("h3", {}, [h("span", {}, `Hot Resources — ${S.app}`),
                 h("span", { class: "toolbar" }, [
                   h("span", { class: "sub" }, "machine"), sel])]),
    body,
  ]));
  async function refresh() {
    if (!S.machineSel) {
      body.innerHTML = "";
      body.appendChild(h("span", { class: "dim" }, "no healthy machine"));
      return;
    }
    const [ip, port] = S.machineSel.split(":");
    const j = await api(`/obs/topk.json?ip=${ip}&port=${port}&timeline=60`);
    body.innerHTML = "";
    if (!j || !j.success) {
      body.appendChild(h("span", { class: "bad" }, j ? j.msg : "error"));
      return;
    }
    const d = j.data || {};
    if (!d.enabled) {
      body.appendChild(h("span", { class: "dim" },
        "telemetry disabled on this agent (SENTINEL_TELEMETRY_DISABLE " +
        "or SENTINEL_OBS_DISABLE)"));
      return;
    }
    body.appendChild(h("span", { class: "sub" },
      `k=${d.k} · ${d.n_shards} shard(s) × ${d.rows_per_shard} rows · ` +
      `ticks ${d.ticks} · readback drops ${d.drops}`));
    const hot = d.hot || [];
    // per-resource RT quantile columns from the device-resident histogram
    // table — absent when SENTINEL_RESOURCE_HIST_DISABLE is set
    const hasHist = hot.some(r => r.rt_p99_ms !== undefined);
    const hotCols = ["resource", "row", "qps", "load", "pass", "block",
                     "success", "exception"]
      .concat(hasHist ? ["p50 ms", "p95 ms", "p99 ms"] : []);
    body.appendChild(h("div", { class: "card" }, [
      h("h3", {}, [h("span", {}, "Top-K by rolling QPS"),
        h("span", { class: "sub" },
          "device-side lax.top_k merged across row shards (exact)" +
          (hasHist ? " · RT quantiles from the cumulative device histogram"
                   : ""))]),
      hot.length
        ? h("table", {}, [h("thead", {}, h("tr", {},
            hotCols.map(t => h("th", {}, t)))),
            h("tbody", {}, hot.map(r => h("tr", {}, [
              h("td", {}, r.resource),
              h("td", { class: "num" }, String(r.row)),
              h("td", { class: "num" }, String(r.qps)),
              h("td", { class: "num" }, String(r.load)),
              h("td", { class: "num" }, String(r.pass)),
              h("td", { class: "num" }, String(r.block)),
              h("td", { class: "num" }, String(r.success)),
              h("td", { class: "num" }, String(r.exception)),
            ].concat(hasHist ? [
              h("td", { class: "num" },
                r.rt_p50_ms !== undefined ? String(r.rt_p50_ms) : "—"),
              h("td", { class: "num" },
                r.rt_p95_ms !== undefined ? String(r.rt_p95_ms) : "—"),
              h("td", { class: "num" },
                r.rt_p99_ms !== undefined ? String(r.rt_p99_ms) : "—"),
            ] : []))))])
        : h("span", { class: "dim" }, "no hot resources yet"),
    ]));
    const tl = d.timeline || [];
    body.appendChild(h("div", { class: "card" }, [
      h("h3", {}, [h("span", {}, "Per-second timeline"),
        h("span", { class: "sub" },
          "engine-wide aggregates from the device ring buffer " +
          "(newest last)")]),
      tl.length
        ? h("table", {}, [h("thead", {}, h("tr", {},
            ["time", "pass", "block", "success", "exception",
             "occupied", "rt sum (ms)"].map(t => h("th", {}, t)))),
            h("tbody", {}, tl.slice(-30).map(e => h("tr", {}, [
              h("td", {}, new Date(e.sec * 1000).toTimeString().slice(0, 8)),
              h("td", { class: "num" }, String(e.pass)),
              h("td", { class: "num" }, String(e.block)),
              h("td", { class: "num" }, String(e.success)),
              h("td", { class: "num" }, String(e.exception)),
              h("td", { class: "num" }, String(e.occupied_pass)),
              h("td", { class: "num" }, Number(e.rt_sum).toFixed(1)),
            ])))])
        : h("span", { class: "dim" }, "no timeline seconds yet"),
    ]));
  }
  await refresh();
  setRefresh(refresh, 5000);
}

// ------------------------------------------------------------------ control
// Overload-controller state + audit trail (agent `control` command →
// /obs/control.json): admission fraction, estimator extrema, degrade
// trackers, and the applied-action tail with evidence (control/loop.py).
async function viewControl(c) {
  await loadMachines();
  const sel = machineSelector(() => refresh());
  const body = h("div", {});
  c.appendChild(h("div", { class: "card" }, [
    h("h3", {}, [h("span", {}, `Overload Control — ${S.app}`),
                 h("span", { class: "toolbar" }, [
                   h("span", { class: "sub" }, "machine"), sel])]),
    body,
  ]));
  async function refresh() {
    if (!S.machineSel) {
      body.innerHTML = "";
      body.appendChild(h("span", { class: "dim" }, "no healthy machine"));
      return;
    }
    const [ip, port] = S.machineSel.split(":");
    const j = await api(`/obs/control.json?ip=${ip}&port=${port}&actions=32`);
    body.innerHTML = "";
    if (!j || !j.success) {
      body.appendChild(h("span", { class: "bad" },
        j ? j.msg + " (no controller attached on this agent?)" : "error"));
      return;
    }
    const d = j.data || {};
    if (!d.enabled) {
      body.appendChild(h("span", { class: "dim" },
        "controller disabled on this agent (SENTINEL_CONTROL_DISABLE)"));
      return;
    }
    const p = d.policy || {};
    const ob = d.last_obs;
    body.appendChild(h("span", { class: "sub" },
      `interval ${d.interval_ms}ms · ticks ${d.ticks} · ` +
      `actions ${d.total_actions} · admit ` +
      `${(100 * (p.admit_frac == null ? 1 : p.admit_frac)).toFixed(1)}%` +
      (p.degraded_batcher ? " · batcher retuned" : "")));
    if (ob) {
      body.appendChild(h("div", { class: "card" }, [
        h("h3", {}, [h("span", {}, "Last observation"),
          h("span", { class: "sub" },
            "interval p99 from the rolling request histogram; " +
            "rate/RT extrema are windowed estimates")]),
        h("table", {}, [h("thead", {}, h("tr", {},
            ["p99 (ms)", "rt avg (ms)", "pass/s", "block/s", "queue",
             "max rate", "min rt (ms)"].map(t => h("th", {}, t)))),
          h("tbody", {}, [h("tr", {}, [
            h("td", { class: "num" }, String(ob.p99_ms)),
            h("td", { class: "num" }, String(ob.rt_avg_ms)),
            h("td", { class: "num" }, String(ob.pass_per_s)),
            h("td", { class: "num" }, String(ob.block_per_s)),
            h("td", { class: "num" },
              `${ob.queue_depth}/${ob.queue_max || "∞"}`),
            h("td", { class: "num" },
              p.max_rate == null ? "–" : String(p.max_rate)),
            h("td", { class: "num" },
              p.min_rt_ms == null ? "–" : String(p.min_rt_ms)),
          ])])]),
      ]));
    }
    const acts = d.actions || [];
    body.appendChild(h("div", { class: "card" }, [
      h("h3", {}, [h("span", {}, "Applied actions (newest last)"),
        h("span", { class: "sub" },
          "each one is also pinned in the flight recorder " +
          "(trigger kind controller_action)")]),
      acts.length
        ? h("table", {}, [h("thead", {}, h("tr", {},
            ["time", "action", "detail", "p99 (ms)", "queue"]
              .map(t => h("th", {}, t)))),
            h("tbody", {}, acts.map(a => h("tr", {}, [
              h("td", {},
                new Date(a.ts_ms).toTimeString().slice(0, 8)),
              h("td", {}, a.kind),
              h("td", {}, a.note),
              h("td", { class: "num" },
                String((a.evidence || {}).p99_ms)),
              h("td", { class: "num" },
                String((a.evidence || {}).queue_depth)),
            ])))])
        : h("span", { class: "dim" },
            "no interventions yet — the loop is holding"),
    ]));
  }
  await refresh();
  setRefresh(refresh, 5000);
}

// ------------------------------------------------------------------ resources
// shared by the resource + tree views: healthy-machine <select> wired to
// S.machineSel (call after loadMachines())
function machineSelector(refresh) {
  const healthy = S.machines.filter(m => m.healthy);
  if (!S.machineSel || !healthy.some(m => `${m.ip}:${m.port}` === S.machineSel)) {
    S.machineSel = healthy.length ? `${healthy[0].ip}:${healthy[0].port}` : "";
  }
  return h("select", { onchange: (e) => { S.machineSel = e.target.value; refresh(); } },
    healthy.map(m => {
      const v = `${m.ip}:${m.port}`;
      return h("option", v === S.machineSel ? { value: v, selected: "" }
                                            : { value: v }, v);
    }));
}

// shared per-origin drill-down subtable row (agent `origin` command)
async function originsSubtable(ip, port, resource, colspan) {
  const o = await api(`/resource/origin.json?ip=${ip}&port=${port}&id=${encodeURIComponent(resource)}`);
  const origins = (o && o.data) || [];
  return h("tr", {}, h("td", { colspan },
    origins.length
      ? h("table", {}, [
          h("thead", {}, h("tr", {}, ["origin", "pass", "block",
            "success", "exception", "threads"].map(t => h("th", {}, t)))),
          h("tbody", {}, origins.map(g => h("tr", {}, [
            h("td", {}, g.origin),
            h("td", { class: "num ok" }, String(g.passQps)),
            h("td", { class: "num" }, String(g.blockQps)),
            h("td", { class: "num" }, String(g.successQps)),
            h("td", { class: "num" }, String(g.exceptionQps)),
            h("td", { class: "num" }, String(g.threadNum)),
          ])))])
      : h("span", { class: "dim" },
          "no per-origin traffic on this resource")));
}

async function viewResources(c) {
  await loadMachines();
  const sel = machineSelector(() => refresh());
  const tbody = h("tbody", {});
  c.appendChild(h("div", { class: "card" }, [
    h("h3", {}, [h("span", {}, `Resource View — ${S.app}`),
                 h("span", { class: "toolbar" }, [
                   h("span", { class: "sub" }, "machine"), sel])]),
    h("table", {}, [h("thead", {}, h("tr", {}, [
      ["resource", ""], ["pass", "num"], ["block", "num"], ["total", "num"],
      ["success", "num"], ["exception", "num"], ["rt ms", "num"],
      ["threads", "num"], ["", ""],
    ].map(([t, cl]) => h("th", { class: cl }, t)))), tbody]),
  ]));
  async function refresh() {
    if (!S.machineSel) { tbody.innerHTML = ""; tbody.appendChild(h("tr", {}, h("td", { colspan: 9, class: "dim" }, "no healthy machine"))); return; }
    const [ip, port] = S.machineSel.split(":");
    const j = await api(`/resource/machineResource.json?ip=${ip}&port=${port}`);
    tbody.innerHTML = "";
    if (!j || !j.success) {
      tbody.appendChild(h("tr", {}, h("td", { colspan: 9, class: "bad" },
        j ? j.msg : "error")));
      return;
    }
    for (const n of (j.data || [])) {
      const row = h("tr", {}, [
        h("td", {}, n.resource),
        h("td", { class: "num ok" }, String(n.passQps)),
        h("td", { class: "num " + (n.blockQps ? "bad" : "") }, String(n.blockQps)),
        h("td", { class: "num" }, String(n.totalQps)),
        h("td", { class: "num" }, String(n.successQps)),
        h("td", { class: "num " + (n.exceptionQps ? "warn" : "") }, String(n.exceptionQps)),
        h("td", { class: "num" }, String(n.averageRt)),
        h("td", { class: "num" }, String(n.threadNum)),
        h("td", {}, [
          h("button", { class: "sm", onclick: () => {
            // per-origin drill-down (agent `origin` command); state
            // survives the 3 s auto-refresh rebuild
            if (S.openOrigins.has(n.resource)) S.openOrigins.delete(n.resource);
            else S.openOrigins.add(n.resource);
            refresh();
          } }, "origins"),
          " ",
          h("button", { class: "sm",
            onclick: () => openRuleModal("flow", { resource: n.resource }) },
            "+ flow rule"),
        ]),
      ]);
      tbody.appendChild(row);
      if (S.openOrigins.has(n.resource)) {
        tbody.appendChild(await originsSubtable(ip, port, n.resource, 9));
      }
    }
    if (!(j.data || []).length) {
      tbody.appendChild(h("tr", {}, h("td", { colspan: 9, class: "dim" },
        "no live resources on this machine")));
    }
  }
  await refresh();
  setRefresh(refresh, 3000);
}

// ------------------------------------------------------------------ tree
// The reference webapp's identity/resource-tree page (identity.js): the
// machine's invocation tree — EntranceNode root (__total_inbound_traffic__,
// the ENTRY row aggregate) with its resource DefaultNodes indented under
// it, per-origin drill-down per node, and rule creation from a row.
async function viewTree(c) {
  await loadMachines();
  const sel = machineSelector(() => refresh());
  const tbody = h("tbody", {});
  let apiNamesCache = null;   // per-view-load cache of API-group names
  c.appendChild(h("div", { class: "card" }, [
    h("h3", {}, [h("span", {}, `Node Tree — ${S.app}`),
                 h("span", { class: "toolbar" }, [
                   h("span", { class: "sub" }, "machine"), sel])]),
    h("table", {}, [h("thead", {}, h("tr", {}, [
      ["resource", ""], ["threads", "num"], ["total", "num"],
      ["pass", "num"], ["block", "num"], ["success", "num"],
      ["exception", "num"], ["rt ms", "num"], ["", ""],
    ].map(([t, cl]) => h("th", { class: cl }, t)))), tbody]),
  ]));
  async function refresh() {
    if (!S.machineSel) { tbody.innerHTML = ""; tbody.appendChild(h("tr", {}, h("td", { colspan: 9, class: "dim" }, "no healthy machine"))); return; }
    const [ip, port] = S.machineSel.split(":");
    const j = await api(`/resource/jsonTree.json?ip=${ip}&port=${port}`);
    tbody.innerHTML = "";
    if (!j || !j.success) {
      tbody.appendChild(h("tr", {}, h("td", { colspan: 9, class: "bad" },
        j ? j.msg : "error")));
      return;
    }
    const nodes = j.data || [];
    const root = nodes.find(n => n.resource === "__total_inbound_traffic__");
    // gateway-classified resources (ResourceTypeConstants gateway = 3) get
    // their own section, the reference gateway identity page's tree
    const children = nodes.filter(n => n !== root && n.classification !== 3);
    const gateway = nodes.filter(n => n !== root && n.classification === 3);
    const rootCells = root
      ? [String(root.threadNum), String(root.totalQps), String(root.passQps),
         String(root.blockQps), String(root.successQps),
         String(root.exceptionQps), String(root.averageRt)]
      : ["0", "0", "0", "0", "0", "0", "0"];
    tbody.appendChild(h("tr", {}, [
      h("td", {}, h("b", {}, "machine-root (total inbound)")),
      ...rootCells.map((v, i) => h("td", { class: "num" + (i === 3 && v !== "0" ? " bad" : "") }, v)),
      h("td", {}),
    ]));
    for (const n of children) {
      tbody.appendChild(h("tr", {}, [
        h("td", {}, `  └─ ${n.resource}`),
        h("td", { class: "num" }, String(n.threadNum)),
        h("td", { class: "num" }, String(n.totalQps)),
        h("td", { class: "num ok" }, String(n.passQps)),
        h("td", { class: "num " + (n.blockQps ? "bad" : "") }, String(n.blockQps)),
        h("td", { class: "num" }, String(n.successQps)),
        h("td", { class: "num " + (n.exceptionQps ? "warn" : "") }, String(n.exceptionQps)),
        h("td", { class: "num" }, String(n.averageRt)),
        h("td", {}, [
          h("button", { class: "sm", onclick: () => {
            if (S.openOrigins.has(n.resource)) S.openOrigins.delete(n.resource);
            else S.openOrigins.add(n.resource);
            refresh();
          } }, "origins"),
          " ",
          h("button", { class: "sm",
            onclick: () => openRuleModal("flow", { resource: n.resource }) },
            "+ flow rule"),
          " ",
          h("button", { class: "sm",
            onclick: () => openRuleModal("degrade", { resource: n.resource }) },
            "+ degrade rule"),
        ]),
      ]));
      if (S.openOrigins.has(n.resource)) {
        tbody.appendChild(await originsSubtable(ip, port, n.resource, 9));
      }
    }
    if (gateway.length) {
      // which gateway resources are API groups (vs routes) comes from the
      // app's API definitions, same as the reference gateway identity
      // page — fetched once per view load (each fetch round-trips to the
      // agent), not on every 3 s tree poll
      if (apiNamesCache === null) {
        const aj = await api(`/v1/gatewayApi/rules?app=${encodeURIComponent(S.app)}`);
        apiNamesCache = new Set(((aj && aj.data) || []).map(r => r.apiName));
      }
      const apiNames = apiNamesCache;
      tbody.appendChild(h("tr", {}, [
        h("td", { colspan: 9 },
          h("b", {}, "gateway — routes and API groups"))]));
      for (const n of gateway) {
        const kind = apiNames.has(n.resource) ? "API group" : "route";
        tbody.appendChild(h("tr", {}, [
          h("td", {}, [`  └─ ${n.resource} `,
                       h("span", { class: "sub" }, `[${kind}]`)]),
          h("td", { class: "num" }, String(n.threadNum)),
          h("td", { class: "num" }, String(n.totalQps)),
          h("td", { class: "num ok" }, String(n.passQps)),
          h("td", { class: "num " + (n.blockQps ? "bad" : "") },
            String(n.blockQps)),
          h("td", { class: "num" }, String(n.successQps)),
          h("td", { class: "num " + (n.exceptionQps ? "warn" : "") },
            String(n.exceptionQps)),
          h("td", { class: "num" }, String(n.averageRt)),
          h("td", {}, h("button", { class: "sm",
            onclick: () => openRuleModal("gatewayFlow",
                                         { resource: n.resource }) },
            "+ gateway rule")),
        ]));
      }
    }
    if (!children.length && !gateway.length && !root) {
      tbody.appendChild(h("tr", {}, h("td", { colspan: 9, class: "dim" },
        "no live nodes on this machine")));
    }
  }
  await refresh();
  setRefresh(refresh, 3000);
}

// ------------------------------------------------------------------ cluster
const MODES = { "-1": "off", 0: "client", 1: "server" };
async function viewCluster(c) {
  const tbody = h("tbody", {});
  const topo = h("div", {});
  const srvConfig = h("div", {});
  const srvMonitor = h("div", {});
  const srvMetrics = h("div", {});
  c.appendChild(h("div", { class: "card" }, [
    h("h3", {}, [h("span", {}, `Cluster — ${S.app}`)]), topo]));
  c.appendChild(h("div", { class: "card" }, [
    h("h3", {}, [h("span", {}, "Machines"),
      h("span", { class: "sub" },
        "assign = make that machine the token server, bind the rest as clients")]),
    h("table", {}, [h("thead", {}, h("tr", {}, [
      "machine", "mode", "token server", "",
    ].map(t => h("th", {}, t)))), tbody]),
  ]));
  c.appendChild(srvConfig);
  c.appendChild(srvMonitor);
  c.appendChild(srvMetrics);

  // --- token-server config editor (reference cluster_app_server_manage) —
  // rebuilt only when the server machine changes so edits aren't clobbered
  let cfgKey = null;
  async function refreshServerConfig(server) {
    const key = server ? `${server.ip}:${server.port}` : "";
    if (key === cfgKey) return;
    cfgKey = key;
    srvConfig.innerHTML = "";
    if (!server) return;
    let j;
    try {
      j = await api(`/cluster/serverConfig.json?ip=${server.ip}&port=${server.port}`);
    } catch (e) {
      cfgKey = null;        // transient fetch failure: retry next poll
      return;
    }
    if (!j || !j.success) { cfgKey = null; return; }
    const cfg = j.data || {};
    const nsList = (cfg.namespaceSet && cfg.namespaceSet.length)
      ? cfg.namespaceSet : [S.app];
    const nsInput = h("input", { value: nsList.join(", "), size: "40" });
    const nsSel = h("select", {},
      nsList.map(ns => h("option", { value: ns }, ns)));
    const qpsInput = h("input", { type: "number", min: "0",
                                  placeholder: "unlimited" });
    const applied = h("span", { class: "sub" }, "");
    const loadQps = async () => {
      let r = null;
      try {
        r = await api(`/cluster/serverConfig.json?ip=${server.ip}&port=${server.port}&namespace=${encodeURIComponent(nsSel.value)}`);
      } catch (e) { /* transient: leave the field; onchange retries */ }
      const v = (r && r.success && r.data && r.data.flow)
        ? r.data.flow.maxAllowedQps : null;
      qpsInput.value = (v == null || v < 0) ? "" : String(v);
      applied.textContent = "";
    };
    nsSel.onchange = loadQps;
    await loadQps();
    const sub = (cfg.transport
      ? `token port :${cfg.transport.port} · idle ${cfg.transport.idleSeconds}s · `
      : "") + (cfg.flow
      ? `window ${cfg.flow.intervalMs}ms × ${cfg.flow.sampleCount} buckets`
      : "");
    srvConfig.appendChild(h("div", { class: "card" }, [
      h("h3", {}, [h("span", {}, `Token server config — ${key}`),
                   h("span", { class: "sub" }, sub)]),
      h("div", { class: "toolbar" }, [
        h("span", { class: "sub" }, "namespace set"), nsInput,
        h("button", { class: "sm primary", onclick: async () => {
          const r = await post("/cluster/serverConfig",
            { ip: server.ip, port: server.port, namespaces: nsInput.value });
          if (r && !r.success) alert(r.msg);
          cfgKey = null; refreshServerConfig(server);
        } }, "save set"),
      ]),
      h("div", { class: "toolbar" }, [
        h("span", { class: "sub" }, "maxAllowedQps"), nsSel, qpsInput,
        h("button", { class: "sm primary", onclick: async () => {
          if (qpsInput.value === "") { alert("enter a QPS ceiling"); return; }
          const r = await post("/cluster/serverConfig",
            { ip: server.ip, port: server.port, namespace: nsSel.value,
              maxAllowedQps: qpsInput.value });
          if (r && !r.success) alert(r.msg);
          else applied.textContent = "applied";
        } }, "apply"),
        applied,
      ]),
    ]));
  }

  // --- token-server QPS monitor (reference cluster_app_server_monitor) —
  // granted/rejected per poll, charted from a client-side history
  let monKey = null, monCv = null;
  function ensureMonitor(server) {
    const key = server ? `${server.ip}:${server.port}` : "";
    if (key === monKey) return;
    monKey = key;
    srvMonitor.innerHTML = "";
    monCv = null;
    if (!server) return;
    monCv = h("canvas", { class: "chart" });
    srvMonitor.appendChild(h("div", { class: "card" }, [
      h("h3", {}, [h("span", {}, `Token server QPS — ${key}`),
        h("span", { class: "sub" },
          "granted (pass) vs rejected (block), summed over cluster flows")]),
      monCv]));
  }

  async function refreshServerMetrics(server) {
    refreshServerConfig(server);
    ensureMonitor(server);
    srvMetrics.innerHTML = "";
    if (!server) return;
    const j = await api(`/cluster/metrics.json?app=${encodeURIComponent(S.app)}&ip=${server.ip}&port=${server.port}`);
    if (!j || !j.success) return;
    const flows = j.data || [];
    const hist = (S.clusterHist = S.clusterHist || {});
    const pts = (hist[monKey] = hist[monKey] || []);
    pts.push({
      timestamp: Date.now(),
      passQps: flows.reduce((a, n) => a + (+n.passQps || 0), 0),
      blockQps: flows.reduce((a, n) => a + (+n.blockQps || 0), 0),
      rt: 0,
    });
    if (pts.length > 180) pts.shift();
    if (monCv) drawChart(monCv, pts, null);
    const rows = flows.map(n => h("tr", {}, [
      h("td", {}, String(n.flowId)),
      h("td", {}, n.resourceName),
      h("td", { class: "num ok" }, String(n.passQps)),
      h("td", { class: "num " + (n.blockQps ? "bad" : "") },
        String(n.blockQps)),
    ]));
    srvMetrics.appendChild(h("div", { class: "card" }, [
      h("h3", {}, [h("span", {}, `Token server flows — ${server.ip}:${server.port}`),
        h("span", { class: "sub" }, "current-window pass/block per cluster flow")]),
      h("table", {}, [h("thead", {}, h("tr", {},
        ["flow id", "resource", "pass", "block"].map(t => h("th", {}, t)))),
        h("tbody", {}, rows.length ? rows
          : h("tr", {}, h("td", { colspan: 4, class: "dim" },
              "no cluster rules loaded on the token server")))]),
    ]));
  }
  async function refresh() {
    const j = await api(`/cluster/state.json?app=${encodeURIComponent(S.app)}`);
    if (!j) return;
    const states = j.data || [];
    tbody.innerHTML = "";
    for (const s of states) {
      const srv = s.serverPort
        ? `listening :${s.serverPort}` +
          (s.connectedCount != null ? ` · ${s.connectedCount} clients` : "")
        : (s.serverHost ? `→ ${s.serverHost}:${s.clientServerPort ?? s.serverPort ?? ""}` : "—");
      const modeSel = h("select", {},
        Object.entries(MODES).map(([v, l]) =>
          h("option", String(s.mode) === String(v)
            ? { value: v, selected: "" } : { value: v }, l)));
      tbody.appendChild(h("tr", {}, [
        h("td", {}, `${s.ip}:${s.port}`),
        h("td", {}, [modeSel, " ", h("button", { class: "sm", onclick: async () => {
          await post("/cluster/mode", { app: S.app, ip: s.ip, port: s.port,
                                        mode: +modeSel.value });
          refresh();
        } }, "apply")]),
        h("td", {}, srv),
        h("td", {}, h("button", { class: "sm primary", onclick: async () => {
          const r = await post("/cluster/assign",
            { app: S.app, serverIp: s.ip, serverPort: s.port });
          if (r && !r.success) alert(r.msg);
          refresh();
        } }, "assign")),
      ]));
    }
    if (!states.length) {
      tbody.appendChild(h("tr", {}, h("td", { colspan: 4, class: "dim" },
        "no machines")));
    }
    drawTopology(topo, states);
    refreshServerMetrics(states.find(s => s.mode === 1));
  }
  await refresh();
  setRefresh(refresh, 10000);
}

function drawTopology(container, states) {
  container.innerHTML = "";
  if (!states.length) {
    container.appendChild(h("div", { class: "empty" }, "no machines"));
    return;
  }
  const server = states.find(s => s.mode === 1);
  const others = states.filter(s => s !== server);
  const W = 700, H = 240, ns = "http://www.w3.org/2000/svg";
  const svg = document.createElementNS(ns, "svg");
  svg.setAttribute("class", "topo");
  svg.setAttribute("viewBox", `0 0 ${W} ${H}`);
  const node = (x, y, label, cls) => {
    const g = document.createElementNS(ns, "g");
    g.setAttribute("class", cls);
    const rect = document.createElementNS(ns, "rect");
    rect.setAttribute("x", x - 75); rect.setAttribute("y", y - 18);
    rect.setAttribute("width", 150); rect.setAttribute("height", 36);
    rect.setAttribute("rx", 8);
    const text = document.createElementNS(ns, "text");
    text.setAttribute("x", x); text.setAttribute("y", y + 4);
    text.setAttribute("text-anchor", "middle");
    text.textContent = label;
    g.appendChild(rect); g.appendChild(text);
    svg.appendChild(g);
  };
  const edge = (x1, y1, x2, y2) => {
    const l = document.createElementNS(ns, "line");
    l.setAttribute("x1", x1); l.setAttribute("y1", y1);
    l.setAttribute("x2", x2); l.setAttribute("y2", y2);
    svg.appendChild(l);
  };
  const sx = W / 2, sy = 40;
  const n = others.length, step = W / Math.max(1, n);
  others.forEach((s, i) => {
    const cx = step * (i + 0.5), cy = H - 50;
    if (server) edge(sx, sy + 18, cx, cy - 18);
    node(cx, cy, `${s.ip}:${s.port} (${MODES[String(s.mode)] ?? s.mode})`,
         s.mode === 0 ? "cli" : "cli off");
  });
  if (server) {
    node(sx, sy, `token server ${server.ip}:${server.port}` +
         (server.serverPort ? ` :${server.serverPort}` : ""), "srv");
  } else {
    const t = document.createElementNS(ns, "text");
    t.setAttribute("x", W / 2); t.setAttribute("y", 26);
    t.setAttribute("text-anchor", "middle");
    t.setAttribute("fill", "#7f8ea0");
    t.textContent = "no token server assigned";
    svg.appendChild(t);
  }
  container.appendChild(svg);
}

// ------------------------------------------------------------------ rules
const E = {   // enum label maps (reference RuleConstant / gateway constants)
  flowGrade: { 0: "Thread", 1: "QPS" },
  strategy: { 0: "Direct", 1: "Relate", 2: "Chain" },
  behavior: { 0: "Reject", 1: "Warm Up", 2: "Rate Limiter",
              3: "Warm Up + Rate Limiter" },
  degradeGrade: { 0: "Slow ratio (RT)", 1: "Exception ratio",
                  2: "Exception count" },
  authStrategy: { 0: "Whitelist", 1: "Blacklist" },
  resourceMode: { 0: "Route ID", 1: "API Group" },
  parseStrategy: { 0: "Client IP", 1: "Host", 2: "Header", 3: "URL Param",
                   4: "Cookie" },
  paramMatch: { 0: "Exact", 1: "Prefix", 2: "Regex", 3: "Contains" },
  urlMatch: { 0: "Exact", 1: "Prefix", 2: "Regex" },
  thresholdType: { 0: "Avg Local", 1: "Global" },
};

// field spec: n(ame/path) l(abel) k(ind: text num sel chk json) o(ptions)
// d(efault) req show(fn of current values)
const SCHEMAS = {
  flow: [
    { n: "resource", l: "Resource", k: "text", req: true },
    { n: "limitApp", l: "Limit origin (limitApp)", k: "text", d: "default" },
    { n: "grade", l: "Grade", k: "sel", o: E.flowGrade, d: 1 },
    { n: "count", l: "Threshold", k: "num", d: 10 },
    { n: "strategy", l: "Strategy", k: "sel", o: E.strategy, d: 0 },
    { n: "refResource", l: "Ref resource / entrance", k: "text", d: "",
      show: v => +v.strategy !== 0 },
    { n: "controlBehavior", l: "Control behavior", k: "sel", o: E.behavior,
      d: 0 },
    { n: "warmUpPeriodSec", l: "Warm-up period (s)", k: "num", d: 10,
      show: v => +v.controlBehavior === 1 || +v.controlBehavior === 3 },
    { n: "maxQueueingTimeMs", l: "Max queueing time (ms)", k: "num", d: 500,
      show: v => +v.controlBehavior === 2 || +v.controlBehavior === 3 },
    { n: "clusterMode", l: "Cluster mode", k: "chk", d: false },
    { n: "clusterConfig.flowId", l: "Cluster flow ID", k: "num", d: 0,
      show: v => v.clusterMode },
    { n: "clusterConfig.thresholdType", l: "Threshold type", k: "sel",
      o: E.thresholdType, d: 0, show: v => v.clusterMode },
    { n: "clusterConfig.fallbackToLocalWhenFail", l: "Fallback to local",
      k: "chk", d: true, show: v => v.clusterMode },
  ],
  degrade: [
    { n: "resource", l: "Resource", k: "text", req: true },
    { n: "grade", l: "Strategy", k: "sel", o: E.degradeGrade, d: 0 },
    { n: "count", l: "Threshold (max RT ms / ratio / count)", k: "num",
      d: 0.5 },
    { n: "slowRatioThreshold", l: "Slow ratio threshold", k: "num", d: 1.0,
      show: v => +v.grade === 0 },
    { n: "timeWindow", l: "Recovery window (s)", k: "num", d: 10 },
    { n: "minRequestAmount", l: "Min request amount", k: "num", d: 5 },
    { n: "statIntervalMs", l: "Stat interval (ms)", k: "num", d: 1000 },
  ],
  paramFlow: [
    { n: "resource", l: "Resource", k: "text", req: true },
    { n: "paramIdx", l: "Param index", k: "num", d: 0 },
    { n: "grade", l: "Grade", k: "sel", o: E.flowGrade, d: 1 },
    { n: "count", l: "Threshold", k: "num", d: 10 },
    { n: "durationInSec", l: "Duration (s)", k: "num", d: 1 },
    { n: "burstCount", l: "Burst", k: "num", d: 0 },
    { n: "controlBehavior", l: "Control behavior", k: "sel",
      o: { 0: "Reject", 2: "Rate Limiter" }, d: 0 },
    { n: "maxQueueingTimeMs", l: "Max queueing time (ms)", k: "num", d: 0,
      show: v => +v.controlBehavior === 2 },
    { n: "paramFlowItemList", l: "Per-item overrides (JSON)", k: "json",
      d: [], hint: '[{"object":"vip","count":100,"classType":"String"}]' },
    { n: "clusterMode", l: "Cluster mode", k: "chk", d: false },
    { n: "clusterConfig.flowId", l: "Cluster flow ID", k: "num", d: 0,
      show: v => v.clusterMode },
  ],
  system: [
    { n: "highestSystemLoad", l: "Max load1 (-1 = off)", k: "num", d: -1 },
    { n: "highestCpuUsage", l: "Max CPU usage 0..1 (-1 = off)", k: "num",
      d: -1 },
    { n: "qps", l: "Max total QPS (-1 = off)", k: "num", d: -1 },
    { n: "avgRt", l: "Max avg RT ms (-1 = off)", k: "num", d: -1 },
    { n: "maxThread", l: "Max threads (-1 = off)", k: "num", d: -1 },
  ],
  authority: [
    { n: "resource", l: "Resource", k: "text", req: true },
    { n: "limitApp", l: "Origins (comma-separated)", k: "text", req: true },
    { n: "strategy", l: "Mode", k: "sel", o: E.authStrategy, d: 0 },
  ],
  gatewayFlow: [
    { n: "resource", l: "Route ID / API group", k: "text", req: true },
    { n: "resourceMode", l: "Resource mode", k: "sel", o: E.resourceMode,
      d: 0 },
    { n: "grade", l: "Grade", k: "sel", o: E.flowGrade, d: 1 },
    { n: "count", l: "Threshold", k: "num", d: 10 },
    { n: "intervalSec", l: "Interval (s)", k: "num", d: 1 },
    { n: "controlBehavior", l: "Control behavior", k: "sel",
      o: { 0: "Reject", 2: "Rate Limiter" }, d: 0 },
    { n: "burst", l: "Burst", k: "num", d: 0 },
    { n: "maxQueueingTimeoutMs", l: "Max queueing timeout (ms)", k: "num",
      d: 500, show: v => +v.controlBehavior === 2 },
    { n: "_hasParam", l: "Limit by request attribute", k: "chk", d: false,
      virtual: true },
    { n: "paramItem.parseStrategy", l: "Attribute", k: "sel",
      o: E.parseStrategy, d: 0, show: v => v._hasParam },
    { n: "paramItem.fieldName", l: "Field name (header/param/cookie)",
      k: "text", d: "", show: v => v._hasParam && +getPath(v, "paramItem.parseStrategy") >= 2 },
    { n: "paramItem.pattern", l: "Match pattern (optional)", k: "text", d: "",
      show: v => v._hasParam },
    { n: "paramItem.matchStrategy", l: "Match strategy", k: "sel",
      o: E.paramMatch, d: 0, show: v => v._hasParam && !!getPath(v, "paramItem.pattern") },
  ],
  gatewayApi: [
    { n: "apiName", l: "API group name", k: "text", req: true },
    { n: "predicateItems", l: "Path predicates (JSON)", k: "json",
      d: [{ pattern: "/", matchStrategy: 1 }],
      hint: '[{"pattern":"/foo/**","matchStrategy":1}] — 0 exact, 1 prefix, 2 regex' },
  ],
};

// columns shown in each rule table: [header, render(rule)]
const COLS = {
  flow: [
    ["resource", r => r.resource],
    ["origin", r => r.limitApp],
    ["grade", r => E.flowGrade[r.grade] ?? r.grade],
    ["threshold", r => r.count],
    ["strategy", r => E.strategy[r.strategy] ?? r.strategy],
    ["behavior", r => E.behavior[r.controlBehavior] ?? r.controlBehavior],
    ["cluster", r => r.clusterMode ? `yes (#${r.clusterConfig?.flowId ?? 0})` : "no"],
  ],
  degrade: [
    ["resource", r => r.resource],
    ["strategy", r => E.degradeGrade[r.grade] ?? r.grade],
    ["threshold", r => r.count],
    ["recovery (s)", r => r.timeWindow],
    ["min requests", r => r.minRequestAmount],
    ["stat interval", r => `${r.statIntervalMs} ms`],
  ],
  paramFlow: [
    ["resource", r => r.resource],
    ["param idx", r => r.paramIdx],
    ["grade", r => E.flowGrade[r.grade] ?? r.grade],
    ["threshold", r => r.count],
    ["duration (s)", r => r.durationInSec],
    ["items", r => (r.paramFlowItemList || []).length],
    ["cluster", r => r.clusterMode ? "yes" : "no"],
  ],
  system: [
    ["load1", r => r.highestSystemLoad],
    ["cpu", r => r.highestCpuUsage],
    ["qps", r => r.qps],
    ["avg rt", r => r.avgRt],
    ["threads", r => r.maxThread],
  ],
  authority: [
    ["resource", r => r.resource],
    ["origins", r => r.limitApp],
    ["mode", r => E.authStrategy[r.strategy] ?? r.strategy],
  ],
  gatewayFlow: [
    ["resource", r => r.resource],
    ["mode", r => E.resourceMode[r.resourceMode] ?? r.resourceMode],
    ["grade", r => E.flowGrade[r.grade] ?? r.grade],
    ["threshold", r => `${r.count} / ${r.intervalSec}s`],
    ["behavior", r => ({ 0: "Reject", 2: "Rate Limiter" })[r.controlBehavior] ?? r.controlBehavior],
    ["param", r => r.paramItem
      ? (E.parseStrategy[r.paramItem.parseStrategy] ?? "?") +
        (r.paramItem.fieldName ? `:${r.paramItem.fieldName}` : "")
      : "—"],
  ],
  gatewayApi: [
    ["api group", r => r.apiName],
    ["predicates", r => (r.predicateItems || [])
      .map(p => `${E.urlMatch[p.matchStrategy] ?? "?"} ${p.pattern}`)
      .join(", ")],
  ],
};

async function viewRules(c, rtype) {
  const tbody = h("tbody", {});
  const errBox = h("div", { class: "err" });
  const cols = COLS[rtype];
  c.appendChild(h("div", { class: "card" }, [
    h("h3", {}, [h("span", {}, `${VIEW_TITLES[rtype]} — ${S.app}`),
      h("span", { class: "toolbar" }, [
        h("button", { class: "sm", onclick: () => refreshRules(true) },
          "reload from machines"),
        h("button", { class: "sm primary",
          onclick: () => openRuleModal(rtype) }, "+ new"),
      ])]),
    errBox,
    h("table", {}, [h("thead", {}, h("tr", {},
      [...cols.map(([t]) => h("th", {}, t)), h("th", {}, "")])), tbody]),
  ]));
  async function refreshRules() {
    const j = await api(`/v1/${rtype}/rules?app=${encodeURIComponent(S.app)}`);
    tbody.innerHTML = "";
    errBox.textContent = (j && !j.success) ? j.msg : "";
    const rules = (j && j.data) || [];
    for (const r of rules) {
      tbody.appendChild(h("tr", {}, [
        ...cols.map(([, f]) => h("td", {}, String(f(r) ?? ""))),
        h("td", {}, [
          h("button", { class: "sm",
            onclick: () => openRuleModal(rtype, r) }, "edit"),
          " ",
          h("button", { class: "sm danger", onclick: async () => {
            if (!confirm("Delete this rule?")) return;
            const d = await api(`/v1/${rtype}/rule/${r.id}`,
                                { method: "DELETE" });
            if (d && !d.success) alert(d.msg);
            refreshRules();
          } }, "delete"),
        ]),
      ]));
    }
    if (!rules.length) {
      tbody.appendChild(h("tr", {}, h("td", {
        colspan: cols.length + 1, class: "dim" }, "no rules")));
    }
  }
  S.refreshRules = refreshRules;
  await refreshRules();
}

// ------------------------------------------------------------------ modal
function closeModal() {
  const m = $("#modal-bg");
  if (m) m.remove();
}

function openRuleModal(rtype, rule) {
  closeModal();
  if (S.view !== rtype) nav(S.app, rtype);
  const editing = rule && rule.id;
  const spec = SCHEMAS[rtype];
  // working values: defaults <- existing rule
  const vals = {};
  for (const f of spec) {
    const existing = rule ? getPath(rule, f.n) : undefined;
    setPath(vals, f.n, existing !== undefined ? existing
      : (f.k === "json" ? JSON.stringify(f.d) : f.d));
  }
  if (rtype === "gatewayFlow") vals._hasParam = !!(rule && rule.paramItem);
  const err = h("div", { class: "err" });

  function buildFields(form) {
    form.innerHTML = "";
    for (const f of spec) {
      if (f.show && !f.show(vals)) continue;
      const cur = getPath(vals, f.n);
      let input;
      if (f.k === "sel") {
        input = h("select", { onchange: (e) => {
          setPath(vals, f.n, +e.target.value); buildFields(form); } },
          Object.entries(f.o).map(([v, l]) =>
            h("option", String(cur) === String(v)
              ? { value: v, selected: "" } : { value: v }, l)));
      } else if (f.k === "chk") {
        input = h("input", { type: "checkbox", onchange: (e) => {
          setPath(vals, f.n, e.target.checked); buildFields(form); } });
        input.checked = !!cur;
      } else if (f.k === "json") {
        input = h("textarea", { oninput: (e) => setPath(vals, f.n, e.target.value) });
        input.value = typeof cur === "string" ? cur : JSON.stringify(cur);
      } else {
        input = h("input", {
          type: f.k === "num" ? "number" : "text",
          oninput: (e) => setPath(vals, f.n, e.target.value) });
        input.value = cur ?? "";
        if (f.k === "num") input.step = "any";
        if (editing && f.n === "resource") input.disabled = true;
      }
      if (f.k === "chk") {
        form.appendChild(h("div", { class: "field chk" },
          [input, h("label", {}, f.l)]));
      } else {
        form.appendChild(h("div", { class: "field" }, [
          h("label", {}, f.l + (f.req ? " *" : "")),
          input,
          f.hint ? h("div", { class: "legend" }, f.hint) : null,
        ]));
      }
    }
  }

  function collect() {
    const body = {};
    for (const f of spec) {
      if (f.show && !f.show(vals)) continue;
      if (f.virtual) continue;
      let v = getPath(vals, f.n);
      if (f.k === "num") {
        // Number("") === 0, which would silently save a 0 threshold (i.e.
        // block all traffic) when a field is cleared — empty/whitespace is
        // always a validation error, never a silent default substitution.
        if (v == null || String(v).trim() === "") {
          throw new Error(`${f.l}: not a number`);
        }
        v = Number(v);
        if (Number.isNaN(v)) throw new Error(`${f.l}: not a number`);
      }
      if (f.k === "json" && typeof v === "string") {
        try { v = JSON.parse(v || "null"); }
        catch (e) { throw new Error(`${f.l}: invalid JSON`); }
      }
      if (f.req && (v === "" || v == null)) {
        throw new Error(`${f.l} is required`);
      }
      setPath(body, f.n, v);
    }
    // unchecking "limit by attribute" must clear a previously saved
    // paramItem (PUT merges fields, so absence alone wouldn't remove it)
    if (rtype === "gatewayFlow" && !vals._hasParam) body.paramItem = null;
    return body;
  }

  const form = h("div", {});
  buildFields(form);
  const bg = h("div", { id: "modal-bg", onclick: (e) => {
    if (e.target.id === "modal-bg") closeModal(); } }, [
    h("div", { id: "modal" }, [
      h("h3", {}, `${editing ? "Edit" : "New"} — ${VIEW_TITLES[rtype]}`),
      form, err,
      h("div", { class: "actions" }, [
        h("button", { onclick: closeModal }, "Cancel"),
        h("button", { class: "primary", onclick: async () => {
          let body;
          try { body = collect(); }
          catch (e) { err.textContent = e.message; return; }
          const j = editing
            ? await post(`/v1/${rtype}/rule/${rule.id}`, body, "PUT")
            : await post(`/v1/${rtype}/rule`, { app: S.app, ...body });
          if (j && !j.success) { err.textContent = j.msg; return; }
          closeModal();
          if (S.refreshRules) S.refreshRules();
        } }, editing ? "Save" : "Create"),
      ]),
    ]),
  ]);
  document.body.appendChild(bg);
}

// ------------------------------------------------------------------ init
(async () => {
  $("#login form").onsubmit = doLogin;
  $("#logout").onclick = doLogout;
  const j = await fetch("/auth/check").then(r => r.json());
  const logged = j.data && j.data.loggedIn;
  showLogin(!logged);
  if (logged) boot();
  setInterval(async () => {   // keep the app list fresh
    if ($("#app").style.display === "none") return;
    const r = await api("/app/names.json");
    if (r && JSON.stringify(r.data) !== JSON.stringify(S.apps)) {
      S.apps = r.data || [];
      if (!S.app && S.apps.length) { S.app = S.apps[0]; route(); }
      else renderSidebar();
    }
  }, 10000);
})();
