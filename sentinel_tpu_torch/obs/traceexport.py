"""Chrome-trace-event / Perfetto export of causal span chains.

Converts the span recorder's ``causal()`` payload (or a flight-recorder
pinned record — same shape) into the Trace Event Format that
``chrome://tracing`` and https://ui.perfetto.dev load directly
(JSON Object Format, ``{"traceEvents": [...]}``):

* every span becomes one complete duration event (``"ph": "X"``) — ``ts``
  / ``dur`` in MICROseconds (the format's unit) from the recorder's ns,
  ``tid`` the recording thread ident, so the per-thread rings render as
  per-thread tracks;
* every causal link becomes a flow-arrow pair — ``"ph": "s"`` (start)
  anchored inside a span of the source trace and ``"ph": "f"`` with
  ``"bp": "e"`` (bind to enclosing slice) inside a span of the
  destination trace — drawing the cross-thread fan-in (request → flush
  batch) and fan-out (batch → verdict) arrows.

Everything here is pure data transformation over already-snapshot
dicts — no recorder access, no locks — so the transport ``trace``
command, the dashboard ``/obs/traces.json`` proxy, the serving-bench
worst-request dump and the tests all share one code path
(tests/test_tracing.py round-trips the output through ``json.loads``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

CATEGORY = "sentinel"
FLOW_CATEGORY = "sentinel.flow"


def _anchor_src(spans: List[Dict], ts_ns: int) -> Optional[Dict]:
    """The source-trace span a flow arrow starts from: the last span
    starting at or before the link timestamp, else the first span."""
    best = None
    for s in spans:
        if s["start_ns"] <= ts_ns and (
                best is None or s["start_ns"] >= best["start_ns"]):
            best = s
    return best if best is not None else (spans[0] if spans else None)


def _anchor_dst(spans: List[Dict], ts_ns: int) -> Optional[Dict]:
    """The destination-trace span a flow arrow lands in: the first span
    ending at or after the link timestamp, else the last span."""
    best = None
    for s in spans:
        if s["end_ns"] >= ts_ns and (
                best is None or s["start_ns"] <= best["start_ns"]):
            best = s
    return best if best is not None else (spans[-1] if spans else None)


def _clamp(ts_ns: int, span: Dict) -> int:
    return min(max(ts_ns, span["start_ns"]), span["end_ns"])


def chrome_trace_events(spans: List[Dict], links: List[Dict],
                        pid: int = 1) -> List[Dict]:
    """Span/link dicts → a flat trace-event list (durations + flows)."""
    events: List[Dict] = []
    by_trace: Dict[int, List[Dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace"], []).append(s)
        events.append({
            "ph": "X", "name": s["name"], "cat": CATEGORY,
            "ts": s["start_ns"] / 1000.0,
            # zero-duration ManualClock spans still need visible slices
            "dur": max(s["end_ns"] - s["start_ns"], 1) / 1000.0,
            "pid": pid, "tid": s["thread"],
            "args": {"trace": s["trace"], "n": s["n"], "note": s["note"]},
        })
    for i, ln in enumerate(links, start=1):
        src = _anchor_src(by_trace.get(ln["src"], []), ln["ts_ns"])
        dst = _anchor_dst(by_trace.get(ln["dst"], []), ln["ts_ns"])
        if src is None or dst is None:
            continue   # one side of the edge fell off its ring
        name = "link." + ln["kind"]
        events.append({
            "ph": "s", "id": i, "name": name, "cat": FLOW_CATEGORY,
            "ts": _clamp(ln["ts_ns"], src) / 1000.0,
            "pid": pid, "tid": src["thread"],
        })
        events.append({
            "ph": "f", "bp": "e", "id": i, "name": name,
            "cat": FLOW_CATEGORY,
            "ts": _clamp(ln["ts_ns"], dst) / 1000.0,
            "pid": pid, "tid": dst["thread"],
        })
    return events


def chrome_trace(causal: Dict, pid: int = 1) -> Dict:
    """A ``causal()`` payload / flight pinned record → the loadable
    JSON-object-format document."""
    meta = {"root": causal.get("root", 0)}
    for k in ("kind", "note", "ts_ms", "worst_ms", "truncated"):
        if k in causal:
            meta[k] = causal[k]
    return {
        "traceEvents": chrome_trace_events(
            causal.get("spans", []), causal.get("links", []), pid=pid),
        "displayTimeUnit": "ms",
        "otherData": meta,
    }


def export_chain(spans_recorder, trace_id: int, pid: int = 1) -> Dict:
    """Convenience: recorder + root id → loadable trace document."""
    return chrome_trace(spans_recorder.causal(trace_id), pid=pid)


def dumps(doc: Dict) -> str:
    return json.dumps(doc, separators=(",", ":"))
