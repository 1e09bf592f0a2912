"""Reading a ``torch.profiler`` chrome trace of the traced stretch.

Times are the trace's microseconds. The device is busy where a kernel,
a memory copy or a memory set runs: the union of those intervals, not
their sum, since operations of several streams overlap. An idle gap is
named after the innermost host interval open at its middle: the
benchmark's own regions (``portbench.*``) and the program's spans,
moved onto the trace's clock by the clock mark the harness records.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
STRETCH = "portbench.traced_stretch"
CLOCK_MARK = "portbench.clock_mark"
#: the benchmark's own host regions and the names an idle gap gets
REGIONS = {"portbench.generator": "generator",
           "portbench.result_wait": "result wait",
           "portbench.submit": "pipeline.enqueue"}
#: the program's spans an idle gap may be named after
SPANS = ("pipeline.enqueue", "fused.dispatch", "decide.dispatch",
         "pipeline.settle")

Interval = Tuple[float, float]


def load_events(path: str) -> List[dict]:
    with open(path) as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X"]


def span_of(events, name: str) -> Optional[Interval]:
    for e in events:
        if e.get("name") == name and e.get("cat") == "user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
    return None


def device_ops(events, lo: float, hi: float) -> List[Tuple[float, float,
                                                           str]]:
    """(start, end, name) of every device operation inside [lo, hi]."""
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            s = float(e["ts"])
            t = s + float(e.get("dur", 0))
            if t > lo and s < hi:
                out.append((max(s, lo), min(t, hi), e.get("name", "")))
    out.sort()
    return out


def merge(intervals) -> List[Interval]:
    """The union of ``(start, end, ...)`` intervals as disjoint
    intervals, in order."""
    out: List[List[float]] = []
    for s, t, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def busy(intervals) -> float:
    return sum(t - s for s, t in merge(intervals))


def gaps(merged: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The idle intervals of [lo, hi] around ``merged`` busy ones."""
    out, at = [], lo
    for s, t in merged:
        if s > at:
            out.append((at, s))
        at = max(at, t)
    if hi > at:
        out.append((at, hi))
    return out


def launches(events, lo: float, hi: float) -> int:
    return sum(1 for e in events
               if e.get("cat") == "cuda_runtime"
               and e.get("name") in LAUNCHES
               and lo <= float(e["ts"]) <= hi)


def host_intervals(events, spans, offset_us: Optional[float]
                   ) -> List[Tuple[float, float, str]]:
    """The host intervals an idle gap may be named after: the
    benchmark's regions from the trace, and the program's spans
    (``perf_counter_ns``) moved by ``offset_us`` onto the trace's
    clock."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            REGIONS[e["name"]])
           for e in events if e.get("cat") == "user_annotation"
           and e.get("name") in REGIONS]
    if offset_us is not None:
        out += [(s["start_ns"] / 1e3 + offset_us,
                 s["end_ns"] / 1e3 + offset_us, s["name"])
                for s in spans if s["name"] in SPANS]
    return out


def name_gap(gap: Interval, hosts) -> str:
    mid = (gap[0] + gap[1]) / 2
    inside = [(t - s, name) for s, t, name in hosts if s <= mid <= t]
    return min(inside)[1] if inside else "other"


def top_device_ops(ops, steps: int, n: int = 10) -> List[list]:
    """The device operations that took most time, seconds a step."""
    tot: Dict[str, float] = {}
    for s, t, name in ops:
        tot[name] = tot.get(name, 0.0) + (t - s)
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6 / max(steps, 1)] for name, us in rows]


def longest_gaps(idle: List[Interval], hosts, n: int = 10) -> List[list]:
    """The longest idle gaps, each named after what the host was doing,
    in seconds."""
    rows = sorted(idle, key=lambda g: g[0] - g[1])[:n]
    return [[name_gap(g, hosts), (g[1] - g[0]) / 1e6] for g in rows]
