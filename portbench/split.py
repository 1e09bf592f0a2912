"""The traced stretch of one run, split by the program's spans and
ranges: where a dispatch's host time goes, and which slot of the engine
step launched which device time.

    python3 -m portbench.split --workload flow_1m.fused --seed 7 \\
        --seconds 50 [--out split.json]

Runs the cell once as ``python3 -m portbench.run ... --trace 1`` does
and prints ``SPLIT`` and the split as JSON, then the run's result line:

* ``dispatch``: ms a step of the window's dispatch spans (the ring's
  ``fused.dispatch`` / ``decide.dispatch``) and of their parts
  (``dispatch.route``, ``.stage``, ``.engine``), the residue and the
  share of the dispatch the parts cover;
* ``ranges``: for each range of the traced stretch (the program's and
  the benchmark's), host ms, count, launches and device ms a step. A
  device operation belongs to the innermost range open on the thread
  that launched it, matched through the trace's ``correlation`` ids;
* ``named_device_share``: the share of the device's busy time launched
  inside the engine step's slots (``engine.*``), the staging and the
  readback;
* ``top_ops``: the device operations that took most time, ms a step,
  each split by the range that launched it;
* ``idle_ms``: the device's idle time a step, by the innermost range
  open on any thread (the shortest), and ``idle_share``.

It reads what the per-layer readers of a traced run read: the trace of
the stretch and the window's spans.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys
from typing import Dict, List, Optional, Tuple

from portbench import trace

#: the parts of a dispatch in the ring, inside its span
PARTS = ("dispatch.route", "dispatch.stage", "dispatch.engine")
DISPATCH = ("fused.dispatch", "decide.dispatch")
#: where the device's work is put down to a named part of the program
NAMED = ("engine.", "dispatch.stage", "dispatch.readback")

Range = Tuple[float, float, str]


def _ranges(events, lo: float, hi: float) -> Dict[object, List[Range]]:
    """The stretch's ``user_annotation`` ranges, by thread."""
    out: Dict[object, List[Range]] = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            s = float(e["ts"])
            t = s + float(e.get("dur", 0))
            if t > lo and s < hi and e["name"] != trace.STRETCH:
                out[e.get("tid")].append((s, t, e["name"]))
    return out


def innermost(ranges: List[Range], times: List[float]
              ) -> List[Optional[Range]]:
    """For each of ``times``, the innermost of one thread's nested
    ``ranges`` that holds it (None where none does)."""
    rs = sorted(ranges, key=lambda r: (r[0], -r[1]))
    order = sorted(range(len(times)), key=times.__getitem__)
    out: List[Optional[Range]] = [None] * len(times)
    stack: List[Range] = []
    i = 0
    for k in order:
        t = times[k]
        while i < len(rs) and rs[i][0] <= t:
            while stack and stack[-1][1] < rs[i][0]:
                stack.pop()
            stack.append(rs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


def _shortest(by_thread, times: List[float]) -> List[str]:
    """For each of ``times``, the shortest range open on any thread."""
    best: List[Optional[Range]] = [None] * len(times)
    for rs in by_thread.values():
        for k, r in enumerate(innermost(rs, times)):
            if r is not None and (best[k] is None
                                  or r[1] - r[0] < best[k][1] - best[k][0]):
                best[k] = r
    return [r[2] if r else "other" for r in best]


def dispatch_split(spans) -> Optional[dict]:
    """The ring's dispatch spans and their parts, ms a step."""
    mean = {}
    for name in (*DISPATCH, *PARTS):
        d = [s["dur_ns"] for s in spans if s["name"] == name]
        if d:
            mean[name] = sum(d) / len(d) / 1e6
    whole = next((mean[n] for n in DISPATCH if n in mean), None)
    if whole is None:
        return None
    parts = {p: mean.get(p, 0.0) for p in PARTS}
    covered = sum(parts.values())
    return {"dispatch_ms": whole, **parts, "residue": whole - covered,
            "covered_share": covered / whole if whole else None}


def split(events, lo: float, hi: float, steps: int, spans=()) -> dict:
    """The split of the stretch [lo, hi] of ``events`` over ``steps``
    traced steps, and of the window's ring ``spans``."""
    n = max(steps, 1)
    by_thread = _ranges(events, lo, hi)
    host: Dict[str, float] = collections.defaultdict(float)
    count: collections.Counter = collections.Counter()
    for rs in by_thread.values():
        for s, t, name in rs:
            host[name] += min(t, hi) - max(s, lo)
            count[name] += 1
    # each launch (or copy call) by the innermost range on its thread
    calls = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cuda_runtime" and lo <= float(e["ts"]) <= hi:
            calls[e.get("tid")].append(e)
    owner: Dict[object, str] = {}
    launches: collections.Counter = collections.Counter()
    for tid, es in calls.items():
        got = innermost(by_thread.get(tid, []), [float(e["ts"]) for e in es])
        for e, r in zip(es, got):
            name = r[2] if r else "other"
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                owner[corr] = name
            if e.get("name") in trace.LAUNCHES:
                launches[name] += 1
    ops = []
    for e in events:
        if e.get("cat") in trace.DEVICE_CATS:
            s = float(e["ts"])
            t = s + float(e.get("dur", 0))
            if t > lo and s < hi:
                corr = (e.get("args") or {}).get("correlation")
                ops.append((max(s, lo), min(t, hi), e.get("name", ""),
                            owner.get(corr, "other")))
    total = trace.busy(ops)
    device = collections.defaultdict(list)
    by_op = collections.defaultdict(lambda: collections.defaultdict(float))
    for s, t, name, r in ops:
        device[r].append((s, t))
        by_op[name[:110]][r] += (t - s) / 1e3 / n
    names = sorted(set(host) | set(launches) | set(device))
    table = {r: {"host_ms": host.get(r, 0.0) / 1e3 / n,
                 "count": count.get(r, 0) / n,
                 "launches": launches.get(r, 0) / n,
                 "device_ms": trace.busy(device.get(r, [])) / 1e3 / n}
             for r in names}
    named = [(s, t) for s, t, _, r in ops if r.startswith(NAMED)]
    top = sorted(by_op.items(), key=lambda kv: -sum(kv[1].values()))[:14]
    # the idle time, cut at every range's bounds, by the range it lies in
    idle = trace.gaps(trace.merge(ops), lo, hi)
    bounds = sorted({b for rs in by_thread.values() for s, t, _ in rs
                     for b in (s, t)})
    pieces = []
    for s, t in idle:
        i, j = bisect.bisect_right(bounds, s), bisect.bisect_left(bounds, t)
        pts = [s, *bounds[i:j], t]
        pieces += [(a, b) for a, b in zip(pts, pts[1:]) if b > a]
    idle_by: Dict[str, float] = collections.defaultdict(float)
    for (a, b), name in zip(pieces, _shortest(
            by_thread, [(a + b) / 2 for a, b in pieces])):
        idle_by[name] += (b - a) / 1e3 / n
    return {
        "steps": steps,
        "dispatch": dispatch_split(spans),
        "ranges": table,
        "device_ms": total / 1e3 / n,
        "named_device_share": trace.busy(named) / total if total else None,
        "top_ops": [[k, sum(v.values()),
                     dict(sorted(v.items(), key=lambda kv: -kv[1]))]
                    for k, v in top],
        "idle_ms": dict(sorted(idle_by.items(), key=lambda kv: -kv[1])),
        "idle_share": 1 - total / (hi - lo) if hi > lo else None,
    }


def main(argv=None) -> int:
    from portbench import run as pbrun
    t_proc = pbrun.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    pbrun.set_paths()
    pbrun.set_threads()
    import torch
    torch.set_num_threads(pbrun.HOST_THREADS)
    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench.split: needs a CUDA device", file=sys.stderr)
        return 2
    # the harness reads the trace once and drops it: keep what it read
    seen = {}
    read_trace = harness.read_trace

    def keep(run, tmp):
        seen["run"], seen["got"] = run, read_trace(run, tmp)
        return seen["got"]

    harness.read_trace = keep
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds, True,
                               "cuda", t_proc=t_proc)
    finally:
        harness.read_trace = read_trace
    run = seen["run"]
    events, lo, hi, _offset = seen["got"]
    got = split(events, lo, hi, run.traced["last"] - run.traced["first"],
                harness.window_spans(run.spans, run))
    print("SPLIT " + json.dumps(got))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"result": out, "split": got}, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
