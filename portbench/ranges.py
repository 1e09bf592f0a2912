"""What the readers of the program's own spans and profiler ranges
share.

The program records the parts of a dispatch (``dispatch.route``,
``.stage``, ``.engine``) and of its settle (``verdicts.wait``,
``.unpack``) as spans in its ring and, while a profiler collects, as
``record_function`` ranges (``user_annotation`` events of the trace):
of the same names, except the engine's issue, whose range is the
dispatch's ``sentinel_tpu.*`` annotation. The readback of the verdicts
(``dispatch.readback``) and the engine step's slots (``engine.degrade``,
...) are ranges alone. A program without them gives nothing to read,
and the readers return None."""

from typing import List, Optional, Tuple

from portbench import trace


def mean_ms(ctx, name: str) -> Optional[float]:
    """The mean duration of the window's spans named ``name``, in ms."""
    d = [s["dur_ns"] for s in ctx.spans if s["name"] == name]
    return sum(d) / len(d) / 1e6 if d else None


def of(events, name: str, lo: float,
       hi: float) -> List[Tuple[float, float, object]]:
    """``(start, end, thread)`` of the trace's ranges named ``name``
    that overlap [lo, hi], clipped to it."""
    out = []
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == name:
            s = float(e["ts"])
            t = s + float(e.get("dur", 0))
            if t > lo and s < hi:
                out.append((max(s, lo), min(t, hi), e.get("tid")))
    return out


def overlap(a, b) -> float:
    """The length of the intersection of two unions of intervals."""
    total, j = 0.0, 0
    a, b = trace.merge(a), trace.merge(b)
    for s, t in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < t:
            total += min(t, b[k][1]) - max(s, b[k][0])
            k += 1
    return total
