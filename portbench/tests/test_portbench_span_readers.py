"""The readers of the program's own spans and profiler ranges
(``route_ms``, ``stage_ms``, ``engine_issue_ms``, ``verdict_wait_ms``,
``engine_idle_ms``, ``degrade_device_ms``) and ``portbench.split`` on
a small synthetic span list and trace, in the style of
``test_portbench_readers.py``."""

import pytest

from portbench import ranges, split, trace
from portbench.metrics import (
    degrade_device_ms, engine_idle_ms, engine_issue_ms, route_ms, stage_ms,
    verdict_wait_ms,
)
from portbench.tests.test_portbench_readers import _ctx, _ev

READERS = (route_ms, stage_ms, engine_issue_ms, verdict_wait_ms,
           engine_idle_ms, degrade_device_ms)


def _on(event, tid=1, corr=None):
    """``event`` on thread ``tid``, with a ``correlation`` id."""
    event["tid"] = tid
    if corr is not None:
        event["args"] = {"correlation": corr}
    return event


EVENTS = [
    _ev(trace.STRETCH, "user_annotation", 0.0, 1000.0),
    # the engine's issue: the dispatches' annotations
    _on(_ev("sentinel_tpu.fused", "user_annotation", 100.0, 200.0)),
    _on(_ev("sentinel_tpu.decide", "user_annotation", 600.0, 100.0)),
    _on(_ev("engine.degrade", "user_annotation", 140.0, 20.0)),
    _on(_ev("engine.degrade", "user_annotation", 640.0, 20.0)),
    # the device's side of a range is not a range
    _on(_ev("sentinel_tpu.fused", "gpu_user_annotation", 0.0, 1000.0)),
    # launches: two inside the degrade ranges, one outside them, and one
    # inside their time on another thread
    _on(_ev("cudaLaunchKernel", "cuda_runtime", 145.0, 5.0), corr=1),
    _on(_ev("cudaLaunchKernel", "cuda_runtime", 245.0, 5.0), corr=2),
    _on(_ev("cudaLaunchKernel", "cuda_runtime", 645.0, 5.0), corr=3),
    _on(_ev("cudaLaunchKernel", "cuda_runtime", 150.0, 5.0), tid=2, corr=4),
    # device busy 150..200, 250..400, 650..680, 800..900
    _on(_ev("degrade_a", "kernel", 150.0, 50.0), tid=7, corr=1),
    _on(_ev("flow_b", "kernel", 250.0, 150.0), tid=7, corr=2),
    _on(_ev("degrade_c", "kernel", 650.0, 30.0), tid=7, corr=3),
    _on(_ev("other_d", "kernel", 800.0, 100.0), tid=7, corr=4),
]


def _span(name, start_ms, dur_ms, thread=1):
    return {"name": name, "thread": thread, "trace": 1,
            "start_ns": int(start_ms * 1e6),
            "end_ns": int((start_ms + dur_ms) * 1e6),
            "dur_ns": int(dur_ms * 1e6)}


SPANS = [
    _span("fused.dispatch", 0, 40), _span("fused.dispatch", 50, 44),
    _span("dispatch.route", 0, 1), _span("dispatch.route", 50, 3),
    _span("dispatch.stage", 1, 10), _span("dispatch.stage", 53, 12),
    _span("dispatch.engine", 11, 25), _span("dispatch.engine", 65, 27),
    _span("verdicts.wait", 40, 0.5), _span("verdicts.wait", 94, 1.5),
]


@pytest.mark.parametrize("reader, want", [
    (route_ms, 2.0), (stage_ms, 11.0), (engine_issue_ms, 26.0),
    (verdict_wait_ms, 1.0)])
def test_a_part_of_the_dispatch_is_the_mean_of_its_spans(reader, want):
    assert reader.read(_ctx(spans=SPANS)) == pytest.approx(want)


def test_engine_idle_is_the_idle_time_inside_the_engine_ranges():
    # idle 0..150, 200..250, 400..650, 680..800, 900..1000; inside
    # 100..300: 100..150 and 200..250; inside 600..700: 600..650 and
    # 680..700 — 170 us over 2 steps; the idle time outside the ranges
    # (0..100, 300..600, ...) is not counted
    got = engine_idle_ms.read(_ctx(events=EVENTS))
    assert got == pytest.approx(0.170 / 2)


def test_degrade_device_time_follows_the_launches_correlation():
    # kernels 1 (150..200) and 3 (650..680); kernel 2 was launched
    # outside the ranges, kernel 4 on another thread
    got = degrade_device_ms.read(_ctx(events=EVENTS))
    assert got == pytest.approx(0.080 / 2)
    # ranges that launched nothing: the slot's device time is 0
    quiet = [e for e in EVENTS if e.get("args", {}).get("correlation")
             not in (1, 3)]
    assert degrade_device_ms.read(_ctx(events=quiet)) == 0.0


def test_the_overlap_of_two_unions():
    a = [(0.0, 10.0), (5.0, 20.0), (30.0, 40.0)]
    b = [(15.0, 35.0, "t"), (38.0, 50.0, "t")]
    assert ranges.overlap(a, b) == pytest.approx(5.0 + 5.0 + 2.0)
    assert ranges.overlap(a, []) == 0.0
    assert ranges.of(EVENTS, "engine.degrade", 150.0, 650.0) == [
        (150.0, 160.0, 1), (640.0, 650.0, 1)]


def test_span_readers_find_nothing_and_say_so():
    # a run without a trace, and a program that records none of these
    # spans or ranges (the benchmark's own regions and kernels alone)
    bare = [e for e in EVENTS if e["cat"] != "user_annotation"
            or e["name"] == trace.STRETCH]
    for events in (None, bare):
        ctx = _ctx(events=events or [],
                   spans=[s for s in SPANS if s["name"] == "fused.dispatch"])
        ctx.events = events
        for reader in READERS:
            assert reader.read(ctx) is None, reader.__name__
    # a trace with the ranges but no device operation (a CPU run): the
    # device readers give no number
    host = [e for e in EVENTS if e["cat"] != "kernel"]
    for reader in (engine_idle_ms, degrade_device_ms):
        assert reader.read(_ctx(events=host)) is None


def _launch(name, ts, corr, tid=1):
    return _on(_ev(name, "cuda_runtime", ts, 2.0), tid=tid, corr=corr)


def _op(cat, ts, dur, corr):
    return _on(_ev(f"{cat}_{corr}", cat, ts, dur), tid=7, corr=corr)


SPLIT_EVENTS = [
    _ev(trace.STRETCH, "user_annotation", 0.0, 1000.0),
    *[_on(_ev(name, "user_annotation", s, t - s)) for name, s, t in (
        ("portbench.submit", 90.0, 410.0), ("fused.dispatch", 100.0, 400.0),
        ("dispatch.route", 100.0, 150.0), ("dispatch.stage", 150.0, 200.0),
        ("sentinel_tpu.fused", 200.0, 380.0),
        ("engine.flow", 210.0, 250.0), ("engine.degrade", 260.0, 300.0),
        ("dispatch.readback", 400.0, 405.0))],
    _launch("cudaMemcpyAsync", 160.0, 10),
    _launch("cudaLaunchKernel", 220.0, 11),
    _launch("cudaLaunchKernel", 270.0, 12),
    _launch("cudaLaunchKernel", 350.0, 13),
    _launch("cudaMemcpyAsync", 402.0, 15),
    # inside engine.flow's time, on another thread
    _launch("cudaLaunchKernel", 230.0, 14, tid=2),
    _op("gpu_memcpy", 170.0, 10.0, 10), _op("kernel", 240.0, 60.0, 11),
    _op("kernel", 300.0, 20.0, 12), _op("kernel", 360.0, 40.0, 13),
    _op("gpu_memcpy", 405.0, 10.0, 15), _op("kernel", 500.0, 100.0, 14),
]


def test_split_puts_device_and_idle_time_down_to_ranges():
    spans = [_span("fused.dispatch", 0, 40), _span("dispatch.route", 0, 5),
             _span("dispatch.stage", 5, 10),
             _span("dispatch.engine", 15, 20)]
    got = split.split(SPLIT_EVENTS, 0.0, 1000.0, 1, spans)
    assert got["dispatch"] == pytest.approx(
        {"dispatch_ms": 40.0, "dispatch.route": 5.0, "dispatch.stage": 10.0,
         "dispatch.engine": 20.0, "residue": 5.0, "covered_share": 0.875})
    table = got["ranges"]
    for name, launches, device_us in (
            ("engine.flow", 1, 60.0), ("engine.degrade", 1, 20.0),
            ("sentinel_tpu.fused", 1, 40.0), ("dispatch.stage", 0, 10.0),
            ("dispatch.readback", 0, 10.0), ("other", 1, 100.0)):
        assert table[name]["launches"] == launches, name
        assert table[name]["device_ms"] == pytest.approx(device_us / 1e3)
    assert table["fused.dispatch"]["host_ms"] == pytest.approx(0.3)
    assert table["fused.dispatch"]["device_ms"] == 0.0
    assert got["device_ms"] == pytest.approx(0.240)
    # stage, flow, degrade and readback launched 100 of the 240 us
    assert got["named_device_share"] == pytest.approx(100 / 240)
    assert got["idle_ms"] == pytest.approx(
        {"other": 0.575, "portbench.submit": 0.010, "dispatch.route": 0.050,
         "dispatch.stage": 0.040, "sentinel_tpu.fused": 0.050,
         "engine.flow": 0.030, "dispatch.readback": 0.005})
    assert got["idle_share"] == pytest.approx(0.760)
    assert got["top_ops"][0] == ["kernel_14", pytest.approx(0.1),
                                 {"other": pytest.approx(0.1)}]


def test_split_without_the_programs_spans():
    bare = [e for e in SPLIT_EVENTS if e["cat"] != "user_annotation"
            or e["name"] == trace.STRETCH]
    got = split.split(bare, 0.0, 1000.0, 2)
    assert got["dispatch"] is None
    assert got["named_device_share"] == 0.0
    assert set(got["idle_ms"]) == {"other"}
    assert got["ranges"]["other"]["launches"] == 4 / 2
