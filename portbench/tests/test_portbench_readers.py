"""The per-layer metric readers on a small synthetic trace and span
list, and the roofline's arithmetic."""

import json
import types

import pytest
import torch

from portbench import roofline, trace
from portbench.metrics import (
    device_idle_share, device_ms_per_step, dispatch_ms, enqueue_ms,
    launches_per_step,
)


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _ev(trace.STRETCH, "user_annotation", 0.0, 1000.0),
    _ev(trace.CLOCK_MARK, "user_annotation", 0.0, 1.0),
    _ev("portbench.generator", "user_annotation", 0.0, 100.0),
    _ev("portbench.submit", "user_annotation", 100.0, 400.0),
    _ev("portbench.result_wait", "user_annotation", 500.0, 300.0),
    # two streams overlapping: union 100..300 and 600..700 = 300 us
    _ev("kA", "kernel", 100.0, 150.0),
    _ev("kB", "kernel", 200.0, 100.0),
    _ev("Memcpy HtoD", "gpu_memcpy", 600.0, 100.0),
    _ev("cudaLaunchKernel", "cuda_runtime", 110.0, 5.0),
    _ev("cudaLaunchKernel", "cuda_runtime", 120.0, 5.0),
    _ev("cudaGraphLaunch", "cuda_runtime", 130.0, 5.0),
    _ev("cudaMemcpyAsync", "cuda_runtime", 140.0, 5.0),
    _ev("cudaLaunchKernel", "cuda_runtime", 5000.0, 5.0),   # outside
]


def _ctx(events=EVENTS, spans=(), steps=2):
    run = types.SimpleNamespace(traced={"first": 0, "last": steps})
    ctx = types.SimpleNamespace(events=list(events), lo=0.0, hi=1000.0,
                                spans=list(spans), run=run)
    ctx.traced_steps = range(steps)
    return ctx


def test_device_time_is_the_union_not_the_sum():
    ops = trace.device_ops(EVENTS, 0.0, 1000.0)
    assert sum(t - s for s, t, _ in ops) == pytest.approx(350.0)
    assert trace.busy(ops) == pytest.approx(300.0)
    ctx = _ctx()
    assert device_ms_per_step.read(ctx) == pytest.approx(0.300 / 2)
    assert device_idle_share.read(ctx) == pytest.approx(70.0)


def test_launches_count_kernel_and_graph_launches_in_the_stretch():
    assert launches_per_step.read(_ctx()) == pytest.approx(3 / 2)


def test_idle_gaps_are_named_after_the_innermost_host_interval():
    merged = trace.merge(trace.device_ops(EVENTS, 0.0, 1000.0))
    idle = trace.gaps(merged, 0.0, 1000.0)
    assert idle == [(0.0, 100.0), (300.0, 600.0), (700.0, 1000.0)]
    spans = [{"name": "fused.dispatch", "start_ns": 200_000,
              "end_ns": 480_000}]
    hosts = trace.host_intervals(EVENTS, spans, offset_us=0.0)
    named = trace.longest_gaps(idle, hosts)
    # 300..600: mid 450 lies in the submit region and, inside it, the
    # dispatch span; 700..1000: mid 850 in no region
    assert named[0] == ["fused.dispatch", pytest.approx(300e-6)]
    assert ["other", pytest.approx(300e-6)] in named
    assert named[-1] == ["generator", pytest.approx(100e-6)]
    top = trace.top_device_ops(trace.device_ops(EVENTS, 0, 1000), 2)
    assert top[0] == ["kA", pytest.approx(150e-6 / 2)]


def test_a_trace_file_round_trips(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS + [{"ph": "i"}]}))
    assert trace.load_events(str(p)) == EVENTS
    assert trace.span_of(EVENTS, trace.STRETCH) == (0.0, 1000.0)


def test_enqueue_self_time_leaves_out_nested_spans():
    spans = [
        {"name": "pipeline.enqueue", "thread": 1, "start_ns": 0,
         "end_ns": 10_000_000, "dur_ns": 10_000_000},
        {"name": "fused.dispatch", "thread": 1, "start_ns": 1_000_000,
         "end_ns": 7_000_000, "dur_ns": 6_000_000},
        {"name": "pipeline.settle", "thread": 1, "start_ns": 6_000_000,
         "end_ns": 8_000_000, "dur_ns": 2_000_000},
        # another thread's span inside the interval is not nested
        {"name": "fused.dispatch", "thread": 2, "start_ns": 2_000_000,
         "end_ns": 9_000_000, "dur_ns": 7_000_000},
    ]
    ctx = _ctx(spans=spans)
    # 10 ms less the union 1..8 ms on its own thread
    assert enqueue_ms.read(ctx) == pytest.approx(3.0)
    assert dispatch_ms.read(ctx) == pytest.approx(6.5)


def test_readers_find_nothing_and_say_so():
    ctx = _ctx(events=[], steps=0)
    ctx.events = None
    for reader in (device_ms_per_step, device_idle_share, launches_per_step,
                   enqueue_ms, dispatch_ms):
        assert reader.read(ctx) is None


def test_roofline_arithmetic():
    # 4 lanes of 12 bytes; cells in two 32-byte sectors (0..31, 32..63)
    addr = torch.tensor([0, 4, 28, 32])
    got = roofline.bound_s([(4, 12, addr)])
    assert got == pytest.approx((48 + 2 * 32 * 2) / roofline.HBM_BYTES_PER_S)
    # one fused step: 2 events (pass, block) on rows 1 and 2, one exit
    rows = torch.tensor([1, 2])
    allow = torch.tensor([True, False])
    ex = torch.tensor([1])
    ups = roofline.fused_step_updates(
        rows, allow, ex, torch.tensor([3]), torch.tensor([True]),
        torch.tensor([0]), [(0, 2)])
    lanes = [(n, b) for n, b, _a in ups]
    # decide, exit counters, exit RT, histogram, breaker total, bad
    assert lanes == [(2, 12), (1, 12), (1, 8), (1, 12), (1, 8), (1, 8)]
    # with nodes and gauges: event 1 has a node (row 5), the exit none
    ups = roofline.fused_step_updates(
        rows, allow, ex, torch.tensor([3]), torch.tensor([True]),
        torch.tensor([0]), [(0, 2)],
        nodes=(torch.tensor([1]), torch.tensor([5])),
        exit_nodes=(torch.tensor([], dtype=torch.long),
                    torch.tensor([], dtype=torch.long)),
        node_window=(1, 2), gauges=True)
    lanes = [(n, b) for n, b, _a in ups]
    # ... then the gauges (one admission, one exit), the node's record,
    # the node's gauge (its event was blocked)
    assert lanes[6:] == [(1, 8), (1, 8), (1, 12), (0, 8), (0, 8)]
    assert ups[8][2].tolist() == [((5 * 2 + 1) * 8 + 1) * 4]
    # PASS of row 1 and BLOCK of row 2 at bucket 0: rows' own sectors
    assert ups[0][2].tolist() == [(1 * 2 * 8 + 0) * 4,
                                  (2 * 2 * 8 + 1) * 4]
    # RT 3 ms lands in histogram bucket 2 ((2, 4] ms)
    assert ups[3][2].tolist() == [(1 * 32 + 2) * 4]


class _Ev:
    """A stand-in for a timing event that completed at device second
    ``t``."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_ready_clock_places_device_events_on_the_host_clock():
    from portbench import window
    rc = window.ReadyClock("cpu")
    rc.on = True
    # the device's clock runs 0.1% slow against the host's
    rc.anchors = [(_Ev(100.0), 5.0), (_Ev(110.0), 15.01)]
    rc.events = [_Ev(101.0), _Ev(105.0)]
    steps = [window.Step(at_ms=0), window.Step(at_ms=0)]
    rc.stamp(steps)
    assert steps[0].t_ready == pytest.approx(6.001)
    assert steps[1].t_ready == pytest.approx(10.005)


def test_a_step_keeps_packed_admissions_and_compact_verdicts():
    import numpy as np
    from portbench import window
    rng = np.random.default_rng(3)
    n = 1001
    v = types.SimpleNamespace(
        allow=rng.random(n) < 0.7,
        reason=rng.integers(0, 5, n).astype(np.int8),
        wait_ms=np.where(rng.random(n) < 0.05, 7, 0).astype(np.int32))
    st = window.Step(at_ms=0, n=n)
    st.allow_bits = np.packbits(v.allow)
    st.keep(v)
    np.testing.assert_array_equal(st.allow(), v.allow)
    got = st.kept()
    for f in ("allow", "reason", "wait_ms"):
        np.testing.assert_array_equal(getattr(got, f), getattr(v, f))
