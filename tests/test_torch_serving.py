"""Port parity: the dispatch pipeline and the cadence scheduler
(``sentinel_tpu_torch.serving``) against ``sentinel_tpu.serving``.

Twins of ``tests/test_dispatch_pipeline.py``: every scenario runs on both
packages under twin ManualClocks (the shared harness of
``test_torch_obs.py``: observations, counters, spans, flight records and
engine state compared exactly), and
inside each package the pipelined run is held against a sequential twin
runtime of its own. Covered: pipelined == sequential at depths 1, 2 and 4
(interacting QPS depletion, prioritized bookings), origin batches, the
fused decide+exit program == decide-then-exit, in-order settle under
out-of-order ``result()``, the pipeline counters and stalls, the depth
knob, leaked handles counted once, host staging reuse and in-flight slots
(a pipeline deeper than the staging ring grows it), and the
``CadenceScheduler``.

``test_donation_escape_hatch`` has no counterpart: the port donates no
buffers (its engine updates its state in place), so ``SENTINEL_DONATE``
has nothing to switch.
"""

import gc
import threading
import time

import numpy as np
import pytest

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu_torch import convert
from sentinel_tpu_torch import runtime as trt
from sentinel_tpu_torch import serving as tserving
from sentinel_tpu_torch.obs import counters as ck

from test_torch_obs import T0, make, twin

RULES = [dict(resource="r0", count=30.0), dict(resource="r1", count=5.0),
         dict(resource="r2", count=12.0)]


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SENTINEL_TIERING_DISABLE", "1")


def _rules(pkg, specs):
    return [pkg.FlowRule(**r) for r in specs]


def _v(v):
    return (np.asarray(v.allow).tolist(), np.asarray(v.reason).tolist(),
            np.asarray(v.wait_ms).tolist())


def _same_state(a, b):
    assert convert.leaf_diff(convert.to_numpy(a._state),
                             convert.to_numpy(b._state)) == []


def _traffic(rng, step, n=24):
    names = [f"r{int(i)}" for i in rng.integers(0, 4, n)]
    prio = (rng.random(n) < 0.3) if step % 2 else np.zeros(n, np.bool_)
    return names, prio


# ---------------------------------------------------------------------------
# pipelined == sequential
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipelined_matches_sequential(tmp_path, depth):
    def scenario(pkg, s, clk):
        seq = make(pkg, pkg.ManualClock(start_ms=T0))
        for x in (s, seq):
            x.load_flow_rules(_rules(pkg, RULES))
        rng = np.random.default_rng(7)
        traffic = [_traffic(rng, step) for step in range(8)]
        seq_out = []
        for names, prio in traffic:
            seq_out.append(_v(seq.entry_batch_nowait(
                names, prioritized=prio).result()))
            seq.clock.advance_ms(120)
        pipe = pkg.DispatchPipeline(s, depth=depth)
        tickets = []
        for names, prio in traffic:
            tickets.append(pipe.submit(names, prioritized=prio))
            clk.advance_ms(120)
        pipe.flush()
        out = [_v(t.result()) for t in tickets]
        assert out == seq_out
        _same_state(seq, s)
        totals = [s.node_totals(r) for r in ("r0", "r1", "r2")]
        assert totals == [seq.node_totals(r) for r in ("r0", "r1", "r2")]
        seq.close()
        return out, totals

    twin(scenario, tmp_path)


def test_pipelined_origin_batches_match(tmp_path):
    def scenario(pkg, s, clk):
        seq = make(pkg, pkg.ManualClock(start_ms=T0))
        rules = _rules(pkg, [dict(resource="r1", count=8.0,
                                  limit_app="app-a")])
        s.load_flow_rules(rules)
        seq.load_flow_rules(rules)
        rng = np.random.default_rng(8)
        traffic = []
        for _ in range(6):
            names = [f"r{int(i)}" for i in rng.integers(0, 3, 16)]
            origins = [("app-a" if rng.random() < 0.5 else "app-b")
                       for _ in names]
            traffic.append((names, origins))
        seq_out = [_v(seq.entry_batch_nowait(n, origins=o).result())
                   for n, o in traffic]
        with pkg.DispatchPipeline(s, depth=2) as pipe:
            tickets = [pipe.submit(n, origins=o) for n, o in traffic]
            out = [_v(t.result()) for t in tickets]
        assert out == seq_out
        _same_state(seq, s)
        seq.close()
        return out

    twin(scenario, tmp_path)


# ---------------------------------------------------------------------------
# fused decide+exit == decide-then-exit, and through the pipeline
# ---------------------------------------------------------------------------

def _fused_cols(sph, rng, n, with_origins):
    pad_a = sph.spec.alt_rows
    rows = np.asarray([sph.resources.get_or_create(f"r{int(i)}")
                       for i in rng.integers(0, 3, n)], np.int32)
    if with_origins:
        oid = sph.origins.get_or_create("app-a")
        origin_ids = np.full(n, oid, np.int32)
        origin_rows = np.asarray([sph._alt_row(int(r), 0, oid)
                                  for r in rows], np.int32)
    else:
        origin_ids = np.zeros(n, np.int32)
        origin_rows = np.full(n, pad_a, np.int32)
    return rows, origin_ids, origin_rows


@pytest.mark.parametrize("with_origins", [False, True])
def test_fused_matches_decide_then_exit(tmp_path, with_origins):
    """The fused program, a pipeline's ``submit_fused`` at depth 2, and
    the two-call form (decide, then the previous step's exits) on three
    runtimes of each package: verdicts and state equal."""
    def scenario(pkg, s, clk):
        two = make(pkg, pkg.ManualClock(start_ms=T0))
        fus = make(pkg, pkg.ManualClock(start_ms=T0))
        for x in (s, two, fus):
            x.load_flow_rules(_rules(pkg, RULES))
        pipe = pkg.DispatchPipeline(s, depth=2)
        rng = np.random.default_rng(9)
        n = 16
        pad_a = two.spec.alt_rows
        ones = np.ones(n, np.int32)
        is_in = np.ones(n, np.bool_)
        no_prio = np.zeros(n, np.bool_)
        ctx0 = np.zeros(n, np.int32)
        crow = np.full(n, pad_a, np.int32)
        prev, out, tickets = None, [], []
        for step in range(6):
            st = rng.bit_generator.state
            r1, oid1, orow1 = _fused_cols(two, rng, n, with_origins)
            for x in (fus, s):
                rng.bit_generator.state = st
                assert np.array_equal(_fused_cols(x, rng, n,
                                                  with_origins)[0], r1)
            rt = rng.integers(1, 50, n).astype(np.int32)
            err = rng.random(n) < 0.3
            h = two.decide_raw_nowait(r1, oid1, orow1, ctx0, crow, ones,
                                      is_in, no_prio)
            if prev is not None:
                two.exit_batch(rows=prev[0], origin_rows=prev[1],
                               chain_rows=crow, acquire=ones, rt_ms=prev[2],
                               error=prev[3], is_in=is_in)
                fx = dict(exit_rows=prev[0], exit_origin_rows=prev[1],
                          exit_chain_rows=crow, exit_acquire=ones,
                          exit_rt_ms=prev[2], exit_error=prev[3],
                          exit_is_in=is_in)
                h2 = fus.decide_and_exit_raw_nowait(
                    r1, oid1, orow1, ctx0, crow, ones, is_in, no_prio, **fx)
                tickets.append(pipe.submit_fused(
                    r1, oid1, orow1, ctx0, crow, ones, is_in, no_prio,
                    **fx))
            else:
                h2 = fus.decide_raw_nowait(r1, oid1, orow1, ctx0, crow,
                                           ones, is_in, no_prio)
                tickets.append(pipe.submit_raw(r1, oid1, orow1, ctx0, crow,
                                               ones, is_in, no_prio))
            v1, v2 = _v(h.result()), _v(h2.result())
            assert v1 == v2, f"step {step}"
            out.append(v1)
            prev = (r1, orow1, rt, err)
            for c in (clk, two.clock, fus.clock):
                c.advance_ms(130)
        pipe.flush()
        assert [_v(t.result()) for t in tickets] == out
        for x in (two, fus, s):
            x.exit_batch(rows=prev[0], origin_rows=prev[1], chain_rows=crow,
                         acquire=ones, rt_ms=prev[2], error=prev[3],
                         is_in=is_in)
        _same_state(two, fus)
        _same_state(two, s)
        two.close()
        fus.close()
        return out

    twin(scenario, tmp_path)


def test_fused_counts_route_counter(tmp_path):
    def scenario(pkg, s, clk):
        rows = np.asarray([s.resources.get_or_create("x")], np.int32)
        pad_a = s.spec.alt_rows
        one = np.ones(1, np.int32)
        pipe = pkg.DispatchPipeline(s, depth=1)
        t = pipe.submit_fused(
            rows, np.zeros(1, np.int32), np.full(1, pad_a, np.int32),
            np.zeros(1, np.int32), np.full(1, pad_a, np.int32), one,
            np.ones(1, np.bool_), np.zeros(1, np.bool_), exit_rows=rows)
        return bool(t.result().allow[0])

    sph, allowed, _ = twin(scenario, tmp_path)
    assert allowed
    assert sph.obs.counters.get(ck.ROUTE_FUSED) == 1


# ---------------------------------------------------------------------------
# in-order settle + pipeline counters
# ---------------------------------------------------------------------------

def test_in_order_settle_under_out_of_order_results(tmp_path):
    def scenario(pkg, s, clk):
        pipe = pkg.DispatchPipeline(s, depth=4)
        tickets = [pipe.submit(["a", "b"]) for _ in range(3)]
        order = []
        with pipe._lock:
            for seq, h, _tr in pipe._inflight:
                fn = h._cell.fn

                def spied(f=fn, q=seq):
                    order.append(q)
                    return f()
                h._cell.fn = spied
        v_last = tickets[2].result()
        assert order == [0, 1, 2]
        assert np.array_equal(tickets[0].result().allow, v_last.allow)
        assert tickets[2].result() is v_last         # memoized
        tickets[1].result()
        with pytest.raises(KeyError):
            pipe._settle_through(1)                  # already consumed
        return order, [t.seq for t in tickets]

    twin(scenario, tmp_path)


def test_pipeline_counters_and_stall(tmp_path):
    def scenario(pkg, s, clk):
        pipe = pkg.DispatchPipeline(s, depth=2)
        for _ in range(5):
            pipe.submit(["a"])
        pipe.flush()
        return pipe.in_flight

    sph, in_flight, _ = twin(scenario, tmp_path)
    c = sph.obs.counters
    assert in_flight == 0
    assert c.get(ck.PIPE_DEPTH) == 9            # 1 + 2 + 2 + 2 + 2
    assert c.get(ck.PIPE_STALL) == 3
    assert c.get(ck.PIPE_MESHED) == 0


def test_on_settle_fires_once_per_batch_in_order(tmp_path):
    def scenario(pkg, s, clk):
        seen = []
        pipe = pkg.DispatchPipeline(
            s, depth=2, on_settle=lambda q, v: seen.append((q, len(v.allow))))
        tickets = [pipe.submit(["a"] * (i + 1)) for i in range(5)]
        tickets[3].result()
        pipe.flush()
        return seen

    _, seen, _ = twin(scenario, tmp_path)
    assert seen == [(i, i + 1) for i in range(5)]


def test_pipeline_depth_env_knob(monkeypatch):
    assert trt.PIPELINE_DEPTH_ENV == stpu.serving.PIPELINE_DEPTH_ENV
    assert tserving.PIPELINE_DEPTH_ENV == trt.PIPELINE_DEPTH_ENV
    for raw in ("5", "not-a-number", "0", "999"):
        monkeypatch.setenv(trt.PIPELINE_DEPTH_ENV, raw)
        assert stt.pipeline_depth() == stpu.pipeline_depth(), raw
    monkeypatch.setenv(trt.PIPELINE_DEPTH_ENV, "5")
    sph = make(stt, stt.ManualClock(start_ms=T0))
    assert stt.DispatchPipeline(sph).depth == 5
    assert sph._staging_depth == 12              # covers the pipeline
    assert stt.DispatchPipeline(sph, depth=0).depth == 1
    sph.close()


# ---------------------------------------------------------------------------
# leaked-handle guard
# ---------------------------------------------------------------------------

def test_leaked_handle_settled_and_counted(tmp_path):
    def scenario(pkg, s, clk):
        s.load_flow_rules([pkg.FlowRule(resource="q", count=1.0)])
        h = s.entry_batch_nowait(["q", "q", "q"])
        del h
        gc.collect()
        first = s.obs.counters.get(ck.PIPE_LEAKED)
        h2 = s.entry_batch_nowait(["q"])
        h2.result()
        del h2
        gc.collect()
        return first, s.obs.counters.get(ck.PIPE_LEAKED)

    _, got, lines = twin(scenario, tmp_path)
    assert got == (1, 1)
    assert lines                       # the leaked batch's blocks logged


def test_leaked_nested_handle_counts_once(tmp_path):
    def scenario(pkg, s, clk):
        h = s.entry_batch_nowait(["a", "b"])
        del h
        gc.collect()
        return s.obs.counters.get(ck.PIPE_LEAKED)

    _, n, _ = twin(scenario, tmp_path)
    assert n == 1


def test_pipelined_tickets_never_leak(tmp_path):
    """A pipeline owns its handles: tickets dropped unread leave nothing
    for the GC guard, once flushed."""
    def scenario(pkg, s, clk):
        pipe = pkg.DispatchPipeline(s, depth=3)
        for _ in range(4):
            pipe.submit(["a", "b"])
        pipe.flush()
        gc.collect()
        return s.obs.counters.get(ck.PIPE_LEAKED)

    _, n, _ = twin(scenario, tmp_path)
    assert n == 0


# ---------------------------------------------------------------------------
# host staging
# ---------------------------------------------------------------------------

def test_staging_reuse_parity(tmp_path):
    """Serving-sized batches reuse staging slots; verdicts and state must
    match a staging-off twin of the same package."""
    def scenario(pkg, s, clk):
        off = make(pkg, pkg.ManualClock(start_ms=T0))
        off._staging_on = False
        assert s._staging_on
        for x in (s, off):
            x.load_flow_rules([pkg.FlowRule(resource="r0", count=900.0)])
        rng = np.random.default_rng(11)
        b = max(600, trt.Sentinel._STAGING_MIN_B + 88)
        out = []
        for step in range(4):
            names = [f"r{int(i)}" for i in rng.integers(0, 3, b)]
            v1 = _v(s.entry_batch_nowait(names).result())
            assert v1 == _v(off.entry_batch_nowait(names).result())
            out.append(v1)
            clk.advance_ms(90)
            off.clock.advance_ms(90)
        _same_state(s, off)
        assert s._staging and not off._staging
        off.close()
        return out

    twin(scenario, tmp_path)


def test_staging_ring_settlement_freelist():
    ring = trt._StagingRing(1024, 4, pinned=False)
    held = [ring.acquire() for _ in range(4)]
    assert len({id(s["rows"]) for s in held}) == 4
    extra = ring.acquire()     # pool exhausted: fresh slot, never reuse
    assert ring.grown == 1
    assert id(extra["rows"]) not in {id(s["rows"]) for s in held}
    ring.release(held[0])
    assert id(ring.acquire()["rows"]) == id(held[0]["rows"])


def test_staging_inflight_slots_never_rewritten(tmp_path, monkeypatch):
    """More unsettled dispatches in flight than the ring has slots: the
    ring grows instead of handing an in-flight slot out again, and every
    slot is recycled after settle; verdicts equal a staging-off twin."""
    monkeypatch.setattr(trt.Sentinel, "_STAGING_MIN_B", 8)
    sph = make(stt, stt.ManualClock(start_ms=T0))
    off = make(stt, stt.ManualClock(start_ms=T0))
    off._staging_on = False
    for s in (sph, off):
        s.load_flow_rules(_rules(stt, RULES))
    depth = sph._staging_depth
    rng_a, rng_b = (np.random.default_rng(1602) for _ in range(2))
    handles, expected = [], []
    for _ in range(depth + 3):   # strictly deeper than the free list
        handles.append(sph.entry_batch_nowait(
            [f"r{int(i)}" for i in rng_a.integers(0, 4, 12)]))
        expected.append(off.entry_batch_nowait(
            [f"r{int(i)}" for i in rng_b.integers(0, 4, 12)]).result())
    (ring,) = sph._staging.values()
    assert ring.grown >= 3 and not ring._free
    for h, want in zip(handles, expected):
        assert _v(h.result()) == _v(want)
    assert len(ring._free) == depth + ring.grown
    _same_state(sph, off)
    sph.close()
    off.close()


@pytest.mark.parametrize("depth", [1, 4])
def test_pipeline_deeper_than_staging_ring_grows_it(tmp_path, depth):
    """A depth-k pipeline over a ring of one slot: at depth 4 the ring
    must grow (never rewrite a slot in flight), at depth 1 it never does;
    verdicts and state equal the sequential run and the reference."""
    def scenario(pkg, s, clk):
        s._staging_depth = 1
        seq = make(pkg, pkg.ManualClock(start_ms=T0))
        for x in (s, seq):
            x.load_flow_rules(_rules(pkg, RULES))
        rng = np.random.default_rng(31)
        traffic = [[f"r{int(i)}" for i in rng.integers(0, 5, 700)]
                   for _ in range(6)]
        want = []
        for names in traffic:
            want.append(_v(seq.entry_batch_nowait(names).result()))
            seq.clock.advance_ms(70)
        pipe = pkg.DispatchPipeline(s, depth=depth)
        tickets = []
        for names in traffic:
            tickets.append(pipe.submit(names))
            clk.advance_ms(70)
        pipe.flush()
        out = [_v(t.result()) for t in tickets]
        assert out == want
        _same_state(seq, s)
        seq.close()
        return out, sorted(len(r._free) for r in s._staging.values())

    sph, _, _ = twin(scenario, tmp_path)
    (ring,) = sph._staging.values()
    assert ring.grown == depth - 1


# ---------------------------------------------------------------------------
# CadenceScheduler
# ---------------------------------------------------------------------------

def test_cadence_poll_self_dispatches_stale_telemetry_tick(tmp_path):
    def scenario(pkg, s, clk):
        sched = pkg.CadenceScheduler(s, telemetry_interval_sec=1.0)
        out = [sched.poll()]                 # fresh: no tick, nothing queued
        clk.advance_ms(1499)
        out.append(sched.poll())             # 1.499 s < 1.5 intervals
        s.entry_batch(["a", "b", "a"])
        clk.advance_ms(1)
        out.append(sched.poll())             # stale → tick + drain
        clk.advance_ms(100)
        out.append(sched.poll())             # just ticked
        s.telemetry.tick()                   # queued by someone else
        out.append(sched.poll())             # drained by the pass
        out.append(s.telemetry.snapshot()["ticks"])
        out.append([h["resource"] for h in s.telemetry.hot_entries()])
        return out

    _, out, _ = twin(scenario, tmp_path)
    assert out == [0, 0, 1, 0, 1, 2, ["a", "b"]]


def test_cadence_skips_services_the_runtime_lacks(monkeypatch):
    """The scheduler carries the runtime's telemetry and tiering; it skips
    the overload controller until a ``ControlLoop`` attaches itself as
    ``sph.control``, and it skips a disabled service."""
    from sentinel_tpu_torch.control import ControlLoop
    monkeypatch.delenv("SENTINEL_TIERING_DISABLE")
    sph = make(stt, stt.ManualClock(start_ms=T0))
    assert sph.tiering.enabled and not hasattr(sph, "control")
    sched = stt.CadenceScheduler(sph, telemetry_interval_sec=0.5)
    assert [svc for svc, _ in sched._carried()] == [sph.telemetry,
                                                    sph.tiering]
    sph.clock.advance_ms(5000)
    assert sched.poll() == 2                 # one tick of each, drained
    ctl = ControlLoop(sph, interval_ms=100)
    assert sph.control is ctl
    sph.clock.advance_ms(5000)
    assert sched.poll() == 2                 # the idle loop applies nothing
    assert ctl.snapshot()["ticks"] == 1
    sph.telemetry.enabled = False
    sph.tiering.enabled = False
    ctl.enabled = False
    sph.clock.advance_ms(5000)
    assert sched.poll() == 0
    assert ctl.snapshot()["ticks"] == 1
    assert sph.tiering.snapshot()["ticks"] == 2
    sph.close()


def test_cadence_tiering_interval_knob(monkeypatch):
    for raw, want in (("", 200), ("250", 250), ("1", 10), ("x", 200),
                      ("999999", 60000)):
        monkeypatch.setenv(tserving.TIER_TICK_MS_ENV, raw)
        from sentinel_tpu.tiering.manager import tier_tick_ms
        assert tserving.tier_tick_ms() == tier_tick_ms() == want, raw
    sph = make(stt, stt.ManualClock(start_ms=T0))
    sched = stt.CadenceScheduler(sph, telemetry_interval_sec=2.0)
    assert (sched._tel_ms, sched._tier_ms) == (2000, 60000)
    assert sched._poll_s == 1.0
    sph.close()


def test_cadence_start_stop_idempotent_and_joined():
    sph = make(stt, stt.ManualClock(start_ms=T0))
    sched = stt.CadenceScheduler(sph, telemetry_interval_sec=0.04)
    sched.start()
    thread = sched._thread
    assert thread is not None and thread.is_alive()
    assert sph.telemetry._carry_ms == 40
    sched.start()                           # idempotent: same thread
    assert sched._thread is thread
    sph.clock.advance_ms(1000)              # stale: the daemon ticks
    deadline = time.monotonic() + 10
    while (sph.telemetry.snapshot()["ticks"] == 0
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert sph.telemetry.snapshot()["ticks"] >= 1
    sched.stop()
    assert sched._thread is None and not thread.is_alive()
    assert sph.telemetry._carry_ms is None
    sched.stop()                            # idempotent
    sched.start()                           # restartable
    assert sched._thread is not None
    sph.close()                             # registered: close stops it
    assert sched._thread is None
    assert not any(t.name == "sentinel-cadence" and t.is_alive()
                   for t in threading.enumerate())


# ---------------------------------------------------------------------------
# trace ids through the pipeline (tests/test_tracing.py)
# ---------------------------------------------------------------------------

def test_pipeline_threads_trace_through_split_route(tmp_path):
    def scenario(pkg, s, clk):
        s.load_flow_rules([pkg.FlowRule(resource="api", count=1e9),
                           pkg.FlowRule(resource="api", count=1e9,
                                        limit_app="app-a")])
        rng = np.random.default_rng(3)
        n = 8192                 # the scalar side above the split threshold
        origins = ["app-a" if x else "" for x in (rng.random(n) < 0.1)]
        pipe = pkg.DispatchPipeline(s, depth=2)
        tr = s.obs.spans.mint()
        pipe.submit(["api"] * n, origins=origins, trace_id=tr).result()
        chain = s.obs.spans.chain(tr)
        assert all(x["trace"] == tr for x in chain)
        return [x["name"] for x in chain]

    _, names, _ = twin(scenario, tmp_path)
    for expected in ("pipeline.enqueue", "entry.prep",
                     "decide.split_decision", "split.dispatch",
                     "split.device", "pipeline.settle"):
        assert expected in names, f"chain missing {expected}: {names}"


def test_pipeline_threads_trace_through_fused_route(tmp_path):
    def scenario(pkg, s, clk):
        rows = np.asarray([s.resources.get_or_create("x")], np.int32)
        pad_a = s.spec.alt_rows
        one = np.ones(1, np.int32)
        pipe = pkg.DispatchPipeline(s, depth=2)
        tr = s.obs.spans.mint()
        t = pipe.submit_fused(
            rows, np.zeros(1, np.int32), np.full(1, pad_a, np.int32),
            np.zeros(1, np.int32), np.full(1, pad_a, np.int32), one,
            np.ones(1, np.bool_), np.zeros(1, np.bool_), exit_rows=rows,
            trace_id=tr)
        assert bool(t.result().allow[0])
        return [x["name"] for x in s.obs.spans.chain(tr)]

    sph, names, _ = twin(scenario, tmp_path)
    for expected in ("pipeline.enqueue", "fused.dispatch", "pipeline.settle"):
        assert expected in names, f"chain missing {expected}: {names}"
    assert sph.obs.counters.get(ck.ROUTE_FUSED) == 1
