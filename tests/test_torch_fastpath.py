"""Port parity: the host fast path (``engine/fastpath.py``) of
``sentinel_tpu_torch`` against ``sentinel_tpu``.

The reference's deterministic scenarios (``tests/test_fastpath.py``) run on
twin runtimes under twin ManualClocks with the default configuration (the
host fast path on): FREE resources admitted on the host and flushed in
batches, LEASED resources served from pre-charged token chunks (renewal,
denied chunk, expiry and the uncount of unused tokens), the exclusions,
and rule reloads. The observations (outcomes, ``Entry.fast`` modes, node
totals, lease counters), the whole engine state and the routes must agree
exactly. Every count here is a small integer.

The threaded invariants run on the port alone (the interleaving is not
reproducible across two engines), each within a time limit of its own.
"""

import threading

import torch

import sentinel_tpu_torch as stt
from sentinel_tpu_torch.stats import window as tw

from test_torch_occupy import ROUTE_KEYS, T0, _twin

torch.set_num_threads(2)

def _totals(sph, name):
    t = sph.node_totals(name)
    t.pop("avg_rt", None)
    return t


def _drain(pkg, sph, resource, n, advance_ms=0, **kw):
    out = []
    for _ in range(n):
        try:
            with sph.entry(resource, **kw) as e:
                out.append("p" if e.fast is None else e.fast[0])
        except pkg.BlockException:
            out.append("b")
        if advance_ms:
            sph.clock.advance_ms(advance_ms)
    return out


def _dispatches(sph):
    """Device dispatches so far (the port's routes, the reference's
    ``split_route.*`` counters)."""
    if isinstance(sph, stt.Sentinel):
        return sum(sph.routes.values())
    return sum(sph.obs.counters.get(v) for v in ROUTE_KEYS.values())


def _within(seconds, fn):
    """``fn()`` in a thread that must finish within ``seconds``."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as exc:            # re-raised below
            out["error"] = exc

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"did not finish within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


# ---------------------------------------------------------------- FREE tier

def test_twin_free_resource_stats_land_on_device():
    def scenario(pkg, sph, clk):
        modes = []
        for _ in range(40):
            with sph.entry("free") as e:
                modes.append(e.fast)
                clk.advance_ms(3)
        return [modes, _totals(sph, "free"), sph._fast.fast_admits]
    _, obs = _twin(scenario)
    assert obs[0] == ["free"] * 40
    assert obs[1]["pass"] == 40 and obs[1]["success"] == 40
    assert obs[1]["threads"] == 0 and obs[2] == 40


def test_twin_free_resource_no_per_call_device_dispatch():
    def scenario(pkg, sph, clk):
        with sph.entry("warm"):
            pass
        sph.node_totals("warm")
        before = _dispatches(sph)
        for _ in range(100):
            with sph.entry("free"):
                pass
        mid = _dispatches(sph) - before
        t = _totals(sph, "free")                  # one forced flush
        return [t, (mid, _dispatches(sph) - before)]
    _, obs = _twin(scenario)
    assert obs[1] == (0, 1) and obs[0]["pass"] == 100


def test_twin_free_thread_gauge_tracks_inflight():
    def scenario(pkg, sph, clk):
        entries = [sph.entry("free") for _ in range(5)]
        t = _totals(sph, "free")
        for e in entries:
            e.exit()
        return [t, _totals(sph, "free")]
    _, obs = _twin(scenario, thread_gauge_always=True)
    assert obs[0]["threads"] == 5 and obs[1]["threads"] == 0


def test_twin_thread_gauge_live_when_a_reader_rule_is_loaded():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="guarded", count=50.0,
                                          grade=pkg.GRADE_THREAD)])
        entries = [sph.entry("free") for _ in range(3)]
        t = _totals(sph, "free")
        for e in entries:
            e.exit()
        return [t, _totals(sph, "free")]
    _, obs = _twin(scenario)
    assert obs[0]["threads"] == 3 and obs[1]["threads"] == 0


def test_twin_thread_gauge_elided_reads_zero_without_readers():
    def scenario(pkg, sph, clk):
        entries = [sph.entry("free") for _ in range(4)]
        t = _totals(sph, "free")
        for e in entries:
            e.exit()
        return [t]
    _, obs = _twin(scenario)
    assert obs[0]["threads"] == 0 and obs[0]["pass"] == 4


def test_twin_thread_gauge_no_leak_across_elision_flips():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="thr", count=50.0,
                                          grade=pkg.GRADE_THREAD)])
        entries = [sph.entry("free") for _ in range(5)]
        obs = [_totals(sph, "free")["threads"]]
        sph.load_flow_rules([pkg.FlowRule(resource="other", count=5.0)])
        for e in entries:
            e.exit()
        sph.load_flow_rules([pkg.FlowRule(resource="free", count=3.0,
                                          grade=pkg.GRADE_THREAD)])
        obs.append(_totals(sph, "free")["threads"])
        fresh = [sph.entry("free") for _ in range(3)]
        try:
            sph.entry("free")
            obs.append("p")
        except pkg.BlockException:
            obs.append("b")
        for e in fresh:
            e.exit()
        obs.append(_totals(sph, "free")["threads"])
        sph.entry("free").exit()
        return obs
    _, obs = _twin(scenario)
    assert obs == [5, 0, "b", 0]


def test_twin_free_with_origin_records_origin_stats():
    def scenario(pkg, sph, clk):
        modes = []
        for origin in ("app-a", "app-a", "app-b"):
            with sph.entry("free", origin=origin) as e:
                modes.append(e.fast)
        return [modes, _totals(sph, "free")]
    ts, obs = _twin(scenario)
    assert obs[0] == ["free"] * 3 and obs[1]["pass"] == 3
    # the origin rows were recorded through the flush
    row = ts.resources.lookup("free")
    idx = ts.spec.second.index_of(ts.clock.now_ms())
    alt = tw.rolling_totals(ts.spec.second, ts._state.alt_second, idx)
    o_row = ts._alt_row(row, 0, ts.origins.lookup("app-a"))
    assert int(alt[o_row, tw.ev.PASS]) == 2


# ---------------------------------------------------------------- leases

def test_twin_lease_enforces_exact_qps():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=10.0)])
        a = _drain(pkg, sph, "api", 25)
        clk.advance_ms(1000)
        b = _drain(pkg, sph, "api", 25)
        return [a, b, _totals(sph, "api"), sph._fast.lease_renewals]
    _, obs = _twin(scenario)
    assert obs[0].count("l") == 10 and obs[1].count("l") == 10
    assert obs[2]["pass"] == 10 and obs[2]["block"] == 15


def test_twin_lease_never_overadmits_under_uneven_arrival():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=20.0)])
        out = []
        for burst in (7, 1, 13, 30, 2):
            out.append(_drain(pkg, sph, "api", burst))
            clk.advance_ms(100)
        return out
    _, obs = _twin(scenario)
    assert sum(len(x) - x.count("b") for x in obs) <= 20


def test_twin_lease_stats_match_admissions():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=6.0)])
        return [_drain(pkg, sph, "api", 9), _totals(sph, "api")]
    _, obs = _twin(scenario)
    assert obs[1]["pass"] == 6 and obs[1]["block"] == 3
    assert obs[0].count("b") == 3


def test_twin_leased_with_origin_takes_device_path():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=100.0)])
        return [_drain(pkg, sph, "api", 2, origin="caller"),
                _drain(pkg, sph, "api", 2), _totals(sph, "api")]
    _, obs = _twin(scenario)
    assert obs[0] == ["p", "p"] and obs[1] == ["l", "l"]


def test_twin_rule_reload_drops_leases():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=100.0)])
        a = _drain(pkg, sph, "api", 5)
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=2.0)])
        b = _drain(pkg, sph, "api", 6)
        clk.advance_ms(1200)
        return [a, b, _totals(sph, "api")]
    _, obs = _twin(scenario)
    assert obs[0] == ["l"] * 5 and len(obs[1]) - obs[1].count("b") <= 2


def test_twin_denied_chunk_marks_the_row_hot():
    """A pre-charge the device denies marks the row hot for the bucket:
    the next calls take the exact device path until the bucket rotates."""
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=40.0)])
        v = sph.entry_batch(["api"] * 35)        # 35 of 40 spent
        a = _drain(pkg, sph, "api", 8)            # chunk 10 is denied
        hot = sph._fast.is_hot(sph.resources.lookup("api"), clk.now_ms())
        clk.advance_ms(1000)
        b = _drain(pkg, sph, "api", 3)
        return [int(v.allow.sum()), a, hot, b, _totals(sph, "api"),
                sph._fast.lease_renewals]
    _, obs = _twin(scenario)
    assert obs[0] == 35 and obs[1] == ["p"] * 5 + ["b"] * 3
    assert obs[2] and obs[3] == ["l"] * 3


# ------------------------------------------------------------- exclusions

def test_twin_degrade_rule_disables_fast_path():
    def scenario(pkg, sph, clk):
        sph.load_degrade_rules([pkg.DegradeRule(
            resource="svc", grade=pkg.GRADE_EXCEPTION_RATIO, count=0.5,
            time_window=10)])
        return [_drain(pkg, sph, "svc", 2)]
    ts, obs = _twin(scenario)
    assert obs[0] == ["p", "p"] and ts.routes["scalar"] == 2


def test_twin_system_rules_disable_inbound_fast_path():
    def scenario(pkg, sph, clk):
        sph.load_system_rules([pkg.SystemRule(qps=1e9)])
        a = _drain(pkg, sph, "free", 2)
        out = _drain(pkg, sph, "free", 1, entry_type=pkg.ENTRY_TYPE_OUT)
        sph.load_system_rules([])
        sph.node_totals("free")
        b = _drain(pkg, sph, "free", 2)
        return [a, out, b, _totals(sph, "free")]
    _, obs = _twin(scenario)
    assert obs[0] == ["p", "p"] and obs[1] == ["f"] and obs[2] == ["f"] * 2


def test_twin_complex_flow_rules_ineligible():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([
            pkg.FlowRule(resource="warm", count=100.0,
                         control_behavior=pkg.BEHAVIOR_WARM_UP),
            pkg.FlowRule(resource="two", count=100.0),
            pkg.FlowRule(resource="two", count=50.0),
            pkg.FlowRule(resource="orig", count=100.0, limit_app="caller"),
            pkg.FlowRule(resource="rel", count=100.0,
                         strategy=pkg.STRATEGY_RELATE, ref_resource="ref"),
        ])
        return [_drain(pkg, sph, r, 1) for r in ("warm", "two", "orig",
                                                  "ref", "rel")]
    _, obs = _twin(scenario)
    assert obs == [["p"]] * 5


def test_twin_batch_tier_unaffected():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=5.0)])
        v = sph.entry_batch(["api"] * 8)
        return [v.allow.tolist(), v.reason.tolist()]
    _, obs = _twin(scenario)
    assert sum(obs[0]) == 5


def test_twin_rule_load_flushes_buffered_passes_first():
    def scenario(pkg, sph, clk):
        for _ in range(6):
            with sph.entry("r"):
                pass
        sph.load_flow_rules([pkg.FlowRule(resource="r", count=1.0)])
        return [_totals(sph, "r")]
    _, obs = _twin(scenario)
    assert obs[0]["pass"] == 6 and obs[0]["block"] == 0


def test_twin_in_out_alternation_does_not_burn_budget():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=40.0)])
        out = []
        for i in range(20):
            et = pkg.ENTRY_TYPE_IN if i % 2 == 0 else pkg.ENTRY_TYPE_OUT
            out += _drain(pkg, sph, "api", 1, entry_type=et)
        return [out, sph._fast.lease_renewals]
    _, obs = _twin(scenario)
    assert "b" not in obs[0] and obs[1] <= 2


def test_twin_expired_lease_returns_unused_tokens():
    """The pre-charged chunk's unused tokens are subtracted back once the
    bucket rotates (``uncount_reserved``): the minute window's second
    holds the admissions, not the reservations."""
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=100.0)])
        a = _drain(pkg, sph, "api", 5)           # chunk 25, 5 used
        clk.advance_ms(600)                       # the bucket rotates
        b = _drain(pkg, sph, "api", 1)            # expiry + a new lease
        clk.advance_ms(600)
        sph._flush_fast()
        clk.advance_ms(1500)
        return [a, b, _totals(sph, "api")]
    ts, obs = _twin(scenario)
    row = ts.resources.lookup("api")
    sec = T0 // 1000
    k = sec % ts.spec.minute.buckets
    m = ts._state.minute
    assert int(m.stamps[row, k]) == tw.wrap_i32(sec)
    assert int(m.counters[row, k, tw.ev.PASS]) == 6


def test_twin_mixed_fast_and_batch_traffic_consistent():
    def scenario(pkg, sph, clk):
        for _ in range(4):
            with sph.entry("free"):
                pass
        sph._flush_fast()
        sph.load_flow_rules([pkg.FlowRule(resource="free", count=5.0)])
        return [_drain(pkg, sph, "free", 5)]
    _, obs = _twin(scenario)
    assert obs[0].count("b") == 4


def test_twin_late_flush_restamps_a_stale_group():
    """Buffered events older than a full window ring than a later
    dispatch land at now, not in a recycled bucket."""
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=100.0)])
        for _ in range(3):
            with sph.entry("free"):
                clk.advance_ms(1)
        clk.advance_ms(1500)
        v = sph.entry_batch(["api"] * 4)          # a newer dispatch
        sph._flush_fast()
        return [v.allow.tolist(), _totals(sph, "free"),
                _totals(sph, "api")]
    _, obs = _twin(scenario)
    assert obs[1]["pass"] == 3


# ------------------------------------------------- port-only, threaded

def _sph(clk=None, **over):
    cfg = {**dict(max_resources=64, max_flow_rules=16, max_degrade_rules=16,
                  max_authority_rules=16), **over}
    return stt.Sentinel(config=stt.load_config(**cfg), clock=clk,
                        device="cpu")


def test_concurrent_lease_renewals_single_precharge():
    """One renewal pre-charge in flight per row: 40 calls from 4 threads
    against count=100 all pass (racing renewals would spend chunks twice
    and deny some)."""
    sph = _sph(stt.ManualClock(start_ms=T0))
    sph.load_flow_rules([stt.FlowRule(resource="api", count=100.0)])
    admitted = []
    barrier = threading.Barrier(4)

    def worker():
        barrier.wait()
        got = 0
        for _ in range(10):
            try:
                with sph.entry("api"):
                    got += 1
            except stt.BlockException:
                pass
        admitted.append(got)

    def run():
        threads = [threading.Thread(target=worker) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    _within(60, run)
    assert sum(admitted) == 40


def test_threaded_leased_path_never_overadmits():
    """8 threads on one leased resource, the clock held still for each
    phase: admissions in a window never exceed the count."""
    clk = stt.ManualClock(start_ms=T0)
    sph = _sph(clk, max_resources=32, max_flow_rules=8, minute_enabled=False)
    count, n_threads = 40, 8
    sph.load_flow_rules([stt.FlowRule(resource="hot", count=float(count))])
    win_ms = sph.spec.second.win_ms

    def run_phase():
        admitted = [0] * n_threads
        barrier = threading.Barrier(n_threads)

        def worker(i):
            barrier.wait()
            for _ in range(3 * count):
                try:
                    with sph.entry("hot"):
                        admitted[i] += 1
                except stt.BlockException:
                    pass

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return sum(admitted)

    for phase in range(3):
        got = _within(60, run_phase)
        assert 0 < got <= count, f"phase {phase}: {got} admissions"
        clk.advance_ms(2 * win_ms)


def test_threaded_free_path_thread_gauge_returns_to_zero():
    """Entry/exit churn from 6 threads on a rule-free resource with
    aggressive flushing (real clock): afterwards the thread gauge reads 0,
    the flush lock's drain→dispatch order guarantee."""
    sph = _sph(max_resources=32, max_flow_rules=8, max_degrade_rules=8,
               max_authority_rules=8, fast_path_flush_events=4,
               fast_path_flush_ms=1, thread_gauge_always=True)
    with sph.entry("free-res"):
        pass
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            with sph.entry("free-res"):
                pass

    def run():
        threads = [threading.Thread(target=worker) for _ in range(6)]
        for t in threads:
            t.start()
        stop.wait(1.0)
        stop.set()
        for t in threads:
            t.join()
    _within(60, run)
    sph._flush_fast()
    totals = sph.node_totals("free-res")
    assert totals["threads"] == 0, totals
    assert totals["pass"] >= 0 and totals["success"] >= 0


def test_default_config_constructs_with_the_fast_path_on():
    sph = stt.Sentinel(stt.load_config(max_resources=32), device="cpu")
    assert sph.cfg.host_fast_path and sph._fast_enabled
    with sph.entry("free") as e:
        assert e.fast == "free"
    assert sph.node_totals("free")["pass"] == 1
