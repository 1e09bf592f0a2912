"""Port parity: the runtime's self-telemetry (``sentinel_tpu_torch.obs``)
against ``sentinel_tpu.obs``.

The reference's scenarios of ``tests/test_obs.py`` that need no serving
front end, transport, exporter or multihost run on both packages. The
bare recorders and histograms take the same inputs in both; twin
runtimes (``host_fast_path=False``) under twin ManualClocks take the same
rule loads and numpy-seeded batches, and their counters, spans (by name
and virtual time), histogram snapshots, sampled block events, flight
records, block-log lines and engine state must agree exactly. Every
counter is compared, ``compile_cache.*`` (first against repeat
dispatches of each program key) and ``tune.*`` (startup artifact and
``SENTINEL_*`` knob validation) included.

Both packages' tiering is switched off in these twins
(``SENTINEL_TIERING_DISABLE``): their counter expectations predate it
(ROADMAP C8); ``test_torch_tiering.py`` and its siblings run it on.

Also here: the port's ``counters_catalog.txt`` pinned to the reference's
file line by line, the host staging ring, the leak guard of
``PendingVerdicts`` and the facade's snapshots and switches.
"""

import dataclasses
import gc
import os
import threading

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.core import logs as jlogs
from sentinel_tpu.obs import counters as jck
from sentinel_tpu.obs import eventlog as jeventlog
from sentinel_tpu.obs import hist as jhist
from sentinel_tpu.obs import spans as jspans
from sentinel_tpu_torch import convert
from sentinel_tpu_torch import runtime as trt
from sentinel_tpu_torch.core import logs as tlogs
from sentinel_tpu_torch.obs import counters as ck
from sentinel_tpu_torch.obs import eventlog as teventlog
from sentinel_tpu_torch.obs import hist as thist
from sentinel_tpu_torch.obs import spans as tspans

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_785_000_000_000
PKGS = {"jax": stpu, "torch": stt}
MODS = {"jax": dict(spans=jspans, hist=jhist, eventlog=jeventlog, ck=jck,
                    logs=jlogs),
        "torch": dict(spans=tspans, hist=thist, eventlog=teventlog, ck=ck,
                      logs=tlogs)}
BASE_CFG = dict(max_resources=64, max_origins=32, max_flow_rules=32,
                max_degrade_rules=16, max_authority_rules=16,
                host_fast_path=False, minute_enabled=True)
RULES = [dict(resource="api", count=100.0),
         dict(resource="api", count=3.0, limit_app="app-a")]


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    """Every log, block-log and metric file of a test lands in its own
    temp dir; the reference's tiering is off (see the module docstring)."""
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SENTINEL_TIERING_DISABLE", "1")


def _both(fn):
    """``fn(name, modules)`` on both packages' modules → the port's
    result, which must equal the reference's."""
    want = fn("jax", MODS["jax"])
    got = fn("torch", MODS["torch"])
    assert got == want
    return got


def make(pkg, clk, **over):
    """A Sentinel of ``pkg`` with the small twin geometry (CPU for the
    port; a fixed system-load sample so both read alike)."""
    cfg = pkg.load_config(**{**BASE_CFG, **over})
    extra = {"device": "cpu"} if pkg is stt else {}
    sph = pkg.Sentinel(config=cfg, clock=clk, **extra)
    sph._cpu.sample = lambda: (0.5, 0.25)
    return sph


def rules(pkg, specs):
    return [pkg.FlowRule(**r) for r in specs]


def obs_view(sph) -> dict:
    """What the twins must agree on in ``sph.obs``."""
    o = sph.obs
    return dict(
        counters=o.counters.snapshot(),
        spans=o.spans.snapshot(), links=o.spans.links_snapshot(),
        hist={h: getattr(o, h).snapshot()
              for h in ("hist_entry", "hist_dispatch", "hist_request")},
        block_events=o.block_events.snapshot(limit=1 << 20),
        flight=o.flight.snapshot(full=True))


def twin(scenario, tmp_path, **over):
    """Run ``scenario(pkg, sph, clk) -> observations`` on twin runtimes
    whose block logs write under ``tmp_path/<package>`` → (port runtime,
    its observations, its block-log lines). Observations, obs views,
    block-log lines and engine state must agree."""
    got, engines, lines = {}, {}, {}
    for name, pkg in PKGS.items():
        clk = pkg.ManualClock(start_ms=T0)
        sph = make(pkg, clk, **over)
        sph.block_log.close()
        sph.block_log = MODS[name]["logs"].BlockStatLogger(
            clk, base_dir=str(tmp_path / name))
        got[name] = scenario(pkg, sph, clk)
        got[name] = (got[name], obs_view(sph))
        sph.block_log.flush()
        path = tmp_path / name / sph.block_log.FILE_NAME
        lines[name] = path.read_text().splitlines() if path.exists() else []
        engines[name] = sph
    assert got["torch"][0] == got["jax"][0]
    for key in got["jax"][1]:
        assert got["torch"][1][key] == got["jax"][1][key], key
    assert lines["torch"] == lines["jax"]
    assert convert.leaf_diff(convert.to_numpy(engines["jax"]._state),
                             convert.to_numpy(engines["torch"]._state)) == []
    engines["jax"].close()
    return engines["torch"], got["torch"][0], lines["torch"]


def mixed_batch(pkg, sph, n=8192, origin_frac=0.1, seed=3):
    """(resources, origins) of a batch that takes the split path (the
    numbers are drawn inside, so both twins get the same batch)."""
    sph.load_flow_rules(rules(pkg, RULES))
    rng = np.random.default_rng(seed)
    origins = ["app-a" if x else ""
               for x in (rng.random(n) < origin_frac)]
    return ["api"] * n, origins


def verdicts(v):
    return (v.allow.tolist(), v.reason.tolist(), v.wait_ms.tolist())


# ---------------------------------------------------------------- spans

def test_span_recorder_virtual_clock_lifecycle():
    def run(name, m):
        clk = PKGS[name].ManualClock(start_ms=T0)
        rec = m["spans"].SpanRecorder.for_clock(clk)
        tr = rec.maybe_trace()
        t0 = rec.now_ns()
        clk.advance_ms(3)
        t1 = rec.now_ns()
        rec.record(tr, "entry.total", t0, t1, n=128, note="x")
        out = [tr, t1 - t0, rec.snapshot(), rec.chain(tr),
               rec.last_trace_id()]
        rec.record(0, "noise", t0, t1)     # unsampled: dropped
        return out + [len(rec.snapshot())]

    tr, dur, snap, chain, last, n_after = _both(run)
    assert tr == 1 and dur == 3_000_000 and last == 1 and n_after == 1
    (span,) = snap
    assert span["name"] == "entry.total" and span["n"] == 128
    assert span["thread"] == threading.get_ident()
    assert chain == [span]


def test_span_sampling_stride_is_deterministic():
    def run(name, m):
        clk = PKGS[name].ManualClock(start_ms=T0)
        rec = m["spans"].SpanRecorder.for_clock(clk, sample=0.25)
        ids = [rec.maybe_trace() for _ in range(12)]
        off = m["spans"].SpanRecorder.for_clock(clk, sample=0.0)
        return ids, off.maybe_trace()

    ids, off = _both(run)
    assert [bool(i) for i in ids] == [True, False, False, False] * 3
    assert [i for i in ids if i] == [1, 2, 3] and off == 0


def test_span_recorder_close_is_idempotent():
    def run(name, m):
        rec = m["spans"].SpanRecorder.for_clock(
            PKGS[name].ManualClock(start_ms=T0))
        rec.record(rec.maybe_trace(), "s", 0, 1)
        rec.close()
        rec.close()
        out = [rec.snapshot(), rec.maybe_trace()]
        rec.record(99, "after-close", 0, 1)
        return out + [rec.snapshot()]

    assert _both(run) == [[], 0, []]


def test_ring_wraps_at_capacity():
    def run(name, m):
        rec = m["spans"].SpanRecorder(capacity=16, time_ns=lambda: 7)
        for i in range(40):
            rec.record(rec.maybe_trace(), f"s{i}", i, i + 1)
        return rec.snapshot()

    spans = _both(run)
    assert len(spans) == 16
    assert min(s["trace"] for s in spans) == 25


# ----------------------------------------------------------- histograms

def test_bucket_geometry():
    def run(name, m):
        h = m["hist"]
        base = h.BASE_NS
        return ([h.bucket_index(v) for v in
                 (0, base, base + 1, 2 * base, 2 * base + 1, 1 << 62)],
                h.bucket_bounds_ns(), h.NUM_BUCKETS)

    idx, bounds, nb = _both(run)
    assert idx == [0, 0, 1, 1, 2, nb - 1]
    assert len(bounds) == nb and bounds[1] == 2 * bounds[0]


def test_percentiles_interpolate_deterministically():
    def run(name, m):
        h = m["hist"].LogHistogram()
        for _ in range(100):
            h.record(2048)
        return [h.percentile(q) for q in (0.5, 0.95, 0.99)], h.snapshot()

    pct, snap = _both(run)
    assert pct == pytest.approx([1024 + 1024 * q for q in (0.5, 0.95, 0.99)])
    assert snap["count"] == 100 and snap["sum_ns"] == 100 * 2048
    assert snap["max_ns"] == 2048 and snap["buckets"][1] == 100


def test_percentiles_across_buckets_and_empty():
    def run(name, m):
        h = m["hist"].LogHistogram()
        empty = [h.percentile(0.99), h.snapshot()["p50_ms"]]
        for v in [512] * 90 + [4000] * 10:
            h.record(v)
        return empty, h.percentile(0.50), h.percentile(0.95)

    empty, p50, p95 = _both(run)
    assert empty == [None, None]
    assert p50 == pytest.approx(1024 * 50 / 90)
    assert p95 == pytest.approx(2048 + 2048 * 5 / 10)


def test_histogram_merge_matches_union():
    def run(name, m):
        H = m["hist"].LogHistogram
        a, b, u = H(), H(), H()
        for v in (100, 5000, 70_000):
            a.record(v)
            u.record(v)
        for v in (800, 800, 9_000_000):
            b.record(v)
            u.record(v)
        a.merge(b)
        c = H()
        sb = b.snapshot()
        c.merge_counts(sb["buckets"], sb["sum_ns"], sb["max_ns"])
        return a.snapshot(), u.snapshot(), c.snapshot(), sb

    a, u, c, b = _both(run)
    assert a == u and c == b


def test_last_bucket_percentile_clamps_to_max():
    def run(name, m):
        h = m["hist"].LogHistogram()
        big = m["hist"].BASE_NS << 45
        h.record(big)
        return h.percentile(0.99), big

    p99, big = _both(run)
    assert p99 <= big


# ------------------------------------------------- counters vs routing

def test_split_fired_counter_matches_actual_split_calls(tmp_path):
    def scenario(pkg, sph, clk):
        resources, origins = mixed_batch(pkg, sph)
        calls = []
        orig = sph._decide_split_nowait
        sph._decide_split_nowait = lambda *a, **k: (calls.append(1),
                                                    orig(*a, **k))[1]
        out = []
        for _ in range(3):
            out.append(verdicts(sph.entry_batch(resources, origins=origins)))
            clk.advance_ms(50)
        return out, len(calls)

    ts, (_, calls), lines = twin(scenario, tmp_path)
    assert calls == 3
    assert ts.obs.counters.get(ck.ROUTE_SPLIT) == 3
    assert ts.obs.hist_entry.count == 3 and ts.obs.hist_dispatch.count == 3
    assert ts.obs.counters.get(ck.BLOCK_PREFIX + "FlowException") > 0
    assert lines and all(",FlowException," in ln for ln in lines)
    ts.close()


def test_fast_and_scalar_route_counters(tmp_path):
    def scenario(pkg, sph, clk):
        sph.load_flow_rules(rules(pkg, RULES))
        out = []
        for _ in range(2):
            out.append(verdicts(sph.entry_batch(["api"] * 64)))
            clk.advance_ms(10)
        return out

    ts, _, _ = twin(scenario, tmp_path)
    c = ts.obs.counters.snapshot()
    assert c.get(ck.ROUTE_SPLIT, 0) == 0
    assert (c.get(ck.ROUTE_SCALAR, 0) + c.get(ck.ROUTE_FAST, 0)
            + c.get(ck.ROUTE_FAST_OCCUPY, 0)) == 2
    assert c[ck.PIPE_DISPATCH] == 2
    ts.close()


def test_obs_disable_env_turns_instrumentation_off(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_OBS_DISABLE", "1")

    def scenario(pkg, sph, clk):
        assert not sph.obs.enabled
        sph.load_flow_rules(rules(pkg, RULES))
        return verdicts(sph.entry_batch(["api"] * 64))

    ts, _, _ = twin(scenario, tmp_path)
    assert ts.obs.counters.snapshot() == {}
    assert ts.obs.spans.snapshot() == []
    assert ts.obs.hist_entry.count == 0
    ts.close()


def test_trace_sample_env(monkeypatch):
    monkeypatch.setenv("SENTINEL_TRACE_SAMPLE", "0.5")
    from sentinel_tpu.obs import RuntimeObs as JObs
    from sentinel_tpu_torch.obs import RuntimeObs as TObs
    for cls, pkg in ((JObs, stpu), (TObs, stt)):
        obs = cls(clock=pkg.ManualClock(start_ms=T0))
        assert obs.sample == 0.5 and obs.spans._stride == 2


# -------------------------------------------------- span chain end-to-end

def test_batch_records_full_span_chain(tmp_path):
    def scenario(pkg, sph, clk):
        resources, origins = mixed_batch(pkg, sph, seed=5)
        v = sph.entry_batch(resources, origins=origins)
        tr = sph.obs.spans.last_trace_id()
        return verdicts(v), tr, sph.obs.spans.chain(tr)

    ts, (_, tr, chain), _ = twin(scenario, tmp_path)
    names = [s["name"] for s in chain]
    for expected in ("entry.prep", "decide.split_decision",
                     "split.dispatch", "split.device", "entry.settle",
                     "entry.total"):
        assert expected in names, names
    total = [s for s in chain if s["name"] == "entry.total"]
    assert tr > 0 and total[0]["n"] == 8192
    ts.close()


# ------------------------------------------------------ block-event log

def test_block_event_log_roundtrip_via_searcher(tmp_path):
    from sentinel_tpu.metrics.searcher import MetricSearcher as JS
    from sentinel_tpu_torch.metrics.searcher import MetricSearcher as TS

    def run(name, m):
        d = tmp_path / name
        log = m["eventlog"].BlockEventLog()
        base_name = log.configure(str(d), "appx")
        log.log(T0, "api", int(stt.BlockReason.FLOW),
                reason_name="FlowException", count=7)
        log.log(T0 + 1000, "api", int(stt.BlockReason.DEGRADE),
                reason_name="DegradeException", origin="app-a", count=2)
        written = log.flush()
        searcher = (JS if name == "jax" else TS)(str(d), base_name)
        found = searcher.find(T0 - 1000, T0 + 5000)
        ident = searcher.find(T0 - 1000, T0 + 5000, identity="api")
        log.close()
        log.close()
        files = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
        return (written, [dataclasses.asdict(n) for n in found],
                [dataclasses.asdict(n) for n in ident], files)

    written, found, ident, files = _both(run)
    assert written == 2 and files
    by_res = {n["resource"]: n for n in found}
    assert by_res["api"]["block_qps"] == 7
    assert by_res["api"]["classification"] == int(stt.BlockReason.FLOW)
    assert by_res["api@app-a"]["block_qps"] == 2
    assert len(ident) == 1


def test_block_events_buffer_before_configure(tmp_path):
    def scenario(pkg, sph, clk):
        resources, origins = mixed_batch(pkg, sph, seed=5)
        v = sph.entry_batch(resources, origins=origins)
        return verdicts(v), sph.obs.block_events.flush()

    ts, (_, flushed), _ = twin(scenario, tmp_path)
    recent = ts.obs.block_events.snapshot()
    assert recent and flushed == 0
    assert recent[-1]["resource"] == "api"
    assert recent[-1]["reason_name"] == "FlowException"
    assert recent[-1]["count"] >= 1
    ts.close()


# ------------------------------------------- shutdown / thread hygiene

def test_close_is_idempotent_and_leaks_no_threads(tmp_path):
    from sentinel_tpu_torch.metrics.timer import MetricTimerListener

    def cycle():
        clk = stt.ManualClock(start_ms=T0)
        sph = make(stt, clk, app_name="leakcheck",
                   metric_log_dir=str(tmp_path))
        timer = MetricTimerListener(sph)
        timer.start()
        sph.load_flow_rules(rules(stt, RULES))
        sph.entry_batch(["api"] * 32)
        sph.close()
        sph.close()                     # a second close is a no-op
        assert timer._thread is None    # the shutdown hook stopped it
        assert not sph.obs.enabled

    cycle()
    before = set(threading.enumerate())
    for _ in range(3):
        cycle()
    new = set(threading.enumerate()) - before
    assert not [t.name for t in new
                if t.name.startswith(("sentinel-metric-timer",
                                      "statlog-flush"))]
    assert len(new) == 0


def test_context_manager_closes():
    with make(stt, stt.ManualClock(start_ms=T0)) as sph:
        sph.load_flow_rules(rules(stt, RULES))
        sph.entry_batch(["api"] * 16)
    assert not sph.obs.enabled
    assert sph.block_log.appender._stop.is_set()


# ------------------------------------------------------------ catalog

def test_catalog_vector_roundtrip():
    def run(name, m):
        c = m["ck"]
        counts = {c.ROUTE_SPLIT: 5, c.CACHE_HIT: 2,
                  c.BLOCK_PREFIX + "FlowException": 9}
        vec = c.catalog_vector(counts)
        longer = np.concatenate([vec, np.array([42], np.int64)])
        return (vec.dtype.str, vec.tolist(), c.vector_counts(vec),
                c.vector_counts(longer))

    dtype, vec, back, back_longer = _both(run)
    assert dtype == np.dtype(np.int64).str and len(vec) == len(ck.CATALOG)
    assert back[ck.ROUTE_SPLIT] == 5 and back_longer == back


def test_catalog_is_append_only_with_r20_keys_last():
    """The port's CATALOG is the reference's, key for key and in order
    (a counter vector is aggregated by position), and both end with the
    same groups."""
    assert ck.CATALOG == jck.CATALOG
    assert len(ck.CATALOG) == len(set(ck.CATALOG))
    assert ck.CATALOG[-2:] == ("telemetry.hist_tick", "control.tail_signal")
    assert ck.CATALOG[-9:-7] == ("pipeline.dispatches",
                                 "split_route.single_dispatch")
    assert ck.CATALOG[-24:-22] == ("split_route.sortfree",
                                   "sortfree.bucket_overflow")
    names = [n for n in dir(jck) if n.isupper() and isinstance(
        getattr(jck, n), str)]
    assert {n: getattr(ck, n, None) for n in names} == {
        n: getattr(jck, n) for n in names}


def test_counters_catalog_file_equals_the_reference():
    """The port's ``obs/counters_catalog.txt`` is the reference's file,
    line by line, and its keys are the exact prefix of CATALOG."""
    mine = os.path.join(REPO, "sentinel_tpu_torch", "obs",
                        "counters_catalog.txt")
    ref = os.path.join(REPO, "sentinel_tpu", "obs", "counters_catalog.txt")
    with open(mine) as a, open(ref) as b:
        got, want = a.read().splitlines(), b.read().splitlines()
    assert got == want
    keys = [ln.strip() for ln in got
            if ln.strip() and not ln.lstrip().startswith("#")]
    assert tuple(keys) == ck.CATALOG[:len(keys)]


# ------------------------------------------------ staging ring, leaks

def test_staging_ring_grows_past_its_depth_and_reuses_released_slots():
    """A pipeline deeper than the ring grows it (``grown``) instead of
    rewriting a slot whose dispatch has not settled; settled slots are
    reused. The verdicts equal those of a twin with staging off."""
    def run(staging):
        os.environ["SENTINEL_HOST_STAGING"] = "1" if staging else "0"
        try:
            sph = make(stt, stt.ManualClock(start_ms=T0))
        finally:
            del os.environ["SENTINEL_HOST_STAGING"]
        sph.load_flow_rules([stt.FlowRule(resource="api", count=700.0)])
        rows = sph.intern_resources(["api"] * 1000)
        depth = sph._staging_depth
        handles = []
        for _ in range(depth + 3):
            handles.append(sph.entry_batch_nowait(rows))
            sph.clock.advance_ms(100)
        ring = sph._staging.get(1024)
        mid = (None if ring is None
               else (ring.grown, len(ring._free)))
        out = [verdicts(h.result()) for h in handles]
        end = None if ring is None else (ring.grown, len(ring._free))
        # released slots serve the next dispatches: no growth
        for _ in range(depth):
            out.append(verdicts(sph.entry_batch(rows)))
        again = None if ring is None else ring.grown
        return out, mid, end, again, depth

    out_on, mid, end, again, depth = run(True)
    out_off, mid_off, _, _, _ = run(False)
    assert out_on == out_off and mid_off is None
    assert mid == (3, 0)
    assert end == (3, depth + 3)
    assert again == 3


def test_dropped_handle_is_settled_and_counted():
    sph = make(stt, stt.ManualClock(start_ms=T0))
    sph.load_flow_rules([stt.FlowRule(resource="api", count=2.0)])
    sph.entry_batch_nowait(["api"] * 8)     # dropped without .result()
    gc.collect()
    assert sph.obs.counters.get(ck.PIPE_LEAKED) == 1
    # its settle ran: the block log holds the 6 denials
    assert sph.obs.counters.get(ck.BLOCK_PREFIX + "FlowException") == 6
    h = sph.entry_batch_nowait(["api"] * 8)
    h.result()
    del h
    gc.collect()
    assert sph.obs.counters.get(ck.PIPE_LEAKED) == 1
    sph.close()


# --------------------------------------------- facade snapshots, switch

def test_twin_snapshots_totals_and_switch(tmp_path):
    """metrics_snapshot, the totals family, origin totals, system status,
    the rule getters, the global switch and ``threads_elided``."""
    def scenario(pkg, sph, clk):
        sph.load_flow_rules(rules(pkg, RULES) + [
            pkg.FlowRule(resource="t", count=1, grade=pkg.GRADE_THREAD)])
        sph.load_system_rules([pkg.SystemRule(qps=1e6)])
        obs = [sph.threads_elided]
        for i in range(6):
            try:
                with sph.entry("api", origin="app-a" if i % 2 else "",
                               resource_type=3):
                    clk.advance_ms(7)
            except pkg.BlockException as e:
                obs.append(type(e).__name__)
        held = sph.entry("api")
        v = sph.entry_batch(["api"] * 50 + ["other"] * 30,
                            origins=["app-a"] * 10 + ["app-b"] * 70)
        obs.append(verdicts(v))
        obs.append(sph.node_totals("api"))
        obs.append(sph.all_node_totals())
        obs.append(sph.origin_totals("api"))
        obs.append(sph.origin_totals("nope"))
        obs.append(sph.system_status())
        held.exit()
        sph.set_global_switch(False)
        e = sph.entry("api")
        obs.append(e.row)
        e.exit()
        sph.set_global_switch(True)
        clk.advance_ms(1500)
        obs.append([dataclasses.asdict(n) for n in sph.metrics_snapshot(T0)])
        obs.append(sph.metrics_snapshot(T0 - 5000))
        obs.append([dataclasses.asdict(r) for r in sph.get_flow_rules()])
        obs.append([dataclasses.asdict(r) for r in sph.get_system_rules()])
        obs += [sph.get_degrade_rules(), sph.get_authority_rules(),
                sph.get_param_flow_rules()]
        return obs

    ts, obs, lines = twin(scenario, tmp_path)
    assert obs[0] is False                   # a THREAD rule reads gauges
    snap = {n["resource"]: n for n in obs[-7]}
    assert snap["api"]["classification"] == 3
    assert snap["api"]["pass_qps"] > 0
    assert lines
    ts.close()


def test_twin_callbacks_on_every_path(tmp_path):
    """onPass / onBlocked / onExit fire on the single call (device decide
    and the host fast path, free and leased), on host-gate denials in both
    tiers, in the same order with the same arguments."""
    def scenario(pkg, sph, clk):
        seq = []
        cb = sph.callbacks
        cb.add_pass_handler(lambda r, o, a, args: seq.append(
            ("pass", r, o, a, tuple(args))))
        cb.add_blocked_handler(lambda r, o, a, exc: seq.append(
            ("block", r, o, a, type(exc).__name__)))
        cb.add_exit_handler(lambda r, rt, err, a: seq.append(
            ("exit", r, rt, err, a)))

        class Gate(pkg.HostGate):
            name = "no-evil"

            def check(self, resource, origin, acquire, args):
                return resource != "evil"

        sph.register_slot(Gate())
        sph.load_flow_rules([pkg.FlowRule(resource="lim", count=2.0)])
        for res in ("free", "lim", "lim", "lim", "evil"):
            try:
                with sph.entry(res, origin="o1", args=(7,)):
                    clk.advance_ms(3)
            except pkg.BlockException as e:
                seq.append(("raised", type(e).__name__))
        v = sph.entry_batch(["evil", "lim", "free"], origins=["", "o2", ""])
        seq.append(verdicts(v))
        return seq

    _, seq, lines = twin(scenario, tmp_path, host_fast_path=True)
    kinds = [s[0] for s in seq]
    assert kinds.count("pass") == 3 and kinds.count("exit") == 3
    assert ("raised", "CustomSlotException") in seq
    assert ("raised", "FlowException") in seq
    assert any("evil,CustomSlotException" in ln for ln in lines)


def test_twin_occupy_and_eviction_counters(tmp_path):
    """occupy.granted on prioritized admissions, occupy.carried/settled at
    a reload with live bookings, occupy.evicted with recycled rows."""
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="svc", count=2.0)])
        out = []
        for _ in range(2):
            sph.entry("svc").exit()
        clk.advance_ms(500)
        v = sph.entry_batch(["svc"] * 6, prioritized=[True] * 6)
        out.append(verdicts(v))
        sph.load_flow_rules([pkg.FlowRule(resource="svc", count=3.0)])
        names = [f"r{i}" for i in range(80)]       # > max_resources
        out.append(verdicts(sph.entry_batch(names)))
        out.append(verdicts(sph.entry_batch(names[:8])))
        return out

    ts, _, _ = twin(scenario, tmp_path)
    c = ts.obs.counters.snapshot()
    assert c.get(ck.OCCUPY_GRANTED, 0) > 0
    assert c.get(ck.OCCUPY_CARRIED, 0) + c.get(ck.OCCUPY_SETTLED, 0) > 0
    assert c.get(ck.OCCUPY_EVICTED, 0) > 0
    ts.close()


def test_fused_route_counters_and_spans(tmp_path):
    def scenario(pkg, sph, clk):
        sph.load_flow_rules(rules(pkg, RULES))
        rows = sph.intern_resources(["api"] * 64)
        n = rows.shape[0]
        ra = sph.spec.alt_rows
        z = np.zeros(n, np.int32)
        out = []
        for step in range(3):
            h = sph.decide_and_exit_raw_nowait(
                rows, z, np.full(n, ra, np.int32), z,
                np.full(n, ra, np.int32), np.ones(n, np.int32),
                np.ones(n, np.bool_), np.zeros(n, np.bool_),
                exit_rows=rows[:step * 8])
            out.append(verdicts(h.result()))
            clk.advance_ms(400)
        return out

    ts, _, _ = twin(scenario, tmp_path)
    c = ts.obs.counters.snapshot()
    assert c[ck.ROUTE_FUSED] == 3 and c[ck.PIPE_DISPATCH] == 3
    names = {s["name"] for s in ts.obs.spans.snapshot()}
    assert {"fused.dispatch", "fused.device"} <= names
    ts.close()


def test_annotate_names_dispatches_in_the_profiler():
    """``obs.annotate`` wraps every dispatch in a ``record_function`` of
    the reference's name; obs off, it is one shared no-op context."""
    sph = make(stt, stt.ManualClock(start_ms=T0))
    sph.load_flow_rules(rules(stt, RULES))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sph.entry_batch(["api"] * 16)
        sph.entry("api").exit()
    keys = {e.key for e in prof.key_averages()}
    assert {"sentinel_tpu.decide", "sentinel_tpu.exit"} <= keys
    sph.obs.enabled = False
    assert sph.obs.annotate("x") is sph.obs.annotate("y")
    sph.close()


def test_runtime_module_has_every_public_method_of_the_reference():
    """Every public name of the reference's ``Sentinel`` (the last one,
    ``set_token_service``, came with the cluster token tier)."""
    from sentinel_tpu import runtime as jrt
    want = {n for n in dir(jrt.Sentinel) if not n.startswith("_")}
    have = {n for n in dir(trt.Sentinel) if not n.startswith("_")}
    assert want - have == set()
    assert hasattr(trt.PendingVerdicts, "attach_leak_guard")


# ------------------------------------- the dispatch's parts (port only)

PARTS = ("dispatch.route", "dispatch.stage", "dispatch.engine")
SETTLE_PARTS = ("verdicts.wait", "verdicts.unpack")
ENGINE_RANGES = ("engine.flow", "engine.degrade", "engine.statistic",
                 "engine.exits")
#: the profiler ranges of a fused and a decide dispatch: the ring's spans
#: except those whose region an annotation already names (dispatch.engine
#: is sentinel_tpu.fused / .decide) or that a split may yet replace
#: (decide.dispatch and its route), and the profiler-only readback
FUSED_RANGES = ("pipeline.enqueue", "pipeline.settle", "fused.dispatch",
                "dispatch.route", "dispatch.stage", "dispatch.readback",
                "sentinel_tpu.fused", *SETTLE_PARTS, *ENGINE_RANGES)
DECIDE_RANGES = ("dispatch.stage", "dispatch.readback",
                 "sentinel_tpu.decide", "engine.verdict", *SETTLE_PARTS)


def _real_clock_sentinel(**over):
    """A port Sentinel on the real clock (its spans on perf_counter_ns),
    with a flow rule and a breaker, so every slot of the step runs."""
    cfg = stt.load_config(**{**BASE_CFG, **over})
    sph = stt.Sentinel(config=cfg, device="cpu")
    sph._cpu.sample = lambda: (0.5, 0.25)
    sph.load_flow_rules(rules(stt, RULES))
    sph.load_degrade_rules([stt.DegradeRule(
        resource="api", grade=stt.GRADE_EXCEPTION_RATIO, count=0.5,
        time_window=10)])
    return sph


def _raw_columns(sph, n=64):
    rows = sph.intern_resources(["api"] * n)
    ra = sph.spec.alt_rows
    z = np.zeros(n, np.int32)
    return (rows, z, np.full(n, ra, np.int32), z, np.full(n, ra, np.int32),
            np.ones(n, np.int32), np.ones(n, np.bool_),
            np.zeros(n, np.bool_))


def _one_dispatch(sph, route):
    cols = _raw_columns(sph)
    if route == "decide":
        return sph.decide_raw_nowait(*cols).result()
    return sph.decide_and_exit_raw_nowait(
        *cols, exit_rows=cols[0][:16], exit_rt_ms=np.full(16, 7, np.int32),
        exit_error=np.arange(16) % 2 == 0).result()


def _inside(child, parent):
    return (child["trace"] == parent["trace"]
            and child["thread"] == parent["thread"]
            and parent["start_ns"] <= child["start_ns"]
            <= child["end_ns"] <= parent["end_ns"])


@pytest.mark.parametrize("route", ["decide", "fused"])
def test_dispatch_records_its_parts_inside_its_span(route):
    """Under the real clock a dispatch records its route choice, staging
    and engine issue as spans on its trace, each inside the dispatch's
    own span on its thread; together they take no longer than it. The
    dispatch's span ends before the verdict copies start, where its
    device span starts."""
    sph = _real_clock_sentinel()
    _one_dispatch(sph, route)
    spans = sph.obs.spans.snapshot()
    (parent,) = [s for s in spans if s["name"] == f"{route}.dispatch"]
    assert parent["note"].startswith("scalar")
    parts = {s["name"]: s for s in spans if s["name"] in PARTS}
    assert set(parts) == set(PARTS)
    for s in parts.values():
        assert _inside(s, parent), s
    assert sum(s["dur_ns"] for s in parts.values()) <= parent["dur_ns"]
    (device,) = [s for s in spans if s["name"] == f"{route}.device"]
    assert device["start_ns"] == parent["end_ns"]
    assert "dispatch.readback" not in {s["name"] for s in spans}
    sph.close()


@pytest.mark.parametrize("route,n,note", [
    ("fused", 600, "ring=9 fresh=0 const=8"),
    ("fused", 64, "ring=0 fresh=17 const=0"),
    ("decide", 600, "ring=9 fresh=0 const=0"),
    ("decide", 64, "ring=0 fresh=9 const=0"),
])
def test_stage_span_notes_how_its_columns_were_staged(route, n, note):
    """``dispatch.stage`` notes how many columns went through ring slots,
    were staged fresh, or were served as device constants: a serving
    sized fused batch whose caller passes exit rows, RT and errors
    stages those and the entry columns in slots and leaves five exit
    columns to constants; a small batch stages every column fresh."""
    sph = _real_clock_sentinel()
    cols = _raw_columns(sph, n)
    if route == "decide":
        sph.decide_raw_nowait(*cols).result()
    else:
        sph.decide_and_exit_raw_nowait(
            *cols, exit_rows=cols[0], exit_rt_ms=np.full(n, 7, np.int32),
            exit_error=np.arange(n) % 2 == 0).result()
    (stage,) = [s for s in sph.obs.spans.snapshot()
                if s["name"] == "dispatch.stage"]
    assert stage["note"] == note
    sph.close()


def test_pipeline_settle_records_the_verdict_wait_inside_it():
    sph = _real_clock_sentinel()
    pipe = stt.DispatchPipeline(sph)
    cols = _raw_columns(sph)
    tickets = [pipe.submit_fused(*cols, exit_rows=cols[0][:8])
               for _ in range(3)]
    for t in tickets:
        t.result()
    spans = sph.obs.spans.snapshot()
    settles = [s for s in spans if s["name"] == "pipeline.settle"]
    dispatches = [s for s in spans if s["name"] == "fused.dispatch"]
    assert len(settles) == len(dispatches) == 3
    for name in SETTLE_PARTS:
        got = [s for s in spans if s["name"] == name]
        assert len(got) == 3
        for s, d in zip(sorted(got, key=lambda s: s["start_ns"]),
                        sorted(dispatches, key=lambda s: s["start_ns"])):
            # the dispatch's trace, inside a settle on its thread (the
            # settle span is on the pipeline's trace)
            assert s["trace"] == d["trace"]
            assert any(_inside(s, {**o, "trace": s["trace"]})
                       for o in settles)
    sph.close()


def _profiled(fn):
    """The profiler's range names over ``fn()`` (CPU activity)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()]


def test_profiler_sees_the_spans_and_the_engine_ranges(monkeypatch):
    """While a profiler collects, the ring's spans are ``record_function``
    ranges of their names, the engine step's slots are ranges of their
    own (the single-dispatch epilogue too, with tiering on), and each
    region has one range: ``dispatch.engine`` is the ``sentinel_tpu.*``
    annotation's, and a decide dispatch, which may yet split, opens no
    range for itself or its route."""
    monkeypatch.delenv("SENTINEL_TIERING_DISABLE")
    sph = _real_clock_sentinel()
    pipe = stt.DispatchPipeline(sph)
    cols = _raw_columns(sph)
    fused = _profiled(
        lambda: pipe.submit_fused(*cols, exit_rows=cols[0][:8]).result())
    assert {*FUSED_RANGES, "engine.epilogue"} <= set(fused), \
        set(FUSED_RANGES) - set(fused)
    assert "dispatch.engine" not in fused
    for name in ("fused.dispatch", "dispatch.route", "dispatch.stage",
                 "sentinel_tpu.fused", "dispatch.readback"):
        assert fused.count(name) == 1, name
    decide = _profiled(lambda: _one_dispatch(sph, "decide"))
    assert set(DECIDE_RANGES) <= set(decide)
    assert not {"decide.dispatch", "dispatch.route",
                "dispatch.engine"} & set(decide)
    sph.close()


def test_a_split_decide_records_no_route_span_and_no_range():
    """A decide batch that splits records ``decide.split_decision`` and
    ``split.dispatch`` in the ring, and neither ``decide.dispatch`` nor
    its route; under a profiler no ``decide.dispatch`` range wraps the
    ``split.dispatch`` one."""
    sph = _real_clock_sentinel()
    resources, origins = mixed_batch(stt, sph)
    names = _profiled(lambda: sph.entry_batch(resources, origins=origins))
    assert sph.routes["split"] == 1
    ring = [s["name"] for s in sph.obs.spans.snapshot()]
    assert {"decide.split_decision", "split.dispatch"} <= set(ring)
    assert not {"decide.dispatch", "dispatch.route"} & set(ring)
    assert "split.dispatch" in names and "decide.dispatch" not in names
    sph.close()


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler running, neither the spans, the engine's ranges
    nor the ``sentinel_tpu.*`` dispatch annotations enter
    ``record_function``; with one, they do."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    sph = _real_clock_sentinel()
    pipe = stt.DispatchPipeline(sph)
    cols = _raw_columns(sph)

    def both_routes():
        pipe.submit_fused(*cols, exit_rows=cols[0][:8]).result()
        _one_dispatch(sph, "decide")
        sph.exit_batch(rows=cols[0][:8], origin_rows=cols[2][:8],
                       chain_rows=cols[4][:8], acquire=cols[5][:8],
                       rt_ms=np.full(8, 5, np.int32),
                       error=np.zeros(8, np.bool_), is_in=cols[6][:8])

    both_routes()
    assert entered == []
    assert {s["name"] for s in sph.obs.spans.snapshot()} >= set(PARTS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        both_routes()
    assert {*FUSED_RANGES, *DECIDE_RANGES, "exit.dispatch",
            "sentinel_tpu.exit"} <= set(entered)
    sph.close()


def test_obs_off_records_no_span_and_no_span_range(monkeypatch):
    """Observability off: the ring stays empty and, under a profiler,
    only the profiler-only ranges (the engine's slots, the readback)
    appear."""
    monkeypatch.setenv("SENTINEL_OBS_DISABLE", "1")
    sph = _real_clock_sentinel()
    pipe = stt.DispatchPipeline(sph)
    cols = _raw_columns(sph)
    names = set(_profiled(lambda: (
        pipe.submit_fused(*cols, exit_rows=cols[0][:8]).result(),
        _one_dispatch(sph, "decide"))))
    assert sph.obs.spans.snapshot() == []
    assert {*ENGINE_RANGES, "dispatch.readback"} <= names
    assert not names & {"fused.dispatch", "pipeline.enqueue",
                        "sentinel_tpu.fused", *PARTS, *SETTLE_PARTS}
    sph.close()


def test_detail_spans_need_the_real_clock():
    """On a virtual clock a call's parts would all last 0 ns: the ring
    keeps only the spans the reference records (the twins above agree
    on them)."""
    from sentinel_tpu_torch.obs import RuntimeObs
    for clock, want in ((stt.ManualClock(start_ms=T0), ["outer"]),
                        (None, ["outer", "inner"])):
        obs = RuntimeObs(clock=clock)
        tr = obs.spans.mint()
        with obs.span(tr, "outer", n=3):
            with obs.span(tr, "inner", detail=True):
                pass
        assert [s["name"] for s in obs.spans.snapshot()] == want
        with pytest.raises(ValueError):
            with obs.span(tr, "raised"):
                raise ValueError
        assert "raised" not in {s["name"] for s in obs.spans.snapshot()}
        obs.close()
