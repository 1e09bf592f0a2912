"""Port parity: the serving front end (``sentinel_tpu_torch.frontend``)
against ``sentinel_tpu.frontend``.

* The ``IngestQueue`` deadline policy of ``tests/test_frontend.py`` runs
  on both packages' classes under explicit virtual ``now_ms`` values; the
  env knobs and the admission gate's drop pattern are compared.
* The ``AdaptiveBatcher`` scenarios (flush on full, deadline and idle;
  batcher == a sequential ``entry_batch`` replay of its flush log; shed;
  close and re-entrant close) run on twin runtimes (``host_fast_path``
  off, the reference's tiering off, twin ManualClocks): verdicts, flush
  logs, counters, histograms,
  spans (less the worker thread's id, which differs run to run) and
  engine state equal to the reference's.
* Every workload's request list equals the reference's for three seeds.
* The HTTP endpoint, where aiohttp is installed.

Every asyncio body runs under ``asyncio.wait_for`` with a time limit, so
a hang fails the test instead of stalling the run.
"""

import asyncio

import numpy as np
import pytest

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.frontend import batcher as jfe
from sentinel_tpu.frontend import workloads as jwl
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.frontend import batcher as tfe
from sentinel_tpu_torch.frontend import workloads as twl
from sentinel_tpu_torch.obs import counters as ck

from test_torch_obs import T0, make

PKGS = {"jax": stpu, "torch": stt}
FE = {"jax": jfe, "torch": tfe}
LIMIT_S = 60


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SENTINEL_TIERING_DISABLE", "1")


def run_async(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _fe_view(sph) -> dict:
    """What twin front ends must agree on in ``sph.obs`` (spans as a
    multiset without the recording thread)."""
    o = sph.obs
    spans = sorted((s["trace"], s["name"], s["start_ns"], s["end_ns"],
                    s["n"], s["note"]) for s in o.spans.snapshot())
    links = sorted((e["src"], e["dst"], e["kind"], e["ts_ns"])
                   for e in o.spans.links_snapshot())
    return dict(
        counters=o.counters.snapshot(),
        spans=spans, links=links,
        hist={h: getattr(o, h).snapshot()
              for h in ("hist_entry", "hist_dispatch", "hist_request")},
        flight=[(r["kind"], r.get("note")) for r in o.flight.snapshot()])


def fe_twin(scenario, **over):
    """``scenario(pkg, sph, clk) -> observations`` on twin runtimes →
    the port's (runtime, observations); observations, obs views and
    state must agree with the reference's."""
    got, engines = {}, {}
    for name, pkg in PKGS.items():
        clk = pkg.ManualClock(start_ms=T0)
        sph = make(pkg, clk, **over)
        out = scenario(pkg, sph, clk)
        got[name] = (out, _fe_view(sph), convert.to_numpy(sph._state))
        engines[name] = sph
    assert got["torch"][0] == got["jax"][0]
    for key in got["jax"][1]:
        assert got["torch"][1][key] == got["jax"][1][key], key
    assert convert.leaf_diff(got["jax"][2], got["torch"][2]) == []
    engines["jax"].close()
    return engines["torch"], got["torch"][0]


def _verdicts(vs):
    return [(v.allow, v.reason, v.wait_ms, v.reason_name) for v in vs]


# ---------------------------------------------------------------------------
# IngestQueue: the pure deadline policy, both packages' classes
# ---------------------------------------------------------------------------

def _req(m, deadline_ms=T0 + 25):
    return m._Pending("r", 1, False, "", deadline_ms, 0, None)


@pytest.fixture(params=["jax", "torch"])
def fe(request):
    return FE[request.param]


def test_flush_on_full_beats_deadline(fe):
    q = fe.IngestQueue(batch_max=3, budget_ms=0)
    for _ in range(2):
        q.add(_req(fe, T0 + 100))
    assert q.flush_reason(T0) is None
    q.add(_req(fe, T0 + 100))
    assert q.flush_reason(T0) == fe.FLUSH_FULL == "full"


def test_flush_on_deadline_minus_budget(fe):
    q = fe.IngestQueue(batch_max=100, budget_ms=3)
    q.add(_req(fe, T0 + 25))
    assert q.fire_at_ms() == T0 + 22
    assert q.flush_reason(T0 + 21) is None
    assert q.flush_reason(T0 + 22) == fe.FLUSH_DEADLINE == "deadline"


def test_oldest_deadline_governs(fe):
    q = fe.IngestQueue(batch_max=100, budget_ms=0)
    q.add(_req(fe, T0 + 50))
    q.add(_req(fe, T0 + 10))
    assert q.fire_at_ms() == T0 + 10
    assert len(q.take()) == 2 and q.fire_at_ms() is None


def test_take_caps_at_batch_max_and_recomputes_min(fe):
    q = fe.IngestQueue(batch_max=2, budget_ms=0)
    for d in (30, 10, 20):
        q.add(_req(fe, T0 + d))
    assert [r.deadline_ms for r in q.take()] == [T0 + 30, T0 + 10]
    assert q.fire_at_ms() == T0 + 20


def test_idle_flush_only_when_reported_idle(fe):
    q = fe.IngestQueue(batch_max=100, budget_ms=0)
    q.add(_req(fe, T0 + 1000))
    assert q.flush_reason(T0) is None
    assert q.flush_reason(T0, idle=True) == fe.FLUSH_IDLE == "idle"
    assert q.take_all() and q.flush_reason(T0, idle=True) is None


def test_backpressure_bound_counts_inflight(fe):
    q = fe.IngestQueue(batch_max=4, queue_max=6)
    for _ in range(4):
        q.add(_req(fe))
    assert not q.would_shed(inflight=1)
    assert q.would_shed(inflight=2)
    assert fe.IngestQueue(batch_max=5).queue_max == 40


def test_admission_gate_drops_the_same_requests():
    names = [f"res-{i % 7}" for i in range(400)]
    pattern = {}
    for key, m in FE.items():
        q = m.IngestQueue(batch_max=8)
        assert all(q.admitted(n) for n in names[:5])     # wide open
        q.set_admission(0.4, seed=17)
        pattern[key] = [q.admitted(n) for n in names]
        q.set_admission(2.0)
        assert q.admit_frac == 1.0
    assert pattern["torch"] == pattern["jax"]
    assert 0.2 < np.mean(pattern["torch"]) < 0.6


def test_env_knobs(monkeypatch):
    for name in ("FRONTEND_BATCH_ENV", "FRONTEND_DEADLINE_ENV",
                 "FRONTEND_BUDGET_ENV", "FRONTEND_IDLE_ENV",
                 "FRONTEND_QUEUE_ENV"):
        assert getattr(tfe, name) == getattr(jfe, name)
    settings = [dict(), {tfe.FRONTEND_BATCH_ENV: "64",
                         tfe.FRONTEND_DEADLINE_ENV: "40",
                         tfe.FRONTEND_BUDGET_ENV: "5",
                         tfe.FRONTEND_IDLE_ENV: "2.5",
                         tfe.FRONTEND_QUEUE_ENV: "100"},
                {tfe.FRONTEND_BATCH_ENV: "not-a-number",
                 tfe.FRONTEND_DEADLINE_ENV: "0",
                 tfe.FRONTEND_IDLE_ENV: "5000",
                 tfe.FRONTEND_QUEUE_ENV: "1"}]
    for env in settings:
        for k in env:
            monkeypatch.setenv(k, env[k])

        def read(m):
            return (m.frontend_batch_max(), m.frontend_deadline_ms(),
                    m.frontend_budget_ms(), m.frontend_idle_ms(),
                    m.frontend_queue_max(64))
        assert read(tfe) == read(jfe), env
    assert read(tfe) == (256, 1, 5, 1000.0, 64)


# ---------------------------------------------------------------------------
# AdaptiveBatcher: flush triggers through a real loop, twin runtimes
# ---------------------------------------------------------------------------

def test_flush_on_full_fans_out():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=2.0)])

        async def run():
            b = pkg.AdaptiveBatcher(sph, batch_max=4, deadline_ms=10_000,
                                    idle_ms=10_000.0)
            return await asyncio.gather(*(b.submit("api")
                                          for _ in range(4)))

        vs = run_async(run())
        c = sph.obs.counters
        out = [_verdicts(vs), c.get(ck.FE_FLUSH_FULL),
               c.get(ck.FE_FLUSH_DEADLINE), c.get(ck.FE_ENQUEUE),
               sph.obs.hist_request.count, [v.trace_id for v in vs]]
        sph.close()
        return out

    _, out = fe_twin(scenario)
    assert [v[0] for v in out[0]] == [True, True, False, False]
    assert all(v[3] == "FlowException" for v in out[0] if not v[0])
    assert out[1:5] == [1, 0, 4, 4]


def test_flush_on_deadline_when_virtual_clock_advances():
    def scenario(pkg, sph, clk):
        async def run():
            b = pkg.AdaptiveBatcher(sph, batch_max=100, deadline_ms=30,
                                    budget_ms=5, idle_ms=10_000.0)
            task = asyncio.gather(b.submit("api"), b.submit("api"))
            await asyncio.sleep(0.005)
            assert b.pending == 2
            clk.advance_ms(40)
            return await task

        vs = run_async(run())
        c = sph.obs.counters
        out = [_verdicts(vs), c.get(ck.FE_FLUSH_DEADLINE),
               c.get(ck.FE_FLUSH_FULL)]
        sph.close()
        return out

    _, out = fe_twin(scenario)
    assert all(v[0] for v in out[0]) and out[1:] == [1, 0]


def test_flush_on_idle_gap():
    def scenario(pkg, sph, clk):
        async def run():
            b = pkg.AdaptiveBatcher(sph, batch_max=100, deadline_ms=60_000,
                                    idle_ms=2.0)
            vs = await asyncio.gather(b.submit("api"), b.submit("api"))
            return vs, b.pending

        vs, pending = run_async(run())
        c = sph.obs.counters
        out = [_verdicts(vs), pending, c.get(ck.FE_FLUSH_IDLE) >= 1,
               c.get(ck.FE_FLUSH_DEADLINE)]
        sph.close()
        return out

    _, out = fe_twin(scenario)
    assert all(v[0] for v in out[0]) and out[1:] == [0, True, 0]


# ---------------------------------------------------------------------------
# parity: batcher == sequential entry_batch replay == the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
def test_batcher_parity_with_sequential_entry_batch(depth):
    """Verdicts fanned out of the front end equal a sequential
    ``entry_batch`` replay of the same batch cuts on a twin runtime of the
    same package (priority bookings, origin alt rows included), and both
    equal the reference's; so do the flush logs and the state."""
    def scenario(pkg, sph, clk):
        seq = make(pkg, pkg.ManualClock(start_ms=T0))
        rules = [pkg.FlowRule(resource="r0", count=6.0),
                 pkg.FlowRule(resource="r1", count=3.0),
                 pkg.FlowRule(resource="r1", count=2.0, limit_app="app-a"),
                 pkg.FlowRule(resource="r2", count=40.0)]
        sph.load_flow_rules(rules)
        seq.load_flow_rules(rules)
        rng = np.random.default_rng(21)
        stream = [(f"r{int(rng.integers(0, 4))}", bool(rng.random() < 0.3),
                   "app-a" if rng.random() < 0.4 else "")
                  for _ in range(42)]

        async def run():
            b = sph.frontend(batch_max=8, deadline_ms=60_000,
                             idle_ms=10_000.0, depth=depth,
                             record_flushes=True)
            assert b.depth == depth
            vs = await asyncio.gather(
                *(b.submit(r, prioritized=p, origin=o)
                  for r, p, o in stream))
            await b.drain()
            return vs, b.flush_log

        vs, flush_log = run_async(run())
        assert [r for f in flush_log for r in f["resources"]] == \
            [r for r, _p, _o in stream]
        want = []
        for f in flush_log:
            v = seq.entry_batch_nowait(
                f["resources"], acquire=np.asarray(f["counts"], np.int32),
                prioritized=np.asarray(f["prioritized"], np.bool_),
                origins=(f["origins"] if any(f["origins"]) else None),
            ).result()
            want += list(zip(np.asarray(v.allow).tolist(),
                             np.asarray(v.reason).tolist(),
                             np.asarray(v.wait_ms).tolist()))
        got = [(v.allow, v.reason, v.wait_ms) for v in vs]
        assert got == want
        assert convert.leaf_diff(convert.to_numpy(seq._state),
                                 convert.to_numpy(sph._state)) == []
        totals = [sph.node_totals(r) for r in ("r0", "r1", "r2")]
        assert totals == [seq.node_totals(r) for r in ("r0", "r1", "r2")]
        seq.close()
        return got, flush_log, totals

    sph, (got, flush_log, _) = fe_twin(scenario)
    assert len(flush_log) == 6 and any(not a for a, _r, _w in got)
    sph.close()


# ---------------------------------------------------------------------------
# backpressure + lifecycle
# ---------------------------------------------------------------------------

def test_overload_shed_is_fail_fast():
    def scenario(pkg, sph, clk):
        fe_mod = FE["jax" if pkg is stpu else "torch"]

        async def run():
            b = pkg.AdaptiveBatcher(sph, batch_max=100, deadline_ms=60_000,
                                    idle_ms=10_000.0, queue_max=3)
            tasks = [asyncio.ensure_future(b.submit("api"))
                     for _ in range(3)]
            await asyncio.sleep(0.005)
            with pytest.raises(fe_mod.IngestOverload):
                await b.submit("api")
            await b.drain()
            return await asyncio.gather(*tasks)

        vs = run_async(run())
        out = [_verdicts(vs), sph.obs.counters.get(ck.FE_SHED)]
        sph.close()
        return out

    _, out = fe_twin(scenario)
    assert len(out[0]) == 3 and all(v[0] for v in out[0]) and out[1] == 1


def test_close_fails_pending_futures_no_leak():
    def scenario(pkg, sph, clk):
        async def run():
            b = sph.frontend(batch_max=100, deadline_ms=60_000,
                             idle_ms=10_000.0)
            tasks = [asyncio.ensure_future(b.submit("api"))
                     for _ in range(5)]
            await asyncio.sleep(0.005)
            assert b.pending == 5
            sph.close()
            results = await asyncio.gather(*tasks, return_exceptions=True)
            closed = [type(r).__name__ for r in results]
            try:
                await b.submit("api")
            except Exception as exc:      # FrontendClosed of its package
                closed.append(type(exc).__name__)
            return closed, b.pending

        return run_async(run())

    _, (closed, pending) = fe_twin(scenario)
    assert closed == ["FrontendClosed"] * 6 and pending == 0


def test_close_is_idempotent_and_reentrant():
    def scenario(pkg, sph, clk):
        async def run():
            b = pkg.AdaptiveBatcher(sph, batch_max=2)
            v = await b.submit("api")
            b.close()
            b.close()
            return v.allow, b._closed

        out = run_async(run())
        sph.close()
        return out

    _, out = fe_twin(scenario)
    assert out == (True, True)


def test_retune_clamps_to_provisioned_width():
    sph = make(stt, stt.ManualClock(start_ms=T0))
    b = sph.frontend(batch_max=64, budget_ms=3)
    b.retune(budget_ms=7, batch_cap=1000)
    assert (b.queue.budget_ms, b.queue.batch_max) == (7, 64)
    b.retune(batch_cap=8)
    assert b.queue.batch_max == 8 and b.batch_max == 64
    sph.close()
    assert b._closed                     # close() reached the batcher


# ---------------------------------------------------------------------------
# workload zoo: the reference's request lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jwl.WORKLOADS))
@pytest.mark.parametrize("seed", [0, 5, 9])
def test_workload_requests_equal_reference(name, seed):
    assert sorted(twl.WORKLOADS) == sorted(jwl.WORKLOADS)
    a = twl.make(name, seed, duration_ms=300.0, rate_rps=500.0)
    b = jwl.make(name, seed, duration_ms=300.0, rate_rps=500.0)
    assert [tuple(r) for r in a] == [tuple(r) for r in b]
    assert a and all(0 <= r.t_ms < 300.0 for r in a)


def test_workloads_shapes():
    reqs = twl.make("flash_crowd", 3, duration_ms=400.0, rate_rps=500.0,
                    spike_mult=8.0)
    spike = [r for r in reqs if 160 <= r.t_ms < 240]
    calm = [r for r in reqs if r.t_ms < 160]
    assert len(spike) > 2 * len(calm)
    assert sum(r.resource == "flash/hot" for r in spike) > len(spike) // 2
    reqs = twl.make("priority_mix", 4, duration_ms=300.0, rate_rps=600.0,
                    prio_frac=0.3)
    assert 0.15 < sum(r.prioritized for r in reqs) / len(reqs) < 0.45
    big = twl._zipf_ranks(np.random.default_rng(1), 500, 1.1, 16_000_000)
    ref = jwl._zipf_ranks(np.random.default_rng(1), 500, 1.1, 16_000_000)
    assert np.array_equal(big, ref) and big.min() >= 1


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------

def test_http_entry_endpoint():
    pytest.importorskip("aiohttp")
    from aiohttp.test_utils import TestClient, TestServer

    from sentinel_tpu_torch.frontend.server import make_app

    sph = make(stt, stt.ManualClock(start_ms=T0))
    sph.load_flow_rules([stt.FlowRule(resource="api", count=2.0)])

    async def run():
        b = stt.AdaptiveBatcher(sph, batch_max=4, idle_ms=0.5)
        client = TestClient(TestServer(make_app(b)))
        await client.start_server()
        try:
            r = await client.post("/v1/entry", json={"resource": "api"})
            assert r.status == 200
            body = await r.json()
            assert body["allow"] is True and body["reason"] == 0
            r = await client.post("/v1/entry_batch", json={
                "entries": [{"resource": "api"} for _ in range(4)]})
            verdicts = (await r.json())["verdicts"]
            assert [v["allow"] for v in verdicts] == [True, False, False,
                                                      False]
            assert verdicts[1]["reason_name"] == "FlowException"
            r = await client.post("/v1/entry", json={"count": 2})
            assert r.status == 400
            r = await client.get("/healthz")
            assert (await r.json())["ok"] is True
            r = await client.get("/stats")
            stats = await r.json()
            assert stats["counters"][ck.FE_ENQUEUE] == 5
            assert stats["hist_request_to_verdict"]["count"] == 5
            b.close()
            r = await client.post("/v1/entry", json={"resource": "api"})
            assert r.status == 503
        finally:
            await client.close()

    run_async(run())
    sph.close()


# ---------------------------------------------------------------------------
# request tracing through the batcher (tests/test_tracing.py)
# ---------------------------------------------------------------------------

def test_request_chain_end_to_end_through_batcher():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=1e9)])

        async def run():
            b = pkg.AdaptiveBatcher(sph, batch_max=4, deadline_ms=10_000,
                                    idle_ms=60_000)
            vs = await asyncio.gather(*(b.submit("api") for _ in range(4)))
            b.close()
            return vs

        vs = run_async(run())
        ids = [v.trace_id for v in vs]
        va = sph.obs.spans.causal(ids[0])
        names = sorted(s["name"] for s in va["spans"])
        traces = {s["trace"] for s in va["spans"]}
        batch_tr = next(ln["dst"] for ln in va["links"]
                        if ln["kind"] == "flush")
        fan = {s["trace"] for s in sph.obs.spans.causal(batch_tr)["spans"]}
        out = [[v.allow for v in vs], ids, names,
               traces.isdisjoint(ids[1:]), set(ids) <= fan, batch_tr]
        sph.close()
        return out

    _, (allow, ids, names, isolated, fanned, _) = fe_twin(scenario)
    assert all(allow) and all(ids) and len(set(ids)) == 4
    for expected in ("frontend.enqueue", "frontend.flush",
                     "pipeline.enqueue", "entry.prep", "pipeline.settle",
                     "frontend.settle"):
        assert expected in names, f"lifecycle missing {expected}: {names}"
    assert isolated and fanned


def test_flight_pins_induced_deadline_miss(tmp_path):
    def scenario(pkg, sph, clk):
        from importlib import import_module
        flight_mod = import_module(pkg.__name__ + ".obs.flight")
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=1e9)])
        d = tmp_path / pkg.__name__
        sph.obs.flight.configure(str(d), "traceapp")

        async def run():
            b = pkg.AdaptiveBatcher(sph, batch_max=8, deadline_ms=10_000,
                                    budget_ms=0, idle_ms=25)
            task = asyncio.ensure_future(b.submit("api", deadline_ms=5))
            for _ in range(4):             # let submit reach its future
                await asyncio.sleep(0)
            assert b.pending == 1
            clk.advance_ms(60_000)         # far past the 5 ms budget
            v = await task
            b.close()
            return v

        v = run_async(run())
        rec = sph.obs.flight.pinned(v.trace_id)
        out = [v.allow, v.trace_id, rec["kind"], rec["worst_ms"],
               sorted({s["name"] for s in rec["spans"]}),
               sorted(ln["kind"] for ln in rec["links"]),
               sph.obs.flight.trigger("deadline_miss", root=v.trace_id),
               sph.obs.flight.flush()]
        loaded = flight_mod.load_pinned(str(d), "traceapp")
        out += [len(loaded), loaded[0]["root"],
                sorted({s["name"] for s in loaded[0]["spans"]})]
        sph.close()
        return out

    _, out = fe_twin(scenario)
    allow, tid, kind, worst, names, links, again, flushed = out[:8]
    assert allow and tid > 0 and kind == "deadline_miss" and worst >= 59_000
    assert {"frontend.enqueue", "frontend.flush",
            "frontend.settle"} <= set(names)
    assert "flush" in links and not again and flushed == 1
    assert out[8:] == [1, tid, names]


def test_shed_trigger_pins_a_chain():
    def scenario(pkg, sph, clk):
        fe_mod = FE["jax" if pkg is stpu else "torch"]

        async def run():
            b = pkg.AdaptiveBatcher(sph, batch_max=100, deadline_ms=60_000,
                                    idle_ms=60_000.0, queue_max=1)
            task = asyncio.ensure_future(b.submit("api"))
            await asyncio.sleep(0.005)
            try:
                await b.submit("api")
                shed = False
            except fe_mod.IngestOverload:
                shed = True
            await b.drain()
            v = await task
            b.close()
            return shed, v.allow

        out = list(run_async(run()))
        out.append([r["kind"] for r in sph.obs.flight.snapshot()])
        sph.close()
        return out

    _, (shed, allow, kinds) = fe_twin(scenario)
    assert shed and allow and "shed" in kinds
