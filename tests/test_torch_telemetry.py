"""Port parity: the hot-resource telemetry (``sentinel_tpu_torch.obs.
telemetry``, ``Sentinel.telemetry``) against ``sentinel_tpu.obs.telemetry``
on one device.

* :func:`telemetry_tick` on numpy-seeded window states full of tied
  loads (small integer counters, most rows idle) against the reference's
  jitted ``telemetry_tick`` (no mesh): every output and the ring, exactly;
  and against a host recompute (stable argsort of the rolling load, ENTRY
  masked, ``np_quantiles``).
* the scenarios of ``tests/test_telemetry.py`` on twin runtimes
  (``host_fast_path=False``, the reference's tiering off, twin
  ManualClocks): the hot set against the host recompute and the
  reference, determinism, the ring wrap, one append a second, the
  readback drop, the knobs, stop/close, the ``<app>-metric`` lines and the
  flight recorder's pinned hot set. Counters, flight records and state
  are compared by the shared twin harness of ``test_torch_obs.py``.

Exact everywhere; every RT histogram row total here is far below 2^24.
The reference's three meshed scenarios (the sharded top-K against the
host recompute, determinism, the ``<app>-metric`` lines) run on the JAX
engine on its 8-device mesh, the port on 8 row blocks and both one-device
engines (the harness of ``test_torch_sharded_local.py``): the port's
blocks rank their own rows and merge, and the hot set equals the
reference's and the host recompute's, ties included.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.obs import telemetry as jtel
from sentinel_tpu.stats import window as jwin
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core.registry import ENTRY_NODE_ROW
from sentinel_tpu_torch.obs import counters as ck
from sentinel_tpu_torch.obs import resource_hist as trh
from sentinel_tpu_torch.obs import telemetry as ttel
from sentinel_tpu_torch.stats import window as twin_mod

from test_torch_obs import T0, make, twin

PKGS = {"jax": stpu, "torch": stt}
TEL = {"jax": jtel, "torch": ttel}


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SENTINEL_TIERING_DISABLE", "1")


# ---------------------------------------------------------------------------
# telemetry_tick on random states, against the reference function
# ---------------------------------------------------------------------------

def _random_window(rng, rows, buckets, now_idx, events, idle=0.6):
    """numpy leaves of a window state with small counters (ties) and a
    mix of live, stale and never-written buckets."""
    counters = rng.integers(0, 3, (rows, buckets, events)).astype(np.int32)
    counters[rng.random(rows) < idle] = 0
    choices = np.array([now_idx, now_idx - 1, now_idx - buckets,
                        jwin.NEVER], np.int32)
    stamps = choices[rng.integers(0, 4, (rows, buckets))]
    rt_sum = rng.integers(0, 500, (rows, buckets)).astype(np.float32)
    min_rt = rng.integers(0, 100, (rows, buckets)).astype(np.int32)
    return counters, stamps, rt_sum, min_rt


def _states(leaves):
    j = jwin.WindowState(*[jnp_asarray(x) for x in leaves])
    t = twin_mod.WindowState(*[torch.from_numpy(x.copy()) for x in leaves])
    return j, t


def jnp_asarray(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


def _run_ticks(seed, k, minute_on, hist_on, appends, rows=2048,
               slots=8, cursor0=0):
    """The same random states through both tick functions, ``appends``
    a list of the ticks' append flags → (jax outputs, port outputs, jax
    ring, port ring, numpy inputs) of the last tick."""
    import jax
    rng = np.random.default_rng(seed)
    s_spec_j = jwin.WindowSpec(2, 500)
    s_spec_t = twin_mod.WindowSpec(2, 500)
    m_spec_j = jwin.MINUTE_SPEC if minute_on else None
    m_spec_t = twin_mod.MINUTE_SPEC if minute_on else None
    now_ms = T0 + 777
    idx_s = s_spec_t.index_of(now_ms)
    sec = now_ms // 1000 - 1
    idx_m = twin_mod.MINUTE_SPEC.index_of(sec * 1000) if minute_on else 0
    ring_j = jtel.init_ring(slots)
    ring_t = ttel.init_ring(slots)
    ring_j = ring_j._replace(cursor=jnp_asarray(np.int32(cursor0)))
    ring_t = ring_t._replace(cursor=torch.tensor(cursor0, dtype=torch.int32))
    fn_j = jax.jit(functools.partial(jtel.telemetry_tick, s_spec_j,
                                     m_spec_j, k, None, rows))
    for append in appends:
        sec_leaves = _random_window(rng, rows, 2, idx_s, 8)
        min_leaves = _random_window(rng, rows, 60, idx_m, 8, idle=0.3)
        hist = (rng.integers(0, 50, (rows, 32)).astype(np.int32)
                if hist_on else None)
        sj, st = _states(sec_leaves)
        mj, mt = _states(min_leaves)
        outs_j, ring_j = fn_j(sj, mj, None if hist is None
                              else jnp_asarray(hist), ring_j,
                              jnp_asarray(np.int32(idx_s)),
                              jnp_asarray(np.int32(idx_m)), np.int32(append))
        outs_t, ring_t = ttel.telemetry_tick(
            s_spec_t, m_spec_t, k, st, mt,
            None if hist is None else torch.from_numpy(hist), ring_t,
            idx_s, idx_m, append)
        # the live states must be left untouched (outputs are fresh)
        assert np.array_equal(st.counters.numpy(), sec_leaves[0])
    return outs_j, outs_t, ring_j, ring_t, (sec_leaves, idx_s, hist)


def _assert_outs_equal(outs_j, outs_t):
    names = ("vals", "rows", "roll_lanes", "sec_lanes", "sec_rt",
             "entry_lanes", "entry_rt", "hist_k", "q_k")
    for name, a, b in zip(names, outs_j, outs_t):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


def _host_rank(sec_leaves, idx_s, k):
    counters, stamps = sec_leaves[0], sec_leaves[1]
    diff = np.int32(idx_s) - stamps
    mask = (diff >= 0) & (diff < 2)
    load = np.where(mask, counters[:, :, 0] + counters[:, :, 1], 0) \
        .sum(axis=1).astype(np.int64)
    load[ENTRY_NODE_ROW] = -1
    order = np.argsort(-load, kind="stable")[:k]
    return load[order], order


@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_tick_equals_reference_and_host_with_ties(k, seed):
    outs_j, outs_t, ring_j, ring_t, (sec, idx_s, hist) = _run_ticks(
        seed, k, True, True, [1])
    _assert_outs_equal(outs_j, outs_t)
    vals, rows = outs_t[0].numpy(), outs_t[1].numpy()
    h_vals, h_rows = _host_rank(sec, idx_s, k)
    assert list(rows) == list(h_rows) and list(vals) == list(h_vals)
    # many rows share each load: the tie-break decides the set
    assert len(set(vals.tolist())) < k or k == 1
    np.testing.assert_array_equal(
        outs_t[8].numpy(), trh.np_quantiles(hist[h_rows]))
    assert convert.leaf_diff(convert.to_numpy(ring_j),
                             convert.to_numpy(ring_t)) == []


@pytest.mark.parametrize("minute_on", [True, False])
@pytest.mark.parametrize("hist_on", [True, False])
def test_tick_optional_tables_match(minute_on, hist_on):
    outs_j, outs_t, ring_j, ring_t, _ = _run_ticks(
        7, 16, minute_on, hist_on, [1, 0, 1])
    _assert_outs_equal(outs_j, outs_t)
    assert convert.leaf_diff(convert.to_numpy(ring_j),
                             convert.to_numpy(ring_t)) == []


def test_tick_ring_wraps_like_the_reference():
    outs_j, outs_t, ring_j, ring_t, _ = _run_ticks(
        3, 4, True, False, [1, 1, 0, 1, 1], slots=4, cursor0=2)
    assert int(ring_t.cursor) == 6
    assert convert.leaf_diff(convert.to_numpy(ring_j),
                             convert.to_numpy(ring_t)) == []


def test_topk_rows_all_equal_loads_take_lowest_rows():
    load = torch.zeros(1000, dtype=torch.int32)
    load[0] = -1
    vals, rows = ttel.topk_rows(load, 10)
    assert rows.tolist() == list(range(1, 11)) and vals.tolist() == [0] * 10
    load[500:] = 7
    vals, rows = ttel.topk_rows(load, 5)
    assert rows.tolist() == [500, 501, 502, 503, 504]


# ---------------------------------------------------------------------------
# twin runtimes: the reference's scenarios
# ---------------------------------------------------------------------------

def _zipf_drive(pkg, s, n=300, n_res=20, seed=7):
    rng = np.random.default_rng(seed)
    for z in rng.zipf(1.5, size=n):
        name = f"res-{min(int(z) - 1, n_res - 1)}"
        try:
            s.entry(name).exit()
        except pkg.BlockException:
            pass


def _host_topk(s, k):
    st = convert.to_numpy(s._state)
    spec = s.spec.second
    diff = np.int32(spec.index_of(s.clock.now_ms())) - st["second.stamps"]
    mask = (diff >= 0) & (diff < spec.buckets)
    c = st["second.counters"]
    load = np.where(mask, c[:, :, 0] + c[:, :, 1], 0).sum(axis=1) \
        .astype(np.int64)
    load[ENTRY_NODE_ROW] = -1
    order = np.argsort(-load, kind="stable")[:k]
    return load[order], order


def _tel_view(s):
    snap = s.telemetry.snapshot(timeline_limit=200)
    raw = s.telemetry.last_topk
    ring = (None if s.telemetry._ring is None
            else {k: v.tolist() for k, v in
                  convert.to_numpy(s.telemetry._ring).items()})
    return dict(snap=snap, raw=None if raw is None else
                [np.asarray(x).tolist() for x in raw], ring=ring)


def test_single_device_topk_matches_host_and_reference(tmp_path):
    def scenario(pkg, s, clk):
        assert s.telemetry.enabled and s.telemetry._n_shards == 1
        _zipf_drive(pkg, s, seed=11)
        clk.advance_ms(50)
        assert s.telemetry.poll() == 1
        loads, rows = s.telemetry.last_topk
        h_loads, h_rows = _host_topk(s, s.telemetry.k)
        assert list(rows) == list(h_rows)
        assert list(loads) == list(h_loads)
        hot = s.telemetry.hot_entries()
        assert hot and all(h["load"] > 0 for h in hot)
        return _tel_view(s)

    twin(scenario, tmp_path)


def test_many_tied_loads_match_reference(tmp_path):
    """40 resources entered exactly twice each and 30 once: the hot set
    is decided by the tie-break alone."""
    def scenario(pkg, s, clk):
        for rep in range(2):
            for i in range(40):
                s.entry(f"tie-{i}").exit()
        for i in range(30):
            s.entry(f"one-{i}").exit()
        clk.advance_ms(20)
        s.telemetry.poll()
        loads, rows = s.telemetry.last_topk
        h_loads, h_rows = _host_topk(s, s.telemetry.k)
        assert list(rows) == list(h_rows) and list(loads) == list(h_loads)
        assert len(set(np.asarray(loads).tolist())) == 1
        return _tel_view(s)

    twin(scenario, tmp_path, max_resources=128)


def test_manual_clock_determinism(tmp_path):
    views = []
    for rep in range(2):
        def scenario(pkg, s, clk):
            _zipf_drive(pkg, s, seed=3)
            clk.advance_ms(1500)        # one completed second → timeline
            s.telemetry.poll()
            snap = s.telemetry.snapshot()
            assert snap["timeline"]
            return [snap["hot"], snap["timeline"]]

        _, obs, _ = twin(scenario, tmp_path / str(rep))
        views.append(obs)
    assert views[0] == views[1]


def test_timeline_ring_wraps_past_slots(tmp_path):
    slots, appends = 8, 13

    def scenario(pkg, s, clk):
        s.telemetry.ring_slots = slots
        for _ in range(appends):
            try:
                s.entry("svc").exit()
            except pkg.BlockException:
                pass
            clk.advance_ms(1000)
            assert s.telemetry.poll() == 1
        ring = convert.to_numpy(s.telemetry._ring)
        assert int(ring["cursor"]) == appends
        first = T0 // 1000 + appends - slots
        assert sorted(ring["seconds"].tolist()) == list(
            range(first, first + slots))
        tl = s.telemetry.snapshot(timeline_limit=appends)["timeline"]
        assert [e["sec"] for e in tl] == [T0 // 1000 + i
                                         for i in range(appends)]
        assert all(e["pass"] == 1 for e in tl)
        return _tel_view(s)

    twin(scenario, tmp_path)


def test_tick_appends_once_per_second(tmp_path):
    def scenario(pkg, s, clk):
        s.entry("svc").exit()
        clk.advance_ms(1200)
        s.telemetry.poll()
        clk.advance_ms(100)             # same wall second
        s.telemetry.poll()
        tl = s.telemetry.snapshot()["timeline"]
        assert len(tl) == 1 and tl[0]["sec"] == T0 // 1000
        return _tel_view(s)

    twin(scenario, tmp_path)


def test_readback_drop_counts_when_drain_falls_behind(tmp_path):
    def scenario(pkg, s, clk):
        pmax = TEL["jax" if pkg is stpu else "torch"].PENDING_MAX
        out = [s.telemetry.tick() for _ in range(pmax + 1)]
        snap = s.telemetry.snapshot()
        out += [snap["drops"], snap["ticks"], s.telemetry.drain(),
                s.telemetry.tick(), s.telemetry.drain()]
        return out

    _, out, _ = twin(scenario, tmp_path)
    assert out == [True, True, False, 1, 2, 2, True, 1]
    assert ttel.PENDING_MAX == jtel.PENDING_MAX == 2


def test_knob_envs(monkeypatch):
    for name in ("TELEMETRY_K_ENV", "TELEMETRY_DISABLE_ENV", "DEFAULT_K",
                 "MAX_K", "RING_SLOTS", "FLIGHT_HOT_N"):
        assert getattr(ttel, name) == getattr(jtel, name), name
    monkeypatch.setenv(ttel.TELEMETRY_K_ENV, "4")
    s = make(stt, stt.ManualClock(start_ms=T0))
    assert s.telemetry.k == 4
    s.close()
    monkeypatch.setenv(ttel.TELEMETRY_K_ENV, "999")
    assert ttel.telemetry_k() == jtel.telemetry_k() == ttel.MAX_K
    monkeypatch.setenv(ttel.TELEMETRY_K_ENV, "x")
    assert ttel.telemetry_k() == jtel.telemetry_k() == ttel.DEFAULT_K
    monkeypatch.setenv(ttel.TELEMETRY_DISABLE_ENV, "1")
    s2 = make(stt, stt.ManualClock(start_ms=T0))
    assert not s2.telemetry.enabled and not s2.telemetry.tick()
    assert s2.obs.flight.hot_provider is None
    s2.close()
    monkeypatch.delenv(ttel.TELEMETRY_DISABLE_ENV)
    monkeypatch.setenv("SENTINEL_OBS_DISABLE", "1")
    s3 = make(stt, stt.ManualClock(start_ms=T0))
    assert not s3.telemetry.enabled
    s3.close()


def test_stop_is_idempotent_and_close_stops_it():
    s = make(stt, stt.ManualClock(start_ms=T0))
    s.telemetry.start(interval_sec=60)
    assert s.telemetry._thread is not None
    s.close()                           # shutdown hook stops the ticker
    assert s.telemetry._thread is None and not s.telemetry.enabled
    s.telemetry.stop()                  # second stop is a no-op
    assert not s.telemetry.tick()


def test_metric_lines_roundtrip_for_topk_only(tmp_path):
    def scenario(pkg, s, clk):
        from importlib import import_module
        searcher = import_module(pkg.__name__ + ".metrics.searcher")
        d = tmp_path / ("metric_" + pkg.__name__)
        base = s.telemetry.configure(str(d), "telapp")
        assert base.startswith("telapp-metric")
        clk.advance_ms(600)
        for _ in range(5):
            s.entry("hot-res").exit()
        s.entry("cold-res").exit()
        clk.advance_ms(450)             # completes second T0/1000
        assert s.telemetry.poll() == 1
        found = searcher.MetricSearcher(str(d), base).find(
            T0 - 1000, T0 + 10_000)
        by_res = {n.resource: n for n in found}
        assert by_res["hot-res"].pass_qps == 5
        assert by_res["cold-res"].pass_qps == 1
        s.telemetry.stop()
        files = sorted(p.name for p in d.iterdir())
        body = [(d / f).read_bytes() for f in files
                if not f.endswith(".idx")]
        return [[dataclasses.asdict(n) for n in found], body]

    twin(scenario, tmp_path)


def test_flight_trigger_pins_hot_set(tmp_path):
    def scenario(pkg, s, clk):
        assert s.obs.flight.hot_provider is not None
        _zipf_drive(pkg, s, n=80, seed=9)
        clk.advance_ms(10)
        s.telemetry.poll()
        tr = s.obs.spans.mint()
        ns = s.obs.spans.now_ns()
        s.obs.spans.record(tr, "frontend.enqueue", ns, ns)
        assert s.obs.flight.trigger("block_burst", note="test")
        rec = s.obs.flight.snapshot(full=True)[-1]
        assert rec["hot"] and rec["hot"][0]["resource"].startswith("res-")
        assert all(set(h) == {"resource", "qps"} for h in rec["hot"])
        return rec["hot"]

    twin(scenario, tmp_path)


def test_counters_tick_and_dispatch(tmp_path):
    def scenario(pkg, s, clk):
        s.entry_batch(["a", "b", "a"])
        s.telemetry.poll()
        s.telemetry.poll()
        return s.obs.counters.get(ck.TELEMETRY_TICK)

    sph, ticks, _ = twin(scenario, tmp_path)
    assert ticks == 2
    assert sph.obs.counters.get(ck.PIPE_DISPATCH) == 3


def test_carry_api_claims_and_queues(tmp_path):
    """The carry surface (for a serving dispatch that runs the tick in
    its epilogue): the claim's host scalars, the drop bound and a queued
    carried tick land exactly as the reference's."""
    def scenario(pkg, s, clk):
        tel = s.telemetry
        out = [tel.carry_due_locked(clk.now_ms())]       # not armed
        tel.arm_carry(100)
        out.append(tel.carry_due_locked(clk.now_ms()))   # not due
        s.entry("x").exit()
        clk.advance_ms(1100)
        prep = tel.carry_due_locked(clk.now_ms())
        out.append(list(prep))
        out.append(tel.last_tick_ms())
        with s._lock:
            ring = tel.ring_for_fuse_locked()
            st = s._state
            if pkg is stpu:
                import jax.numpy as jnp
                outs, ring = jtel.telemetry_tick(
                    s.spec.second, s.spec.minute, tel.k, None, s.spec.rows,
                    st.second, st.minute, st.rt_hist, ring,
                    jnp.int32(prep[3]), jnp.int32(prep[4]),
                    np.int32(prep[2]))
            else:
                outs, ring = ttel.telemetry_tick(
                    s.spec.second, s.spec.minute, tel.k, st.second,
                    st.minute, st.rt_hist, ring, prep[3], prep[4], prep[2])
            tel.queue_carry(prep, outs, ring)
        out.append(tel.drain())
        tel.disarm_carry()
        clk.advance_ms(500)
        out.append(tel.carry_due_locked(clk.now_ms()))
        return out + [_tel_view(s)]

    twin(scenario, tmp_path)


# ---------------------------------------------------------------------------
# the reference's meshed scenarios: 8 row blocks against its 8 devices
# ---------------------------------------------------------------------------

def _meshed_view(s):
    """:func:`_tel_view` less the layout fields, which are checked
    against the engine's mesh here (8 blocks of 8 rows, or 1 of 64)."""
    view = _tel_view(s)
    n = 8 if s.mesh is not None else 1
    assert s.telemetry._n_shards == n
    assert s.telemetry._rows_per_shard == s.spec.rows // n
    snap = view["snap"]
    for key in ("n_shards", "rows_per_shard"):
        for holder in [snap] + [v for v in snap.values()
                                if isinstance(v, dict)]:
            if key in holder:
                assert holder[key] == (n if key == "n_shards"
                                       else s.spec.rows // n)
                del holder[key]
    return view


def test_sharded_topk_bit_equal_to_host_recompute():
    from test_torch_sharded_local import trio

    def scenario(pkg, s):
        assert s.telemetry.enabled
        _zipf_drive(pkg, s)
        s.clock.advance_ms(100)
        assert s.telemetry.poll() == 1
        loads, rows = s.telemetry.last_topk
        h_loads, h_rows = _host_topk(s, s.telemetry.k)
        assert list(rows) == list(h_rows)
        assert list(loads) == list(h_loads)
        hot = s.telemetry.hot_entries()
        assert hot and hot[0]["load"] == int(h_loads[0])
        assert all(h["load"] > 0 and h["resource"] != "" for h in hot)
        return _meshed_view(s)

    trio(scenario).close()


def test_meshed_manual_clock_determinism():
    from test_torch_sharded_local import trio
    views = []
    for _rep in range(2):
        def scenario(pkg, s):
            _zipf_drive(pkg, s, seed=3)
            s.clock.advance_ms(1500)        # one completed second
            s.telemetry.poll()
            snap = s.telemetry.snapshot()
            assert snap["timeline"]
            return [snap["hot"], snap["timeline"]]

        sh = trio(scenario)
        snap = sh.telemetry.snapshot()
        views.append([snap["hot"], snap["timeline"]])
        sh.close()
    assert views[0] == views[1]


def test_meshed_metric_lines_roundtrip_for_topk_only(tmp_path):
    from test_torch_sharded_local import trio

    def scenario(pkg, s):
        from importlib import import_module
        searcher = import_module(pkg.__name__ + ".metrics.searcher")
        kind = f"{pkg.__name__}_{'mesh' if s.mesh is not None else 'one'}"
        d = tmp_path / kind
        base = s.telemetry.configure(str(d), "telapp")
        s.clock.advance_ms(600)
        for _ in range(5):
            s.entry("hot-res").exit()
        s.entry("cold-res").exit()
        s.clock.advance_ms(450)             # completes second T0/1000
        assert s.telemetry.poll() == 1
        found = searcher.MetricSearcher(str(d), base).find(
            T0 - 1000, T0 + 10_000)
        by_res = {n.resource: n for n in found}
        assert by_res["hot-res"].pass_qps == 5
        assert by_res["cold-res"].pass_qps == 1
        assert all(n.timestamp == (T0 // 1000) * 1000 for n in found)
        s.telemetry.stop()
        files = sorted(p.name for p in d.iterdir())
        body = [(d / f).read_bytes() for f in files
                if not f.endswith(".idx")]
        return [[dataclasses.asdict(n) for n in found], body]

    trio(scenario).close()
