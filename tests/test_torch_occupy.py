"""Port parity: prioritized admission (occupy) of ``sentinel_tpu_torch``
against ``sentinel_tpu``, module by module, as fused engine steps and
through twin runtimes.

Every input is made from a numpy seed and handed to both packages; the
comparisons are exact (verdicts, ``occupied``, ``sf_overflow`` and every
state leaf). The occupy math is float32 over integer-valued operands
(window counts, bookings, ranks × a uniform acquire): every such sum here
stays below 2^24, where float32 addition is exact in any order and a
contracted ``a*b+c`` rounds like the separate multiply and add.

The sort-free variants run at the default claim-table size and with
``SENTINEL_SORTFREE_BITS`` forced tiny on both sides, so that the claim
cascade overflows and the sorted order is selected. The JAX package reads
that knob when it traces a step and shares traced steps between engines of
one geometry, so the runtime twins that set it use a geometry of their
own.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.core.clock import ManualClock
from sentinel_tpu.engine import pipeline as jp
from sentinel_tpu.obs import counters as obs_keys
from sentinel_tpu.rules import flow as jflow
from sentinel_tpu.stats import events as jev
from sentinel_tpu.stats import window as jw
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.engine import pipeline as tp
from sentinel_tpu_torch.rules import flow as tflow
from sentinel_tpu_torch.stats import window as tw

from test_torch_engine import _port_spec
from test_torch_general import (
    _events, _ids, _jax_dyn, _jax_window, _random_state, _sentinel,
)

torch.set_num_threads(2)

T0 = 1_785_000_000_000       # T0 % 500 == 0
TINY_BITS = "2"
NEVER = -(2 ** 30)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _same(want_tree, got_tree, tag):
    assert convert.leaf_diff(convert.to_numpy(want_tree),
                             convert.to_numpy(got_tree)) == [], tag


# ---------------------------------------------------------------------------
# stats/window.py: settle_occupied and uncount_rows
# ---------------------------------------------------------------------------

def _random_window(rng, rows, buckets, now_idx, track_rt=True):
    """A window with live, rotated and dead buckets (numpy)."""
    b_rt = buckets if track_rt else 0
    return dict(
        counters=rng.integers(0, 9, (rows, buckets, 8)).astype(np.int32),
        stamps=np.where(rng.random((rows, buckets)) < 0.1, NEVER,
                        now_idx - rng.integers(-1, 2 * buckets + 2,
                                               (rows, buckets))
                        ).astype(np.int32),
        rt_sum=rng.integers(0, 500, (rows, b_rt)).astype(np.float32),
        min_rt=rng.integers(0, 90, (rows, b_rt)).astype(np.int32))


@pytest.mark.parametrize("buckets,track_rt", [(2, True), (4, True),
                                              (3, False)])
def test_settle_occupied_matches(buckets, track_rt):
    """Landed bookings (age 0..B-1) credit PASS into their target bucket,
    resetting and restamping it where it is dead or rotated; pending ones
    (age -1) come back for the fresh ring; expired and empty slots drop."""
    rng = np.random.default_rng(31 + buckets)
    spec_j = jw.WindowSpec(buckets, 500, track_rt)
    spec_t = tw.WindowSpec(buckets, 500, track_rt)
    rows, slots = 512, buckets + 1
    for now_idx in (1_785_000_001, 2 ** 31 - 1, -5):
        win = _random_window(rng, rows, buckets, now_idx, track_rt)
        ages = rng.integers(-2, buckets + 3, (rows, slots))
        occ_win = np.where(rng.random((rows, slots)) < 0.15, NEVER,
                           now_idx - ages).astype(np.int32)
        occ_cnt = np.where(rng.random((rows, slots)) < 0.3, 0.0,
                           rng.integers(1, 6, (rows, slots))
                           ).astype(np.float32)
        want = jax.jit(functools.partial(
            jw.settle_occupied, spec_j, event=jev.PASS))(
            jw.WindowState(**{k: _j(v) for k, v in win.items()}),
            _j(occ_cnt), _j(occ_win), jnp.int32(now_idx))
        got = tw.settle_occupied(
            spec_t, tw.WindowState(**{k: _t(v) for k, v in win.items()}),
            _t(occ_cnt), _t(occ_win), now_idx, tw.ev.PASS)
        _same(want[0], got[0], f"window at {now_idx}")
        for w, g in zip(want[1:], got[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # every case was present
        age = (now_idx - occ_win.astype(np.int64) + 2 ** 31) % 2 ** 32 \
            - 2 ** 31
        assert ((age == -1) & (occ_cnt > 0)).any()
        assert ((age >= 0) & (age < buckets) & (occ_cnt > 0)).any()
        assert ((age >= buckets) & (occ_cnt > 0)).any()


@pytest.mark.parametrize("buckets", [2, 60])
def test_uncount_rows_matches(buckets):
    """A subtraction only where the bucket still holds the stamp; padding
    rows (>= R) drop."""
    rng = np.random.default_rng(41)
    spec_j = jw.WindowSpec(buckets, 1000)
    spec_t = tw.WindowSpec(buckets, 1000)
    rows_n, n, now_idx = 300, 257, 1_785_000
    win = _random_window(rng, rows_n, buckets, now_idx)
    # bucket k holds the latest index with that residue, or one a lap older
    k = np.arange(buckets)
    latest = now_idx - (now_idx - k) % buckets
    win["stamps"] = (latest[None, :] - buckets * (
        rng.random((rows_n, buckets)) < 0.3)).astype(np.int32)
    rows = rng.integers(0, rows_n, n).astype(np.int32)
    rows[::9] = rows_n                                  # padding drops
    idxs = (now_idx - rng.integers(0, buckets + 2, n)).astype(np.int32)
    live = win["stamps"][np.minimum(rows, rows_n - 1),
                         idxs % buckets] == idxs
    assert live.any() and (~live).any()
    amounts = rng.integers(1, 30, n).astype(np.int32)
    want = jax.jit(functools.partial(jw.uncount_rows, spec_j,
                                     event=jev.PASS))(
        jw.WindowState(**{k: _j(v) for k, v in win.items()}), _j(rows),
        _j(idxs), amounts=_j(amounts))
    got = tw.uncount_rows(
        spec_t, tw.WindowState(**{k: _t(v) for k, v in win.items()}),
        _t(rows), _t(idxs), tw.ev.PASS, _t(amounts))
    _same(want, got, "uncount")


# ---------------------------------------------------------------------------
# rules/flow.py: flow_check(enable_occupy) and flow_check_fast(occupy)
# ---------------------------------------------------------------------------

def _with_bookings(d, sph, rng):
    """Live bookings on a third of the rows: landed, pending and stale."""
    idx = sph.spec.second.index_of(sph.clock.now_ms())
    shp = d["flow_dyn.occupied_count"].shape
    d["flow_dyn.occupied_count"] = np.where(
        rng.random(shp) < 0.33, rng.integers(1, 3, shp), 0).astype(
        np.float32)
    d["flow_dyn.occupied_window"] = (idx - rng.integers(-1, 4, shp)
                                     ).astype(np.int32)
    return d


@pytest.mark.parametrize("sortfree", ["on", "off", "tiny_bits"])
@pytest.mark.parametrize("path", ["general", "fast"])
def test_occupy_flow_checks_match(path, sortfree, monkeypatch):
    if sortfree == "tiny_bits":
        monkeypatch.setenv("SENTINEL_SORTFREE_BITS", TINY_BITS)
    clk = ManualClock(start_ms=T0 + 250)
    sph = _sentinel(clk)
    origin_ids, ctx_ids = _ids(sph)
    spec = sph.spec
    tspec = _port_spec(spec)
    rs = sph._ruleset
    trs = convert.ruleset_from_numpy(convert.to_numpy(rs))
    rng = np.random.default_rng(51)
    sf = sortfree != "off"
    if path == "general":
        fn_j = (jflow.flow_check_sortfree if sf else functools.partial(
            jflow.flow_check, sortfree=False))
        fn_j = functools.partial(fn_j, enable_occupy=True)
        fn_t = tflow.flow_check
    else:
        fn_j = (jflow.flow_check_fast_occupy_sortfree if sf
                else jflow.flow_check_fast_occupy)
        fn_t = tflow.flow_check_fast
    jitted = jax.jit(lambda tbl, dyn, ridx, sec, alt, thr, athr, view, i_s,
                     rel, minute, i_m, in_win: fn_j(
                         tbl, dyn, ridx, spec.second, sec, alt, thr, athr,
                         view, i_s, rel, minute_spec=spec.minute,
                         main_minute=minute, now_idx_m=i_m, in_win_ms=in_win,
                         occupy_timeout_ms=500))
    occupied = 0
    for trial, share in enumerate((0.0, 0.3, 1.0, 0.3, 1.0, 0.3)):
        d = _with_bookings(_random_state(sph, rng), sph, rng)
        tstate = convert.state_from_numpy(d)
        e = _events(sph, rng, 64, origin_ids, ctx_ids,
                    "mixed" if path == "general" else 1 + trial % 2)
        e["prioritized"] = rng.random(64) < share
        times = [int(x) for x in np.asarray(sph._time_scalars(clk.now_ms()))]
        fb = np.zeros(64, np.int32)
        cols = ("rows", "origin_ids", "origin_rows", "context_ids",
                "chain_rows", "acquire", "valid", "prioritized")
        jview = jflow.FlowBatchView(**{k: _j(e[k]) for k in cols},
                                    cluster_fallback=_j(fb))
        tview = tflow.FlowBatchView(**{k: _t(e[k]) for k in cols},
                                    cluster_fallback=_t(fb))
        want = jitted(rs.flow_table, _jax_dyn(d), rs.flow_idx,
                      _jax_window(d, "second"), _jax_window(d, "alt_second"),
                      jnp.asarray(d["threads"]), jnp.asarray(d["alt_threads"]),
                      jview, jnp.int32(times[0]), jnp.int32(times[2]),
                      _jax_window(d, "minute"), jnp.int32(times[1]),
                      jnp.int32(times[3]))
        got = fn_t(trs.flow_table, tstate.flow_dyn, trs.flow_idx,
                   tspec.second, tstate.second, tstate.alt_second,
                   tstate.threads, tstate.alt_threads, tview, times[0],
                   times[2], minute_spec=tspec.minute,
                   main_minute=tstate.minute, now_idx_m=times[1],
                   sortfree=sf, in_win_ms=times[3], occupy_timeout_ms=500,
                   enable_occupy=True, any_prio=bool(e["prioritized"].any()))
        if not sf:
            assert int(got[4]) == 0
            got = got[:4]
        assert len(got) == len(want)
        _same(want[0], got[0], f"dyn, trial {trial}")
        for k, (g, w) in enumerate(zip(got[1:], want[1:])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"output {k}, {trial}")
        occupied += int(np.asarray(want[3]).sum())
        if share == 0.0:
            assert not np.asarray(want[3]).any()
        clk.advance_ms(int(rng.integers(100, 900)))
    assert occupied > 0


# ---------------------------------------------------------------------------
# engine/pipeline.py: fused decide+exit steps with occupy
# ---------------------------------------------------------------------------

def _scalar_events(e, spec):
    """The scalar route's batch: no origins, contexts or priority."""
    n = e["rows"].shape[0]
    return dict(e, origin_ids=np.zeros(n, np.int32),
                origin_rows=np.full(n, spec.alt_rows, np.int32),
                context_ids=np.zeros(n, np.int32),
                chain_rows=np.full(n, spec.alt_rows, np.int32),
                acquire=np.full(n, 2, np.int32),
                prioritized=np.zeros(n, np.bool_))


@pytest.mark.parametrize("sortfree", ["on", "off", "tiny_bits"])
@pytest.mark.parametrize("route", ["scalar", "fast", "general"])
def test_fused_occupy_steps_match_leaf_by_leaf(route, sortfree,
                                               monkeypatch):
    """Steps over several windows with 30% prioritized events. The
    ``scalar`` variant alternates the scalar step (occupy_base: it reads
    the bookings) with fast steps that make them, as a split does."""
    if sortfree == "tiny_bits":
        monkeypatch.setenv("SENTINEL_SORTFREE_BITS", TINY_BITS)
    clk = ManualClock(start_ms=T0)
    sph = _sentinel(clk)
    origin_ids, ctx_ids = _ids(sph)
    spec = sph.spec
    tspec = _port_spec(spec)
    base = dict(skip_auth=sph._skip_auth, skip_sys=sph._skip_sys,
                scalar_has_rl=sph._scalar_has_rl,
                skip_threads=sph._skip_threads, sortfree=sortfree != "off")
    variants = {
        "scalar": dict(base, scalar_flow=True, record_alt=False),
        "fast": dict(base, fast_flow=True, record_alt=True),
        "general": dict(base, record_alt=True)}
    jsteps = {k: jax.jit(functools.partial(
        jp.decide_and_record_exits, spec, enable_occupy=True, **f))
        for k, f in variants.items()}
    trules = convert.ruleset_from_numpy(convert.to_numpy(sph._ruleset))
    js = sph._state
    ts = convert.state_from_numpy(convert.to_numpy(js))
    rng = np.random.default_rng(61)
    n, ra = 64, spec.alt_rows
    prev = None
    sysv = np.array([0.25, 0.1], np.float32)
    occupied = overflowed = 0
    for step in range(14):
        kind = route
        if route == "scalar" and step % 2 == 0:
            kind = "fast"
        eb = _events(sph, rng, n, origin_ids, ctx_ids,
                     "mixed" if kind == "general" else 2)
        if kind == "scalar":
            eb = _scalar_events(eb, spec)
        else:
            eb["prioritized"] = rng.random(n) < 0.3
        if prev is None:
            xb = dict(rows=np.full(n, spec.rows, np.int32),
                      origin_rows=np.full(n, ra, np.int32),
                      chain_rows=np.full(n, ra, np.int32),
                      acquire=np.ones(n, np.int32),
                      valid=np.zeros(n, np.bool_))
        else:
            xb = dict(prev)
            if kind == "scalar":
                xb.update(origin_rows=np.full(n, ra, np.int32),
                          chain_rows=np.full(n, ra, np.int32))
        xb.update(rt_ms=rng.integers(0, 90, n).astype(np.int32),
                  error=rng.random(n) < 0.4, is_in=rng.random(n) > 0.2)
        times = np.asarray(sph._time_scalars(clk.now_ms()))
        js, jv = jsteps[kind](
            sph._ruleset, js,
            jp.EntryBatch(**{k: _j(a) for k, a in eb.items()}),
            jp.ExitBatch(**{k: _j(a) for k, a in xb.items()}),
            jnp.asarray(times), jnp.asarray(sysv))
        ts, tv = tp.decide_and_record_exits(
            tspec, trules, ts,
            tp.EntryBatch(**{k: _t(a) for k, a in eb.items()}),
            tp.ExitBatch(**{k: _t(a) for k, a in xb.items()}),
            tuple(int(x) for x in times), tuple(float(x) for x in sysv),
            enable_occupy=True, any_prio=bool(eb["prioritized"].any()),
            **variants[kind])
        for f in ("allow", "reason", "wait_ms"):
            np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                          np.asarray(getattr(jv, f)),
                                          err_msg=f"{f}, step {step}")
        if base["sortfree"]:
            assert int(tv.sf_overflow) == int(jv.sf_overflow)
            overflowed += int(jv.sf_overflow)
        _same(js, ts, f"step {step} ({kind})")
        if kind != "scalar":
            occupied += int((np.asarray(jv.allow) & eb["prioritized"]
                             & (np.asarray(jv.wait_ms) > 0)).sum())
        ok = np.asarray(jv.allow) & eb["valid"]
        prev = dict(rows=np.where(ok, eb["rows"], spec.rows).astype(
                        np.int32),
                    origin_rows=eb["origin_rows"],
                    chain_rows=eb["chain_rows"], acquire=eb["acquire"],
                    valid=ok)
        clk.advance_ms(int(rng.integers(60, 400)))
    assert occupied > 0
    assert (overflowed > 0) == (sortfree == "tiny_bits")


# ---------------------------------------------------------------------------
# twin runtimes: the reference's occupy scenarios (tests/test_occupy.py)
# ---------------------------------------------------------------------------

PKGS = {"jax": stpu, "torch": stt}
ROUTE_KEYS = {"scalar": obs_keys.ROUTE_SCALAR, "fast": obs_keys.ROUTE_FAST,
              "fast_occupy": obs_keys.ROUTE_FAST_OCCUPY,
              "general": obs_keys.ROUTE_GENERAL,
              "split": obs_keys.ROUTE_SPLIT, "fused": obs_keys.ROUTE_FUSED}


def _make(pkg, clk, **over):
    """A Sentinel of ``pkg`` (default config: host fast path on)."""
    cfg = pkg.load_config(**{**dict(max_resources=64, max_flow_rules=16,
                                    max_degrade_rules=16,
                                    max_authority_rules=16), **over})
    extra = {"device": "cpu"} if pkg is stt else {}
    sph = pkg.Sentinel(config=cfg, clock=clk, **extra)
    sph._cpu.sample = lambda: (0.5, 0.25)
    return sph


def _drain(pkg, sph, resource, n, **kw):
    out = []
    for _ in range(n):
        try:
            e = sph.entry(resource, **kw)
            out.append("pass")
            e.exit()
        except pkg.BlockException:
            out.append("block")
    return out


def _twin(scenario, **over):
    """Run ``scenario(pkg, sph, clk) -> observations`` on both packages
    (twin ManualClocks) → the port's engine; the observations, the whole
    engine state and the routes must agree."""
    got, engines = {}, {}
    for name, pkg in PKGS.items():
        clk = pkg.ManualClock(start_ms=T0)
        sph = _make(pkg, clk, **over)
        got[name] = scenario(pkg, sph, clk)
        engines[name] = sph
    js, ts = engines["jax"], engines["torch"]
    assert got["torch"] == got["jax"]
    _same(js._state, ts._state, "state")
    c = js.obs.counters
    assert {k: ts.routes.get(k, 0) for k in ROUTE_KEYS} == {
        k: c.get(v) for k, v in ROUTE_KEYS.items()}
    return ts, got["torch"]


def _svc(pkg, sph, count=2):
    sph.load_flow_rules([pkg.FlowRule(resource="svc", count=count)])


def test_twin_prioritized_waits_into_next_window():
    def scenario(pkg, sph, clk):
        _svc(pkg, sph)
        obs = [_drain(pkg, sph, "svc", 2)]
        clk.advance_ms(500)
        obs.append(_drain(pkg, sph, "svc", 1))
        before = clk.now_ms()
        e = sph.entry("svc", prioritized=True)
        obs.append(clk.now_ms() - before)
        e.exit()
        # a full current bucket leaves no next-window headroom
        clk.advance_ms(1000)
        obs.append(_drain(pkg, sph, "svc", 2))
        try:
            sph.entry("svc", prioritized=True).exit()
            obs.append("pass")
        except pkg.BlockException:
            obs.append("block")
        return obs
    ts, obs = _twin(scenario)
    assert obs[2] == 500 and obs[-1] == "block"
    assert ts.routes["fast_occupy"] >= 2


def test_twin_occupied_booking_consumes_next_window_budget():
    def scenario(pkg, sph, clk):
        _svc(pkg, sph)
        _drain(pkg, sph, "svc", 2)
        clk.advance_ms(500)
        sph.entry("svc", prioritized=True).exit()
        return _drain(pkg, sph, "svc", 3)
    _, obs = _twin(scenario)
    assert obs == ["pass", "block", "block"]


def test_twin_occupy_headroom_is_bounded():
    def scenario(pkg, sph, clk):
        _svc(pkg, sph)
        _drain(pkg, sph, "svc", 2)
        clk.advance_ms(500)
        out = []
        for _ in range(4):
            t = clk.now_ms()
            try:
                sph.entry("svc", prioritized=True, sleep=False).exit()
                out.append(("pass", clk.now_ms() - t))
            except pkg.BlockException:
                out.append(("block", 0))
        return out
    _, obs = _twin(scenario)
    assert [o for o, _ in obs].count("pass") <= 2


def test_twin_occupied_entry_records_occupied_and_success():
    def scenario(pkg, sph, clk):
        _svc(pkg, sph, count=1)
        _drain(pkg, sph, "svc", 1)
        clk.advance_ms(500)
        e = sph.entry("svc", prioritized=True)
        e.exit()
        t = sph.node_totals("svc")
        t.pop("avg_rt", None)
        return [t]
    ts, obs = _twin(scenario)
    assert obs[0]["success"] >= 1 and obs[0]["block"] == 0
    # the OCCUPIED_PASS event sits in the grant second's minute bucket
    row = ts.resources.lookup("svc")
    sec = (T0 + 500) // 1000
    k = sec % ts.spec.minute.buckets
    m = ts._state.minute
    assert int(m.stamps[row, k]) == tw.wrap_i32(sec)
    assert int(m.counters[row, k, tw.ev.OCCUPIED_PASS]) == 1


def test_twin_occupy_disabled_blocks_prioritized():
    def scenario(pkg, sph, clk):
        _svc(pkg, sph, count=1)
        _drain(pkg, sph, "svc", 1)
        clk.advance_ms(500)
        return _drain(pkg, sph, "svc", 1, prioritized=True)
    _, obs = _twin(scenario, occupy_timeout_ms=0)
    assert obs == ["block"]


def test_twin_non_default_behavior_never_occupies():
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(
            resource="wu", count=100, control_behavior=pkg.BEHAVIOR_WARM_UP,
            warm_up_period_sec=10)])
        res = _drain(pkg, sph, "wu", 40)
        return res + _drain(pkg, sph, "wu", 1, prioritized=True)
    _, obs = _twin(scenario)
    assert "block" in obs[:-1] and obs[-1] == "block"


def _book_pending(pkg, sph):
    _drain(pkg, sph, "svc", 2)
    sph.clock.advance_ms(500)
    v = sph.entry_batch(["svc"], prioritized=[True])
    return [bool(v.allow[0]), int(v.wait_ms[0])]


def test_twin_pending_booking_survives_rule_reload():
    def scenario(pkg, sph, clk):
        _svc(pkg, sph)
        obs = _book_pending(pkg, sph)
        _svc(pkg, sph)                           # reload: carry
        booked = np.asarray(sph._state.flow_dyn.occupied_count).sum()
        clk.advance_ms(500)
        return obs + [float(booked)] + _drain(pkg, sph, "svc", 3)
    _, obs = _twin(scenario)
    assert obs[0] and obs[1] > 0 and obs[2] == 1.0
    assert obs[3:] == ["pass", "block", "block"]


def test_twin_landed_booking_settles_on_rule_reload():
    def scenario(pkg, sph, clk):
        _svc(pkg, sph)
        obs = _book_pending(pkg, sph)
        clk.advance_ms(500)                       # the booking lands
        _svc(pkg, sph)                            # reload: settle
        left = np.asarray(sph._state.flow_dyn.occupied_count).sum()
        return obs + [float(left)] + _drain(pkg, sph, "svc", 3)
    _, obs = _twin(scenario)
    assert obs[2] == 0.0 and obs[3:] == ["pass", "block", "block"]


def test_twin_row_eviction_clears_bookings():
    def scenario(pkg, sph, clk):
        _svc(pkg, sph)
        row = sph.resources.get_or_create("svc")
        _book_pending(pkg, sph)
        before = float(np.asarray(sph._state.flow_dyn.occupied_count)[row]
                       .sum())
        sph.load_flow_rules([])
        sph.resources.unpin("svc")
        for i in range(4):
            sph.resources.get_or_create(f"fresh-{i}")
        v = sph.entry_batch(["fresh-0"])
        after = float(np.asarray(sph._state.flow_dyn.occupied_count)[row]
                      .sum())
        return [before, bool(v.allow[0]), after]
    _, obs = _twin(scenario, max_resources=4, host_fast_path=False)
    assert obs[0] > 0 and obs[1] and obs[2] == 0.0


def test_twin_split_batch_with_one_percent_prioritized():
    """A ~8k batch with ~1% prioritized events splits: the scalar step
    takes the bulk around live bookings, the fast occupy step takes the
    prioritized slice (no whole-batch demotion); then a batch with no
    prioritized event still reads the bookings."""
    names = [f"r{i}" for i in range(40)]
    rng = np.random.default_rng(71)
    batch = [names[i] for i in rng.integers(0, 40, 8192)]
    prio = rng.random(8192) < 0.01

    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource=r, count=150.0)
                             for r in names])
        out = []
        for step in range(3):
            v = sph.entry_batch(batch, prioritized=prio)
            out.append((v.allow.tolist(), v.wait_ms.tolist()))
            clk.advance_ms(250)
        v = sph.entry_batch(batch)
        out.append((v.allow.tolist(), v.wait_ms.tolist()))
        return out
    ts, obs = _twin(scenario, max_resources=128, max_flow_rules=64)
    assert ts.routes["split"] == 3 and ts.routes["scalar"] >= 1
    waited = np.asarray(obs[0][1] + obs[1][1] + obs[2][1])
    assert (waited > 0).any()


@pytest.mark.parametrize("sortfree", ["on", "tiny_bits"])
def test_twin_fused_and_general_prioritized_batches(sortfree, monkeypatch):
    """``decide_and_exit_raw_nowait`` with prioritized lanes and
    ``entry_batch`` with non-uniform acquire (the general occupy step)."""
    if sortfree == "tiny_bits":
        monkeypatch.setenv("SENTINEL_SORTFREE_BITS", TINY_BITS)
    names = ["a", "b", "c", "d"]

    def scenario(pkg, sph, clk):
        rng = np.random.default_rng(81)
        sph.load_flow_rules([pkg.FlowRule(resource=r, count=6.0)
                             for r in names])
        rows = sph.intern_resources([names[i] for i in
                                     rng.integers(0, 4, 64)])
        n, ra = rows.shape[0], sph.spec.alt_rows
        out, prev = [], np.empty(0, np.int32)
        for step in range(4):
            prio = rng.random(n) < 0.4
            h = sph.decide_and_exit_raw_nowait(
                rows, np.zeros(n, np.int32), np.full(n, ra, np.int32),
                np.zeros(n, np.int32), np.full(n, ra, np.int32),
                np.ones(n, np.int32), np.ones(n, np.bool_), prio,
                exit_rows=prev)
            v = h.result()
            out.append((v.allow.tolist(), v.wait_ms.tolist()))
            prev = rows[v.allow]
            acq = rng.integers(1, 3, n).astype(np.int32)
            v = sph.entry_batch([names[i] for i in rng.integers(0, 4, n)],
                                acquire=acq, prioritized=prio)
            out.append((v.allow.tolist(), v.wait_ms.tolist()))
            clk.advance_ms(300)
        return out
    # a geometry of its own for the tiny claim table (see the docstring)
    over = dict(max_resources=48 if sortfree == "tiny_bits" else 64,
                host_fast_path=False)
    ts, obs = _twin(scenario, **over)
    assert ts.routes["fused"] == 4 and ts.routes["general"] >= 1
    assert any(w > 0 for _a, ws in obs for w in ws)


def test_twin_prioritized_entry_with_sleep_false_reports_the_wait():
    def scenario(pkg, sph, clk):
        _svc(pkg, sph)
        _drain(pkg, sph, "svc", 2)
        clk.advance_ms(700)
        t = clk.now_ms()
        e = sph.entry("svc", prioritized=True, sleep=False)
        obs = [e.wait_ms, clk.now_ms() - t, e.create_ms - t]
        clk.advance_ms(e.wait_ms + 5)
        e.exit()
        return obs
    _, obs = _twin(scenario)
    assert obs == [300, 0, 300]
