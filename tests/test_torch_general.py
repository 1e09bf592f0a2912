"""Port parity: the fast and general admission paths of
``sentinel_tpu_torch`` against ``sentinel_tpu``, module by module and as
fused engine steps.

Every input is made from a numpy seed and handed to both packages; the
comparisons are exact (verdicts, ``sf_overflow`` and every state leaf).
The segment math sums float32 acquire amounts: every batch's total
acquire stays below 2^24, where those sums are exact in any order. The
sort-free variants run at the default claim-table size and with
``SENTINEL_SORTFREE_BITS`` forced tiny on both sides, so that the claim
cascade overflows and the sorted order is selected.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sentinel_tpu as stpu
from sentinel_tpu.core.clock import ManualClock
from sentinel_tpu.engine import pipeline as jp
from sentinel_tpu.ops import segments as jseg
from sentinel_tpu.ops import sortfree as jsf
from sentinel_tpu.rules import degrade as jdeg
from sentinel_tpu.rules import flow as jflow
from sentinel_tpu.stats import window as jw
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.engine import pipeline as tp
from sentinel_tpu_torch.ops import segments as tseg
from sentinel_tpu_torch.ops import sortfree as tsf
from sentinel_tpu_torch.rules import degrade as tdeg
from sentinel_tpu_torch.rules import flow as tflow
from sentinel_tpu_torch.stats import window as tw

from test_fast_flow import DEG_RULES, RESOURCES, _rules
from test_torch_engine import _port_spec

torch.set_num_threads(2)

T0 = 1_785_000_000_000
TINY_BITS = "2"


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


# ---------------------------------------------------------------------------
# ops/segments.py and ops/sortfree.py
# ---------------------------------------------------------------------------

def test_segment_helpers_and_greedy_admit():
    rng = np.random.default_rng(1)
    n = 3000
    k1 = rng.integers(0, 40, n).astype(np.int32)
    k2 = rng.integers(-5, 60, n).astype(np.int32)
    amounts = rng.integers(1, 6, n).astype(np.float32)      # total < 2^24
    order_j = np.asarray(jseg.sort_by_keys(_j(k1), _j(k2)))
    order_t = tseg.sort_by_keys(_t(k1), _t(k2)).numpy()
    np.testing.assert_array_equal(order_t, order_j)
    np.testing.assert_array_equal(
        tseg.sort_by_keys(_t(k2)).numpy(), np.asarray(jseg.sort_by_keys(
            _j(k2))))
    p_s, s_s = k1[order_j], k2[order_j]
    st_j = jseg.segment_starts(_j(p_s), _j(s_s))
    st_t = tseg.segment_starts(_t(p_s), _t(s_s))
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    ld_j = jseg.segment_leader_index(st_j)
    ld_t = tseg.segment_leader_index(st_t)
    np.testing.assert_array_equal(ld_t.numpy(), np.asarray(ld_j))
    a_s = amounts[order_j]
    for vals in (a_s, (a_s * 7).astype(np.int32)):
        for got, want in zip(tseg.segment_prefix_sum(_t(vals), st_t, ld_t),
                             jseg.segment_prefix_sum(_j(vals), st_j, ld_j)):
            assert got.dtype == getattr(torch, str(np.asarray(want).dtype))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tseg.segment_broadcast_first(_t(k2), ld_t).numpy(),
        np.asarray(jseg.segment_broadcast_first(_j(k2), ld_j)))
    np.testing.assert_array_equal(
        tseg.unsort(_t(order_j).long(), _t(s_s)).numpy(),
        np.asarray(jseg.unsort(_j(order_j), _j(s_s))))
    base = rng.integers(0, 8, n).astype(np.float32)
    limit = rng.integers(0, 30, n).astype(np.float32)
    np.testing.assert_array_equal(
        tseg.greedy_admit(_t(base), _t(a_s), _t(limit), st_t, ld_t).numpy(),
        np.asarray(jseg.greedy_admit(_j(base), _j(a_s), _j(limit), st_j,
                                     ld_j)))


@pytest.mark.parametrize("raw", ["", "3", "40", "0", "x"])
def test_table_bits_reads_the_knob_alike(raw, monkeypatch):
    monkeypatch.setenv("SENTINEL_SORTFREE_BITS", raw)
    for n in (1, 100, 5000, 1 << 20):
        assert tsf.table_bits(n) == jsf.table_bits(n)


@pytest.mark.parametrize("bits", ["default", "tiny"])
def test_claim_plans_counting_order_and_hashed_ranks(bits, monkeypatch):
    if bits == "tiny":
        monkeypatch.setenv("SENTINEL_SORTFREE_BITS", TINY_BITS)
    rng = np.random.default_rng(2)
    n = 4096
    nbits = jsf.table_bits(n)
    assert tsf.table_bits(n) == nbits
    k1 = rng.integers(0, 50, n).astype(np.int32)
    k2 = rng.integers(0, 2 ** 31 - 1, n).astype(np.int32)  # >= 2^31 after
    k2[::3] = rng.integers(0, 64, k2[::3].shape[0])         # the multiply
    sentinel = rng.random(n) < 0.3
    jpl = jsf.build_pair_plan(_j(k1), _j(k2), _j(sentinel), nbits)
    tpl = tsf.build_pair_plan(_t(k1), _t(k2), _t(sentinel), nbits)
    np.testing.assert_array_equal(tpl.bucket.numpy(), np.asarray(jpl.bucket))
    assert int(tpl.overflow_count) == int(jpl.overflow_count)
    assert bool(tpl.overflow) == bool(jpl.overflow)
    assert tpl.num_buckets == jpl.num_buckets
    assert bool(jpl.overflow) == (bits == "tiny")
    # the counting order (through the kernel seam's bucket histogram)
    # equals the reference's wherever the plan settled every key
    if not bool(jpl.overflow):
        np.testing.assert_array_equal(
            tsf.counting_order(tpl.bucket, tpl.num_buckets).numpy(),
            np.asarray(jsf.counting_order(jpl.bucket, jpl.num_buckets)))
    key = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    key[::2] = rng.integers(0, 100, key[::2].shape[0])
    jkp = jsf.build_key_plan(_j(key), _j(sentinel), nbits)
    tkp = tsf.build_key_plan(_t(key), _t(sentinel), nbits)
    np.testing.assert_array_equal(tkp.bucket.numpy(), np.asarray(jkp.bucket))
    assert int(tkp.overflow_count) == int(jkp.overflow_count)
    # per-slot hashed ranks: [B, K] composite keys with a shared sentinel
    sent = 99_999
    key2 = rng.integers(0, 2000, (n // 2, 3)).astype(np.int32)
    key2[rng.random(key2.shape) < 0.4] = sent
    jr, jo = jsf.ranks2d_hashed(_j(key2), sent, jsf.table_bits(n // 2))
    tr, to = tsf.ranks2d_hashed(_t(key2), sent, tsf.table_bits(n // 2))
    assert int(to) == int(jo) and (int(jo) > 0) == (bits == "tiny")
    if int(jo) == 0:
        live = key2 != sent
        np.testing.assert_array_equal(tr.numpy()[live], np.asarray(jr)[live])


def test_add_rows_hist_matches_the_matmul_form():
    """The JAX package's one-hot histogram record of a small alt table
    (fast route, RA <= 4096) against the port's single scatter of the
    same lanes with the uniform acquire as every amount (exact)."""
    rng = np.random.default_rng(3)
    spec_j, spec_t = jw.WindowSpec(2, 500), tw.WindowSpec(2, 500)
    ra, n = 1024, 4096
    st = jw.init_window(spec_j, ra)
    counters = rng.integers(0, 40, (ra, 2, 8)).astype(np.int32)
    stamps = np.full((ra, 2), 7, np.int32)
    st = st._replace(counters=_j(counters), stamps=_j(stamps))
    rows = rng.integers(0, ra, n).astype(np.int32)
    rows[rng.random(n) < 0.5] = ra                       # padding drops
    ev_ids = rng.integers(0, 2, n).astype(np.int32)
    for amount in (1, 3):
        want = jw.add_rows_hist(spec_j, st, _j(rows), _j(ev_ids),
                                jnp.int32(amount), 15)
        got = tw.WindowState(_t(counters.copy()), _t(stamps), torch.zeros(
            (ra, 2)), torch.zeros((ra, 2), dtype=torch.int32))
        tw.add_rows_multi(spec_t, got, _t(rows), _t(ev_ids),
                          torch.full((n,), amount, dtype=torch.int32), 15)
        np.testing.assert_array_equal(got.counters.numpy(),
                                      np.asarray(want.counters))


# ---------------------------------------------------------------------------
# rules/flow.py and rules/degrade.py
# ---------------------------------------------------------------------------

CFG = dict(max_resources=64, max_origins=32, max_flow_rules=32,
           max_degrade_rules=16, max_authority_rules=16, minute_enabled=True,
           host_fast_path=False)


def _sentinel(clk):
    sph = stpu.Sentinel(config=stpu.load_config(**CFG), clock=clk)
    sph.load_flow_rules(_rules())
    sph.load_degrade_rules(DEG_RULES)
    return sph


def _ids(sph):
    origin_ids = np.array([sph.origins.pin(o) for o in
                           ("app-a", "app-b", "app-c")], np.int32)
    ctx_ids = np.array([sph.contexts.pin(c) for c in
                        ("some_ctx", "other_ctx")], np.int32)
    return origin_ids, ctx_ids


def _events(sph, rng, n, origin_ids, ctx_ids, acquire):
    """numpy entry columns: ~2/3 of events with an origin (hashed alt row),
    half with a context (chain row), some padding."""
    spec = sph.spec
    names = [RESOURCES[i] for i in rng.integers(0, len(RESOURCES), n)]
    rows = np.array([sph.resources.get_or_create(r) for r in names],
                    np.int32)
    rows[::13] = spec.rows
    oid = np.where(rng.random(n) > 0.33,
                   origin_ids[rng.integers(0, len(origin_ids), n)],
                   0).astype(np.int32)
    cid = np.where(rng.random(n) > 0.5,
                   ctx_ids[rng.integers(0, len(ctx_ids), n)],
                   0).astype(np.int32)
    orow = np.full(n, spec.alt_rows, np.int32)
    crow = np.full(n, spec.alt_rows, np.int32)
    for i in range(n):
        if rows[i] < spec.rows and oid[i]:
            orow[i] = sph._alt_row(int(rows[i]), 0, int(oid[i]))
        if rows[i] < spec.rows and cid[i]:
            crow[i] = sph._alt_row(int(rows[i]), 1, int(cid[i]))
    if acquire == "mixed":
        acq = rng.integers(1, 4, n).astype(np.int32)
    else:
        acq = np.full(n, acquire, np.int32)
    return dict(rows=rows, origin_ids=oid, origin_rows=orow,
                context_ids=cid, chain_rows=crow, acquire=acq,
                is_in=rng.random(n) > 0.3,
                prioritized=np.zeros(n, np.bool_),
                valid=(rng.random(n) > 0.1) & (rows < spec.rows))


def _random_state(sph, rng):
    """The JAX state with random live counts in the second windows, the
    gauges and the pacing/token state (a numpy dict, both packages')."""
    d = convert.to_numpy(sph._state)
    idx = sph.spec.second.index_of(sph.clock.now_ms())
    for w in ("second", "alt_second"):
        shp = d[f"{w}.counters"].shape
        d[f"{w}.counters"] = rng.integers(0, 4, shp).astype(np.int32)
        d[f"{w}.stamps"] = (idx - rng.integers(0, 3, shp[:2])).astype(
            np.int32)
    d["threads"] = rng.integers(0, 5, d["threads"].shape).astype(np.int32)
    d["alt_threads"] = rng.integers(0, 3, d["alt_threads"].shape).astype(
        np.int32)
    rel = sph._rel_ms(sph.clock.now_ms())
    nf1 = d["flow_dyn.latest_passed_ms"].shape
    d["flow_dyn.latest_passed_ms"] = (rel - rng.integers(-300, 300, nf1)
                                      ).astype(np.int32)
    d["flow_dyn.stored_tokens"] = rng.uniform(0, 400, nf1).astype(
        np.float32)
    return d


def _jax_window(d, name):
    return jw.WindowState(*(jnp.asarray(d[f"{name}.{f}"])
                            for f in jw.WindowState._fields))


def _jax_dyn(d):
    return jflow.FlowDynState(*(jnp.asarray(d[f"flow_dyn.{f}"])
                                for f in jflow.FlowDynState._fields))


@pytest.mark.parametrize("path", ["general", "general_sortfree", "fast",
                                  "fast_sortfree"])
def test_flow_checks_match(path):
    clk = ManualClock(start_ms=T0)
    sph = _sentinel(clk)
    origin_ids, ctx_ids = _ids(sph)
    spec = sph.spec
    tspec = _port_spec(spec)
    rs = sph._ruleset
    trs = convert.ruleset_from_numpy(convert.to_numpy(rs))
    rng = np.random.default_rng(4)
    for trial in range(4):
        d = _random_state(sph, rng)
        tstate = convert.state_from_numpy(d)
        e = _events(sph, rng, 64, origin_ids, ctx_ids,
                    "mixed" if path.startswith("general") else 2)
        fb = rng.integers(0, 4, 64).astype(np.int32) * (trial % 2)
        times = [int(x) for x in np.asarray(sph._time_scalars(clk.now_ms()))]
        common = dict(main_minute=_jax_window(d, "minute"),
                      now_idx_m=jnp.int32(times[1]))
        jview = jflow.FlowBatchView(
            rows=_j(e["rows"]), origin_ids=_j(e["origin_ids"]),
            origin_rows=_j(e["origin_rows"]),
            context_ids=_j(e["context_ids"]),
            chain_rows=_j(e["chain_rows"]), acquire=_j(e["acquire"]),
            valid=_j(e["valid"]), prioritized=_j(e["prioritized"]),
            cluster_fallback=_j(fb))
        tview = tflow.FlowBatchView(
            rows=_t(e["rows"]), origin_ids=_t(e["origin_ids"]),
            origin_rows=_t(e["origin_rows"]),
            context_ids=_t(e["context_ids"]),
            chain_rows=_t(e["chain_rows"]), acquire=_t(e["acquire"]),
            valid=_t(e["valid"]), cluster_fallback=_t(fb))
        jargs = (rs.flow_table, _jax_dyn(d), rs.flow_idx, spec.second,
                 _jax_window(d, "second"), _jax_window(d, "alt_second"),
                 jnp.asarray(d["threads"]), jnp.asarray(d["alt_threads"]),
                 jview, jnp.int32(times[0]), jnp.int32(times[2]))
        targs = (trs.flow_table, tstate.flow_dyn, trs.flow_idx,
                 tspec.second, tstate.second, tstate.alt_second,
                 tstate.threads, tstate.alt_threads, tview, times[0],
                 times[2])
        tcommon = dict(minute_spec=tspec.minute, main_minute=tstate.minute,
                       now_idx_m=times[1])
        sortfree = path.endswith("sortfree")
        if path.startswith("general"):
            fn_j = (jflow.flow_check_sortfree if sortfree
                    else functools.partial(jflow.flow_check, sortfree=False))
            kw_j = dict(common, in_win_ms=jnp.int32(times[3]),
                        enable_occupy=False)
            fn_t = tflow.flow_check
        else:
            fn_j = (jflow.flow_check_fast_sortfree if sortfree
                    else jflow.flow_check_fast)
            kw_j = common
            fn_t = tflow.flow_check_fast
        jitted = jax.jit(lambda *a: fn_j(*a[:3], spec.second, *a[3:],
                                         **dict(kw_j, minute_spec=spec.minute)))
        want = jitted(*jargs[:3], *jargs[4:])
        got = fn_t(*targs, **tcommon, sortfree=sortfree)
        if not sortfree:                        # the port's zero overflow
            assert int(got[4]) == 0
            got = got[:4]
        if path.startswith("fast"):             # no occupied column there
            assert not got[3].any()
            got = got[:3] + got[4:]
        assert len(got) == len(want)
        jd, td = convert.to_numpy(want[0]), convert.to_numpy(got[0])
        assert convert.leaf_diff(jd, td) == [], f"dyn, trial {trial}"
        for k, (g, w) in enumerate(zip(got[1:], want[1:])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"output {k}, {trial}")
        clk.advance_ms(int(rng.integers(100, 900)))


def test_degrade_entry_check_matches_sorted_form():
    clk = ManualClock(start_ms=T0)
    sph = _sentinel(clk)
    rs = sph._ruleset
    trs = convert.ruleset_from_numpy(convert.to_numpy(rs))
    nd1 = rs.deg_table.active.shape[0]
    rng = np.random.default_rng(5)
    brk_rows = [sph.resources.get_or_create(r) for r in ("qps", "brk")]
    for trial in range(6):
        st = dict(state=rng.integers(0, 3, nd1).astype(np.int32),
                  next_retry_ms=rng.integers(-50, 50, nd1).astype(np.int32),
                  win_stamp=np.zeros(nd1, np.int32),
                  bad=np.zeros(nd1, np.int32), total=np.zeros(nd1, np.int32))
        st["state"][-1] = 0
        n = 48
        rows = rng.choice(brk_rows + [5, sph.spec.rows], n).astype(np.int32)
        valid = rng.random(n) > 0.2
        js, ja = jdeg.degrade_entry_check(
            rs.deg_table, jdeg.BreakerState(**{k: _j(v) for k, v in
                                               st.items()}),
            rs.deg_idx, _j(rows), _j(valid), jnp.int32(0))
        ts, ta = tdeg.degrade_entry_check(
            trs.deg_table, tdeg.BreakerState(**{k: _t(v) for k, v in
                                                st.items()}),
            trs.deg_idx, _t(rows), _t(valid), 0)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert convert.leaf_diff(convert.to_numpy(js),
                                 convert.to_numpy(ts)) == []


# ---------------------------------------------------------------------------
# engine/pipeline.py: fused decide+exit steps, leaf by leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sortfree", ["on", "off", "tiny_bits"])
@pytest.mark.parametrize("route", ["fast", "general"])
def test_fused_origin_steps_match_leaf_by_leaf(route, sortfree,
                                               monkeypatch):
    if sortfree == "tiny_bits":
        monkeypatch.setenv("SENTINEL_SORTFREE_BITS", TINY_BITS)
    clk = ManualClock(start_ms=T0)
    sph = _sentinel(clk)
    origin_ids, ctx_ids = _ids(sph)
    spec = sph.spec
    tspec = _port_spec(spec)
    flags = dict(skip_auth=sph._skip_auth, skip_sys=sph._skip_sys,
                 scalar_has_rl=sph._scalar_has_rl,
                 skip_threads=sph._skip_threads,
                 sortfree=sortfree != "off", record_alt=True,
                 fast_flow=route == "fast")
    fused = jax.jit(functools.partial(
        jp.decide_and_record_exits, spec, enable_occupy=False, **flags))
    trules = convert.ruleset_from_numpy(convert.to_numpy(sph._ruleset))
    js = sph._state
    ts = convert.state_from_numpy(convert.to_numpy(js))
    rng = np.random.default_rng(6)
    n, ra = 64, spec.alt_rows
    prev = None
    sysv = np.array([0.25, 0.1], np.float32)
    overflowed = 0
    for step in range(18):
        eb = _events(sph, rng, n, origin_ids, ctx_ids,
                     "mixed" if route == "general" else 1 + step % 2)
        if prev is None:
            xb = dict(rows=np.full(n, spec.rows, np.int32),
                      origin_rows=np.full(n, ra, np.int32),
                      chain_rows=np.full(n, ra, np.int32),
                      acquire=np.ones(n, np.int32),
                      valid=np.zeros(n, np.bool_))
        else:
            xb = dict(prev)
        xb.update(rt_ms=rng.integers(0, 90, n).astype(np.int32),
                  error=rng.random(n) < 0.4, is_in=rng.random(n) > 0.2)
        times = np.asarray(sph._time_scalars(clk.now_ms()))
        js, jv = fused(sph._ruleset, js,
                       jp.EntryBatch(**{k: _j(a) for k, a in eb.items()}),
                       jp.ExitBatch(**{k: _j(a) for k, a in xb.items()}),
                       jnp.asarray(times), jnp.asarray(sysv))
        ts, tv = tp.decide_and_record_exits(
            tspec, trules, ts,
            tp.EntryBatch(**{k: _t(a) for k, a in eb.items()}),
            tp.ExitBatch(**{k: _t(a) for k, a in xb.items()}),
            tuple(int(x) for x in times), tuple(float(x) for x in sysv),
            **flags)
        for f in ("allow", "reason", "wait_ms"):
            np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                          np.asarray(getattr(jv, f)),
                                          err_msg=f"{f}, step {step}")
        if flags["sortfree"]:
            assert int(tv.sf_overflow) == int(jv.sf_overflow)
            overflowed += int(jv.sf_overflow)
        else:
            assert tv.sf_overflow is None and jv.sf_overflow is None
        assert convert.leaf_diff(convert.to_numpy(js),
                                 convert.to_numpy(ts)) == [], f"step {step}"
        ok = np.asarray(jv.allow) & eb["valid"]
        prev = dict(rows=np.where(ok, eb["rows"], spec.rows).astype(
                        np.int32),
                    origin_rows=eb["origin_rows"],
                    chain_rows=eb["chain_rows"], acquire=eb["acquire"],
                    valid=ok)
        clk.advance_ms(int(rng.integers(20, 400)))
    assert (overflowed > 0) == (sortfree == "tiny_bits")


def test_invalidate_clears_alt_rows_and_bookings():
    clk = ManualClock(start_ms=T0)
    sph = _sentinel(clk)
    rng = np.random.default_rng(7)
    d = _random_state(sph, rng)
    d["flow_dyn.occupied_count"] = rng.uniform(
        0, 5, d["flow_dyn.occupied_count"].shape).astype(np.float32)
    ts = convert.state_from_numpy(d)
    js = jp.SentinelState(**{
        **sph._state._asdict(),
        "second": _jax_window(d, "second"),
        "minute": _jax_window(d, "minute"),
        "alt_second": _jax_window(d, "alt_second"),
        "threads": jnp.asarray(d["threads"]),
        "alt_threads": jnp.asarray(d["alt_threads"]),
        "flow_dyn": _jax_dyn(d)})
    rows = np.array([3, 9, 9, sph.spec.rows], np.int32)
    alt = np.array([1, 77, sph.spec.alt_rows, sph.spec.alt_rows], np.int32)
    want = jp.invalidate_resource_rows(sph.spec, js, _j(rows), _j(alt))
    got = tp.invalidate_resource_rows(_port_spec(sph.spec), ts, _t(rows),
                                      _t(alt))
    assert convert.leaf_diff(convert.to_numpy(want),
                             convert.to_numpy(got)) == []
