"""Port parity: ``sentinel_tpu_torch.Sentinel`` against
``sentinel_tpu.Sentinel`` on origin- and context-bearing traffic.

Twin engines (both ``host_fast_path=False``) under twin ManualClocks get
the same rule loads and the same stream: ``entry(origin=...)`` inside a
call context, ``entry_batch(origins=, contexts=)`` with uniform and with
mixed ``acquire``, a mixed batch that splits, fused decide+exit steps
with alt rows, and ``exit_batch`` on alt rows. After every stage the
verdicts, raised exceptions and the whole engine state agree exactly,
and each dispatch took the JAX runtime's route (its ``split_route.*``
counters against the port's ``Sentinel.routes``). Acquire totals stay
far below 2^24.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.core.context import ContextScope as JaxContext
from sentinel_tpu.obs import counters as obs_keys
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core.context import ContextScope
from sentinel_tpu_torch.stats import window as tw

from test_fast_flow import DEG_RULES, RESOURCES, _rules

torch.set_num_threads(2)

T0 = 1_785_000_000_000
CFG = dict(max_resources=64, max_origins=32, max_flow_rules=32,
           max_degrade_rules=16, max_authority_rules=16,
           minute_enabled=True, host_fast_path=False)
ORIGINS = ["", "app-a", "app-b", "app-c"]
CONTEXTS = ["", "some_ctx", "other_ctx"]
ROUTE_KEYS = {"scalar": obs_keys.ROUTE_SCALAR, "fast": obs_keys.ROUTE_FAST,
              "general": obs_keys.ROUTE_GENERAL,
              "split": obs_keys.ROUTE_SPLIT, "fused": obs_keys.ROUTE_FUSED}
FLOW = [r for r in _rules() if not r.cluster_mode]
NAMES = [r for r in RESOURCES if r != "clus"]


def _port(rules):
    return [getattr(stt, type(r).__name__)(**dataclasses.asdict(r))
            for r in rules]


def _twins(cfg=CFG, flow=FLOW, deg=DEG_RULES):
    jc, tc = stpu.ManualClock(start_ms=T0), stt.ManualClock(start_ms=T0)
    js = stpu.Sentinel(config=stpu.load_config(**cfg), clock=jc)
    ts = stt.Sentinel(config=stt.load_config(**cfg), clock=tc, device="cpu")
    for sph, conv in ((js, list), (ts, _port)):
        sph.load_flow_rules(conv(flow))
        sph.load_degrade_rules(conv(deg))
        sph._cpu.sample = lambda: (0.5, 0.25)
    return js, ts, jc, tc


def _same_state(js, ts, tag):
    bad = convert.leaf_diff(convert.to_numpy(js._state),
                            convert.to_numpy(ts._state))
    assert bad == [], f"{tag}: {bad}"


def _same_verdicts(vj, vt, tag):
    for f in ("allow", "reason", "wait_ms"):
        np.testing.assert_array_equal(getattr(vt, f), getattr(vj, f),
                                      err_msg=f"{tag}: {f}")


def _same_routes(js, ts, base):
    c = js.obs.counters
    want = {k: c.get(v) - base.get(k, 0) for k, v in ROUTE_KEYS.items()}
    got = {k: ts.routes.get(k, 0) for k in ROUTE_KEYS}
    assert got == want


def _route_base(js):
    return {k: js.obs.counters.get(v) for k, v in ROUTE_KEYS.items()}


def _entries(sph, block_exc, scope, calls, clock):
    out = []
    for name, origin, ctx in calls:
        try:
            with scope(ctx, origin=origin):
                with sph.entry(name) as e:
                    clock.advance_ms(2)
                    if name == "qps":
                        e.trace(RuntimeError("business failure"))
            out.append("pass")
        except block_exc as exc:
            out.append(type(exc).__name__)
    return out


@pytest.mark.parametrize("sortfree", ["on", "off"])
def test_twin_origin_stream_matches(sortfree, monkeypatch):
    if sortfree == "off":
        monkeypatch.setenv("SENTINEL_SORTFREE", "0")
    js, ts, jc, tc = _twins()
    assert ts._sortfree == js._sortfree == (sortfree == "on")
    base = _route_base(js)
    rng = np.random.default_rng(21)
    for step in range(4):
        calls = [(NAMES[i], ORIGINS[o], CONTEXTS[c]) for i, o, c in zip(
            rng.integers(0, len(NAMES), 10), rng.integers(0, 4, 10),
            rng.integers(0, 3, 10))]
        got = [_entries(sph, exc, scope, calls, clk)
               for sph, exc, scope, clk in (
                   (js, stpu.BlockException, JaxContext, jc),
                   (ts, stt.BlockException, ContextScope, tc))]
        assert got[0] == got[1], f"entries, step {step}"
        _same_state(js, ts, f"entries, step {step}")

        n = 40
        names = [NAMES[i] for i in rng.integers(0, len(NAMES), n)]
        kw = dict(origins=[ORIGINS[i] for i in rng.integers(0, 4, n)],
                  contexts=[CONTEXTS[i] for i in rng.integers(0, 3, n)])
        for acq in (None, rng.integers(1, 4, n).astype(np.int32)):
            vj = js.entry_batch(names, acquire=acq, **kw)
            vt = ts.entry_batch(names, acquire=acq, **kw)
            _same_verdicts(vj, vt, f"entry_batch, step {step}")
            _same_state(js, ts, f"entry_batch, step {step}")

        # a fused step with alt rows on both halves, then exits on them
        rows = ts.intern_resources(names)
        raw = [np.asarray(a) for a in (
            rows, np.zeros(n, np.int32),
            [ts._alt_row(int(r), 0, 1) for r in rows],
            np.zeros(n, np.int32), np.full(n, ts.spec.alt_rows, np.int32),
            np.ones(n, np.int32), np.ones(n, np.bool_),
            np.zeros(n, np.bool_))]
        raw[2] = raw[2].astype(np.int32)
        js._alt_row(int(rows[0]), 0, 1)          # same edge on both sides
        xkw = dict(exit_rows=rows[vj.allow], exit_origin_rows=raw[2][
            vj.allow], exit_rt_ms=np.full(int(vj.allow.sum()), 7, np.int32))
        hj = js.decide_and_exit_raw_nowait(*raw, **xkw)
        ht = ts.decide_and_exit_raw_nowait(*raw, **xkw)
        _same_verdicts(hj.result(), ht.result(), f"fused, step {step}")
        _same_state(js, ts, f"fused, step {step}")

        done = rows[vt.allow]
        k = done.shape[0]
        xb = dict(rows=done, origin_rows=raw[2][vt.allow],
                  chain_rows=np.full(k, ts.spec.alt_rows, np.int32),
                  acquire=np.ones(k, np.int32),
                  rt_ms=rng.integers(0, 60, k).astype(np.int32),
                  error=rng.random(k) < 0.5, is_in=np.ones(k, np.bool_))
        js.exit_batch(**xb)
        ts.exit_batch(**xb)
        _same_state(js, ts, f"exit_batch, step {step}")
        jc.advance_ms(int(rng.integers(50, 700)))
        tc.advance_ms(int(jc.now_ms() - tc.now_ms()))
    _same_routes(js, ts, base)
    assert ts.routes["fast"] > 0 and ts.routes["general"] > 0
    assert ts.sortfree_overflow == js.obs.counters.get(
        obs_keys.SORTFREE_OVERFLOW) == 0


def test_mixed_batch_splits_like_the_reference():
    js, ts, jc, tc = _twins()
    base = _route_base(js)
    rng = np.random.default_rng(22)
    n = 4200
    for step in range(2):
        names = [NAMES[i] for i in rng.integers(0, len(NAMES), n)]
        origins = [""] * n
        for i in rng.integers(0, n, 60):
            origins[i] = ORIGINS[1 + i % 3]
        vj = js.entry_batch(names, origins=origins)
        vt = ts.entry_batch(names, origins=origins)
        _same_verdicts(vj, vt, f"split, step {step}")
        _same_state(js, ts, f"split, step {step}")
        jc.advance_ms(300)
        tc.advance_ms(300)
    _same_routes(js, ts, base)
    assert ts.routes["split"] == 2


def test_key_that_does_not_fit_takes_the_general_route():
    cfg = dict(CFG, max_resources=1 << 14, max_flow_rules=1 << 16,
               minute_enabled=False)
    js, ts, jc, tc = _twins(cfg=cfg)
    assert not ts._key_fits()
    base = _route_base(js)
    names = ["qps", "paced", "rel", "chain"] * 8
    origins = ["app-a", "", "app-b", ""] * 8
    for _ in range(2):
        _same_verdicts(js.entry_batch(names, origins=origins),
                       ts.entry_batch(names, origins=origins), "no fit")
        _same_state(js, ts, "no fit")
        jc.advance_ms(100)
        tc.advance_ms(100)
    _same_routes(js, ts, base)
    assert ts.routes == {"general": 2}


def test_claim_overflow_is_tallied_like_the_reference(monkeypatch):
    monkeypatch.setenv("SENTINEL_SORTFREE_BITS", "2")
    # the JAX package reads the knob when it traces a step, and shares
    # traced steps between engines of one geometry: a geometry of its own
    js, ts, jc, tc = _twins(cfg=dict(CFG, max_resources=40))
    names = NAMES * 4
    acq = np.tile([1, 2], len(names) // 2).astype(np.int32)
    origins = (ORIGINS * len(names))[:len(names)]
    _same_verdicts(js.entry_batch(names, origins=origins, acquire=acq),
                   ts.entry_batch(names, origins=origins, acquire=acq),
                   "overflow")
    _same_state(js, ts, "overflow")
    assert ts.sortfree_overflow == js.obs.counters.get(
        obs_keys.SORTFREE_OVERFLOW) > 0


def test_eviction_clears_the_evicted_resources_alt_rows():
    cfg = dict(CFG, max_resources=8)
    js, ts, jc, tc = _twins(cfg=cfg, flow=[], deg=[])
    spec = ts.spec

    def live_alt(row):
        idx = spec.second.index_of(tc.now_ms())
        return int(tw.rolling_totals(spec.second, ts._state.alt_second,
                                     idx)[row].sum())

    for sph in (js, ts):
        sph.entry_batch(["victim", "victim"], origins=["app-a", "app-b"],
                        contexts=["ctx", ""])
    victim = ts.resources.lookup("victim")
    alt = sorted(ts._alt_rows_by_row[victim])
    assert len(alt) == 3 and all(live_alt(r) > 0 for r in alt)
    # origin-less newcomers fill the table and recycle the victim's row
    for i in range(8):
        for sph in (js, ts):
            sph.entry_batch([f"k{i}"])
        _same_state(js, ts, f"churn {i}")
    assert ts.resources.lookup("victim") is None
    assert ts.resources.items() == js.resources.items()
    assert all(live_alt(r) == 0 for r in alt)
    assert victim not in ts._alt_rows_by_row
    assert set(ts._alt_rows_by_row) == set(js._alt_rows_by_row)
