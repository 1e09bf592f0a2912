"""Port parity: the engine step (``decide_and_record_exits``) of
``sentinel_tpu_torch.engine.pipeline`` against ``sentinel_tpu.engine
.pipeline`` on the scalar admission path.

The JAX package's own runtime compiles the rules and builds the initial
state; :mod:`sentinel_tpu_torch.convert` carries both into the port. Then
~30 fused decide+exit steps run in both packages from numpy-seeded
batches (each step's exits are the previous step's admissions), and after
EVERY step the verdicts and the whole state are compared leaf by leaf.
Tolerance: exact. RT values are small integers, so every float32 RT sum
stays below 2^24 (exact in any summation order).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sentinel_tpu as stpu
from sentinel_tpu.core.clock import ManualClock
from sentinel_tpu.engine import pipeline as jp
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.engine import pipeline as tp
from sentinel_tpu_torch.stats import window as tw

from test_scalar_flow import DEG_RULES, MIXED_RULES

torch.set_num_threads(2)

NAMES = ["qps", "qps2", "thread", "warm", "paced", "wurl", "rel", "chain",
         "zero_rl", "free1", "brk", "slow"]

VARIANTS = {
    # every flow behaviour family, breakers, minute window, thread gauges
    "mixed": dict(flow=[r for r in MIXED_RULES if not r.cluster_mode],
                  deg=DEG_RULES, sys=[], auth=[], cfg={}),
    # system + authority slots live; one-bucket second window (B == 1
    # takes refresh_rows instead of refresh_all); no minute window
    "sys_auth_b1": dict(
        flow=[stpu.FlowRule(resource="qps", count=6.0),
              stpu.FlowRule(resource="warm", count=30.0,
                            control_behavior=stpu.BEHAVIOR_WARM_UP,
                            warm_up_period_sec=3)],
        deg=DEG_RULES[:1],
        sys=[stpu.SystemRule(qps=40.0, max_thread=25.0)],
        auth=[stpu.AuthorityRule(resource="slow", limit_app="app-a")],
        cfg=dict(second_sample_count=1, minute_enabled=False)),
}


def _port_spec(spec):
    def ws(s):
        return None if s is None else tw.WindowSpec(s.buckets, s.win_ms,
                                                    s.track_rt)
    return tp.EngineSpec(rows=spec.rows, alt_rows=spec.alt_rows,
                         second=ws(spec.second), minute=ws(spec.minute),
                         statistic_max_rt=spec.statistic_max_rt,
                         hist_buckets=spec.hist_buckets,
                         occupy_timeout_ms=spec.occupy_timeout_ms,
                         param_keys=spec.param_keys,
                         param_pairs=spec.param_pairs)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_steps_match_leaf_by_leaf(variant):
    v = VARIANTS[variant]
    clk = ManualClock(start_ms=1_785_000_000_000)
    cfg = stpu.load_config(max_resources=64, max_origins=32,
                           max_flow_rules=16, max_degrade_rules=16,
                           max_authority_rules=16, host_fast_path=False,
                           **v["cfg"])
    sph = stpu.Sentinel(config=cfg, clock=clk)
    sph.load_flow_rules(v["flow"])
    sph.load_degrade_rules(v["deg"])
    sph.load_system_rules(v["sys"])
    sph.load_authority_rules(v["auth"])
    spec = sph.spec
    tspec = _port_spec(spec)
    assert tspec.hist_buckets > 0           # rt_hist on, as by default
    flags = dict(skip_auth=sph._skip_auth, skip_sys=sph._skip_sys,
                 scalar_has_rl=sph._scalar_has_rl,
                 skip_threads=sph._skip_threads)
    fused = jax.jit(functools.partial(
        jp.decide_and_record_exits, spec, enable_occupy=False,
        record_alt=False, scalar_flow=True, sortfree=True, **flags))
    trules = convert.ruleset_from_numpy(convert.to_numpy(sph._ruleset))
    js = sph._state
    ts = convert.state_from_numpy(convert.to_numpy(js))
    assert ts.rt_hist is not None and trules.joint_idx is not None

    rng = np.random.default_rng(11)
    rows_of = [sph.resources.get_or_create(x) for x in NAMES]
    n, ra, r_pad = 64, spec.alt_rows, spec.rows
    prev = np.full(n, r_pad, np.int32)
    sysv = np.array([0.25, 0.1], np.float32)
    for step in range(30):
        rows = np.array([rows_of[i] for i in rng.integers(0, len(NAMES), n)],
                        np.int32)
        rows[::17] = r_pad
        eb = dict(rows=rows, origin_ids=np.zeros(n, np.int32),
                  origin_rows=np.full(n, ra, np.int32),
                  context_ids=np.zeros(n, np.int32),
                  chain_rows=np.full(n, ra, np.int32),
                  acquire=np.ones(n, np.int32),
                  is_in=rng.random(n) > 0.3,
                  prioritized=np.zeros(n, bool),
                  valid=rng.random(n) > 0.1)
        xb = dict(rows=prev, origin_rows=np.full(n, ra, np.int32),
                  chain_rows=np.full(n, ra, np.int32),
                  acquire=np.ones(n, np.int32),
                  rt_ms=rng.integers(0, 90, n).astype(np.int32),
                  error=rng.random(n) < 0.4, is_in=rng.random(n) > 0.2,
                  valid=prev < r_pad)
        times = np.asarray(sph._time_scalars(clk.now_ms()))
        js, jv = fused(sph._ruleset, js,
                       jp.EntryBatch(**{k: jnp.asarray(a)
                                        for k, a in eb.items()}),
                       jp.ExitBatch(**{k: jnp.asarray(a)
                                       for k, a in xb.items()}),
                       jnp.asarray(times), jnp.asarray(sysv))
        ts, tv = tp.decide_and_record_exits(
            tspec, trules, ts,
            tp.EntryBatch(**{k: torch.from_numpy(a) for k, a in eb.items()}),
            tp.ExitBatch(**{k: torch.from_numpy(a) for k, a in xb.items()}),
            tuple(int(x) for x in times), tuple(float(x) for x in sysv),
            scalar_flow=True, record_alt=False, sortfree=True, **flags)
        for f in ("allow", "reason", "wait_ms"):
            want = np.asarray(getattr(jv, f))
            got = getattr(tv, f).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{f}, step {step}")
        jd = convert.to_numpy(js)
        td = convert.to_numpy(ts)
        assert convert.leaf_diff(jd, td) == [], f"state, step {step}"
        prev = np.where(np.asarray(jv.allow) & eb["valid"], rows,
                        r_pad).astype(np.int32)
        clk.advance_ms(int(rng.integers(20, 400)))


def test_convert_round_trip_and_ignored_leaves():
    cfg = stpu.load_config(max_resources=32, max_flow_rules=4,
                           max_degrade_rules=4, host_fast_path=False)
    sph = stpu.Sentinel(config=cfg, clock=ManualClock())
    d = convert.to_numpy(sph._state)
    ts = convert.state_from_numpy(d)
    back = convert.to_numpy(ts)
    # the port carries every leaf, the param-flow ones included
    assert set(d) == set(back)
    assert any(k.startswith("param_dyn.") for k in back)
    assert convert.leaf_diff(d, back) == []
    rules = convert.ruleset_from_numpy(convert.to_numpy(sph._ruleset))
    assert rules.flow_idx.dtype == torch.int32
    # fresh tensors: updating the port's state leaves the dict untouched
    ts.second.counters.add_(1)
    assert d["second.counters"].sum() == 0


def test_off_route_steps_raise():
    """A scalar step refuses a prioritized batch (only the fast and
    general steps may book); an occupy step with one runs as the
    reference's does."""
    clk = ManualClock(start_ms=1_785_000_000_250)
    cfg = stpu.load_config(max_resources=32, max_flow_rules=4,
                           max_degrade_rules=4, host_fast_path=False)
    sph = stpu.Sentinel(config=cfg, clock=clk)
    sph.load_flow_rules([stpu.FlowRule(resource="svc", count=2.0)])
    spec = _port_spec(sph.spec)
    with pytest.raises(ValueError, match="prioritized"):
        tp.decide_entries(spec, None, None, None, (0, 0, 0, 0), (0.0, 0.0),
                          scalar_flow=True, record_alt=False,
                          enable_occupy=True, any_prio=True)
    row = sph.resources.lookup("svc")
    n, ra = 8, sph.spec.alt_rows
    eb = dict(rows=np.full(n, row, np.int32),
              origin_ids=np.zeros(n, np.int32),
              origin_rows=np.full(n, ra, np.int32),
              context_ids=np.zeros(n, np.int32),
              chain_rows=np.full(n, ra, np.int32),
              acquire=np.ones(n, np.int32), is_in=np.ones(n, bool),
              prioritized=np.arange(n) >= 4, valid=np.ones(n, bool))
    times = np.asarray(sph._time_scalars(clk.now_ms()))
    sysv = np.array([0.25, 0.1], np.float32)
    flags = dict(skip_auth=True, skip_sys=True, skip_threads=True,
                 scalar_has_rl=False, record_alt=False, fast_flow=True,
                 sortfree=True)
    js, jv = jax.jit(functools.partial(
        jp.decide_entries, sph.spec, enable_occupy=True, **flags))(
        sph._ruleset, sph._state,
        jp.EntryBatch(**{k: jnp.asarray(a) for k, a in eb.items()}),
        jnp.asarray(times), jnp.asarray(sysv))
    ts, tv = tp.decide_entries(
        spec, convert.ruleset_from_numpy(convert.to_numpy(sph._ruleset)),
        convert.state_from_numpy(convert.to_numpy(sph._state)),
        tp.EntryBatch(**{k: torch.from_numpy(a) for k, a in eb.items()}),
        tuple(int(x) for x in times), tuple(float(x) for x in sysv),
        enable_occupy=True, any_prio=True, **flags)
    for f in ("allow", "reason", "wait_ms"):
        np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                      np.asarray(getattr(jv, f)))
    # 2 pass, 2 denied, then the prioritized 4 book window now+1 (count 2)
    assert tv.allow.tolist() == [True] * 2 + [False] * 2 + [True] * 2 \
        + [False] * 2
    assert convert.leaf_diff(convert.to_numpy(js),
                             convert.to_numpy(ts)) == []


def test_init_state_matches_reference():
    cfg = stpu.load_config(max_resources=48, max_flow_rules=8,
                           max_degrade_rules=6, host_fast_path=False)
    sph = stpu.Sentinel(config=cfg, clock=ManualClock())
    want = convert.to_numpy(sph._state)
    got = convert.to_numpy(tp.init_state(_port_spec(sph.spec), 8, 6))
    assert convert.leaf_diff(want, got) == []
    assert dataclasses.fields(tp.EngineSpec)[0].name == "rows"
