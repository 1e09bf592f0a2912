"""Port parity: the rule compilers and the scalar-path checks of
``sentinel_tpu_torch.rules`` against ``sentinel_tpu.rules``.

Compilers are compared table by table (and registry by registry). The
device checks get identical numpy-seeded tables, state and batches; every
verdict (``allow``, ``wait_ms``) and every state leaf must be equal bit
for bit. The warm-up math is float32 throughout; the port reproduces the
reference's fused multiply-adds, so that comparison is exact as well.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.core import registry as jreg
from sentinel_tpu.rules import authority as jauth
from sentinel_tpu.rules import degrade as jdeg
from sentinel_tpu.rules import flow as jflow
from sentinel_tpu.rules import system as jsys
from sentinel_tpu.stats import window as jw
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core import registry as treg
from sentinel_tpu_torch.rules import authority as tauth
from sentinel_tpu_torch.rules import degrade as tdeg
from sentinel_tpu_torch.rules import flow as tflow
from sentinel_tpu_torch.rules import system as tsys
from sentinel_tpu_torch.stats import window as tw

from test_scalar_flow import DEG_RULES, MIXED_RULES

torch.set_num_threads(2)

R = 64
NF = ND = 16
J_SPEC, T_SPEC = jw.WindowSpec(2, 500), tw.WindowSpec(2, 500)
J_MIN, T_MIN = jw.MINUTE_SPEC, tw.MINUTE_SPEC


def _to_port(rule):
    """The port's rule object with the same field values."""
    cls = {"FlowRule": tflow.FlowRule, "DegradeRule": tdeg.DegradeRule,
           "AuthorityRule": tauth.AuthorityRule,
           "SystemRule": tsys.SystemRule}[type(rule).__name__]
    return cls(**dataclasses.asdict(rule))


def _registries(mod):
    return (mod.ResourceRegistry(R), mod.OriginRegistry(32),
            mod.Registry(64, reserved=("sentinel_default_context",)))


def _compile_flow(rules):
    jr, jo, jc = _registries(jreg)
    tr, to, tc = _registries(treg)
    kw = dict(capacity=NF, k_per_resource=4, num_rows=R, cold_factor=3.0)
    j = jflow.compile_flow_rules(rules, resource_registry=jr,
                                 context_registry=jc, origin_registry=jo,
                                 **kw)
    t = tflow.compile_flow_rules([_to_port(r) for r in rules],
                                 resource_registry=tr, context_registry=tc,
                                 origin_registry=to, **kw)
    return j, t, (jr, jo, jc), (tr, to, tc)


def _compile_degrade(rules):
    jr, _, _ = _registries(jreg)
    tr, _, _ = _registries(treg)
    kw = dict(capacity=ND, k_per_resource=4, num_rows=R)
    return (jdeg.compile_degrade_rules(rules, resource_registry=jr, **kw),
            tdeg.compile_degrade_rules([_to_port(r) for r in rules],
                                       resource_registry=tr, **kw), jr, tr)


def _same(jax_tree, port_tree):
    assert convert.leaf_diff(convert.to_numpy(jax_tree),
                             convert.to_numpy(port_tree)) == []


# ----------------------------------------------------------------------
# compilers
# ----------------------------------------------------------------------

def test_compile_flow_rules_table_by_table():
    j, t, jregs, tregs = _compile_flow(MIXED_RULES)
    _same(j.table, t.table)
    np.testing.assert_array_equal(t.rule_idx.numpy(), np.asarray(j.rule_idx))
    np.testing.assert_array_equal(t.rule_idx_np, j.rule_idx_np)
    assert (t.num_active, t.k_used) == (j.num_active, j.k_used)
    assert [dataclasses.asdict(r) for r in t.rules] == \
        [dataclasses.asdict(r) for r in j.rules]
    for a, b in zip(jregs, tregs):
        assert a.items() == b.items()


def test_compile_flow_rules_rejects_like_reference():
    too_many = [stpu.FlowRule(resource="x", count=1.0)] * 5
    with pytest.raises(ValueError):
        _compile_flow(too_many)


def test_compile_degrade_rules_table_by_table():
    j, t, jr, tr = _compile_degrade(DEG_RULES + [
        stpu.DegradeRule(resource="bad", grade=9, count=1, time_window=1)])
    _same(j.table, t.table)
    np.testing.assert_array_equal(t.rule_idx.numpy(), np.asarray(j.rule_idx))
    assert (t.num_active, t.k_used) == (j.num_active, j.k_used)
    assert jr.items() == tr.items()


def test_compile_authority_and_system_rules():
    rules = [stpu.AuthorityRule(resource="a", limit_app="app1,app2"),
             stpu.AuthorityRule(resource="b", limit_app="app3",
                                strategy=stpu.STRATEGY_BLACK)]
    jr, jo, _ = _registries(jreg)
    tr, to, _ = _registries(treg)
    kw = dict(capacity=8, k_per_resource=2, num_rows=R)
    j = jauth.compile_authority_rules(rules, resource_registry=jr,
                                      origin_registry=jo, **kw)
    t = tauth.compile_authority_rules([_to_port(r) for r in rules],
                                      resource_registry=tr,
                                      origin_registry=to, **kw)
    _same(j.table, t.table)
    np.testing.assert_array_equal(t.rule_idx.numpy(), np.asarray(j.rule_idx))
    assert jo.items() == to.items()
    srules = [stpu.SystemRule(qps=100.5), stpu.SystemRule(qps=40.0,
                                                          avg_rt=12.0),
              stpu.SystemRule(highest_system_load=2.5)]
    _same(jsys.compile_system_rules(srules),
          tsys.compile_system_rules([_to_port(r) for r in srules]))
    _same(jsys.compile_system_rules([]), tsys.compile_system_rules([]))


# ----------------------------------------------------------------------
# flow_check_scalar
# ----------------------------------------------------------------------

def _window(rng, now_idx, rows=R):
    stamps = (now_idx + rng.integers(-2, 1, (rows, 2))).astype(np.int32)
    return {"counters": rng.integers(0, 6, (rows, 2, 8)).astype(np.int32),
            "stamps": stamps,
            "rt_sum": rng.integers(0, 100, (rows, 2)).astype(np.float32),
            "min_rt": rng.integers(0, 100, (rows, 2)).astype(np.int32)}


def _minute(rng, now_idx_m):
    stamps = (now_idx_m + rng.integers(-61, 1, (R, 60))).astype(np.int32)
    return {"counters": rng.integers(0, 30, (R, 60, 8)).astype(np.int32),
            "stamps": stamps,
            "rt_sum": np.zeros((R, 60), np.float32),
            "min_rt": np.zeros((R, 60), np.int32)}


def _jws(d):
    return jw.WindowState(**{k: jnp.asarray(v) for k, v in d.items()})


def _tws(d):
    return tw.WindowState(**{k: torch.from_numpy(v.copy())
                             for k, v in d.items()})


def _jax_flow(has_rl, occupy_base=False):
    return jax.jit(functools.partial(
        jflow.flow_check_scalar, spec=J_SPEC, minute_spec=J_MIN,
        has_rate_limiter=has_rl, occupy_base=occupy_base, sortfree=True))


def _run_flow_steps(rules, names, *, steps, n, acquire, seed,
                    has_rl=True, occupy=None, dt=(20, 400)):
    j, t, jregs, _ = _compile_flow(rules)
    rows_of = [jregs[0].get_or_create(x) for x in names]
    rng = np.random.default_rng(seed)
    jdyn = jflow.init_flow_dyn(NF, 2, R)
    if occupy is not None:
        jdyn = jdyn._replace(occupied_count=jnp.asarray(occupy[0]),
                             occupied_window=jnp.asarray(occupy[1]))
    tdyn = convert.from_numpy(tflow.FlowDynState, convert.to_numpy(jdyn))
    jf = _jax_flow(has_rl, occupy_base=occupy is not None)
    now_ms, epoch = 1_785_000_000_000, 1_784_999_000_000
    for step in range(steps):
        idx_s, idx_m = J_SPEC.index_of(now_ms), J_MIN.index_of(now_ms)
        rel = now_ms - epoch
        sec, mnt = _window(rng, idx_s), _minute(rng, idx_m)
        threads = rng.integers(0, 6, R).astype(np.int32)
        rows = np.array([rows_of[i] for i in
                         rng.integers(0, len(names), n)], np.int32)
        rows[::11] = R                                  # padding
        valid = rng.random(n) > 0.15
        acq = np.full(n, acquire, np.int32)
        jdyn, ja, jwt = jf(j.table, jdyn, j.rule_idx, main_second=_jws(sec),
                           main_threads=jnp.asarray(threads),
                           rows=jnp.asarray(rows), acquire=jnp.asarray(acq),
                           valid=jnp.asarray(valid),
                           now_idx_s=jnp.int32(idx_s),
                           rel_now_ms=jnp.int32(rel),
                           main_minute=_jws(mnt), now_idx_m=jnp.int32(idx_m))
        tdyn, ta, twt = tflow.flow_check_scalar(
            t.table, tdyn, t.rule_idx, T_SPEC, _tws(sec),
            torch.from_numpy(threads), torch.from_numpy(rows),
            torch.from_numpy(acq), torch.from_numpy(valid), idx_s, rel,
            minute_spec=T_MIN, main_minute=_tws(mnt), now_idx_m=idx_m,
            has_rate_limiter=has_rl, occupy_base=occupy is not None)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja),
                                      err_msg=f"allow, step {step}")
        np.testing.assert_array_equal(twt.numpy(), np.asarray(jwt),
                                      err_msg=f"wait_ms, step {step}")
        _same(jdyn, tdyn)
        now_ms += int(rng.integers(*dt))
    return np.asarray(ja), np.asarray(jwt)


FLOW_NAMES = ["qps", "qps2", "thread", "warm", "paced", "wurl", "rel",
              "chain", "clus", "zero_rl", "free1", "free2"]


@pytest.mark.parametrize("acquire", [1, 3])
def test_flow_check_scalar_mixed_rules(acquire):
    _run_flow_steps(MIXED_RULES, FLOW_NAMES, steps=10, n=96,
                    acquire=acquire, seed=7)


def test_flow_check_scalar_without_rate_limiter_columns():
    rules = [r for r in MIXED_RULES if r.control_behavior not in (
        stpu.BEHAVIOR_RATE_LIMITER, stpu.BEHAVIOR_WARM_UP_RATE_LIMITER)]
    _run_flow_steps(rules, FLOW_NAMES, steps=6, n=64, acquire=1, seed=3,
                    has_rl=False)


def test_flow_check_scalar_landed_bookings():
    """occupy_base: LANDED bookings on a rule's row join its QPS base."""
    rng = np.random.default_rng(1)
    idx = J_SPEC.index_of(1_785_000_000_000)
    occ_c = rng.integers(0, 4, (R, 3)).astype(np.float32)
    occ_w = (idx + rng.integers(-3, 2, (R, 3))).astype(np.int32)
    _run_flow_steps(MIXED_RULES, FLOW_NAMES, steps=1, n=64, acquire=1,
                    seed=5, occupy=(occ_c, occ_w))


def test_rate_limiter_pacing_ladder():
    """The closed-form rate limiter: wait_ms = k * cost for the k-th
    admitted event, and the pacing clock carried across steps."""
    rules = [stpu.FlowRule(resource="p", count=10.0,
                           control_behavior=stpu.BEHAVIOR_RATE_LIMITER,
                           max_queueing_time_ms=500)]
    allow, wait = _run_flow_steps(rules, ["p"], steps=4, n=8, acquire=1,
                                  seed=0, dt=(137, 138))
    assert wait.max() > 0


def test_rate_limiter_high_rank_does_not_overflow():
    """count=0.01 → cost 100000 ms: ranks up to 2^15 push rank*cost past
    2^31, yet exactly the one immediate event is admitted."""
    rules = [stpu.FlowRule(resource="slowpace", count=0.01,
                           control_behavior=stpu.BEHAVIOR_RATE_LIMITER,
                           max_queueing_time_ms=500)]
    j, t, jregs, _ = _compile_flow(rules)
    row = jregs[0].get_or_create("slowpace")
    n = 1 << 15
    rows = np.full(n, row, np.int32)
    zeros = np.zeros((R, 2, 8), np.int32)
    sec = {"counters": zeros, "stamps": np.zeros((R, 2), np.int32),
           "rt_sum": np.zeros((R, 2), np.float32),
           "min_rt": np.zeros((R, 2), np.int32)}
    jdyn = jflow.init_flow_dyn(NF, 2, R)
    tdyn = convert.from_numpy(tflow.FlowDynState, convert.to_numpy(jdyn))
    jf = jax.jit(functools.partial(jflow.flow_check_scalar, spec=J_SPEC,
                                   has_rate_limiter=True, sortfree=True))
    jdyn, ja, jwt = jf(j.table, jdyn, j.rule_idx, main_second=_jws(sec),
                       main_threads=jnp.zeros(R, jnp.int32),
                       rows=jnp.asarray(rows), acquire=jnp.ones(n, jnp.int32),
                       valid=jnp.ones(n, jnp.bool_), now_idx_s=jnp.int32(5),
                       rel_now_ms=jnp.int32(1000))
    tdyn, ta, twt = tflow.flow_check_scalar(
        t.table, tdyn, t.rule_idx, T_SPEC, _tws(sec),
        torch.zeros(R, dtype=torch.int32), torch.from_numpy(rows),
        torch.ones(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
        5, 1000, has_rate_limiter=True)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(twt.numpy(), np.asarray(jwt))
    _same(jdyn, tdyn)
    assert int(ta.sum()) == 1 and bool(ta[0]) and int(twt[0]) == 0


def test_warmup_token_math_random_tables():
    """_warmup_sync_and_limits over 4000 random warm-up rules: token refill
    and the warning-zone limit are non-exact float32 expressions; the
    reference's fused multiply-adds are reproduced exactly."""
    rng = np.random.default_rng(1)
    nf, cf = 4000, 3.0
    count = rng.uniform(0.5, 500, nf + 1).astype(np.float32)
    period = rng.integers(1, 20, nf + 1)
    wt = (period * count) / (cf - 1.0)
    mt = wt + 2.0 * period * count / (1.0 + cf)
    slope = (cf - 1.0) / count / np.maximum(mt - wt, 1e-9)
    tab = dict(
        active=np.ones(nf + 1, bool), grade=np.ones(nf + 1, np.int32),
        count=count, behavior=np.ones(nf + 1, np.int32),
        sel_kind=np.zeros(nf + 1, np.int32), ref_row=np.zeros(nf + 1, np.int32),
        ref_context=np.full(nf + 1, -1, np.int32),
        limit_origin=np.full(nf + 1, -1, np.int32),
        max_queue_ms=np.zeros(nf + 1, np.int32),
        warning_token=wt.astype(np.float32), max_token=mt.astype(np.float32),
        slope=slope.astype(np.float32),
        cold_factor=np.full(nf + 1, cf, np.float32),
        sync_row=rng.integers(0, R, nf + 1).astype(np.int32),
        cluster_mode=np.zeros(nf + 1, bool))
    dyn = dict(latest_passed_ms=np.zeros(nf + 1, np.int32),
               stored_tokens=(rng.uniform(0, 1, nf + 1) * mt).astype(
                   np.float32),
               last_filled_sec=rng.integers(-5, 0, nf + 1).astype(np.int32),
               occupied_count=np.zeros((R, 3), np.float32),
               occupied_window=np.zeros((R, 3), np.int32))
    sec = {"counters": rng.integers(0, 1000, (R, 2, 8)).astype(np.int32),
           "stamps": rng.integers(98, 101, (R, 2)).astype(np.int32),
           "rt_sum": np.zeros((R, 2), np.float32),
           "min_rt": np.zeros((R, 2), np.int32)}
    f = jax.jit(lambda t, d, w: jflow._warmup_sync_and_limits(
        t, d, J_SPEC, w, jnp.int32(100), jnp.int32(3500), None, None, None))
    jd, je = f(jflow.FlowRuleTable(**{k: jnp.asarray(v)
                                      for k, v in tab.items()}),
               jflow.FlowDynState(**{k: jnp.asarray(v)
                                     for k, v in dyn.items()}), _jws(sec))
    td, te = tflow._warmup_sync_and_limits(
        tflow.FlowRuleTable(**{k: torch.from_numpy(v)
                               for k, v in tab.items()}),
        tflow.FlowDynState(**{k: torch.from_numpy(v)
                              for k, v in dyn.items()}),
        T_SPEC, _tws(sec), 100, 3500, None, None, None)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _same(jd, td)


def test_f32_to_i32_saturates_like_xla():
    x = np.array([1e12, -1e12, 3e9, -3e9, np.nan, 2.0 ** 31, -2.0 ** 31,
                  123.9, -123.9, 0.0], np.float32)
    want = np.asarray(jax.jit(lambda v: v.astype(jnp.int32))(jnp.asarray(x)))
    np.testing.assert_array_equal(
        tflow._f32_to_i32(torch.from_numpy(x)).numpy(), want)


# ----------------------------------------------------------------------
# degrade_entry_check (the scalar form) / degrade_exit_feed
# ----------------------------------------------------------------------

def test_degrade_scalar_trip_probe_arcs():
    """Trip → OPEN → probe (HALF_OPEN) → resolve arcs over entry+exit
    sequences, with the breaker state carried in both packages."""
    j, t, jr, _ = _compile_degrade(DEG_RULES)
    names = ["qps", "brk", "slow", "free1"]
    rows_of = [jr.get_or_create(x) for x in names]
    rng = np.random.default_rng(3)
    jst = jdeg.init_breaker_state(ND)
    tst = tdeg.init_breaker_state(ND)
    je = jax.jit(jdeg.degrade_entry_check_scalar)
    jx = jax.jit(jdeg.degrade_exit_feed)
    rel = 5_000
    arcs = set()
    for step in range(24):
        n = 32
        rows = np.array([rows_of[i] for i in rng.integers(0, 4, n)],
                        np.int32)
        rows[::9] = R
        valid = rng.random(n) > 0.1
        jst, ja = je(j.table, jst, j.rule_idx, jnp.asarray(rows),
                     jnp.asarray(valid), jnp.int32(rel))
        tst, ta = tdeg.degrade_entry_check(
            t.table, tst, t.rule_idx, torch.from_numpy(rows),
            torch.from_numpy(valid), rel)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        _same(jst, tst)
        arcs.update(np.asarray(jst.state).tolist())
        done = np.asarray(ja) & valid
        rt = rng.integers(1, 60, n).astype(np.int32)
        err = rng.random(n) < 0.6
        jst = jx(j.table, jst, j.rule_idx, jnp.asarray(rows),
                 jnp.asarray(rt), jnp.asarray(err), jnp.asarray(done),
                 jnp.int32(rel))
        tst = tdeg.degrade_exit_feed(
            t.table, tst, t.rule_idx, torch.from_numpy(rows),
            torch.from_numpy(rt), torch.from_numpy(err),
            torch.from_numpy(done), rel)
        _same(jst, tst)
        arcs.update(np.asarray(jst.state).tolist())
        rel += int(rng.integers(100, 1500))
    # the run crossed every breaker state
    assert {jdeg.STATE_CLOSED, jdeg.STATE_OPEN, jdeg.STATE_HALF_OPEN} <= arcs


# ----------------------------------------------------------------------
# system_check / authority_check
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_system_check(seed):
    rng = np.random.default_rng(seed)
    srules = [stpu.SystemRule(qps=float(rng.integers(5, 60)),
                              max_thread=float(rng.integers(2, 30)),
                              avg_rt=float(rng.integers(5, 50)),
                              highest_system_load=0.5)]
    jt = jsys.compile_system_rules(srules)
    tt = tsys.compile_system_rules([_to_port(r) for r in srules])
    idx = 1000
    sec = _window(rng, idx)
    sec["counters"] = rng.integers(0, 20, (R, 2, 8)).astype(np.int32)
    threads = rng.integers(0, 40, R).astype(np.int32)
    n = 80
    is_in = rng.random(n) > 0.3
    acq = np.full(n, 2, np.int32)
    valid = rng.random(n) > 0.1
    load1 = float(np.float32(rng.uniform(0, 1)))
    want = jax.jit(functools.partial(jsys.system_check, spec=J_SPEC,
                                     statistic_max_rt=5000))(
        jt, main_second=_jws(sec), main_threads=jnp.asarray(threads),
        is_in=jnp.asarray(is_in), acquire=jnp.asarray(acq),
        valid=jnp.asarray(valid), now_idx_s=jnp.int32(idx),
        load1=jnp.float32(load1), cpu_usage=jnp.float32(0.25))
    got = tsys.system_check(tt, T_SPEC, _tws(sec), torch.from_numpy(threads),
                            torch.from_numpy(is_in), torch.from_numpy(acq),
                            torch.from_numpy(valid), idx, load1, 0.25, 5000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_authority_check():
    rules = [stpu.AuthorityRule(resource="a", limit_app="app1,app2"),
             stpu.AuthorityRule(resource="b", limit_app="app3",
                                strategy=stpu.STRATEGY_BLACK),
             stpu.AuthorityRule(resource="b", limit_app="app1")]
    jr, jo, _ = _registries(jreg)
    tr, to, _ = _registries(treg)
    kw = dict(capacity=8, k_per_resource=2, num_rows=R)
    j = jauth.compile_authority_rules(rules, resource_registry=jr,
                                      origin_registry=jo, **kw)
    t = tauth.compile_authority_rules([_to_port(r) for r in rules],
                                      resource_registry=tr,
                                      origin_registry=to, **kw)
    rng = np.random.default_rng(4)
    rows_of = [jr.get_or_create(x) for x in ("a", "b", "c")]
    oids = [0] + [jo.get_or_create(o) for o in ("app1", "app2", "app3",
                                                "zzz")]
    n = 100
    rows = np.array([rows_of[i] for i in rng.integers(0, 3, n)], np.int32)
    rows[::13] = R
    origin = np.array([oids[i] for i in rng.integers(0, 5, n)], np.int32)
    valid = rng.random(n) > 0.1
    want = jauth.authority_check(j.table, j.rule_idx, jnp.asarray(rows),
                                 jnp.asarray(origin), jnp.asarray(valid))
    got = tauth.authority_check(t.table, t.rule_idx, torch.from_numpy(rows),
                                torch.from_numpy(origin),
                                torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.asarray(want).all()


def test_port_rule_objects_mirror_reference():
    for jcls, tcls in ((stpu.FlowRule, stt.FlowRule),
                       (stpu.DegradeRule, stt.DegradeRule),
                       (stpu.AuthorityRule, stt.AuthorityRule),
                       (stpu.SystemRule, stt.SystemRule)):
        jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
        tf = [(f.name, f.default) for f in dataclasses.fields(tcls)]
        assert jf == tf
    for name in ("GRADE_QPS", "GRADE_THREAD", "BEHAVIOR_WARM_UP",
                 "BEHAVIOR_RATE_LIMITER", "BEHAVIOR_WARM_UP_RATE_LIMITER",
                 "STRATEGY_RELATE", "STRATEGY_CHAIN", "GRADE_RT",
                 "GRADE_EXCEPTION_RATIO", "GRADE_EXCEPTION_COUNT",
                 "STRATEGY_WHITE", "STRATEGY_BLACK"):
        assert getattr(stt, name) == getattr(stpu, name)


# ----------------------------------------------------------------------
# arrival ranks and index helpers (ops/segments.py, ops/sortfree.py)
# ----------------------------------------------------------------------

def test_ranks_match_reference():
    from sentinel_tpu.ops import segments as jseg
    from sentinel_tpu.ops import sortfree as jsf
    from sentinel_tpu_torch.ops import segments as tseg
    from sentinel_tpu_torch.ops import sortfree as tsf
    rng = np.random.default_rng(8)
    key = rng.integers(0, 40, 3000).astype(np.int32)
    key2d = rng.integers(0, 40, (700, 3)).astype(np.int32)
    key2d[:, 1] += 40                      # disjoint key groups per slot
    jk, tk = jnp.asarray(key), torch.from_numpy(key)
    pairs = [
        (jseg.ranks_by_key(jk), tseg.ranks_by_key(tk)),
        (jsf.scatter_ranks(jk, 40), tsf.scatter_ranks(tk, 40)),
        (jseg.ranks_per_slot(jnp.asarray(key2d)),
         tseg.ranks_per_slot(torch.from_numpy(key2d))),
        (jsf.ranks2d_ident(jnp.asarray(key2d), 120),
         tsf.ranks2d_ident(torch.from_numpy(key2d), 120)),
        (jseg.first_index_by_key(jk, 50), tseg.first_index_by_key(tk, 50)),
    ]
    for want, got in pairs:
        want = np.asarray(want)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_padded_table_gather_and_repeat():
    from sentinel_tpu.ops import segments as jseg
    from sentinel_tpu_torch.ops import segments as tseg
    rng = np.random.default_rng(9)
    table = rng.integers(0, 99, (20, 3)).astype(np.int32)
    rows = np.array([0, 5, 19, 20, 25, -1, -20], np.int32)
    want = jseg.padded_table_gather(jnp.asarray(table), jnp.asarray(rows), 77)
    got = tseg.padded_table_gather(torch.from_numpy(table),
                                   torch.from_numpy(rows), 77)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.integers(0, 9, 11).astype(np.int32)
    np.testing.assert_array_equal(
        tseg.repeat_each(torch.from_numpy(x), 3).numpy(), np.repeat(x, 3))
