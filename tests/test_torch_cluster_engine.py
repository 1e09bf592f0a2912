"""Port parity: the sharded cluster token engine
(``sentinel_tpu_torch.parallel.cluster``) against
``sentinel_tpu.parallel.cluster``.

The JAX engine runs on an S-device mesh of the conftest's 8 virtual CPU
devices; the port's runs its S logical shards on the CPU. Each scenario
of the reference's ``tests/test_cluster_parallel.py`` runs on both
packages at S ∈ {1, 2, 8} (the row geometry scaled so the rules fit):
its own assertions hold on both, and the verdict tuples,
``flow_metrics``, ``top_params`` and the three windows and the rule
table (``convert.cluster_to_numpy``) agree bit for bit. An AVG_LOCAL
rule whose threshold passes 2^31 checks the saturating float → int32
cast; ``test_torch_cluster_fuzz.py`` mixes every path of the step.
"""

import numpy as np
import pytest
import torch

from sentinel_tpu.parallel import cluster as jc
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.ops import scatter_add as sa
from sentinel_tpu_torch.parallel import cluster as tc
from sentinel_tpu_torch.parallel import shard_math

torch.set_num_threads(2)

NOW0 = 10_000_000
PKGS = {"jax": jc, "torch": tc}
SHARDS = (1, 2, 8)


#: the JAX engines' jitted steps by geometry: every engine of one spec
#: builds the same program on the same mesh, so later engines reuse the
#: first one's (and its compiled shapes) instead of compiling again
_JAX_STEPS = {}


def _engine(m, spec_kw, **kw):
    spec = m.ClusterSpec(**spec_kw)
    if m is tc:
        return tc.ClusterEngine(spec, device="cpu", **kw)
    eng = jc.ClusterEngine(spec, **kw)
    eng._step = _JAX_STEPS.setdefault(spec, eng._step)
    return eng


def twin(scenario, S):
    """Run ``scenario(m, make)`` on both packages (``make(rows=128,
    **spec)`` builds an engine of ``S`` shards holding ``rows`` flow rows)
    → the port's observations; observations and every engine's state and
    table must agree."""
    got, engines = {}, {}
    for name, m in PKGS.items():
        made = []

        def make(rows=128, namespaces=4, **kw):
            spec = dict(n_shards=S, flows_per_shard=max(1, rows // S),
                        namespaces=namespaces,
                        **{k: v for k, v in kw.items()
                           if k in ("param_keys_per_shard", "max_params")})
            eng = _engine(m, spec, **{k: v for k, v in kw.items()
                                      if k == "default_ns_qps"})
            made.append(eng)
            return eng

        got[name] = scenario(m, make)
        engines[name] = made
    assert got["torch"] == got["jax"]
    for je, te in zip(engines["jax"], engines["torch"]):
        assert convert.leaf_diff(convert.cluster_to_numpy(je),
                                 convert.cluster_to_numpy(te)) == []
    return got["torch"]


def oks(res, m):
    return sum(1 for s, _, _ in res if s == m.STATUS_OK)


# ------------------------------------------------ test_cluster_parallel.py

def scn_global_threshold_exact_admission(m, make):
    eng = make()
    eng.load_rules("ns-a", [m.ClusterFlowRule(
        flow_id=101, count=10, threshold_type=m.THRESHOLD_GLOBAL)])
    res = eng.request_tokens([101] * 15, [1] * 15, now_ms=NOW0)
    blocked = sum(1 for s, _, _ in res if s == m.STATUS_BLOCKED)
    assert oks(res, m) == 10 and blocked == 5
    return res, eng.flow_metrics(101, now_ms=NOW0)


def scn_avg_local_threshold_scales_with_connected_count(m, make):
    eng = make()
    eng.load_rules("ns-a", [m.ClusterFlowRule(
        flow_id=7, count=5, threshold_type=m.THRESHOLD_AVG_LOCAL)])
    eng.set_connected_count("ns-a", 3)
    res = eng.request_tokens([7] * 20, [1] * 20, now_ms=NOW0)
    assert oks(res, m) == 15  # 5 × 3 connected clients
    return res


def scn_window_slide_replenishes(m, make):
    eng = make()
    eng.load_rules("ns-a", [m.ClusterFlowRule(
        flow_id=1, count=4, threshold_type=m.THRESHOLD_GLOBAL)])
    r1 = eng.request_tokens([1] * 6, [1] * 6, now_ms=NOW0)
    assert oks(r1, m) == 4
    # 1 s later the whole 10×100 ms window has rotated
    r2 = eng.request_tokens([1] * 6, [1] * 6, now_ms=NOW0 + 1100)
    assert oks(r2, m) == 4
    return r1, r2, eng.flow_metrics(1, now_ms=NOW0 + 1100)


def scn_unknown_flow_is_no_rule(m, make):
    eng = make()
    res = eng.request_tokens([999], [1], now_ms=NOW0)
    assert res[0][0] == m.STATUS_NO_RULE_EXISTS
    return res


def scn_namespace_request_limiter_too_many(m, make):
    eng = make()
    eng.load_rules("ns-a", [m.ClusterFlowRule(
        flow_id=5, count=1e9, threshold_type=m.THRESHOLD_GLOBAL)])
    eng.set_namespace_qps_limit("ns-a", 10)
    res = eng.request_tokens([5] * 25, [1] * 25, now_ms=NOW0)
    many = sum(1 for s, _, _ in res if s == m.STATUS_TOO_MANY_REQUEST)
    assert oks(res, m) == 10 and many == 15
    return res


def scn_namespace_limiter_is_global_across_shards(m, make):
    """Flows on different shards share one namespace budget (the psum)."""
    eng = make()
    eng.load_rules("ns-a", [
        m.ClusterFlowRule(flow_id=1, count=1e9,
                          threshold_type=m.THRESHOLD_GLOBAL),
        m.ClusterFlowRule(flow_id=2, count=1e9,
                          threshold_type=m.THRESHOLD_GLOBAL),
    ])
    eng.set_namespace_qps_limit("ns-a", 10)
    r1 = eng.request_tokens([1] * 10, [1] * 10, now_ms=NOW0)
    res = eng.request_tokens([2] * 5, [1] * 5, now_ms=NOW0 + 1)
    assert all(s == m.STATUS_TOO_MANY_REQUEST for s, _, _ in res)
    return r1, res


def scn_acquire_weights_count_against_threshold(m, make):
    eng = make()
    eng.load_rules("ns-a", [m.ClusterFlowRule(
        flow_id=3, count=10, threshold_type=m.THRESHOLD_GLOBAL)])
    res = eng.request_tokens([3, 3, 3], [4, 4, 4], now_ms=NOW0)
    statuses = [s for s, _, _ in res]
    assert statuses.count(m.STATUS_OK) == 2
    assert statuses.count(m.STATUS_BLOCKED) == 1
    return res


def scn_remaining_decreases(m, make):
    eng = make()
    eng.load_rules("ns-a", [m.ClusterFlowRule(
        flow_id=4, count=10, threshold_type=m.THRESHOLD_GLOBAL)])
    res = eng.request_tokens([4, 4], [3, 3], now_ms=NOW0)
    assert res[0][2] == 7 and res[1][2] == 4
    return res


def scn_prioritized_should_wait(m, make):
    eng = make()
    eng.load_rules("ns-a", [m.ClusterFlowRule(
        flow_id=6, count=5, threshold_type=m.THRESHOLD_GLOBAL)])
    r0 = eng.request_tokens([6] * 5, [1] * 5, now_ms=NOW0)
    r_np = eng.request_tokens([6], [1], now_ms=NOW0 + 10)
    r_p = eng.request_tokens([6], [1], [True], now_ms=NOW0 + 10)
    assert r_np[0][0] == m.STATUS_BLOCKED
    assert r_p[0][0] == m.STATUS_SHOULD_WAIT
    assert 0 < r_p[0][1] <= 1000
    return r0, r_np, r_p, eng.flow_metrics(6, now_ms=NOW0 + 10)


def scn_rules_across_many_shards(m, make):
    eng = make()
    rules = [m.ClusterFlowRule(flow_id=i, count=2,
                               threshold_type=m.THRESHOLD_GLOBAL)
             for i in range(100, 124)]
    eng.load_rules("ns-spread", rules)
    ids = [r.flow_id for r in rules for _ in range(3)]
    res = eng.request_tokens(ids, [1] * len(ids), now_ms=NOW0)
    by_flow = {}
    for fid, (s, _, _) in zip(ids, res):
        by_flow.setdefault(fid, []).append(s)
    for fid, sts in by_flow.items():
        assert sts.count(m.STATUS_OK) == 2, (fid, sts)
        assert sts.count(m.STATUS_BLOCKED) == 1
    return res


def scn_rule_reload_churn_reuses_rows_and_clears_counters(m, make):
    eng = make(rows=8, namespaces=2)
    out = []
    for gen in range(12):
        fid = 1000 + gen
        eng.load_rules("ns", [m.ClusterFlowRule(
            flow_id=fid, count=3, threshold_type=m.THRESHOLD_GLOBAL)])
        res = eng.request_tokens([fid] * 3, [1] * 3, now_ms=NOW0 + gen)
        assert all(s == m.STATUS_OK for s, _, _ in res), (gen, res)
        out.append(res)
    return out


def scn_non_positive_acquire_is_bad_request(m, make):
    eng = make()
    eng.load_rules("ns-a", [m.ClusterFlowRule(flow_id=1, count=5)])
    res = eng.request_tokens([1, 1, 1], [0, -5, 1], now_ms=NOW0)
    assert res[0][0] == m.STATUS_BAD_REQUEST
    assert res[1][0] == m.STATUS_BAD_REQUEST
    assert res[2][0] == m.STATUS_OK
    return res


def scn_rule_reload_drops_removed_flows(m, make):
    eng = make()
    eng.load_rules("ns-a", [m.ClusterFlowRule(flow_id=1, count=5),
                            m.ClusterFlowRule(flow_id=2, count=5)])
    eng.load_rules("ns-a", [m.ClusterFlowRule(flow_id=2, count=5)])
    res = eng.request_tokens([1, 2], [1, 1], now_ms=NOW0)
    assert res[0][0] == m.STATUS_NO_RULE_EXISTS
    assert res[1][0] == m.STATUS_OK
    return res


SCENARIOS = [v for k, v in sorted(globals().items())
             if k.startswith("scn_")]


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=lambda f: f.__name__[4:])
def test_scenario_matches_reference(scenario, S):
    twin(scenario, S)


def scn_saturating_cast(m, make):
    """count 1e9 × 3 connected clients = 3e9 > 2^31 - 1: XLA saturates
    the remaining-tokens cast, a plain torch cast would not."""
    eng = make()
    eng.load_rules("ns-a", [m.ClusterFlowRule(
        flow_id=1, count=1e9, threshold_type=m.THRESHOLD_AVG_LOCAL)])
    eng.set_connected_count("ns-a", 3)
    eng.set_namespace_qps_limit("ns-a", 1e9)
    res = eng.request_tokens([1] * 4, [1] * 4, now_ms=NOW0)
    assert [r[2] for r in res] == [2 ** 31 - 1] * 4
    return res


@pytest.mark.parametrize("S", SHARDS)
def test_saturating_cast_matches_reference(S):
    twin(scn_saturating_cast, S)


# ------------------------------------------------- the port on its own

def test_non_flow_lanes_of_every_shard_share_the_infinite_segment():
    """Param lanes on every shard fall into the flow step's never-blocking
    segment, merged across shards at an infinite limit: they change no
    flow verdict, and the port's launches are the plan's (3 a step with
    hot keys: flows, namespaces, params)."""
    S = 4
    eng = tc.ClusterEngine(tc.ClusterSpec(
        n_shards=S, flows_per_shard=4, namespaces=2,
        param_keys_per_shard=8), device="cpu")
    eng.load_rules("ns", [tc.ClusterFlowRule(
        flow_id=i, count=2.0, threshold_type=tc.THRESHOLD_GLOBAL)
        for i in range(S)])
    eng.load_param_rules("ns", [tc.ClusterParamFlowRule(
        flow_id=10 + i, count=1.0, threshold_type=tc.THRESHOLD_GLOBAL)
        for i in range(S)])
    flows = eng.request_tokens(list(range(S)) * 3, [1] * 3 * S,
                               now_ms=NOW0)
    assert [s for s, _, _ in flows] == [tc.STATUS_OK] * 2 * S \
        + [tc.STATUS_BLOCKED] * S
    params = eng.request_param_tokens([10 + i for i in range(S)] * 2,
                                      [1] * 2 * S, [["u"]] * 2 * S,
                                      now_ms=NOW0)
    assert [s for s, _, _ in params] == [tc.STATUS_OK] * S \
        + [tc.STATUS_BLOCKED] * S


def test_global_pads_never_reach_a_live_row():
    """Shard s's local pad L is global row (s+1)·L, a live row of the
    next shard: the step must send its pads past the whole table. Every
    lane of shard 0 is invalid padding here; shard 1's row 0 must count
    only its own requests."""
    eng = tc.ClusterEngine(tc.ClusterSpec(
        n_shards=2, flows_per_shard=4, namespaces=2), device="cpu")
    eng.load_rules("ns", [tc.ClusterFlowRule(
        flow_id=i, count=100.0, threshold_type=tc.THRESHOLD_GLOBAL)
        for i in range(2)])
    assert eng._flow_to_row == {0: 0, 1: 4}
    eng.request_tokens([1] * 3, [1] * 3, now_ms=NOW0)
    assert eng.flow_metrics(1, now_ms=NOW0)["pass"] == 3
    assert eng.flow_metrics(0, now_ms=NOW0)["pass"] == 0
    ns = convert.cluster_to_numpy(eng)["state.ns.counters"]
    assert int(ns[..., 0].sum()) == 3


def test_shard_math_matches_reference():
    from sentinel_tpu.parallel import shard_math as jsm
    rng = np.random.default_rng(5)
    rowg = rng.integers(-1, 64, 300)
    acq = rng.integers(-1, 4, 300)
    prio = rng.random(300) < 0.3
    st = rng.integers(-4, 8, 4 * 128)
    kw = dict(status_fail=-1, status_bad=-4, status_no_rule=3)
    outs = []
    for mod in (jsm, shard_math):
        lanes, plan = mod.route_requests(rowg, acq, prio, 4, 16, **kw)
        v = st[:4 * lanes.lanes]
        back = mod.scatter_verdicts(plan, lanes.lanes, v, v * 2, v * 3, 4)
        local = mod.mask_to_local_lanes(lanes, plan, [1, 3])
        outs.append((tuple(np.asarray(x).tolist() for x in lanes),
                     tuple(np.asarray(x).tolist() for x in plan), back,
                     tuple(np.asarray(x).tolist() for x in local)))
        assert mod.owner_shard(np.array([17]), 16)[0] == 1
        assert mod.local_row(np.array([17]), 16)[0] == 1
        with pytest.raises(ValueError, match="does not divide"):
            mod.validate_divisible("rows", 10, 4)
    assert outs[0] == outs[1]


def test_cluster_from_numpy_carries_a_reference_engine():
    """A JAX engine's state and table, carried into the port, decide the
    next batch as the JAX engine does."""
    spec = dict(n_shards=2, flows_per_shard=8, namespaces=2,
                param_keys_per_shard=8)
    je = jc.ClusterEngine(jc.ClusterSpec(**spec))
    te = tc.ClusterEngine(tc.ClusterSpec(**spec), device="cpu")
    for eng, m in ((je, jc), (te, tc)):
        eng.load_rules("ns", [m.ClusterFlowRule(
            flow_id=i, count=3.0, threshold_type=m.THRESHOLD_GLOBAL)
            for i in range(4)])
    je.request_tokens([0, 1, 2, 3] * 2, [1] * 8, now_ms=NOW0)
    te.state, te._table = convert.cluster_from_numpy(
        convert.cluster_to_numpy(je))
    ids = [0, 1, 2, 3] * 2
    assert te.request_tokens(ids, [1] * 8, now_ms=NOW0 + 1) == \
        je.request_tokens(ids, [1] * 8, now_ms=NOW0 + 1)
    assert convert.leaf_diff(convert.cluster_to_numpy(je),
                             convert.cluster_to_numpy(te)) == []


def test_engine_runs_on_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.ClusterEngine(tc.ClusterSpec(1, 4, 1))
    assert tc.ClusterEngine(tc.ClusterSpec(1, 4, 1),
                            device="cpu").device.type == "cpu"


def test_cpu_engine_takes_the_plain_scatter():
    """On the CPU the window records take the kernel's plain version and
    launch nothing."""
    before = sum(sa.LAUNCHES.values())
    eng = tc.ClusterEngine(tc.ClusterSpec(2, 4, 2), device="cpu")
    eng.load_rules("ns", [tc.ClusterFlowRule(flow_id=1, count=5.0)])
    assert eng.request_tokens([1], [1], now_ms=NOW0)[0][0] == tc.STATUS_OK
    assert sum(sa.LAUNCHES.values()) == before
