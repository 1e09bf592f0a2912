"""Port parity: a seeded fuzz of the sharded cluster token engine against
the JAX engine (the twin harness of ``test_torch_cluster_engine.py``).

Every path of the step over 40 steps of 2^10–2^12 requests, 10–70 ms of
virtual time apart: Zipf(1.1) flow ids, 1/8 prioritized lanes with
occupy (some ``max_occupy_ratio`` < 1), GLOBAL and AVG_LOCAL rules with
``exceed`` 1.0–1.5, param requests with 0–4 values (per-item
overrides), a namespace at its request limit, unknown flow ids,
``acquire`` 0, and a rule reload midway that frees and reuses rows.
Verdicts, ``flow_metrics``, ``top_params``, the three windows and the
rule table agree bit for bit at S = 1 and S = 8.
"""

import numpy as np
import pytest

from test_torch_cluster_engine import NOW0, twin


def _zipf(rng, n, universe, s=1.1):
    ranks = np.arange(1, universe + 1, dtype=np.float64)
    p = ranks ** -s
    return rng.choice(universe, size=n, p=p / p.sum())


def scn_fuzz(m, make, steps=40, seed=2026):
    """Every path of the step over 40 steps of 2^10–2^12 requests."""
    rng = np.random.default_rng(seed)
    eng = make(rows=256, param_keys_per_shard=32, max_params=4)
    n_flows = 48

    def flow_rules(shift):
        return [m.ClusterFlowRule(
            flow_id=i, count=float(20 + (i * 7 + shift) % 60),
            threshold_type=m.THRESHOLD_GLOBAL if i % 3 else
            m.THRESHOLD_AVG_LOCAL,
            exceed_count=1.0 + 0.25 * (i % 3),
            max_occupy_ratio=0.5 if i % 4 == 0 else 1.0)
            for i in range(n_flows)]

    eng.load_rules("ns-a", flow_rules(0))
    eng.load_rules("ns-b", [m.ClusterFlowRule(
        flow_id=200 + i, count=1e9, threshold_type=m.THRESHOLD_GLOBAL)
        for i in range(4)])
    eng.load_param_rules("ns-c", [m.ClusterParamFlowRule(
        flow_id=300 + i, count=float(3 + i),
        threshold_type=m.THRESHOLD_GLOBAL if i % 2 else
        m.THRESHOLD_AVG_LOCAL, items={7: 1.0, "hot": 50.0})
        for i in range(6)])
    eng.set_connected_count("ns-a", 2)
    eng.set_connected_count("ns-c", 2)
    eng.set_namespace_qps_limit("ns-b", 600)      # at its limit
    eng.set_namespace_qps_limit("ns-a", 1e9)
    eng.set_namespace_qps_limit("ns-c", 1e9)
    out, counts = [], {}
    now = NOW0
    for step in range(steps):
        if step == steps // 2:        # a reload midway: rows reused
            eng.load_rules("ns-a", flow_rules(5)[4:] + [m.ClusterFlowRule(
                flow_id=90, count=9.0)])
        n = int(rng.choice([1 << 10, 1 << 11, 1 << 12]))
        ids = _zipf(rng, n, n_flows + 8)
        ids = np.where(ids >= n_flows, 200 + (ids - n_flows), ids)
        ids = np.where(rng.random(n) < 0.02, 5000, ids)     # unknown
        acq = rng.integers(1, 4, n)
        acq[rng.random(n) < 0.01] = 0                        # bad request
        prio = rng.random(n) < 0.125
        res = eng.request_tokens(ids.astype(np.int64), acq, prio,
                                 now_ms=now)
        np_ = n // 4
        pids = [300 + int(x) for x in rng.integers(0, 7, np_)]  # 306: none
        pacq = [int(x) for x in rng.integers(0, 3, np_)]
        vals = [[(7 if v == 0 else "hot" if v == 1 else int(v))
                 for v in _zipf(rng, int(rng.integers(0, 5)), 40)]
                for _ in range(np_)]
        pres = eng.request_param_tokens(pids, pacq, vals, now_ms=now + 3)
        for s, _, _ in res + pres:
            counts[s] = counts.get(s, 0) + 1
        out.append((res, pres))
        now += int(rng.integers(10, 70))
    out.append([eng.flow_metrics(f, now_ms=now) for f in (0, 1, 90, 200)])
    out.append([eng.top_params(300 + i, now_ms=now) for i in range(6)])
    for st in (m.STATUS_OK, m.STATUS_BLOCKED, m.STATUS_SHOULD_WAIT,
               m.STATUS_TOO_MANY_REQUEST, m.STATUS_NO_RULE_EXISTS,
               m.STATUS_BAD_REQUEST):
        assert counts.get(st, 0) > 0, (st, counts)
    return out


@pytest.mark.parametrize("S", (1, 8))
def test_fuzz_matches_reference(S):
    twin(scn_fuzz, S)


