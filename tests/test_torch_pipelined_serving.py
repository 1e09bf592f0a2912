"""Port parity: the cluster half of ``tests/test_pipelined_serving.py``
(the batched cluster-RPC delegation, the cluster engine's in-flight
pipeline, the socket client's pipelined batch and the engine's
vectorized request prep) on ``sentinel_tpu_torch`` against
``sentinel_tpu``.

Each of the nine scenarios runs on both packages — twin runtimes under
twin ManualClocks (the port's on the CPU), twin ``ClusterEngine``s (the
port's with ``device="cpu"``), the same scripted token services — and
returns its observations: verdicts, reasons, waits, RPC counts, token
statuses, node totals. They must be equal, exactly (no tolerance), and
each keeps the reference test's own expectations. The code under test
was ported with the serving tier and the cluster token tier; these
twins hold it by name.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.cluster import client as jclient
from sentinel_tpu.cluster import server as jserver
from sentinel_tpu.parallel import cluster as jcl
from sentinel_tpu_torch.cluster import client as tclient
from sentinel_tpu_torch.cluster import server as tserver
from sentinel_tpu_torch.parallel import cluster as tcl

torch.set_num_threads(2)

T0 = 1_785_000_000_000
SIDES = {
    "jax": types.SimpleNamespace(pkg=stpu, cl=jcl, client=jclient,
                                 server=jserver, extra={}),
    "torch": types.SimpleNamespace(pkg=stt, cl=tcl, client=tclient,
                                   server=tserver, extra={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


def both(scenario):
    """``scenario(x)`` on both packages → the port's observations, equal
    to the reference's."""
    got = {name: scenario(side) for name, side in SIDES.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def make(x, **over):
    kw = dict(max_resources=64, max_flow_rules=16, max_degrade_rules=16,
              max_authority_rules=16, minute_enabled=True)
    kw.update(over)
    return x.pkg.Sentinel(config=x.pkg.load_config(**kw),
                          clock=x.pkg.ManualClock(start_ms=T0), **x.extra)


def engine(x, n_shards=1):
    return x.cl.ClusterEngine(x.cl.ClusterSpec(
        n_shards=n_shards, flows_per_shard=16, namespaces=2), **x.extra)


def _verdicts(v):
    return ([bool(a) for a in np.asarray(v.allow)],
            [int(r) for r in np.asarray(v.reason)],
            [int(w) for w in np.asarray(v.wait_ms)])


@dataclasses.dataclass
class _Result:
    status: int
    wait_ms: int = 0


class BatchedTokenService:
    """A token service with the pipelined batch surface that records how
    it was driven."""

    def __init__(self):
        self.flow_script = {}     # flow_id → status to return
        self.batch_calls = 0
        self.single_calls = 0
        self.last_items = None

    def request_token(self, flow_id, count, prioritized=False):
        self.single_calls += 1
        return _Result(self.flow_script.get(flow_id, 0))

    def request_param_token(self, flow_id, count, params):
        self.single_calls += 1
        return _Result(self.flow_script.get(flow_id, 0))

    def request_tokens_batch(self, items):
        self.batch_calls += 1
        self.last_items = list(items)
        return [_Result(self.flow_script.get(fid, 0))
                for fid, _c, _p in items]

    def request_param_tokens_batch(self, items):
        self.batch_calls += 1
        return [_Result(self.flow_script.get(fid, 0))
                for fid, _c, _p in items]


def cluster_rule(x, **over):
    kw = dict(resource="csvc", count=100.0, cluster_mode=True,
              cluster_flow_id=42, cluster_fallback_to_local=True)
    kw.update(over)
    return x.pkg.FlowRule(**kw)


def test_entry_batch_uses_one_batched_rpc():
    def sc(x):
        sph = make(x)
        svc = BatchedTokenService()
        sph.set_token_service(svc)
        sph.load_flow_rules([cluster_rule(x, count=0.0)])
        v = sph.entry_batch(["csvc"] * 16)
        out = [_verdicts(v), svc.batch_calls, svc.single_calls,
               svc.last_items, sph.node_totals("csvc")]
        sph.close()
        return out
    got = both(sc)
    assert all(got[0][0]) and got[1:3] == [1, 0] and len(got[3]) == 16


def test_batched_rpc_semantics_match_per_event():
    def sc(x):
        sph = make(x)
        svc = BatchedTokenService()
        sph.set_token_service(svc)
        sph.load_flow_rules([
            cluster_rule(x, count=0.0, cluster_flow_id=42),
            cluster_rule(x, count=2.0, cluster_flow_id=43),
        ])
        svc.flow_script = {42: 0, 43: -1}
        out = [_verdicts(sph.entry_batch(["csvc"] * 5))]
        svc.flow_script = {42: 1, 43: 0}
        before = sph.node_totals("csvc")["block"]
        out += [_verdicts(sph.entry_batch(["csvc"])),
                sph.node_totals("csvc")["block"] - before]

        class WaitService(BatchedTokenService):
            def request_tokens_batch(self, items):
                self.batch_calls += 1
                return [_Result(2, wait_ms=70) for _ in items]

        sph.set_token_service(WaitService())
        out.append(_verdicts(sph.entry_batch(["csvc"])))
        out.append(sph.node_totals("csvc"))
        sph.close()
        return out
    got = both(sc)
    assert got[0][0] == [True, True, False, False, False]
    assert got[1][0] == [False] and got[1][1] == [int(stt.BlockReason.FLOW)]
    assert got[2] == 1
    assert got[3][0] == [True] and got[3][2] == [140]


def test_flow_batch_only_service_still_enforces_param_rules():
    class FlowBatchOnly:
        def __init__(self):
            self.param_calls = 0

        def request_tokens_batch(self, items):
            return [_Result(0) for _ in items]

        def request_param_token(self, flow_id, count, params):
            self.param_calls += 1
            return _Result(1)                # BLOCKED

    def sc(x):
        sph = make(x)
        svc = FlowBatchOnly()
        sph.set_token_service(svc)
        sph.load_param_flow_rules([x.pkg.ParamFlowRule(
            resource="psvc", param_idx=0, count=100, cluster_mode=True,
            cluster_flow_id=77)])
        v = sph.entry_batch(["psvc"] * 2, args_list=[("a",), ("b",)])
        out = [_verdicts(v), svc.param_calls, sph.node_totals("psvc")]
        sph.close()
        return out
    got = both(sc)
    assert got[0][0] == [False, False] and got[1] == 2


def test_rules_per_resource_cap_validates():
    def sc(x):
        try:
            x.pkg.load_config(max_rules_per_resource=32)
            over = "accepted"
        except ValueError:
            over = "ValueError"
        return [over, x.pkg.load_config(
            max_rules_per_resource=31).max_rules_per_resource]
    assert both(sc) == ["ValueError", 31]


def test_cluster_engine_inflight_pipeline():
    def sc(x):
        eng = engine(x)
        eng.load_rules("ns", [x.cl.ClusterFlowRule(
            flow_id=1, count=5, threshold_type=x.cl.THRESHOLD_GLOBAL)])
        handles = [eng.request_tokens_nowait([1] * 2, [1] * 2,
                                             now_ms=10_000_000 + i)
                   for i in range(4)]
        return [h.result() for h in handles]
    got = both(sc)
    statuses = [s for batch in got for (s, _w, _r) in batch]
    assert statuses[:5] == [0] * 5 and set(statuses[5:]) == {1}


def test_client_pipelined_batch_over_socket():
    def sc(x):
        eng = engine(x)
        eng.load_rules("ns", [x.cl.ClusterFlowRule(
            flow_id=9, count=3, threshold_type=x.cl.THRESHOLD_GLOBAL)])
        srv = x.server.ClusterTokenServer(
            eng, host="127.0.0.1", port=0,
            clock=x.pkg.ManualClock(start_ms=T0))
        srv.start()
        try:
            cli = x.client.ClusterTokenClient(
                "127.0.0.1", srv.port, namespace="ns",
                request_timeout_ms=10_000)
            cli.start()
            try:
                warm = [cli.request_token(999, 1).status,
                        [r.status for r in
                         cli.request_tokens_batch([(999, 1, False)] * 5)]]
                res = cli.request_tokens_batch([(9, 1, False)] * 5)
                return warm, [(r.status, r.remaining, r.wait_ms)
                              for r in res]
            finally:
                cli.stop()
        finally:
            srv.stop()
    _warm, res = both(sc)
    assert [r[0] for r in res] == [0, 0, 0, 1, 1]


def test_vectorized_request_prep_matches_loop_path():
    ids = [0, 7, 3, 99, 2, 0, 5, -1, 1, 3]
    acq = [1, 1, 1, 1, 0, 1, 1, 1, 1, 1]
    now = 50_000_000

    def sc(x):
        def build():
            eng = engine(x, n_shards=2)
            eng.load_rules("ns", [x.cl.ClusterFlowRule(
                flow_id=i, count=5.0, threshold_type=x.cl.THRESHOLD_GLOBAL)
                for i in range(8)])
            return eng
        eng_v = build()
        assert eng_v._fid_lookup is not None
        eng_l = build()
        eng_l._fid_lookup = None          # the loop path
        out = []
        for t in (now, now + 1):
            res_v = eng_v.request_tokens(ids, acq, now_ms=t)
            assert res_v == eng_l.request_tokens(ids, acq, now_ms=t)
            out.append(res_v)
        return out
    got = both(sc)
    assert [s for s, _w, _r in got[0]].count(0) >= 1


def test_vectorized_prep_numpy_ids_and_prioritized():
    def sc(x):
        eng = engine(x)
        eng.load_rules("ns", [x.cl.ClusterFlowRule(
            flow_id=4, count=100.0, threshold_type=x.cl.THRESHOLD_GLOBAL)])
        return eng.request_tokens(np.full(32, 4, np.int64),
                                  np.ones(32, np.int64),
                                  prioritized=np.zeros(32, bool),
                                  now_ms=60_000_000)
    got = both(sc)
    assert all(s == tcl.STATUS_OK for s, _w, _r in got)


def test_negative_flow_ids_disable_lookup_but_still_route():
    def sc(x):
        eng = engine(x)
        eng.load_rules("ns", [
            x.cl.ClusterFlowRule(flow_id=-5, count=10.0,
                                 threshold_type=x.cl.THRESHOLD_GLOBAL),
            x.cl.ClusterFlowRule(flow_id=2, count=10.0,
                                 threshold_type=x.cl.THRESHOLD_GLOBAL)])
        lookup_off = eng._fid_lookup is None
        res = eng.request_tokens([-5, 2], [1, 1], now_ms=70_000_000)
        res2 = eng.request_tokens(np.array([-5, 2]), np.ones(2, np.int64),
                                  prioritized=np.zeros(2, bool),
                                  now_ms=70_000_001)
        return [lookup_off, res, res2]
    lookup_off, res, res2 = both(sc)
    assert lookup_off
    assert [s for s, _w, _r in res] == [tcl.STATUS_OK] * 2
    assert [s for s, _w, _r in res2] == [tcl.STATUS_OK] * 2


def test_cluster_param_precheck_tolerates_none_args_entry():
    class _Svc:
        def __init__(self):
            self.calls = []

        def request_param_tokens(self, flow_id, acquire, params, now_ms=0):
            self.calls.append((flow_id, acquire, list(params)))
            return (0, 0, 1)

    def sc(x):
        sph = x.pkg.Sentinel(x.pkg.load_config(
            max_resources=32, max_flow_rules=8, max_degrade_rules=8,
            max_authority_rules=8, max_param_rules=8, param_table_slots=64),
            clock=x.pkg.ManualClock(start_ms=T0), **x.extra)
        sph.load_param_flow_rules([x.pkg.ParamFlowRule(
            resource="svc", param_idx=0, count=100, cluster_mode=True,
            cluster_flow_id=9)])
        svc = _Svc()
        sph.set_token_service(svc)
        v = sph.entry_batch(["svc"] * 3, args_list=[(1,), None, (2,)])
        out = [_verdicts(v), svc.calls, sph.node_totals("svc")]
        sph.close()
        return out
    got = both(sc)
    assert got[0][0] == [True, True, True]
