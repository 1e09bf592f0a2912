"""Port parity: the batched gRPC token service
(``sentinel_tpu_torch.cluster.grpc_token``) against
``sentinel_tpu.cluster.grpc_token``.

Twins of the 4 tests of ``tests/test_grpc_token.py``: each scenario runs
on both packages (the port's engine on the CPU) under twin ManualClocks,
and every status, wait and remaining count must agree. Then the cross
pairs over real loopback channels: the reference's client against the
port's server, and the port's client against the reference's server,
each batch's results equal to the same-package pair's. Every server binds
port 0 and is stopped in a ``finally``.
"""

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.cluster import grpc_token as jgt
from sentinel_tpu.parallel import cluster as jcl
from sentinel_tpu_torch.cluster import grpc_token as tgt
from sentinel_tpu_torch.parallel import cluster as tcl

torch.set_num_threads(2)

T0 = 1_785_000_000_000
PKGS = {"jax": (stpu, jcl, jgt), "torch": (stt, tcl, tgt)}
#: the twins' client deadline: the reference's tests use 2 s, but a JAX
#: engine's first call at a new batch size compiles, which can outrun
#: 2 s on a loaded machine, and a call that times out on the client
#: still runs on the server — its FAIL rows and the late engine step
#: would make the packages differ. The deadline path has its own test.
PARITY_TIMEOUT_MS = 60_000


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


def engine(name):
    """The reference test's fixture: two shards, a tight and a generous
    flow rule, a param rule, both steps warmed."""
    pkg, cl, _ = PKGS[name]
    clk = pkg.ManualClock(start_ms=T0)
    extra = {"device": "cpu"} if name == "torch" else {}
    eng = cl.ClusterEngine(cl.ClusterSpec(n_shards=2, flows_per_shard=16,
                                          namespaces=4,
                                          param_keys_per_shard=64), **extra)
    eng.load_rules("ns-g", [
        cl.ClusterFlowRule(flow_id=1, count=5.0,
                           threshold_type=cl.THRESHOLD_GLOBAL),
        cl.ClusterFlowRule(flow_id=2, count=100.0,
                           threshold_type=cl.THRESHOLD_GLOBAL)])
    eng.load_param_rules("ns-g", [
        cl.ClusterParamFlowRule(flow_id=7, count=2.0,
                                threshold_type=cl.THRESHOLD_GLOBAL)])
    eng.request_tokens([2], [1], now_ms=clk.now_ms())
    eng.request_param_tokens([7], [1], [["_warm"]], now_ms=clk.now_ms())
    return eng, clk


def twin(scenario):
    got = {name: scenario(name, *PKGS[name], *engine(name))
           for name in PKGS}
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_service_mixed_batch_alignment():
    def scenario(name, pkg, cl, gt, eng, clk):
        svc = gt.TokenGrpcService(eng, clock=clk)
        out = [svc.request_tokens([
            (1, 1, False, ()), (7, 1, False, ["vip"]), (1, 1, False, ()),
            (999, 1, False, ()), (1, 0, False, ()),
            (7, 1, False, ["vip"])])]
        out.append(svc.request_tokens([(1, 1, False, ())] * 5))
        out.append(svc.request_tokens([(7, 1, False, ["vip"])]))
        out.append(svc.request_tokens([(1, 1, False, ())]
                                      * (gt.MAX_BATCH + 1))[:2])
        return out

    first, second, third, huge = twin(scenario)
    assert [s for s, _, _ in first] == [
        tcl.STATUS_OK, tcl.STATUS_OK, tcl.STATUS_OK,
        tcl.STATUS_NO_RULE_EXISTS, tcl.STATUS_BAD_REQUEST, tcl.STATUS_OK]
    assert [s for s, _, _ in second].count(tcl.STATUS_OK) == 3
    assert [s for s, _, _ in second].count(tcl.STATUS_BLOCKED) == 2
    assert third[0][0] == tcl.STATUS_BLOCKED
    assert huge == [(tcl.STATUS_BAD_REQUEST, 0, 0)] * 2


def _rows(results):
    return [(r.status, r.wait_ms, r.remaining) for r in results]


def _roundtrip(cli):
    """The reference test's client script → every result row."""
    out = [_rows(cli.request_tokens_batch([(1, 1, False)] * 6
                                          + [(2, 1, True)]))]
    out.append(_rows(cli.request_tokens_batch([(1, 1, True)])))
    out.append(_rows(cli.request_param_tokens_batch([(7, 1, ["basic"])] * 3)))
    out.append(_rows([cli.request_token(2, 1), cli.request_token(2, 0)]))
    return out


def _served(name, client_gt, eng, clk):
    """Serve ``eng`` with its package's server, run the script through
    ``client_gt``'s client."""
    gt = PKGS[name][2]
    srv = gt.TokenGrpcServer(eng, host="127.0.0.1", port=0, clock=clk)
    port = srv.start()
    try:
        cli = client_gt.GrpcTokenClient(f"127.0.0.1:{port}",
                                        namespace="ns-g",
                                        timeout_ms=PARITY_TIMEOUT_MS)
        try:
            return _roundtrip(cli)
        finally:
            cli.close()
    finally:
        srv.stop()


def test_grpc_roundtrip_mixed_verdicts():
    pytest.importorskip("grpc")
    out = twin(lambda name, pkg, cl, gt, eng, clk:
               _served(name, gt, eng, clk))
    statuses = [r[0] for r in out[0]]
    assert statuses.count(tcl.STATUS_OK) == 6
    assert statuses.count(tcl.STATUS_BLOCKED) == 1
    assert out[1][0][0] == tcl.STATUS_SHOULD_WAIT and out[1][0][1] > 0
    assert [r[0] for r in out[2]] == [tcl.STATUS_OK, tcl.STATUS_OK,
                                      tcl.STATUS_BLOCKED]
    assert [r[0] for r in out[3]] == [tcl.STATUS_OK, tcl.STATUS_BAD_REQUEST]


def test_grpc_deadline_maps_to_fail_per_item():
    pytest.importorskip("grpc")

    def scenario(name, pkg, cl, gt, eng, clk):
        cli = gt.GrpcTokenClient("127.0.0.1:1", timeout_ms=50)
        try:
            return _rows(cli.request_tokens_batch([(1, 1, False),
                                                   (2, 1, False)]))
        finally:
            cli.close()

    assert twin(scenario) == [(tcl.STATUS_FAIL, 0, 0)] * 2


def test_grpc_client_plugs_into_sentinel_fallback():
    pytest.importorskip("grpc")

    def scenario(name, pkg, cl, gt, eng, clk):
        srv = gt.TokenGrpcServer(eng, host="127.0.0.1", port=0, clock=clk)
        port = srv.start()
        extra = {"device": "cpu"} if name == "torch" else {}
        sph = pkg.Sentinel(pkg.load_config(
            max_resources=64, max_flow_rules=16, max_degrade_rules=16,
            max_authority_rules=16, host_fast_path=False),
            clock=pkg.ManualClock(start_ms=T0), **extra)
        cli = None
        try:
            sph.load_flow_rules([pkg.FlowRule(
                resource="svc", count=3.0, cluster_mode=True,
                cluster_flow_id=1, cluster_fallback_to_local=True)])
            cli = gt.GrpcTokenClient(f"127.0.0.1:{port}", namespace="ns-g",
                                     timeout_ms=PARITY_TIMEOUT_MS)
            sph.set_token_service(cli)
            out = []
            for phase in range(2):
                if phase == 1:
                    srv.stop()            # server gone → FAIL → fallback
                    sph.clock.advance_ms(1100)
                ok = blocked = 0
                for _ in range(8 if phase == 0 else 6):
                    try:
                        with sph.entry("svc"):
                            ok += 1
                    except pkg.BlockException:
                        blocked += 1
                out.append((ok, blocked))
            return out, sph.node_totals("svc")
        finally:
            srv.stop()
            if cli is not None:
                cli.close()
            sph.close()

    out, _totals = twin(scenario)
    assert out == [(5, 3), (3, 3)]


# ------------------------------------------------------- cross pairs

@pytest.mark.parametrize("server,client", [("torch", "jax"),
                                           ("jax", "torch")])
def test_grpc_cross_package_pairs(server, client):
    """One package's client against the other's server: the same result
    rows as the same-package pair, then a seeded stream of 16 mixed
    batches."""
    pytest.importorskip("grpc")
    rng = np.random.default_rng(29)
    stream = []
    for _ in range(16):
        n = int(rng.integers(1, 48))
        stream.append([(int(rng.choice([1, 2, 7, 999])),
                        int(rng.integers(0, 3)), bool(rng.random() < 0.2),
                        [f"u{int(rng.integers(0, 4))}"]
                        if rng.random() < 0.3 else ()) for _ in range(n)])

    def drive(server_name, client_name):
        eng, clk = engine(server_name)
        gt = PKGS[server_name][2]
        srv = gt.TokenGrpcServer(eng, host="127.0.0.1", port=0, clock=clk)
        port = srv.start()
        try:
            cli = PKGS[client_name][2].GrpcTokenClient(
                f"127.0.0.1:{port}", namespace="ns-g",
                timeout_ms=PARITY_TIMEOUT_MS)
            try:
                out = _roundtrip(cli)
                for batch in stream:
                    rows = cli._batch(batch)
                    out.append(_rows(rows))
                    clk.advance_ms(37)
                return out
            finally:
                cli.close()
        finally:
            srv.stop()

    cross = drive(server, client)
    same = drive(server, server)
    assert cross == same
    assert cross == drive(client, client)
