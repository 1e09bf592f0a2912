"""Port parity: the cluster transport (``sentinel_tpu_torch.cluster``:
codec, token server and client) and the concurrent-token manager against
the JAX package's.

* Every request and response type of the wire codec gives the same bytes
  from both packages, and each package decodes the other's frames.
* ``ConcurrentTokenManager`` twins run the reference's scenarios and a
  seeded op stream (acquire, release, sweep, reload, connected counts).
* The reference's cluster param-flow scenarios run on twin engines
  (``test_torch_cluster_engine.twin``).
* The reference's server and client scenarios run on loopback against a
  port server whose engine is on the CPU; the JAX package's client talks
  to the port's server too (same bytes).

Every socket or asyncio body runs under a time limit (a thread join or a
client request timeout): the repo has no pytest-timeout.
"""

import socket
import threading

import numpy as np
import pytest
import torch

from sentinel_tpu.cluster import client as jclient_mod
from sentinel_tpu.cluster import codec as jcodec
from sentinel_tpu.parallel import concurrent as jconc
from sentinel_tpu_torch.cluster import codec
from sentinel_tpu_torch.cluster.client import ClusterTokenClient
from sentinel_tpu_torch.cluster.server import ClusterTokenServer
from sentinel_tpu_torch.core.clock import ManualClock
from sentinel_tpu_torch.parallel import concurrent as tconc
from sentinel_tpu_torch.parallel.cluster import (
    STATUS_ALREADY_RELEASE, STATUS_BLOCKED, STATUS_NO_RULE_EXISTS, STATUS_OK,
    STATUS_RELEASE_OK, THRESHOLD_AVG_LOCAL, THRESHOLD_GLOBAL,
    ClusterEngine, ClusterFlowRule, ClusterParamFlowRule, ClusterSpec,
)

from test_torch_cluster_engine import twin

torch.set_num_threads(2)

NOW0 = 50_000_000
#: a client's request budget here: the CPU engine's first step is slow
TIMEOUT_MS = 30_000


# ----------------------------------------------------------------- codec

REQUESTS = [
    (7, codec.MSG_TYPE_PING, "my-app"),
    (8, codec.MSG_TYPE_PING, "命名空间"),
    (99, codec.MSG_TYPE_FLOW, (12345678901234, 5, True)),
    (100, codec.MSG_TYPE_FLOW, (-3, 1, False)),
    (1, codec.MSG_TYPE_PARAM_FLOW,
     (55, 2, [3, 2 ** 40, 1.5, "hello-世界", True, False, -7, 0])),
    (2, codec.MSG_TYPE_PARAM_FLOW, (56, 1, [])),
    (3, codec.MSG_TYPE_CONCURRENT_FLOW_ACQUIRE, (77, 2, False)),
    (4, codec.MSG_TYPE_CONCURRENT_FLOW_RELEASE, 987654321),
]
RESPONSES = [
    (7, codec.MSG_TYPE_PING, 0, 3),
    (99, codec.MSG_TYPE_FLOW, 0, (42, 17)),
    (100, codec.MSG_TYPE_FLOW, 1, (0, 0)),
    (101, codec.MSG_TYPE_FLOW, 2, (0, 480)),
    (102, codec.MSG_TYPE_FLOW, -2, (0, 0)),
    (1, codec.MSG_TYPE_PARAM_FLOW, 0, (2147483647, 0)),
    (3, codec.MSG_TYPE_CONCURRENT_FLOW_ACQUIRE, 0, 987654321),
    (4, codec.MSG_TYPE_CONCURRENT_FLOW_RELEASE, 6, None),
    (5, 9, codec.RESPONSE_STATUS_BAD, None),
]


def _frames(mod, data):
    frames = mod.FrameAssembler().feed(data)
    assert len(frames) == 1
    return frames[0]


@pytest.mark.parametrize("args", REQUESTS, ids=lambda a: f"t{a[1]}-x{a[0]}")
def test_request_bytes_equal_and_decode_across(args):
    mine = codec.encode_request(codec.Request(*args))
    ref = jcodec.encode_request(jcodec.Request(*args))
    assert mine == ref
    a = codec.decode_request(_frames(codec, ref))
    b = jcodec.decode_request(_frames(jcodec, mine))
    assert (a.xid, a.type, a.data) == (b.xid, b.type, b.data)
    assert (a.xid, a.type) == args[:2]


@pytest.mark.parametrize("args", RESPONSES, ids=lambda a: f"t{a[1]}-s{a[2]}")
def test_response_bytes_equal_and_decode_across(args):
    mine = codec.encode_response(codec.Response(*args))
    ref = jcodec.encode_response(jcodec.Response(*args))
    assert mine == ref
    a = codec.decode_response(_frames(codec, ref))
    b = jcodec.decode_response(_frames(jcodec, mine))
    assert (a.xid, a.type, a.status, a.data) == (b.xid, b.type, b.status,
                                                 b.data)


def test_codec_constants_match_reference():
    names = [n for n in dir(jcodec) if n.isupper()]
    assert names and {n: getattr(codec, n) for n in names} == \
        {n: getattr(jcodec, n) for n in names}


def test_frame_assembler_partial_coalesced_and_capped():
    f1 = codec.encode_request(codec.Request(1, codec.MSG_TYPE_PING, "a"))
    f2 = codec.encode_request(codec.Request(2, codec.MSG_TYPE_PING, "b"))
    asm = codec.FrameAssembler()
    stream = f1 + f2
    assert asm.feed(stream[:3]) == []
    frames = asm.feed(stream[3:])
    assert [codec.decode_request(f).xid for f in frames] == [1, 2]
    for mod in (codec, jcodec):
        with pytest.raises(ValueError):
            mod.FrameAssembler().feed(b"\xff\xff" + b"x" * 10)


# ------------------------------------------------------ concurrent tokens

def _both(fn):
    want = fn(jconc)
    got = fn(tconc)
    assert got == want
    return got


def test_concurrent_acquire_block_release():
    def run(m):
        mgr = m.ConcurrentTokenManager()
        mgr.load_rules([m.ConcurrentFlowRule(flow_id=1, count=2)])
        out = [mgr.acquire(1, 1, now_ms=NOW0) for _ in range(3)]
        t1 = out[0][1]
        out += [mgr.now_calls(1), mgr.release(t1), mgr.release(t1),
                mgr.acquire(1, 1, now_ms=NOW0)]
        return out

    out = _both(run)
    assert [s for s, _ in out[:3]] == [STATUS_OK, STATUS_OK, STATUS_BLOCKED]
    assert out[3:6] == [2, STATUS_RELEASE_OK, STATUS_ALREADY_RELEASE]


def test_concurrent_avg_local_and_expiry():
    def run(m):
        mgr = m.ConcurrentTokenManager()
        mgr.load_rules([m.ConcurrentFlowRule(
            flow_id=9, count=2, threshold_type=THRESHOLD_AVG_LOCAL),
            m.ConcurrentFlowRule(flow_id=5, count=1,
                                 resource_timeout_ms=500)])
        mgr.set_connected_count(9, 3)
        out = [mgr.acquire(9, 1, now_ms=NOW0)[0] for _ in range(8)]
        out.append(mgr.acquire(5, 1, now_ms=NOW0)[0])
        out.append(mgr.acquire(5, 1, now_ms=NOW0)[0])
        out += [mgr.sweep_expired(now_ms=NOW0 + 400),
                mgr.sweep_expired(now_ms=NOW0 + 600), mgr.now_calls(5),
                mgr.acquire(5, 1, now_ms=NOW0 + 600)[0],
                mgr.acquire(404, 1, now_ms=NOW0)[0]]
        return out

    out = _both(run)
    assert out[:8].count(STATUS_OK) == 6
    assert out[8:] == [STATUS_OK, STATUS_BLOCKED, 0, 1, 0, STATUS_OK, -1]


def test_concurrent_manager_twins_on_a_seeded_op_stream():
    """Acquires, releases (live, double and unknown), sweeps, a reload
    and connected-count changes: every return value and the lease table
    agree."""
    def run(m):
        rng = np.random.default_rng(11)
        mgr = m.ConcurrentTokenManager()
        mgr.load_rules([m.ConcurrentFlowRule(
            flow_id=f, count=float(1 + f % 4),
            threshold_type=f % 2, resource_timeout_ms=100 + 50 * f)
            for f in range(6)])
        now, tokens, out = NOW0, [], []
        for step in range(400):
            op = rng.integers(0, 10)
            if op < 5:
                st, tok = mgr.acquire(int(rng.integers(0, 7)),
                                      int(rng.integers(1, 3)),
                                      client_address=f"c{rng.integers(3)}",
                                      now_ms=now)
                out.append((st, tok))
                if tok:
                    tokens.append(tok)
            elif op < 8 and tokens:
                out.append(mgr.release(tokens[int(rng.integers(
                    len(tokens)))]))
            elif op == 8:
                out.append(mgr.sweep_expired(now_ms=now))
            else:
                mgr.set_connected_count(int(rng.integers(0, 6)),
                                        int(rng.integers(1, 4)))
            if step == 200:
                mgr.load_rules([m.ConcurrentFlowRule(flow_id=f, count=2.0)
                                for f in range(3, 8)])
            now += int(rng.integers(0, 40))
        out.append([mgr.now_calls(f) for f in range(8)])
        out.append(mgr.lease_count())
        out.append(sorted((ls.token_id, ls.flow_id, ls.acquire,
                           ls.expire_at_ms)
                          for ls in mgr.leases_of("c1")))
        return out

    _both(run)


# ------------------------------------------------- cluster param flow

def _pengine(make):
    return make(rows=64, param_keys_per_shard=64)


def scn_param_flow_per_value_isolation(m, make):
    eng = _pengine(make)
    eng.load_param_rules("ns-p", [m.ClusterParamFlowRule(
        flow_id=200, count=3, threshold_type=m.THRESHOLD_GLOBAL)])
    res = eng.request_param_tokens(
        [200] * 8, [1] * 8, [["user-a"]] * 5 + [["user-b"]] * 3,
        now_ms=NOW0)
    a = [s for s, _, _ in res[:5]]
    b = [s for s, _, _ in res[5:]]
    assert a.count(m.STATUS_OK) == 3 and a.count(m.STATUS_BLOCKED) == 2
    assert b.count(m.STATUS_OK) == 3
    return res, eng.top_params(200, now_ms=NOW0)


def scn_param_flow_item_override(m, make):
    eng = _pengine(make)
    eng.load_param_rules("ns-p", [m.ClusterParamFlowRule(
        flow_id=201, count=2, threshold_type=m.THRESHOLD_GLOBAL,
        items={"vip": 10.0})])
    vip = eng.request_param_tokens([201] * 6, [1] * 6, [["vip"]] * 6,
                                   now_ms=NOW0)
    assert sum(1 for s, _, _ in vip if s == m.STATUS_OK) == 6
    norm = eng.request_param_tokens([201] * 6, [1] * 6, [["pleb"]] * 6,
                                    now_ms=NOW0)
    assert sum(1 for s, _, _ in norm if s == m.STATUS_OK) == 2
    return vip, norm


def scn_param_flow_multi_value_all_must_pass(m, make):
    eng = _pengine(make)
    eng.load_param_rules("ns-p", [m.ClusterParamFlowRule(
        flow_id=202, count=1, threshold_type=m.THRESHOLD_GLOBAL)])
    r1 = eng.request_param_tokens([202], [1], [["hot"]], now_ms=NOW0)
    r2 = eng.request_param_tokens([202], [1], [["cold", "hot"]],
                                  now_ms=NOW0)
    r3 = eng.request_param_tokens([202], [1], [["cold"]], now_ms=NOW0)
    assert (r1[0][0], r2[0][0], r3[0][0]) == (
        m.STATUS_OK, m.STATUS_BLOCKED, m.STATUS_OK)
    return r1, r2, r3


def scn_param_flow_empty_values_pass_and_unknown_rule(m, make):
    eng = _pengine(make)
    eng.load_param_rules("ns-p", [m.ClusterParamFlowRule(flow_id=203,
                                                         count=1)])
    a = eng.request_param_tokens([203], [1], [[]], now_ms=NOW0)
    b = eng.request_param_tokens([999], [1], [["x"]], now_ms=NOW0)
    assert a[0][0] == m.STATUS_OK and b[0][0] == m.STATUS_NO_RULE_EXISTS
    return a, b


def scn_param_rules_and_flow_rules_coexist(m, make):
    eng = _pengine(make)
    eng.load_rules("ns-p", [m.ClusterFlowRule(
        flow_id=300, count=5, threshold_type=m.THRESHOLD_GLOBAL)])
    eng.load_param_rules("ns-p", [m.ClusterParamFlowRule(
        flow_id=301, count=2, threshold_type=m.THRESHOLD_GLOBAL)])
    eng.load_rules("ns-p", [m.ClusterFlowRule(
        flow_id=300, count=5, threshold_type=m.THRESHOLD_GLOBAL)])
    res = eng.request_param_tokens([301] * 3, [1] * 3, [["k"]] * 3,
                                   now_ms=NOW0)
    assert sum(1 for s, _, _ in res if s == m.STATUS_OK) == 2
    res_f = eng.request_tokens([300] * 6, [1] * 6, now_ms=NOW0)
    assert sum(1 for s, _, _ in res_f if s == m.STATUS_OK) == 5
    return (res, res_f, eng.namespace_flow_ids("ns-p"),
            sorted(eng.namespace_rules("ns-p")),
            sorted(eng.namespace_rules("ns-p", param=True)))


PARAM_SCENARIOS = [v for k, v in sorted(globals().items())
                   if k.startswith("scn_")]


@pytest.mark.parametrize("scenario", PARAM_SCENARIOS,
                         ids=lambda f: f.__name__[4:])
def test_param_scenario_matches_reference(scenario):
    twin(scenario, 8)


# ------------------------------------------ server ⇄ client on loopback

def _engine(**kw):
    spec = dict(n_shards=8, flows_per_shard=8, namespaces=4,
                param_keys_per_shard=64)
    spec.update(kw)
    return ClusterEngine(ClusterSpec(**spec), device="cpu")


@pytest.fixture(scope="module")
def served():
    engine = _engine()
    engine.load_rules("it-ns", [ClusterFlowRule(
        flow_id=401, count=4, threshold_type=THRESHOLD_GLOBAL)])
    engine.load_param_rules("it-ns", [ClusterParamFlowRule(
        flow_id=402, count=2, threshold_type=THRESHOLD_GLOBAL)])
    clock = ManualClock(start_ms=NOW0)
    server = ClusterTokenServer(engine, clock=clock, host="127.0.0.1",
                                port=0, batch_window_ms=0.5)
    server.load_concurrent_rules("it-ns", [tconc.ConcurrentFlowRule(
        flow_id=403, count=1)])
    server.start()
    client = ClusterTokenClient("127.0.0.1", server.port, namespace="it-ns",
                                request_timeout_ms=TIMEOUT_MS,
                                auto_reconnect=False)
    client.start()
    yield server, client, clock
    client.stop()
    server.stop()


def test_socket_ping_registers_namespace(served):
    server, client, _ = served
    assert client.ping() == 1
    assert server.connection_count("it-ns") == 1


def test_socket_flow_tokens(served):
    _, client, _ = served
    statuses = [client.request_token(401, 1).status for _ in range(6)]
    assert statuses.count(STATUS_OK) == 4
    assert statuses.count(STATUS_BLOCKED) == 2


def test_socket_param_tokens(served):
    _, client, _ = served
    statuses = [client.request_param_token(402, 1, ["u1"]).status
                for _ in range(4)]
    assert statuses.count(STATUS_OK) == 2


def test_socket_concurrent_tokens(served):
    _, client, _ = served
    r1 = client.acquire_concurrent_token(403, 1)
    assert r1.status == STATUS_OK and r1.token_id > 0
    assert client.acquire_concurrent_token(403, 1).status == STATUS_BLOCKED
    assert client.release_concurrent_token(r1.token_id).status \
        == STATUS_RELEASE_OK
    assert client.release_concurrent_token(r1.token_id).status \
        == STATUS_ALREADY_RELEASE


def test_socket_unknown_flow(served):
    _, client, _ = served
    assert client.request_token(40999, 1).status == STATUS_NO_RULE_EXISTS


def test_reference_client_talks_to_the_port_server(served):
    """The JAX package's client against the port's server: the same wire."""
    server, _, _ = served
    cli = jclient_mod.ClusterTokenClient(
        "127.0.0.1", server.port, namespace="it-ns",
        request_timeout_ms=TIMEOUT_MS, auto_reconnect=False)
    cli.start()
    try:
        assert cli.request_token(40999, 1).status == STATUS_NO_RULE_EXISTS
        assert cli.request_param_token(402, 1, []).status == STATUS_OK
    finally:
        cli.stop()


def _run_threads(targets, limit_s=60.0):
    threads = [threading.Thread(target=t, daemon=True) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=limit_s)
        assert not t.is_alive(), "client thread did not finish in time"


def test_exact_grants_across_clients_and_avg_local_pings():
    """Under a frozen ManualClock a GLOBAL rule of count C yields exactly
    C OKs across four clients (single and pipelined batch calls), and
    three PINGs in a namespace triple its AVG_LOCAL threshold."""
    engine = _engine()
    engine.load_rules("g", [ClusterFlowRule(
        flow_id=1, count=37, threshold_type=THRESHOLD_GLOBAL)])
    engine.load_rules("avg", [ClusterFlowRule(
        flow_id=2, count=5, threshold_type=THRESHOLD_AVG_LOCAL)])
    server = ClusterTokenServer(engine, clock=ManualClock(start_ms=NOW0),
                                host="127.0.0.1", port=0,
                                batch_window_ms=0.5)
    server.start()
    clients = []
    try:
        for ns in ("g",) * 4 + ("avg",) * 3:
            c = ClusterTokenClient("127.0.0.1", server.port, namespace=ns,
                                   request_timeout_ms=TIMEOUT_MS,
                                   auto_reconnect=False)
            c.start()
            clients.append(c)
        # each client registers its namespace (PING) when it connects
        assert [c.ping() for c in clients[4:]] == [3, 3, 3]
        statuses = []
        lock = threading.Lock()

        def drive(c):
            def body():
                got = [c.request_token(1, 1).status for _ in range(8)]
                got += [r.status for r in c.request_tokens_batch(
                    [(1, 1, False)] * 16)]
                with lock:
                    statuses.extend(got)
            return body

        _run_threads([drive(c) for c in clients[:4]])
        assert len(statuses) == 96 and statuses.count(STATUS_OK) == 37
        assert statuses.count(STATUS_BLOCKED) == 59
        avg = [r.status for r in clients[4].request_tokens_batch(
            [(2, 1, False)] * 20)]
        assert avg.count(STATUS_OK) == 15        # 5 × 3 connected
    finally:
        for c in clients:
            c.stop()
        server.stop()


def _eventually(pred, limit_s=10.0):
    import time
    end = time.monotonic() + limit_s
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_concurrent_tokens_balance_and_the_lease_sweep():
    """Acquire, release and the lease sweep balance: leases that expire
    are reclaimed by the server's sweep and free their permits."""
    clock = ManualClock(start_ms=NOW0)
    server = ClusterTokenServer(_engine(), clock=clock, host="127.0.0.1",
                                port=0)
    server.load_concurrent_rules("c", [tconc.ConcurrentFlowRule(
        flow_id=7, count=3, resource_timeout_ms=500)])
    server.start()
    cli = ClusterTokenClient("127.0.0.1", server.port, namespace="c",
                             request_timeout_ms=TIMEOUT_MS,
                             auto_reconnect=False)
    cli.start()
    try:
        got = [cli.acquire_concurrent_token(7, 1) for _ in range(4)]
        assert [r.status for r in got] == [STATUS_OK] * 3 + [STATUS_BLOCKED]
        assert cli.release_concurrent_token(got[0].token_id).status \
            == STATUS_RELEASE_OK
        assert server.concurrent.now_calls(7) == 2
        clock.advance_ms(600)                    # the two others expire
        assert _eventually(lambda: server.concurrent.now_calls(7) == 0,
                           limit_s=5.0)
        assert server.concurrent.lease_count() == 0
        assert cli.release_concurrent_token(got[1].token_id).status \
            == STATUS_ALREADY_RELEASE
    finally:
        cli.stop()
        server.stop()


def test_cluster_server_stat_log(tmp_path):
    """The token server rolls per-second grant/deny counts per flow into
    sentinel-cluster-server.log (the port's BlockStatLogger)."""
    engine = _engine(flows_per_shard=16, param_keys_per_shard=0)
    server = ClusterTokenServer(engine, host="127.0.0.1", port=0,
                                clock=ManualClock(start_ms=10_000_000),
                                log_dir=str(tmp_path))
    server.load_flow_rules("ns", [ClusterFlowRule(
        flow_id=9, count=1, threshold_type=THRESHOLD_GLOBAL)])
    server.start()
    client = ClusterTokenClient(host="127.0.0.1", port=server.port,
                                namespace="ns",
                                request_timeout_ms=TIMEOUT_MS)
    client.start()
    try:
        for _ in range(3):
            client.request_token(9, 1)
    finally:
        client.stop()
        server.stop()
    server.stat_log.flush()
    text = (tmp_path / "sentinel-cluster-server.log").read_text()
    assert "flow-9,pass" in text and "flow-9,block" in text


def test_transport_config_change_restarts_server():
    """A port change restarts the listener on the new port; an idle
    change applies live without a restart."""
    engine = _engine(n_shards=1, flows_per_shard=16, namespaces=2)
    server = ClusterTokenServer(engine, host="127.0.0.1", port=0,
                                clock=ManualClock(start_ms=NOW0))
    server.load_flow_rules("ns", [ClusterFlowRule(
        flow_id=3, count=100, threshold_type=THRESHOLD_GLOBAL)])
    server.start()
    old_port = server.port
    try:
        server.update_transport_config(idle_seconds=42)
        assert server.idle_seconds == 42 and server.port == old_port
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        new_port = probe.getsockname()[1]
        probe.close()
        server.update_transport_config(port=new_port)
        assert server.port == new_port
        cli = ClusterTokenClient("127.0.0.1", new_port, namespace="ns",
                                 request_timeout_ms=TIMEOUT_MS)
        cli.start()
        try:
            assert cli.request_token(3, 1).status == 0
        finally:
            cli.stop()
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", old_port), timeout=0.5)
    finally:
        server.stop()


def test_server_refuses_an_engine_spread_over_processes():
    engine = _engine()
    engine._multiprocess = True
    with pytest.raises(ValueError, match="ROADMAP A11"):
        ClusterTokenServer(engine, port=0)
