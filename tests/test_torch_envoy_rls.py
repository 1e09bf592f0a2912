"""Port parity: the Envoy RLS v3 service
(``sentinel_tpu_torch.cluster.envoy_rls``) against
``sentinel_tpu.cluster.envoy_rls``.

Twins of the 8 tests of ``tests/test_envoy_rls.py`` and the 2 of
``tests/test_envoy_rls_golden.py``: each scenario runs on both packages
(the port's engine on the CPU, twin ManualClocks) and every overall code
and descriptor status (code, limit, remaining) must agree; identifiers
and flow ids must be the reference's. The committed ``GOLDEN_FRAMES``
(canonical ``ShouldRateLimit`` wire bytes) are replayed raw against the
port's server and must give the reference's codes and responses byte for
byte. Every server binds port 0 and is stopped in a ``finally``.
"""

import numpy as np
import pytest
import torch

from sentinel_tpu.cluster import envoy_rls as jrls
from sentinel_tpu.core.clock import ManualClock as JClock
from sentinel_tpu.parallel import cluster as jcl
from sentinel_tpu_torch.cluster import envoy_rls as trls
from sentinel_tpu_torch.core.clock import ManualClock as TClock
from sentinel_tpu_torch.parallel import cluster as tcl
from test_envoy_rls_golden import GOLDEN_FRAMES, expected_codes

torch.set_num_threads(2)

NOW0 = 10_000_000
T0 = 1_785_000_000_000
PKGS = {"jax": (jrls, jcl, JClock), "torch": (trls, tcl, TClock)}


def service(name, n_shards=8, flows=16, start=NOW0, rules=None):
    rls, cl, clock = PKGS[name]
    extra = {"device": "cpu"} if name == "torch" else {}
    engine = cl.ClusterEngine(cl.ClusterSpec(n_shards=n_shards,
                                             flows_per_shard=flows,
                                             namespaces=4), **extra)
    svc = rls.EnvoyRlsService(engine, clock=clock(start_ms=start))
    svc.rules.load_rules(rules(rls) if rules else [rls.EnvoyRlsRule(
        domain="apis", descriptors=[
            rls.RlsDescriptorRule(entries=[("generic_key", "checkout")],
                                  count=3),
            rls.RlsDescriptorRule(entries=[("header_match", "mobile"),
                                           ("dest", "payments")], count=1)])])
    return svc


def _norm(result):
    overall, statuses = result
    return overall, [(s.code, s.limit, s.remaining) for s in statuses]


def twin(scenario):
    got = {name: scenario(name, PKGS[name][0], service(name))
           for name in PKGS}
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_identifier_format_and_id_stability():
    rng = np.random.default_rng(3)
    idents = ["d|a:1|b:2", "d|a:1|b:3", "", "日本|k:v", "x|y|z:w"]
    idents += [f"dom{i}|k{int(rng.integers(0, 1 << 30))}:v" for i in range(64)]
    for ident in idents:
        assert trls.identifier_flow_id(ident) == jrls.identifier_flow_id(ident)
    ident = trls.descriptor_identifier("d", [("a", "1"), ("b", "2")])
    assert ident == "d|a:1|b:2" == jrls.descriptor_identifier(
        "d", [("a", "1"), ("b", "2")])
    assert trls.identifier_flow_id(ident) != trls.identifier_flow_id(
        "d|a:1|b:3")
    for const in ("SEPARATOR", "RLS_METHOD", "CODE_UNKNOWN", "CODE_OK",
                  "CODE_OVER_LIMIT", "UNIT_SECOND"):
        assert getattr(trls, const) == getattr(jrls, const)
    assert trls.SentinelRlsGrpcServer.DEFAULT_PORT == \
        jrls.SentinelRlsGrpcServer.DEFAULT_PORT


def test_single_descriptor_limit():
    def scenario(name, rls, svc):
        return [_norm(svc.should_rate_limit(
            "apis", [[("generic_key", "checkout")]])) for _ in range(4)]

    out = twin(scenario)
    assert [o[0] for o in out] == [trls.CODE_OK] * 3 + [trls.CODE_OVER_LIMIT]
    assert out[3][1][0][:2] == (trls.CODE_OVER_LIMIT, 3)


def test_unmatched_descriptor_passes():
    def scenario(name, rls, svc):
        return [_norm(svc.should_rate_limit("apis",
                                            [[("generic_key", "nope")]])),
                _norm(svc.should_rate_limit(
                    "other", [[("generic_key", "checkout")]]))]

    out = twin(scenario)
    assert [o[0] for o in out] == [trls.CODE_OK] * 2


def test_non_ok_statuses_are_over_limit(monkeypatch):
    def scenario(name, rls, svc):
        cl = PKGS[name][1]
        out = []
        for status in (cl.STATUS_SHOULD_WAIT, -1, cl.STATUS_TOO_MANY_REQUEST,
                       cl.STATUS_BLOCKED, cl.STATUS_NO_RULE_EXISTS,
                       cl.STATUS_OK):
            monkeypatch.setattr(
                svc.engine, "request_tokens",
                lambda fids, counts, now_ms=None, _s=status:
                    [(_s, 25, 0)] * len(fids))
            out.append(_norm(svc.should_rate_limit(
                "apis", [[("generic_key", "checkout")]])))
        return out

    out = twin(scenario)
    assert [o[0] for o in out] == ([trls.CODE_OVER_LIMIT] * 4
                                   + [trls.CODE_OK] * 2)


def test_multi_entry_descriptor_order_matters():
    def scenario(name, rls, svc):
        fwd = [("header_match", "mobile"), ("dest", "payments")]
        return [_norm(svc.should_rate_limit("apis", [fwd])),
                _norm(svc.should_rate_limit("apis", [fwd])),
                _norm(svc.should_rate_limit("apis", [fwd[::-1]]))]

    out = twin(scenario)
    assert [o[0] for o in out] == [trls.CODE_OK, trls.CODE_OVER_LIMIT,
                                   trls.CODE_OK]


def test_any_blocked_descriptor_trips_overall():
    def scenario(name, rls, svc):
        return _norm(svc.should_rate_limit("apis", [
            [("generic_key", "checkout")],
            [("header_match", "mobile"), ("dest", "payments")],
            [("generic_key", "unknown")]], hits_addend=2))

    overall, st = twin(scenario)
    assert overall == trls.CODE_OVER_LIMIT
    assert [s[0] for s in st] == [trls.CODE_OK, trls.CODE_OVER_LIMIT,
                                  trls.CODE_OK]


def test_rule_reload_drops_stale_domains():
    def scenario(name, rls, svc):
        svc.rules.load_rules([rls.EnvoyRlsRule(domain="new", descriptors=[
            rls.RlsDescriptorRule(entries=[("k", "v")], count=1)])])
        return [_norm(svc.should_rate_limit(
                    "apis", [[("generic_key", "checkout")]])),
                _norm(svc.should_rate_limit("new", [[("k", "v")]])),
                _norm(svc.should_rate_limit("new", [[("k", "v")]]))]

    out = twin(scenario)
    assert [o[0] for o in out] == [trls.CODE_OK, trls.CODE_OK,
                                   trls.CODE_OVER_LIMIT]


def _serve(name, svc):
    server = PKGS[name][0].SentinelRlsGrpcServer(svc, host="127.0.0.1",
                                                 port=0)
    return server, server.start()


def test_grpc_roundtrip():
    grpc = pytest.importorskip("grpc")
    from sentinel_tpu_torch.cluster.proto import envoy_rls_pb2 as pb

    def scenario(name, rls, svc):
        server, port = _serve(name, svc)
        try:
            with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = ch.unary_unary(
                    trls.RLS_METHOD,
                    request_serializer=pb.RateLimitRequest.SerializeToString,
                    response_deserializer=lambda b: b)
                req = pb.RateLimitRequest(domain="apis")
                e = req.descriptors.add().entries.add()
                e.key, e.value = "generic_key", "checkout"
                return [stub(req) for _ in range(4)]
        finally:
            server.stop()

    raw = twin(scenario)                  # response bytes equal
    codes = [pb.RateLimitResponse.FromString(b).overall_code for b in raw]
    assert codes == [trls.CODE_OK] * 3 + [trls.CODE_OVER_LIMIT]


# ------------------------------------------------------- golden frames

def _golden_rules(rls):
    return [rls.EnvoyRlsRule(domain="apis", descriptors=[
        rls.RlsDescriptorRule(entries=[("k1", "v1")], count=2),
        rls.RlsDescriptorRule(entries=[("a", "x"), ("b", "y")], count=1)])]


def test_golden_frames_roundtrip_parity():
    grpc = pytest.importorskip("grpc")
    from sentinel_tpu_torch.cluster.proto import envoy_rls_pb2 as pb
    got = {}
    for name in PKGS:
        svc = service(name, flows=8, start=T0, rules=_golden_rules)
        server, port = _serve(name, svc)
        try:
            ch = grpc.insecure_channel(f"127.0.0.1:{port}")
            rpc = ch.unary_unary(trls.RLS_METHOD,
                                 request_serializer=lambda b: b,
                                 response_deserializer=lambda b: b)
            out = []
            for fname, (frame_hex, _fields) in GOLDEN_FRAMES.items():
                raw = bytes.fromhex(frame_hex.replace("_unknown_suffix", ""))
                if "_unknown_suffix" in frame_hex:
                    raw += bytes([0x78, 0x2A])   # field 15 varint: skipped
                body = rpc(raw)
                resp = pb.RateLimitResponse.FromString(body)
                overall, codes = expected_codes(fname)
                assert resp.overall_code == overall, (name, fname)
                assert [s.code for s in resp.statuses] == codes, (name, fname)
                out.append(body)
            ch.close()
            got[name] = out
        finally:
            server.stop()
    assert got["torch"] == got["jax"]


def test_committed_minimal_pb2_parses_golden_bytes():
    pytest.importorskip("google.protobuf")
    from sentinel_tpu.cluster.proto import envoy_rls_pb2 as jpb
    from sentinel_tpu_torch.cluster.proto import envoy_rls_pb2 as pb
    assert pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    raw = bytes.fromhex(GOLDEN_FRAMES["multi_mixed"][0])
    req = pb.RateLimitRequest.FromString(raw)
    assert req.domain == "apis"
    assert [[(e.key, e.value) for e in d.entries]
            for d in req.descriptors] == [[("a", "x"), ("b", "y")],
                                          [("nope", "z")]]
    assert req.SerializeToString().hex() == GOLDEN_FRAMES["multi_mixed"][0]
