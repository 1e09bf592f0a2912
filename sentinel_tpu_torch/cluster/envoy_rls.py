"""Envoy Rate Limit Service v3 backed by the cluster token engine: the
port of ``sentinel_tpu/cluster/envoy_rls.py`` (reference
``sentinel-cluster/sentinel-cluster-server-envoy-rls``:
``SentinelEnvoyRlsServiceImpl.java`` + ``EnvoySentinelRuleConverter.java`` +
``SentinelRlsGrpcServer.java``). Identifiers, flow ids, codes and the
wire messages are the JAX package's.

Descriptor semantics match the reference: each rule names a ``domain`` and an
ordered list of descriptor (key, value) pairs; a request descriptor maps to
the flow id derived from the identifier ``domain|k1:v1|k2:v2``; an unmatched
descriptor passes (no rule ⇒ OK); any BLOCKED descriptor makes the overall
code OVER_LIMIT. Token accounting runs on the sharded
:class:`~sentinel_tpu_torch.parallel.cluster.ClusterEngine` exactly like the Netty
token path — the RLS frontend is just another protocol speaking to the same
checkers (``SimpleClusterFlowChecker`` in the reference is a trimmed acquire
of the same ``ClusterFlowChecker`` state).

The gRPC message classes are compiled from a trimmed wire-compatible subset
of the upstream protos (``proto/envoy_rls.proto``); the service is wired with
``grpc.method_handlers_generic_handler`` (no grpc codegen plugin needed).
``grpc`` and ``google.protobuf`` are imported only when the server is
built; the service core needs neither.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.core.clock import Clock
from sentinel_tpu_torch.parallel.cluster import (
    STATUS_NO_RULE_EXISTS, STATUS_OK, THRESHOLD_GLOBAL,
    ClusterEngine, ClusterFlowRule,
)

SEPARATOR = "|"           # EnvoySentinelRuleConverter.SEPARATOR

RLS_METHOD = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"

CODE_UNKNOWN = 0          # RateLimitResponse.Code
CODE_OK = 1
CODE_OVER_LIMIT = 2
UNIT_SECOND = 1           # RateLimitResponse.RateLimit.Unit


def descriptor_identifier(domain: str,
                          entries: Sequence[Tuple[str, str]]) -> str:
    """``domain|k1:v1|k2:v2`` (EnvoySentinelRuleConverter identifier)."""
    parts = [domain] + [f"{k}:{v}" for k, v in entries]
    return SEPARATOR.join(parts)


def identifier_flow_id(identifier: str) -> int:
    """Stable positive 63-bit flow id for an identifier string (the
    reference derives ids by hashing the identifier; any stable injective-
    enough mapping works since rules and requests share it)."""
    h = 1469598103934665603          # FNV-1a 64
    for b in identifier.encode("utf-8"):
        h = ((h ^ b) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h & 0x7FFFFFFFFFFFFFFF


@dataclasses.dataclass
class RlsDescriptorRule:
    """One limited descriptor: ordered (key, value) pairs + per-second cap."""
    entries: List[Tuple[str, str]]
    count: float


@dataclasses.dataclass
class EnvoyRlsRule:
    """Reference ``EnvoyRlsRule``: domain + limited descriptors."""
    domain: str
    descriptors: List[RlsDescriptorRule]


class EnvoyRlsRuleManager:
    """flow-id table + conversion into cluster rules
    (``EnvoyRlsRuleManager`` + ``EnvoySentinelRuleConverter``)."""

    def __init__(self, engine: ClusterEngine):
        self.engine = engine
        self._lock = threading.Lock()
        self._flow_ids: Dict[str, int] = {}       # identifier → flow id
        self._limits: Dict[int, float] = {}       # flow id → count
        self._loaded_domains: set = set()         # exact domains in engine

    def load_rules(self, rules: Sequence[EnvoyRlsRule]) -> None:
        """Replace all RLS rules (grouped per domain = namespace)."""
        with self._lock:
            by_domain: Dict[str, List[ClusterFlowRule]] = {}
            flow_ids: Dict[str, int] = {}
            limits: Dict[int, float] = {}
            for rule in rules:
                for d in rule.descriptors:
                    ident = descriptor_identifier(rule.domain, d.entries)
                    fid = identifier_flow_id(ident)
                    flow_ids[ident] = fid
                    limits[fid] = d.count
                    by_domain.setdefault(rule.domain, []).append(
                        ClusterFlowRule(
                            flow_id=fid, count=d.count,
                            threshold_type=THRESHOLD_GLOBAL))
            # Apply new/updated domains first; only then clear stale ones and
            # swap the lookup maps. If the engine raises mid-way (e.g.
            # namespace capacity — engine namespace slots are never freed, so
            # domain cardinality is bounded by spec.namespaces), the lookup
            # maps stay on the old, still-loaded rule set; a lookup that
            # races a drop resolves to NO_RULE_EXISTS which reads as OK.
            for domain, crules in by_domain.items():
                self.engine.load_rules(domain, crules)
            # exact loaded-domain set (identifiers can't be split back —
            # domains may themselves contain the separator)
            for stale in (self._loaded_domains - set(by_domain)):
                self.engine.load_rules(stale, [])
            self._loaded_domains = set(by_domain)
            self._flow_ids = flow_ids
            self._limits = limits

    def lookup(self, domain: str,
               entries: Sequence[Tuple[str, str]]) -> Optional[int]:
        with self._lock:
            return self._flow_ids.get(descriptor_identifier(domain, entries))

    def limit_of(self, flow_id: int) -> float:
        with self._lock:
            return self._limits.get(flow_id, 0.0)


@dataclasses.dataclass
class DescriptorStatus:
    code: int
    limit: float = 0.0
    remaining: int = 0


class EnvoyRlsService:
    """Protocol-neutral core of ``shouldRateLimit`` (so it is testable
    without gRPC and reusable behind an HTTP frontend)."""

    def __init__(self, engine: ClusterEngine,
                 rules: Optional[EnvoyRlsRuleManager] = None,
                 clock: Optional[Clock] = None):
        self.engine = engine
        self.rules = rules or EnvoyRlsRuleManager(engine)
        self._clock = clock or Clock()

    def _now_ms(self) -> int:
        return self._clock.now_ms()

    def should_rate_limit(
            self, domain: str,
            descriptors: Sequence[Sequence[Tuple[str, str]]],
            hits_addend: int = 1) -> Tuple[int, List[DescriptorStatus]]:
        acquire = max(1, int(hits_addend))     # 0 → 1 like the reference
        statuses: List[DescriptorStatus] = [None] * len(descriptors)  # type: ignore
        flow_ids: List[int] = []
        positions: List[int] = []
        for i, entries in enumerate(descriptors):
            fid = self.rules.lookup(domain, list(entries))
            if fid is None:
                statuses[i] = DescriptorStatus(code=CODE_OK)   # no rule ⇒ OK
            else:
                flow_ids.append(fid)
                positions.append(i)
        if flow_ids:
            results = self.engine.request_tokens(
                flow_ids, [acquire] * len(flow_ids), now_ms=self._now_ms())
            for (status, _wait, remaining), fid, i in zip(
                    results, flow_ids, positions):
                # SentinelEnvoyRlsServiceImpl: a rule dropped between lookup
                # and token request (NO_RULE_EXISTS) keeps the "no rule ⇒ OK"
                # contract; every OTHER non-OK status (BLOCKED, TOO_MANY,
                # SHOULD_WAIT, FAIL, BAD_REQUEST) is OVER_LIMIT — RLS has no
                # way to honor a wait, and engine errors must not fail open
                blocked = status not in (STATUS_OK, STATUS_NO_RULE_EXISTS)
                statuses[i] = DescriptorStatus(
                    code=CODE_OVER_LIMIT if blocked else CODE_OK,
                    limit=self.rules.limit_of(fid),
                    remaining=max(0, remaining))
        overall = (CODE_OVER_LIMIT
                   if any(s.code == CODE_OVER_LIMIT for s in statuses)
                   else CODE_OK)
        return overall, statuses


class SentinelRlsGrpcServer:
    """gRPC frontend (reference ``SentinelRlsGrpcServer``), default port
    10245 — hand-wired generic handler over the compiled subset protos."""

    DEFAULT_PORT = 10245

    def __init__(self, service: EnvoyRlsService, host: str = "0.0.0.0",
                 port: int = DEFAULT_PORT, max_workers: int = 8):
        self.service = service
        self.host = host
        self.requested_port = port
        self.port: Optional[int] = None
        self._server = None
        self._max_workers = max_workers

    def _handler(self):
        import grpc
        from sentinel_tpu_torch.cluster.proto import envoy_rls_pb2 as pb

        def should_rate_limit(request, context):
            descriptors = [[(e.key, e.value) for e in d.entries]
                           for d in request.descriptors]
            overall, statuses = self.service.should_rate_limit(
                request.domain, descriptors, request.hits_addend or 1)
            resp = pb.RateLimitResponse(overall_code=overall)
            for s in statuses:
                ds = resp.statuses.add()
                ds.code = s.code
                ds.limit_remaining = s.remaining
                if s.limit:
                    ds.current_limit.requests_per_unit = int(s.limit)
                    ds.current_limit.unit = UNIT_SECOND
            return resp

        return grpc.method_handlers_generic_handler(
            "envoy.service.ratelimit.v3.RateLimitService",
            {"ShouldRateLimit": grpc.unary_unary_rpc_method_handler(
                should_rate_limit,
                request_deserializer=pb.RateLimitRequest.FromString,
                response_serializer=pb.RateLimitResponse.SerializeToString)})

    def start(self) -> int:
        import grpc
        from concurrent import futures
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self._max_workers))
        self._server.add_generic_rpc_handlers((self._handler(),))
        self.port = self._server.add_insecure_port(
            f"{self.host}:{self.requested_port}")
        if self.port == 0:
            raise OSError(f"cannot bind RLS port {self.requested_port}")
        self._server.start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=None)
            self._server = None
