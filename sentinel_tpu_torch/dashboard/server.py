"""Dashboard web server: REST API + static UI (reference
``sentinel-dashboard`` Spring Boot controllers, SURVEY §2.5).

Routes (all JSON wrapped in the reference's ``Result`` envelope
``{"success": bool, "code": int, "msg": str, "data": ...}``):

- ``POST /registry/machine``            heartbeat receiver (``MachineRegistryController.java:36-45``)
- ``POST /auth/login`` / ``/auth/logout`` / ``GET /auth/check``
- ``GET  /app/names.json`` / ``GET /app/{app}/machines.json``
- ``GET  /metric/resources.json?app=``
- ``GET  /metric/queryByAppAndResource.json?app&identity&startTime&endTime``
- ``GET  /v1/{type}/rules?app``         pull live rules from a machine into the repo
- ``POST/PUT/DELETE /v1/{type}/rule[/{id}]``  CRUD; every change re-publishes the
  app's full rule set to every healthy machine (``FlowControllerV1.publishRules``)
- ``GET  /resource/machineResource.json?ip&port``  live clusterNode view
- ``GET  /cluster/state.json?app`` / ``POST /cluster/mode``
- ``GET  /``                            single-file JS UI

Rule types: flow, degrade, system, authority, paramFlow (agent command
``getRules``/``setRules`` type keys), plus gatewayFlow / gatewayApi
(``gateway/getRules|updateRules|getApiDefinitions|updateApiDefinitions``,
reference ``GatewayFlowRuleController`` / ``GatewayApiController``).

The PyTorch port's own copy of ``sentinel_tpu/dashboard/server.py``.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from sentinel_tpu_torch.dashboard.auth import AuthService
from sentinel_tpu_torch.dashboard.client import AgentUnreachable, SentinelApiClient
from sentinel_tpu_torch.dashboard.discovery import AppManagement, MachineInfo
from sentinel_tpu_torch.dashboard.fetcher import MetricFetcher
from sentinel_tpu_torch.dashboard.rulepipeline import RulePipelineRegistry
from sentinel_tpu_torch.dashboard.repository import (
    InMemoryMetricsRepository, MetricEntity, RuleEntity, RuleRepository,
)

RULE_TYPES = ("flow", "degrade", "system", "authority", "paramFlow",
              "gatewayFlow", "gatewayApi")

_STATIC_DIR = Path(__file__).parent / "static"


def _ok(data: Any = None) -> dict:
    return {"success": True, "code": 0, "msg": "", "data": data}


def _fail(msg: str, code: int = -1) -> dict:
    return {"success": False, "code": code, "msg": msg, "data": None}


class Dashboard:
    """Wires discovery + repos + fetcher + api client; host for route logic."""

    def __init__(self, *, username: str = "sentinel",
                 password: str = "sentinel", clock=None,
                 agent_timeout_s: Optional[float] = None):
        import os
        self.apps = AppManagement()
        self.metrics = InMemoryMetricsRepository()
        # per-request agent deadline (reference: the dashboard apiClient's
        # configurable http timeouts). An agent's FIRST hit on a stats
        # command jit-compiles its snapshot — allow overriding where 3 s
        # of compile is realistic (cold agents, loaded hosts).
        if agent_timeout_s is None:
            agent_timeout_s = float(
                os.environ.get("SENTINEL_DASH_AGENT_TIMEOUT_S", "0") or 0)
        self.client = (SentinelApiClient(timeout_s=agent_timeout_s)
                       if agent_timeout_s > 0 else SentinelApiClient())
        self.fetcher = MetricFetcher(self.apps, self.metrics,
                                     self.client, clock=clock)
        self.auth = AuthService(username, password)
        self.rules: Dict[str, RuleRepository] = {
            t: RuleRepository() for t in RULE_TYPES}
        # v2 pluggable rule pipeline (DynamicRuleProvider/Publisher SPI):
        # types with a registered pair read/publish through a config center
        # instead of direct machine push; agents pull the same store via a
        # datasource (rulepipeline.py)
        self.rule_pipeline = RulePipelineRegistry()
        self._clock = clock

    def set_rule_pipeline(self, rtype: str, provider=None,
                          publisher=None) -> None:
        """Install a v2 provider/publisher pair for one rule type
        (``FlowRuleApiProvider`` → config-center variant swap)."""
        self.rule_pipeline.set_pipeline(rtype, provider, publisher)

    def _now_ms(self) -> int:
        import time
        return (self._clock.now_ms() if self._clock is not None
                else int(time.time() * 1000))

    # --------------------------------------------------------- heartbeats
    def receive_heartbeat(self, params: Dict[str, str]) -> dict:
        app = params.get("app", "")
        ip = params.get("ip", "")
        if not app or not ip:
            return _fail("app and ip are required")
        m = MachineInfo(
            app=app, hostname=params.get("hostname", ""), ip=ip,
            port=int(params.get("port", "8719") or 8719),
            app_type=int(params.get("app_type", "0") or 0),
            version=params.get("v", ""),
            heartbeat_version=int(params.get("version", "0") or 0),
            last_heartbeat_ms=self._now_ms(),
            exporter_port=int(params.get("exporterPort", "0") or 0))
        self.apps.register(m)
        return _ok("success")

    # --------------------------------------------------------- rule CRUD
    def _machine(self, app: str, ip: str = "",
                 port: int = 0) -> Optional[MachineInfo]:
        if ip and port:
            return self.apps.get_machine(app, ip, port)
        return self.apps.first_healthy(app, self._now_ms())

    def query_rules(self, rtype: str, app: str, ip: str = "",
                    port: int = 0) -> dict:
        provider = self.rule_pipeline.provider(rtype)
        if provider is not None:
            # v2: the config center is the source of truth
            try:
                raw = provider.get_rules(app)
            except Exception as exc:
                return _fail(f"rule provider failed: {exc}")
            m = self._machine(app, ip, port) or MachineInfo(
                app=app, hostname="", ip="", port=0)
        else:
            m = self._machine(app, ip, port)
            if m is None:
                return _fail(f"no healthy machine for app {app}")
            try:
                raw = self.client.fetch_rules(m.ip, m.port, rtype)
            except AgentUnreachable as exc:
                return _fail(str(exc))
        repo = self.rules[rtype]
        known = {json.dumps(e.rule, sort_keys=True): e.id
                 for e in repo.find_by_app(app)}
        entities = []
        for r in raw:
            ent = RuleEntity(app=app, ip=m.ip, port=m.port, rule=r)
            ent.id = known.get(json.dumps(r, sort_keys=True), 0)
            entities.append(ent)
        entities = repo.replace_app(app, entities)
        return _ok([e.to_dict() for e in entities])

    def publish_rules(self, rtype: str, app: str) -> bool:
        rules = [e.rule for e in self.rules[rtype].find_by_app(app)]
        publisher = self.rule_pipeline.publisher(rtype)
        if publisher is not None:
            # v2: publish to the config center; agents converge by pulling
            # it through their datasource (no direct machine push)
            try:
                publisher.publish(app, rules)
                return True
            except Exception as exc:
                from sentinel_tpu_torch.core.logs import record_log
                record_log().warning("rule publisher failed: %r", exc)
                return False
        ok = True
        machines = self.apps.healthy_machines(app, self._now_ms())
        if not machines:
            return False
        for m in machines:
            try:
                ok = self.client.set_rules(m.ip, m.port, rtype, rules) and ok
            except AgentUnreachable:
                ok = False
        return ok

    @staticmethod
    def _canonical(rtype: str, rule: Dict[str, Any]) -> Dict[str, Any]:
        """Round-trip through the rule codec so stored dicts carry every
        field with defaults — identical to what agents echo back from
        ``getRules`` (otherwise re-pulls can't match repo ids)."""
        try:
            if rtype == "gatewayFlow":
                from sentinel_tpu_torch.gateway import codec as gw
                return gw.gateway_rule_to_dict(gw.gateway_rule_from_dict(rule))
            if rtype == "gatewayApi":
                from sentinel_tpu_torch.gateway import codec as gw
                return gw.api_definition_to_dict(
                    gw.api_definition_from_dict(rule))
            from sentinel_tpu_torch.rules import codec
            return json.loads(codec.rules_to_json(
                rtype, codec.rules_from_json(rtype, json.dumps([rule]))))[0]
        except (ValueError, KeyError, TypeError):
            return rule

    def add_rule(self, rtype: str, body: Dict[str, Any]) -> dict:
        app = body.pop("app", "")
        if not app:
            return _fail("app is required")
        ip, port = body.pop("ip", ""), int(body.pop("port", 0) or 0)
        body.pop("id", None)
        ent = self.rules[rtype].save(
            RuleEntity(app=app, ip=ip, port=port,
                       rule=self._canonical(rtype, body)))
        if not self.publish_rules(rtype, app):
            return _fail("rule saved but publish to machines failed",
                         code=-2) | {"data": ent.to_dict()}
        return _ok(ent.to_dict())

    def update_rule(self, rtype: str, rule_id: int,
                    body: Dict[str, Any]) -> dict:
        repo = self.rules[rtype]
        ent = repo.find(rule_id)
        if ent is None:
            return _fail(f"rule {rule_id} not found")
        for k in ("app", "id", "ip", "port"):
            body.pop(k, None)
        ent.rule.update(body)
        ent.rule = self._canonical(rtype, ent.rule)
        repo.save(ent)
        if not self.publish_rules(rtype, ent.app):
            return _fail("rule saved but publish to machines failed", code=-2)
        return _ok(ent.to_dict())

    def delete_rule(self, rtype: str, rule_id: int) -> dict:
        ent = self.rules[rtype].delete(rule_id)
        if ent is None:
            return _fail(f"rule {rule_id} not found")
        if not self.publish_rules(rtype, ent.app):
            return _fail("rule deleted but publish to machines failed",
                         code=-2)
        return _ok(rule_id)

    # --------------------------------------------------------- metrics
    def query_metrics(self, app: str, resource: str, start_ms: int,
                      end_ms: int) -> dict:
        ents = self.metrics.query(app, resource, start_ms, end_ms)
        return _ok([e.to_dict() for e in ents])

    def top_resources(self, app: str) -> dict:
        return _ok(self.metrics.list_resources(app))

    # --------------------------------------------------------- cluster
    def cluster_state(self, app: str) -> dict:
        out = []
        for m in self.apps.healthy_machines(app, self._now_ms()):
            try:
                st = self.client.get_cluster_mode(m.ip, m.port)
            except AgentUnreachable:
                st = {"mode": -1}
            if st.get("mode") == 1:
                # enrich server machines with live token-server info
                # (connected count, idle seconds — cluster/server/info)
                try:
                    info = self.client.fetch_cluster_server_info(m.ip, m.port)
                    st.setdefault("connectedCount",
                                  info.get("connectedCount"))
                    st.setdefault("idleSeconds", info.get("idleSeconds"))
                except AgentUnreachable:
                    pass
            st.update(ip=m.ip, port=m.port)
            out.append(st)
        return _ok(out)

    def set_cluster_mode(self, app: str, ip: str, port: int,
                         mode: int) -> dict:
        try:
            ok = self.client.set_cluster_mode(ip, port, mode)
        except AgentUnreachable as exc:
            return _fail(str(exc))
        return _ok(ok)

    def cluster_server_config(self, ip: str, port: int,
                              namespace: str = "") -> dict:
        """Token-server config view (reference
        ``cluster_app_server_manage`` screen): flow geometry +
        namespaceSet + transport, or one namespace's maxAllowedQps."""
        try:
            return _ok(self.client.fetch_cluster_server_config(
                ip, port, namespace))
        except AgentUnreachable as exc:
            return _fail(str(exc))

    def set_cluster_server_config(self, ip: str, port: int,
                                  namespace: str = "",
                                  max_allowed_qps: Optional[float] = None,
                                  namespaces: Optional[list] = None) -> dict:
        """Apply a server-config edit: the namespace set, the
        per-namespace QPS ceiling, or both in one call.

        The two writes are NOT transactional on the agent: a flow-config
        failure after the namespace set already landed reports partial
        success naming what applied and what didn't, so the operator
        re-submits only the failed half instead of assuming a clean
        rollback."""
        ns_applied = False
        try:
            if namespaces is not None:
                if not self.client.set_cluster_server_namespace_set(
                        ip, port, [str(n) for n in namespaces]):
                    return _fail("modify namespace set rejected")
                ns_applied = True
            if max_allowed_qps is not None:
                if not namespace:
                    return self._maybe_partial(
                        ns_applied, "namespace required for maxAllowedQps")
                if not self.client.set_cluster_server_flow_config(
                        ip, port, namespace, float(max_allowed_qps)):
                    return self._maybe_partial(
                        ns_applied, "modify flow config rejected")
        except AgentUnreachable as exc:
            return self._maybe_partial(ns_applied, str(exc))
        return _ok("success")

    @staticmethod
    def _maybe_partial(ns_applied: bool, msg: str) -> dict:
        if ns_applied:
            return _fail(
                "partial success: namespace set applied, but flow config "
                f"did not: {msg}")
        return _fail(msg)

    def cluster_assign(self, app: str, server_ip: str, server_port: int,
                       request_timeout_ms: int = 10_000) -> dict:
        """One-click topology (reference ``ClusterAssignService``): make the
        named machine the token server, then bind every other healthy
        machine of the app as a client of it."""
        server_machine = self.apps.get_machine(app, server_ip, server_port)
        if server_machine is None:
            return _fail(f"machine {server_ip}:{server_port} not registered")
        try:
            if not self.client.set_cluster_mode(server_ip, server_port, 1):
                return _fail("failed to switch server machine to SERVER mode")
            state = self.client.get_cluster_mode(server_ip, server_port)
        except AgentUnreachable as exc:
            return _fail(str(exc))
        token_port = int(state.get("serverPort", 0) or 0)
        if not token_port:
            return _fail("server machine reports no token-server port")
        bound, failed = [], []
        for m in self.apps.healthy_machines(app, self._now_ms()):
            if m.ip == server_ip and m.port == server_port:
                continue
            try:
                # generous default timeout: the server engine's first step
                # jit-compiles for seconds; the reference's 20 ms assumes a
                # warm JVM (clients can be retuned later via the same cmd)
                ok = (self.client.set_cluster_client_config(
                          m.ip, m.port, server_ip, token_port,
                          request_timeout=request_timeout_ms)
                      and self.client.set_cluster_mode(m.ip, m.port, 0))
            except AgentUnreachable:
                ok = False
            (bound if ok else failed).append(f"{m.ip}:{m.port}")
        return _ok({"server": f"{server_ip}:{server_port}",
                    "tokenPort": token_port,
                    "clients": bound, "failed": failed})


class _Handler(BaseHTTPRequestHandler):
    dash: Dashboard
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------ helpers
    def _send(self, status: int, payload: bytes,
              ctype: str = "application/json; charset=utf-8",
              extra: Optional[List[Tuple[str, str]]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (extra or []):
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _json(self, obj: dict, status: int = 200,
              extra: Optional[List[Tuple[str, str]]] = None) -> None:
        self._send(status, json.dumps(obj).encode("utf-8"), extra=extra)

    def _body_params(self, body: bytes) -> Dict[str, Any]:
        ctype = self.headers.get("Content-Type", "")
        if not body:
            return {}
        if "application/json" in ctype:
            try:
                obj = json.loads(body.decode("utf-8"))
                return obj if isinstance(obj, dict) else {}
            except ValueError:
                return {}
        return {k: v[-1] for k, v in
                urllib.parse.parse_qs(body.decode("utf-8")).items()}

    def _cookie_token(self) -> Optional[str]:
        cookie = self.headers.get("Cookie", "")
        m = re.search(r"sentinel_session=([^;\s]+)", cookie)
        return m.group(1) if m else None

    # ------------------------------------------------------------ routing
    def _route(self, method: str, body: bytes) -> None:
        d = self.dash
        parsed = urllib.parse.urlparse(self.path)
        path = parsed.path
        q = {k: v[-1] for k, v in
             urllib.parse.parse_qs(parsed.query).items()}
        if not d.auth.exempt(path) and not d.auth.check(self._cookie_token()):
            # 200 + code=401 envelope: the reference AuthFilter redirects, the
            # SPA keys off the envelope code instead
            self._json(_fail("login required", code=401))
            return

        if method == "POST" and path == "/registry/machine":
            params = dict(q)
            params.update({k: str(v) for k, v in
                           self._body_params(body).items()})
            self._json(d.receive_heartbeat(params))
            return
        if method == "POST" and path == "/auth/login":
            p = self._body_params(body)
            token = d.auth.login(str(p.get("username", "")),
                                 str(p.get("password", "")))
            if token is None:
                self._json(_fail("invalid credentials", code=401))
            else:
                self._json(_ok({"username": d.auth.username}), extra=[
                    ("Set-Cookie",
                     f"sentinel_session={token}; Path=/; HttpOnly")])
            return
        if method == "POST" and path == "/auth/logout":
            token = self._cookie_token()
            if token:
                d.auth.logout(token)
            self._json(_ok())
            return
        if method == "GET" and path == "/auth/check":
            self._json(_ok({"loggedIn":
                            d.auth.check(self._cookie_token())}))
            return
        if method == "GET" and path == "/app/names.json":
            self._json(_ok(d.apps.app_names()))
            return
        m = re.fullmatch(r"/app/([^/]+)/machines\.json", path)
        if method == "GET" and m:
            now = d._now_ms()
            self._json(_ok([mi.to_dict(now) for mi in
                            d.apps.machines(m.group(1))]))
            return
        m = re.fullmatch(r"/app/([^/]+)/machine/remove\.json", path)
        if method == "POST" and m:
            p = self._body_params(body)
            ok = d.apps.remove_machine(m.group(1), str(p.get("ip", "")),
                                       int(p.get("port", 0) or 0))
            self._json(_ok("success") if ok
                       else _fail("machine not found"))
            return
        if method == "GET" and path == "/metric/resources.json":
            self._json(d.top_resources(q.get("app", "")))
            return
        if method == "GET" and path == "/metric/queryByAppAndResource.json":
            self._json(d.query_metrics(
                q.get("app", ""), q.get("identity", ""),
                int(q.get("startTime", "0") or 0),
                int(q.get("endTime", "0") or 0)))
            return
        if method == "GET" and path == "/resource/machineResource.json":
            try:
                nodes = d.client.fetch_cluster_nodes(
                    q.get("ip", ""), int(q.get("port", "0") or 0))
                self._json(_ok(nodes))
            except AgentUnreachable as exc:
                self._json(_fail(str(exc)))
            return
        if method == "GET" and path == "/resource/origin.json":
            try:
                self._json(_ok(d.client.fetch_origin_stats(
                    q.get("ip", ""), int(q.get("port", "0") or 0),
                    q.get("id", ""))))
            except AgentUnreachable as exc:
                self._json(_fail(str(exc)))
            return
        if method == "GET" and path == "/resource/jsonTree.json":
            try:
                self._json(_ok(d.client.fetch_json_tree(
                    q.get("ip", ""), int(q.get("port", "0") or 0))))
            except AgentUnreachable as exc:
                self._json(_fail(str(exc)))
            return
        if method == "GET" and path == "/systemStatus.json":
            try:
                self._json(_ok(d.client.fetch_system_status(
                    q.get("ip", ""), int(q.get("port", "0") or 0))))
            except AgentUnreachable as exc:
                self._json(_fail(str(exc)))
            return
        if method == "GET" and path == "/obs/telemetry.json":
            try:
                self._json(_ok(d.client.fetch_obs(
                    q.get("ip", ""), int(q.get("port", "0") or 0),
                    spans=int(q.get("spans", "128") or 128),
                    events=int(q.get("events", "64") or 64),
                    trace=q.get("trace", ""))))
            except AgentUnreachable as exc:
                self._json(_fail(str(exc)))
            return
        if method == "GET" and path == "/obs/topk.json":
            # hot-resource telemetry: device-side sharded top-K + the
            # per-second timeline ring (obs/telemetry.py via the agent's
            # ``topk`` command)
            try:
                self._json(_ok(d.client.fetch_topk(
                    q.get("ip", ""), int(q.get("port", "0") or 0),
                    timeline=int(q.get("timeline", "60") or 60),
                    tick=q.get("tick", "") in ("1", "true"))))
            except AgentUnreachable as exc:
                self._json(_fail(str(exc)))
            return
        if method == "GET" and path == "/obs/control.json":
            # overload-controller state + applied-action audit tail
            # (control/loop.py via the agent's ``control`` command)
            try:
                self._json(_ok(d.client.fetch_control(
                    q.get("ip", ""), int(q.get("port", "0") or 0),
                    actions=int(q.get("actions", "32") or 32),
                    tick=q.get("tick", "") in ("1", "true"))))
            except AgentUnreachable as exc:
                self._json(_fail(str(exc)))
            return
        if method == "GET" and path == "/obs/traces.json":
            # request-scoped tracing: ?id= proxies one causal chain as a
            # Chrome-trace-event document; without id, the flight
            # recorder's pinned-record index (docs/OBSERVABILITY.md)
            try:
                self._json(_ok(d.client.fetch_trace(
                    q.get("ip", ""), int(q.get("port", "0") or 0),
                    trace_id=q.get("id", ""))))
            except AgentUnreachable as exc:
                self._json(_fail(str(exc)))
            return
        if method == "GET" and path == "/cluster/state.json":
            self._json(d.cluster_state(q.get("app", "")))
            return
        if method == "GET" and path == "/cluster/metrics.json":
            # token-server per-flow metrics; namespace defaults to the app
            # name (ClusterCoordinator's default namespace)
            try:
                self._json(_ok(d.client.fetch_cluster_server_metrics(
                    q.get("ip", ""), int(q.get("port", "0") or 0),
                    q.get("namespace", "") or q.get("app", ""))))
            except AgentUnreachable as exc:
                self._json(_fail(str(exc)))
            return
        if method == "GET" and path == "/cluster/serverConfig.json":
            self._json(d.cluster_server_config(
                q.get("ip", ""), int(q.get("port", "0") or 0),
                q.get("namespace", "")))
            return
        if method == "POST" and path == "/cluster/serverConfig":
            p = self._body_params(body)
            qps = p.get("maxAllowedQps")
            nss = p.get("namespaces")
            if isinstance(nss, str):
                nss = [s.strip() for s in nss.split(",") if s.strip()]
            if nss is not None and not nss:
                # an empty set would silently stop serving every namespace
                # while the UI still shows the app-name fallback
                self._json(_fail("namespace set must not be empty"))
                return
            self._json(d.set_cluster_server_config(
                str(p.get("ip", "")), int(p.get("port", 0) or 0),
                namespace=str(p.get("namespace", "") or ""),
                max_allowed_qps=(float(qps) if qps not in (None, "")
                                 else None),
                namespaces=nss))
            return
        if method == "POST" and path == "/cluster/mode":
            p = self._body_params(body)
            self._json(d.set_cluster_mode(
                str(p.get("app", "")), str(p.get("ip", "")),
                int(p.get("port", 0) or 0), int(p.get("mode", 0) or 0)))
            return
        if method == "POST" and path == "/cluster/assign":
            p = self._body_params(body)
            self._json(d.cluster_assign(
                str(p.get("app", "")), str(p.get("serverIp", "")),
                int(p.get("serverPort", 0) or 0),
                request_timeout_ms=int(p.get("requestTimeout",
                                             10_000) or 10_000)))
            return

        m = re.fullmatch(r"/v1/([^/]+)/rules", path)
        if method == "GET" and m:
            rtype = m.group(1)
            if rtype not in RULE_TYPES:
                self._json(_fail(f"unknown rule type {rtype}"), status=404)
                return
            self._json(d.query_rules(rtype, q.get("app", ""),
                                     q.get("ip", ""),
                                     int(q.get("port", "0") or 0)))
            return
        m = re.fullmatch(r"/v1/([^/]+)/rule(?:/(\d+))?", path)
        if m:
            rtype, rid = m.group(1), m.group(2)
            if rtype not in RULE_TYPES:
                self._json(_fail(f"unknown rule type {rtype}"), status=404)
                return
            if method == "POST" and rid is None:
                self._json(d.add_rule(rtype, self._body_params(body)))
                return
            if method == "PUT" and rid is not None:
                self._json(d.update_rule(rtype, int(rid),
                                         self._body_params(body)))
                return
            if method == "DELETE" and rid is not None:
                self._json(d.delete_rule(rtype, int(rid)))
                return

        if method == "GET" and path in ("/", "/index.html"):
            page = _STATIC_DIR / "index.html"
            self._send(200, page.read_bytes(),
                       ctype="text/html; charset=utf-8")
            return
        if method == "GET" and path.startswith("/static/"):
            f = _STATIC_DIR / path[len("/static/"):]
            if f.is_file() and _STATIC_DIR in f.resolve().parents:
                ctype = ("text/css" if f.suffix == ".css"
                         else "application/javascript" if f.suffix == ".js"
                         else "application/octet-stream")
                self._send(200, f.read_bytes(), ctype=ctype)
                return
        self._json(_fail(f"no route {method} {path}"), status=404)

    def _route_safe(self, method: str, body: bytes) -> None:
        try:
            self._route(method, body)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as exc:   # malformed params must yield a response
            try:
                self._json(_fail(f"internal error: {exc}", code=500),
                           status=500)
            except OSError:
                pass

    def do_GET(self) -> None:  # noqa: N802
        self._route_safe("GET", b"")

    def _with_body(self, method: str) -> None:
        length = int(self.headers.get("Content-Length", "0") or 0)
        self._route_safe(method, self.rfile.read(length) if length else b"")

    def do_POST(self) -> None:  # noqa: N802
        self._with_body("POST")

    def do_PUT(self) -> None:  # noqa: N802
        self._with_body("PUT")

    def do_DELETE(self) -> None:  # noqa: N802
        self._with_body("DELETE")

    def log_message(self, fmt, *args):
        pass


class DashboardServer:
    """Owns the HTTP server thread + the metric fetcher loop."""

    def __init__(self, dashboard: Optional[Dashboard] = None,
                 host: str = "0.0.0.0", port: int = 8080, **kw):
        self.dashboard = dashboard or Dashboard(**kw)
        self.host = host
        self.requested_port = port
        self.port: Optional[int] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, *, fetch: bool = True) -> int:
        handler = type("BoundDashHandler", (_Handler,),
                       {"dash": self.dashboard})
        self._server = ThreadingHTTPServer(
            (self.host, self.requested_port), handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="sentinel-dashboard")
        self._thread.start()
        if fetch:
            self.dashboard.fetcher.start()
        return self.port

    def stop(self) -> None:
        self.dashboard.fetcher.stop()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
