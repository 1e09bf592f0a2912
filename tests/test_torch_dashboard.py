"""Port parity: the dashboard (``sentinel_tpu_torch.dashboard``) against
``sentinel_tpu.dashboard``.

Twins of the 19 tests of ``tests/test_dashboard.py``, of
``tests/test_rule_pipeline.py`` and of
``tests/test_cluster_coordinator.py::test_dashboard_cluster_assign_end_to_end``.
Each scenario runs once as the reference (the JAX dashboard driving JAX
agents) and then in the pairing its test names:

* ``port``: the port's dashboard driving the port's agents;
* ``jax_dash_port_agent``: the JAX dashboard driving the port's agents;
* ``port_dash_jax_agent``: the port's dashboard driving JAX agents.

Agents run under one ManualClock (the agent package's; the dashboard reads
the same one), the port's on the CPU. Every pairing must give the
reference's parsed response bodies, its rule repositories, its fetched
metric entities, its machine lists and its agents' engine state. What is
left out, and only this:

* ephemeral ports: every bound port is replaced by its role (``<agent0>``,
  ``<dash0>``, ``<token>``) wherever it appears in a body;
* the session token of a login (random by design).

Rule ids come from a process-wide counter in both packages; each run
starts it from 1, as a fresh dashboard process does. Scenarios that touch
no agent run in the ``port`` pairing alone.
"""

import importlib
import itertools
import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

import sentinel_tpu_torch as stt
from sentinel_tpu_torch import convert

torch.set_num_threads(2)

T0 = 1_785_000_000_000
APP = "sentinel-tpu"          # HeartbeatSender's app in the reference tests


def _side(root: str) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}" if name else root)
    return types.SimpleNamespace(
        name=root, pkg=mod(""), dash=mod("dashboard"),
        server=mod("dashboard.server"), client=mod("dashboard.client"),
        repo=mod("dashboard.repository"), pipe=mod("dashboard.rulepipeline"),
        tr=mod("transport"), searcher=mod("metrics.searcher"),
        timer=mod("metrics.timer"), writer=mod("metrics.writer"),
        gw=mod("gateway"), gwcodec=mod("gateway.codec"),
        codec=mod("rules.codec"), coord=mod("cluster.coordinator"),
        pcl=mod("parallel.cluster"), ds=mod("datasource"),
        ctx=mod("core.context"))


SIDES = {"jax": _side("sentinel_tpu"), "torch": _side("sentinel_tpu_torch")}
#: pairing → (dashboard package, agent package)
PAIRS = {"port": ("torch", "torch"),
         "jax_dash_port_agent": ("jax", "torch"),
         "port_dash_jax_agent": ("torch", "jax")}
REFERENCE = ("jax", "jax")
#: every thread a scenario leaves is joined under this limit (there is
#: no pytest-timeout in the repo)
JOIN_S = 60


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


def _bounded(fn, what: str) -> None:
    """``fn()`` in a thread joined under :data:`JOIN_S`."""
    err = []

    def bounded_body():
        try:
            fn()
        except BaseException as exc:        # noqa: BLE001 — re-raised
            err.append(exc)
    t = threading.Thread(target=bounded_body, daemon=True,
                         name=f"close-{what}")
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), f"{what} did not stop within {JOIN_S} s"
    if err:
        raise err[0]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=JOIN_S) as r:
        return json.loads(r.read().decode())


def _send(port, path, method="POST", body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=JOIN_S) as r:
        return json.loads(r.read().decode())


def _raw(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=JOIN_S) as r:
        return r.read().decode()


class Run:
    """One pairing's world: dashboards of package ``dash`` and agents of
    package ``agent``, under the agent package's ManualClock."""

    def __init__(self, dash: str, agent: str, tmp_path):
        self.d, self.a = SIDES[dash], SIDES[agent]
        self.clk = self.a.pkg.ManualClock(start_ms=T0)
        self.dir = tmp_path / f"{dash}-dash-{agent}-agent"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.ports = {}
        self.dashboards, self.sphs = [], []
        self._closers = []

    # ------------------------------------------------------------ parts
    def closing(self, fn, what: str) -> None:
        self._closers.append((fn, what))

    def name_port(self, port: int, role: str) -> None:
        self.ports[int(port)] = role

    def dashboard(self, **kw):
        kw.setdefault("password", "")
        kw.setdefault("clock", self.clk)
        kw.setdefault("agent_timeout_s", 30.0)
        server = self.d.dash.DashboardServer(self.d.dash.Dashboard(**kw),
                                             host="127.0.0.1", port=0)
        port = server.start(fetch=False)     # fetches are driven by hand
        self.closing(server.stop, "dashboard")
        self.name_port(port, f"<dash{len(self.dashboards)}>")
        self.dashboards.append(server.dashboard)
        return server.dashboard, port

    def bare_dashboard(self, **kw):
        """A :class:`Dashboard` without its HTTP server."""
        d = self.d.dash.Dashboard(**{"password": "", "clock": self.clk,
                                     **kw})
        self.dashboards.append(d)
        return d

    def sentinel(self, **cfg):
        config = self.a.pkg.load_config(
            max_resources=64, max_flow_rules=16, max_degrade_rules=16,
            max_authority_rules=16, **cfg)
        extra = {"device": "cpu"} if self.a.pkg is stt else {}
        sph = self.a.pkg.Sentinel(config=config, clock=self.clk, **extra)
        self.sphs.append(sph)
        return sph

    def serve(self, center) -> int:
        # 0.0.0.0: heartbeats advertise the machine's interface IP, and
        # the dashboard connects back to that address
        http = self.a.tr.SimpleHttpCommandCenter(center, host="0.0.0.0",
                                                 port=0)
        port = http.start()
        self.closing(http.stop, "agent server")
        self.name_port(port, f"<agent{len(self.ports)}>")
        return port

    def agent(self):
        """The reference's ``agent`` fixture: a runtime, its metric
        writer, timer and searcher, the default handlers over HTTP."""
        sph = self.sentinel(minute_enabled=True)
        a = self.a
        writer = a.writer.MetricWriter(str(self.dir), sph.cfg.app_name)
        timer = a.timer.MetricTimerListener(sph, writer=writer)
        searcher = a.searcher.MetricSearcher(
            str(self.dir), a.writer.form_metric_file_name(sph.cfg.app_name))
        center = a.tr.CommandCenter()
        a.tr.register_default_handlers(center, sph, metric_searcher=searcher)
        return sph, timer, self.serve(center)

    def gateway_agent(self):
        """The reference's ``gateway_agent`` fixture."""
        sph = self.sentinel()
        gw = self.a.gw.GatewayRuleManager(sph)
        apis = self.a.gw.GatewayApiDefinitionManager()
        center = self.a.tr.CommandCenter()
        self.a.tr.register_default_handlers(
            center, sph, gateway_manager=gw, api_definition_manager=apis)
        return sph, gw, apis, self.serve(center)

    def transport(self, sph, **kw):
        rt = self.a.tr.start_transport(sph, host="0.0.0.0", port=0,
                                       clock=sph.clock, **kw)
        self.closing(rt.stop, "transport")
        self.name_port(rt.port, f"<agent{len(self.ports)}>")
        return rt

    def coordinator(self, sph, **kw):
        coord = self.a.coord.ClusterCoordinator(sph, **kw)
        self.closing(coord.stop, "coordinator")
        return coord

    def beat(self, agent_port: int, dash_port: int):
        hb = self.a.tr.HeartbeatSender(f"127.0.0.1:{dash_port}",
                                       app_name=APP, api_port=agent_port,
                                       clock=self.clk)
        assert hb.send_once()
        return hb

    def agent_rules(self, sph, rtype: str):
        """The agent's live rules of one type, as the rule JSON."""
        get = {"flow": sph.get_flow_rules, "degrade": sph.get_degrade_rules,
               "system": sph.get_system_rules}[rtype]
        return json.loads(self.a.codec.rules_to_json(rtype, get()))

    # ------------------------------------------------------------ results
    def norm(self, obj):
        """``obj`` with every bound port replaced by its role."""
        if isinstance(obj, bool):
            return obj
        if isinstance(obj, int) and obj in self.ports:
            return self.ports[obj]
        if isinstance(obj, str):
            for port, role in self.ports.items():
                obj = obj.replace(f":{port}", f":{role}")
            return self.ports.get(int(obj), obj) if obj.isdigit() else obj
        if isinstance(obj, dict):
            return {k: self.norm(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.norm(v) for v in obj)
        return obj

    def collect(self, observed) -> dict:
        out = {"observed": self.norm(observed), "repos": [], "metrics": [],
               "machines": []}
        for d in self.dashboards:
            out["repos"].append({
                t: [e.to_dict() for e in sorted(repo._by_id.values(),
                                                key=lambda e: e.id)]
                for t, repo in d.rules.items()})
            out["metrics"].append({
                app: {res: [e.to_dict() for e in ring.values()]
                      for res, ring in rings.items()}
                for app, rings in d.metrics._data.items()})
            now = d._now_ms()
            out["machines"].append({
                app: sorted((m.to_dict(now) for m in d.apps.machines(app)),
                            key=lambda m: (m["ip"], m["port"]))
                for app in d.apps.app_names()})
        out = self.norm(out)
        out["state"] = [convert.engine_to_numpy(s) for s in self.sphs]
        return out

    def close(self) -> None:
        for fn, what in reversed(self._closers):
            _bounded(fn, what)
        for sph in self.sphs:
            sph.close()


def run_pairing(scenario, pair, tmp_path) -> dict:
    """``scenario(r)`` in one pairing, rule ids counted from 1."""
    dash, agent = pair
    repo_cls = SIDES[dash].repo.RuleRepository
    saved = repo_cls._ids
    repo_cls._ids = itertools.count(1)
    r = Run(dash, agent, tmp_path)
    try:
        observed = scenario(r)
        return r.collect(observed)
    finally:
        repo_cls._ids = saved
        r.close()


_REFERENCE = {}


def twin(scenario, pairing: str, tmp_path) -> dict:
    """The pairing's results, held to the reference's."""
    key = scenario.__name__
    if key not in _REFERENCE:
        _REFERENCE[key] = run_pairing(scenario, REFERENCE, tmp_path / "reference")
    want = _REFERENCE[key]
    got = run_pairing(scenario, PAIRS[pairing], tmp_path / pairing)
    for part in ("observed", "repos", "metrics", "machines"):
        assert got[part] == want[part], part
    assert len(got["state"]) == len(want["state"])
    for a, b in zip(want["state"], got["state"]):
        assert convert.leaf_diff(a, b) == []
    return got


# ------------------------------------------------------------ discovery

def db_heartbeat_registers_machine(r):
    _sph, _timer, aport = r.agent()
    _d, dport = r.dashboard()
    r.beat(aport, dport)
    names = _get(dport, "/app/names.json")
    assert names["data"] == [APP]
    machines = _get(dport, f"/app/{APP}/machines.json")
    assert machines["data"][0]["port"] == aport
    assert machines["data"][0]["healthy"]
    return [names, machines]


def dbo_machine_goes_unhealthy_by_heartbeat_age(r):
    d, _dport = r.dashboard()
    d.receive_heartbeat({"app": "a", "ip": "1.2.3.4", "port": "8719"})
    before = [m.to_dict(d._now_ms())
              for m in d.apps.healthy_machines("a", d._now_ms())]
    r.clk.advance_ms(120_000)
    after = d.apps.healthy_machines("a", d._now_ms())
    assert before and not after
    return [before, len(after)]


# ------------------------------------------------------------ rule CRUD

def db_rule_crud_writes_through_to_agent(r):
    sph, _timer, aport = r.agent()
    _d, dport = r.dashboard()
    r.beat(aport, dport)
    out = _send(dport, "/v1/flow/rule", body={
        "app": APP, "resource": "svc", "grade": 1, "count": 5.0})
    assert out["success"], out
    rid = out["data"]["id"]
    live = [r.agent_rules(sph, "flow")]
    assert len(live[0]) == 1 and live[0][0]["count"] == 5.0
    got = _get(dport, f"/v1/flow/rules?app={APP}")
    assert len(got["data"]) == 1 and got["data"][0]["id"] == rid
    up = _send(dport, f"/v1/flow/rule/{rid}", method="PUT",
               body={"count": 9.0})
    assert up["success"], up
    live.append(r.agent_rules(sph, "flow"))
    assert live[1][0]["count"] == 9.0
    gone = _send(dport, f"/v1/flow/rule/{rid}", method="DELETE")
    live.append(r.agent_rules(sph, "flow"))
    assert live[2] == []
    return [out, got, up, gone, live]


def db_degrade_and_system_rule_publish(r):
    sph, _timer, aport = r.agent()
    _d, dport = r.dashboard()
    r.beat(aport, dport)
    deg = _send(dport, "/v1/degrade/rule", body={
        "app": APP, "resource": "svc", "grade": 2, "count": 3,
        "timeWindow": 10})
    system = _send(dport, "/v1/system/rule", body={"app": APP, "qps": 100})
    assert deg["success"] and system["success"]
    live = [r.agent_rules(sph, "degrade"), r.agent_rules(sph, "system")]
    assert [len(x) for x in live] == [1, 1]
    return [deg, system, live]


def dbo_add_rule_without_machines_reports_publish_failure(r):
    _d, dport = r.dashboard()
    out = _send(dport, "/v1/flow/rule", body={
        "app": "ghost", "resource": "svc", "count": 1.0})
    assert not out["success"] and out["code"] == -2
    return out


# ------------------------------------------------------------ metrics

def db_metric_fetch_aggregates_into_repo(r):
    sph, timer, aport = r.agent()
    d, dport = r.dashboard()
    r.beat(aport, dport)
    pkg = r.a.pkg
    sph.load_flow_rules([pkg.FlowRule(resource="svc", count=4)])
    verdicts = []
    for _ in range(6):
        try:
            with sph.entry("svc"):
                verdicts.append("pass")
        except pkg.BlockException as exc:
            verdicts.append(type(exc).__name__)
    r.clk.advance_ms(2100)
    ticked = timer.tick()
    assert ticked >= 1
    r.clk.advance_ms(3000)
    fetched = d.fetcher.fetch_once(APP)
    assert fetched >= 1
    res = _get(dport, f"/metric/resources.json?app={APP}")
    assert "svc" in res["data"]
    pts = _get(dport, f"/metric/queryByAppAndResource.json?app={APP}"
               f"&identity=svc&startTime={T0 - 1000}&endTime={T0 + 9000}")
    svc = [p for p in pts["data"] if p["timestamp"] == T0]
    assert svc and svc[0]["passQps"] == 4 and svc[0]["blockQps"] == 2
    return [verdicts, ticked, fetched, res, pts]


def dbo_repo_two_machine_aggregation_and_retention(r):
    repo_mod = r.d.repo
    repo = repo_mod.InMemoryMetricsRepository()
    for rt in (10.0, 30.0):
        repo.save(repo_mod.MetricEntity(app="a", timestamp=1000,
                                        resource="r", pass_qps=5, rt=rt,
                                        count=1), now_ms=2000)
    got = [e.to_dict() for e in repo.query("a", "r", 0, 5000)]
    assert got[0]["passQps"] == 10 and got[0]["rt"] == 20.0
    repo.save(repo_mod.MetricEntity(app="a", timestamp=10_000_000,
                                    resource="r", pass_qps=1, count=1),
              now_ms=10_000_000)
    evicted = repo.query("a", "r", 0, 5000)
    assert evicted == []
    return [got, len(evicted), repo.list_resources("a")]


# ------------------------------------------------------------ live views

def db_machine_resource_view(r):
    sph, _timer, aport = r.agent()
    _d, dport = r.dashboard()
    r.beat(aport, dport)
    with sph.entry("svc"):
        pass
    out = _get(dport,
               f"/resource/machineResource.json?ip=127.0.0.1&port={aport}")
    assert out["success"]
    assert any(n.get("resource") == "svc" for n in out["data"])
    return out


# ------------------------------------------------------------ auth

def dbo_auth_required_when_password_set(r):
    _d, port = r.dashboard(password="s3cret")
    out = [_get(port, "/app/names.json")]
    assert not out[0]["success"] and out[0]["code"] == 401
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/auth/login", method="POST",
        data=json.dumps({"username": "sentinel",
                         "password": "s3cret"}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=JOIN_S) as resp:
        cookie = resp.headers["Set-Cookie"]
        out.append(json.loads(resp.read().decode()))
    token = cookie.split(";")[0]
    # the token is random by design: what is compared is the cookie's form
    out.append(cookie.replace(token.split("=", 1)[1], "<token>"))
    out.append(_get_with(port, "/app/names.json", {"Cookie": token}))
    out.append(_get_with(port, "/auth/check", {"Cookie": token}))
    out.append(_send(port, "/auth/logout", body={},
                     headers={"Cookie": token}))
    out.append(_get_with(port, "/auth/check", {"Cookie": token}))
    bad = _send(port, "/auth/login",
                body={"username": "sentinel", "password": "nope"})
    assert out[1]["success"] and out[3]["success"]
    assert not bad["success"] and bad["code"] == 401
    return out + [bad]


def _get_with(port, path, headers):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=JOIN_S) as r:
        return json.loads(r.read().decode())


def dbo_index_page_served(r):
    _d, dport = r.dashboard()
    body = _raw(dport, "/")
    assert "Sentinel-TPU Dashboard" in body
    return body


def dbo_static_assets_served(r):
    _d, dport = r.dashboard()
    out = []
    for path, must in [("/static/app.js", "openRuleModal"),
                       ("/static/style.css", "--panel")]:
        body = _raw(dport, path)
        assert must in body
        out.append(body)
    # the traversal guard: nothing outside static/ is served
    try:
        _raw(dport, "/static/../server.py")
        out.append("served")
    except urllib.error.HTTPError as exc:
        out.append(exc.code)
    return out


# ------------------------------------------------------------ gateway

def db_gateway_rule_crud_writes_through_to_agent(r):
    _sph, gw, _apis, aport = r.gateway_agent()
    _d, dport = r.dashboard()
    r.beat(aport, dport)
    enc = r.a.gwcodec.gateway_rules_to_json
    out = _send(dport, "/v1/gatewayFlow/rule", body={
        "app": APP, "resource": "route-a", "resourceMode": 0,
        "count": 7.0, "intervalSec": 1,
        "paramItem": {"parseStrategy": 2, "fieldName": "X-Tenant"}})
    assert out["success"], out
    rid = out["data"]["id"]
    live = [json.loads(enc(gw.all_rules()))]
    assert live[0][0]["paramItem"]["fieldName"] == "X-Tenant"
    got = _get(dport, f"/v1/gatewayFlow/rules?app={APP}")
    assert len(got["data"]) == 1 and got["data"][0]["id"] == rid
    up = _send(dport, f"/v1/gatewayFlow/rule/{rid}", method="PUT",
               body={"count": 11.0})
    assert up["success"], up
    live.append(json.loads(enc(gw.all_rules())))
    assert live[1][0]["count"] == 11.0
    gone = _send(dport, f"/v1/gatewayFlow/rule/{rid}", method="DELETE")
    live.append(json.loads(enc(gw.all_rules())))
    assert live[2] == []
    return [out, got, up, gone, live]


def db_gateway_api_definitions_crud(r):
    _sph, _gw, apis, aport = r.gateway_agent()
    _d, dport = r.dashboard()
    r.beat(aport, dport)
    enc = r.a.gwcodec.api_definitions_to_json
    out = _send(dport, "/v1/gatewayApi/rule", body={
        "app": APP, "apiName": "my-api",
        "predicateItems": [{"pattern": "/foo/**", "matchStrategy": 1}]})
    assert out["success"], out
    live = [json.loads(enc(apis.get_api_definitions()))]
    assert live[0][0]["apiName"] == "my-api"
    got = _get(dport, f"/v1/gatewayApi/rules?app={APP}")
    assert got["data"][0]["apiName"] == "my-api"
    gone = _send(dport, f"/v1/gatewayApi/rule/{out['data']['id']}",
                 method="DELETE")
    live.append(json.loads(enc(apis.get_api_definitions())))
    assert live[1] == []
    return [out, got, gone, live]


def db_json_tree_route(r):
    sph, _timer, aport = r.agent()
    _d, dport = r.dashboard()
    r.beat(aport, dport)
    with sph.entry("tree-res"):
        pass
    with sph.entry("gw-route", resource_type=3):   # TYPE_GATEWAY
        pass
    out = _get(dport, f"/resource/jsonTree.json?ip=127.0.0.1&port={aport}")
    assert out["success"]
    nodes = {n.get("resource"): n for n in out["data"]}
    assert nodes["tree-res"]["classification"] == 0
    assert nodes["gw-route"]["classification"] == 3
    return out


def db_cluster_server_metrics_route(r):
    _d, dport = r.dashboard()
    sph = r.sentinel()
    coord = r.coordinator(sph, clock=r.clk)     # namespace = app name
    rt = r.transport(sph, metric_log=False)
    coord.bind(rt.cluster_state, command_center=rt.center)
    coord.on_mode_change(1)
    r.name_port(coord.server.port, "<token>")
    eng = coord.server.engine
    eng.load_rules(coord.namespace, [r.a.pcl.ClusterFlowRule(
        flow_id=11, count=4.0, threshold_type=r.a.pcl.THRESHOLD_GLOBAL)])
    tokens = eng.request_tokens([11] * 6, [1] * 6, now_ms=r.clk.now_ms())
    r.beat(rt.port, dport)
    out = _get(dport, f"/cluster/metrics.json?app={sph.cfg.app_name}"
                      f"&ip=127.0.0.1&port={rt.port}")
    assert out["success"], out
    node = out["data"][0]
    assert node["flowId"] == 11
    assert node["passQps"] == 4.0 and node["blockQps"] == 2.0
    state = _get(dport, f"/cluster/state.json?app={APP}")
    return [[tuple(int(x) for x in t) for t in tokens], out, state]


def db_cluster_server_config_routes(r):
    _d, dport = r.dashboard()
    sph = r.sentinel()
    coord = r.coordinator(sph, clock=r.clk)
    rt = r.transport(sph, metric_log=False)
    coord.bind(rt.cluster_state, command_center=rt.center)
    coord.on_mode_change(1)
    r.name_port(coord.server.port, "<token>")
    r.beat(rt.port, dport)
    base = f"/cluster/serverConfig.json?ip=127.0.0.1&port={rt.port}"
    out = [_get(dport, base)]
    assert out[0]["success"] and "flow" in out[0]["data"]
    ip_port = {"ip": "127.0.0.1", "port": rt.port}
    out.append(_send(dport, "/cluster/serverConfig",
                     body={**ip_port, "namespaces": "nsa, nsb"}))
    out.append(_get(dport, base))
    assert out[-1]["data"]["namespaceSet"] == ["nsa", "nsb"]
    out.append(_send(dport, "/cluster/serverConfig",
                     body={**ip_port, "namespace": "nsa",
                           "maxAllowedQps": 123.0}))
    out.append(_get(dport, base + "&namespace=nsa"))
    assert out[-1]["data"]["flow"]["maxAllowedQps"] == 123.0
    out.append(_send(dport, "/cluster/serverConfig",
                     body={**ip_port, "maxAllowedQps": 5}))
    assert not out[-1]["success"]
    out.append(_send(dport, "/cluster/serverConfig",
                     body={**ip_port, "namespaces": ""}))
    assert not out[-1]["success"]
    out.append(_get(dport, base))
    assert out[-1]["data"]["namespaceSet"] == ["nsa", "nsb"]
    return out


def dbo_machine_remove_route(r):
    d, dport = r.dashboard()
    d.receive_heartbeat({"app": "a", "ip": "1.2.3.4", "port": "8719"})
    d.receive_heartbeat({"app": "a", "ip": "1.2.3.5", "port": "8719"})
    out = [_send(dport, "/app/a/machine/remove.json",
                 body={"ip": "1.2.3.4", "port": 8719})]
    out.append(_get(dport, "/app/a/machines.json"))
    assert [m["ip"] for m in out[-1]["data"]] == ["1.2.3.5"]
    out.append(_send(dport, "/app/a/machine/remove.json",
                     body={"ip": "1.2.3.5", "port": 8719}))
    out.append(_get(dport, "/app/names.json"))
    assert "a" not in out[-1]["data"]
    out.append(_send(dport, "/app/a/machine/remove.json",
                     body={"ip": "9.9.9.9", "port": 1}))
    assert not out[-1]["success"]
    return out


def db_origin_stats_route(r):
    sph, _timer, aport = r.agent()
    _d, dport = r.dashboard()
    r.beat(aport, dport)
    for origin in ("web-app", "job-runner", "web-app"):
        with r.a.ctx.ContextScope("ctx", origin=origin):
            with sph.entry("svc"):
                pass
    out = _get(dport,
               f"/resource/origin.json?ip=127.0.0.1&port={aport}&id=svc")
    assert out["success"]
    assert {o["origin"]: o["passQps"] for o in out["data"]} == {
        "web-app": 2, "job-runner": 1}
    return out


def dbo_cluster_server_config_partial_success_reporting(r):
    unreachable = r.d.client.AgentUnreachable

    class StubClient:
        def __init__(self, flow_result):
            self.flow_result = flow_result
            self.calls = []

        def set_cluster_server_namespace_set(self, ip, port, namespaces):
            self.calls.append(("ns", namespaces))
            return True

        def set_cluster_server_flow_config(self, ip, port, ns, qps):
            self.calls.append(("flow", ns, qps))
            if isinstance(self.flow_result, Exception):
                raise self.flow_result
            return self.flow_result

    d = r.bare_dashboard(password="sentinel")
    out = []
    for result, kw in (
            (False, dict(namespace="nsa", max_allowed_qps=5.0,
                         namespaces=["nsa", "nsb"])),
            (unreachable("conn reset"), dict(namespace="nsa",
                                             max_allowed_qps=5.0,
                                             namespaces=["nsa"])),
            (False, dict(namespace="nsa", max_allowed_qps=5.0)),
            (True, dict(max_allowed_qps=5.0, namespaces=["nsa"]))):
        d.client = StubClient(result)
        res = d.set_cluster_server_config("127.0.0.1", 8719, **kw)
        assert not res["success"]
        out.append([res, d.client.calls])
    assert out[0][0]["msg"].startswith("partial success: namespace set")
    assert "conn reset" in out[1][0]["msg"]
    assert "partial success" not in out[2][0]["msg"]
    assert out[3][0]["msg"].startswith("partial success")
    return out


# ------------------------------------------------------------ rule pipeline

def db_publish_through_file_store_agent_pulls(r):
    d = r.bare_dashboard()
    store = r.d.pipe.FileRuleStore(str(r.dir / "store"), "flow")
    d.set_rule_pipeline("flow", provider=store, publisher=store)
    res = d.add_rule("flow", {"app": "shop", "resource": "checkout",
                              "count": 12})
    assert res["code"] == 0, res
    with open(store.path_for("shop")) as fh:
        on_disk = [json.load(fh)]
    assert on_disk[0][0]["count"] == 12
    sph = r.sentinel()
    ds = r.a.ds.FileRefreshableDataSource(
        store.path_for("shop"), r.a.ds.rule_converter("flow"),
        start_thread=False)
    r.closing(ds.close, "datasource")
    ds.get_property().add_listener(lambda rs: sph.load_flow_rules(rs))
    live = [r.agent_rules(sph, "flow")]
    assert [x["count"] for x in live[0]] == [12]
    ent_id = res["data"]["id"]
    up = d.update_rule("flow", ent_id, {"count": 30})
    assert ds.refresh_now()
    live.append(r.agent_rules(sph, "flow"))
    assert [x["count"] for x in live[1]] == [30]
    q = d.query_rules("flow", "shop")
    assert q["code"] == 0 and q["data"][0]["count"] == 30
    gone = d.delete_rule("flow", ent_id)
    assert ds.refresh_now()
    live.append(r.agent_rules(sph, "flow"))
    assert live[2] == []
    with open(store.path_for("shop")) as fh:
        on_disk.append(json.load(fh))
    return [res, up, q, gone, on_disk, live]


def dbo_v1_direct_path_untouched_for_other_types(r):
    d = r.bare_dashboard()
    store = r.d.pipe.FileRuleStore(str(r.dir / "store"), "flow")
    d.set_rule_pipeline("flow", provider=store, publisher=store)
    res = d.add_rule("degrade", {"app": "shop", "resource": "r",
                                 "count": 1, "timeWindow": 5})
    assert res["code"] == -2
    return res


def dbo_publisher_failure_reported(r):
    d = r.bare_dashboard()

    def boom(app, rules):
        raise RuntimeError("store down")

    d.set_rule_pipeline("flow",
                        publisher=r.d.pipe.CallbackRulePublisher(boom))
    res = d.add_rule("flow", {"app": "a", "resource": "r", "count": 1})
    assert res["code"] == -2
    return res


# ------------------------------------------------------ cluster assign

def db_dashboard_cluster_assign_end_to_end(r):
    """Two agents register by their own heartbeat threads; /cluster/assign
    makes one the token server and the other its client; a cluster rule
    is then enforced globally. Which agent becomes the server follows
    the heartbeats' arrival order, so results are kept in role order and
    both agents' ports carry the same role name."""
    pkg = r.a.pkg
    _d, dport = r.dashboard()
    apps = []
    for _ in range(2):
        sph = r.sentinel()
        coord = r.coordinator(sph, namespace="shared-ns",
                              clock=pkg.ManualClock(start_ms=T0))
        rt = r.transport(sph, dashboard_addr=f"127.0.0.1:{dport}")
        r.name_port(rt.port, "<agent>")
        coord.bind(rt.cluster_state)
        coord.request_timeout_ms = 60_000
        apps.append((sph, coord))
    deadline = time.monotonic() + JOIN_S
    while len(r.dashboards[0].apps.healthy_machines(
            sph.cfg.app_name, r.clk.now_ms())) < 2:
        assert time.monotonic() < deadline, "heartbeats did not land"
        time.sleep(0.05)
    server_m = r.dashboards[0].apps.healthy_machines(
        sph.cfg.app_name, r.clk.now_ms())[0]
    out = _send(dport, "/cluster/assign", body={
        "app": sph.cfg.app_name, "serverIp": server_m.ip,
        "serverPort": server_m.port})
    assert out["success"], out
    server_app = next(a for a in apps if a[1].server is not None)
    client_app = next(a for a in apps if a[1].client is not None)
    r.name_port(server_app[1].server.port, "<token>")
    server_app[1].server.load_flow_rules("shared-ns", [
        r.a.pcl.ClusterFlowRule(flow_id=5, count=2,
                                threshold_type=r.a.pcl.THRESHOLD_GLOBAL)])
    rule = pkg.FlowRule(resource="gsvc", count=1000, cluster_mode=True,
                        cluster_flow_id=5, cluster_fallback_to_local=False)
    for sph, _c in (server_app, client_app):
        sph.load_flow_rules([rule])
    verdicts = []
    for sph in (server_app[0], server_app[0], client_app[0], client_app[0]):
        try:
            with sph.entry("gsvc"):
                verdicts.append("pass")
        except pkg.BlockException as exc:
            verdicts.append(type(exc).__name__)
    assert verdicts.count("pass") == 2
    r.sphs[:] = [server_app[0], client_app[0]]
    state = _get(dport, f"/cluster/state.json?app={sph.cfg.app_name}")
    state["data"].sort(key=lambda m: m.get("mode"))
    return [out, verdicts, state]


SCENARIOS = [v for k, v in list(globals().items()) if k.startswith("db_")]
DASHBOARD_ONLY = [v for k, v in list(globals().items())
                  if k.startswith("dbo_")]


@pytest.mark.parametrize("pairing", list(PAIRS))
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_dashboard_scenario_matches_reference(scenario, pairing, tmp_path):
    twin(scenario, pairing, tmp_path)


@pytest.mark.parametrize("scenario", DASHBOARD_ONLY,
                         ids=lambda f: f.__name__[4:])
def test_dashboard_only_scenario_matches_reference(scenario, tmp_path):
    twin(scenario, "port", tmp_path)


def test_every_reference_scenario_has_a_twin():
    """The 19 tests of test_dashboard.py, the 3 of test_rule_pipeline.py
    and the coordinator's dashboard test each have a scenario here."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    names = set()
    for f in ("test_dashboard.py", "test_rule_pipeline.py"):
        with open(os.path.join(here, f)) as fh:
            names |= {ln[len("def test_"):].split("(")[0]
                      for ln in fh if ln.startswith("def test_")}
    names.add("dashboard_cluster_assign_end_to_end")
    mine = {f.__name__.split("_", 1)[1] for f in SCENARIOS + DASHBOARD_ONLY}
    assert names == mine


def test_dashboard_exports_the_reference_names():
    jd, td = SIDES["jax"].dash, SIDES["torch"].dash
    assert td.__all__ == jd.__all__
    for name in td.__all__:
        assert getattr(td, name).__module__.startswith("sentinel_tpu_torch.")
    assert SIDES["torch"].server.RULE_TYPES == SIDES["jax"].server.RULE_TYPES
    from sentinel_tpu.dashboard import fetcher as jf
    from sentinel_tpu_torch.dashboard import fetcher as tf
    assert (tf.FETCH_INTERVAL_S, tf.DELAY_MS, tf.MAX_SPAN_MS) == (
        jf.FETCH_INTERVAL_S, jf.DELAY_MS, jf.MAX_SPAN_MS) == (6, 2000, 60000)
    assert SIDES["torch"].client.DEFAULT_TIMEOUT_S == 3.0


def test_agent_timeout_knob(monkeypatch):
    """``SENTINEL_DASH_AGENT_TIMEOUT_S`` sets the client's deadline in
    both packages alike; unset or 0 keeps the 3 s default."""
    got = {}
    for name, side in SIDES.items():
        monkeypatch.setenv("SENTINEL_DASH_AGENT_TIMEOUT_S", "12.5")
        a = side.dash.Dashboard(password="").client.timeout_s
        monkeypatch.setenv("SENTINEL_DASH_AGENT_TIMEOUT_S", "0")
        b = side.dash.Dashboard(password="").client.timeout_s
        monkeypatch.delenv("SENTINEL_DASH_AGENT_TIMEOUT_S")
        c = side.dash.Dashboard(password="", agent_timeout_s=4.0
                                ).client.timeout_s
        got[name] = (a, b, c)
    assert got["torch"] == got["jax"] == (12.5, 3.0, 4.0)


def test_fetcher_window_arithmetic_matches_reference():
    """The fetch window (``fetcher.py``: ``[last, now - DELAY]`` in whole
    seconds, a minute at most) and the merge by ``(resource, ts)`` over
    machines, driven through a stub client on both packages."""
    got = {}
    for name, side in SIDES.items():
        node_mod = importlib.import_module(f"{side.name}.metrics.node")
        calls = []

        class Stub:
            def fetch_metrics(self, ip, port, start, end):
                calls.append((ip, start, end))
                if ip == "10.0.0.9":
                    raise side.client.AgentUnreachable("down")
                return [node_mod.MetricNode(
                    timestamp=start + 1000 * k, resource=f"r{k % 2}",
                    pass_qps=k + (ip == "10.0.0.2"), block_qps=1,
                    success_qps=k, exception_qps=0, rt=10 * k + 1)
                    for k in range(3)]

        clk = side.pkg.ManualClock(start_ms=T0 + 777)
        apps = side.dash.AppManagement()
        for ip in ("10.0.0.1", "10.0.0.2", "10.0.0.9"):
            apps.register(side.dash.MachineInfo(
                app="a", ip=ip, port=8719, last_heartbeat_ms=T0))
        repo = side.dash.InMemoryMetricsRepository()
        f = side.dash.MetricFetcher(apps, repo, Stub(), clock=clk)
        counts = [f.fetch_once("a")]
        counts.append(f.fetch_once("a"))          # nothing new yet
        clk.advance_ms(3_500)
        counts.append(f.fetch_once("a"))
        clk.advance_ms(300_000)                   # a long gap: capped
        counts.append(f.fetch_once("a"))
        got[name] = (counts, calls, {
            res: [e.to_dict() for e in repo.query("a", res, 0, 1 << 62)]
            for res in repo.list_resources("a")})
    assert got["torch"] == got["jax"]
    assert got["jax"][0][0] > 0 and got["jax"][0][1] == 0


def test_client_parses_what_the_reference_client_parses(monkeypatch):
    """Every command wrapper of the two ``SentinelApiClient``\\ s sends the
    same request and parses the same body alike (``MetricNode``\\ s
    compared by ``dataclasses.asdict``)."""
    import dataclasses
    body = {
        "version": "0.1.0\n",
        "getRules": '[{"resource": "r", "count": 1.0}]',
        "gateway/getRules": "[]", "gateway/getApiDefinitions": "[]",
        "metric": ("# threadsElided=true\nNo metrics\n"
                   "1785000000000|svc|7|2|7|0|3|0|0|0\nbroken|line\n"),
        "clusterNode": '[{"resource": "svc"}]', "jsonTree": "[]",
        "systemStatus": '{"qps": 1}', "obs": '{"counters": {}}',
        "topk": '{"enabled": true}', "control": '{"enabled": false}',
        "trace": '{"pinned": []}', "getClusterMode": '{"mode": 1}',
        "origin": '[{"origin": "a"}]', "cluster/server/info": "{}",
        "cluster/server/metricList": "[]",
        "cluster/server/fetchConfig": '{"flow": {}}',
    }
    got = {}
    for name, side in SIDES.items():
        sent = []
        cli = side.client.SentinelApiClient()
        monkeypatch.setattr(cli, "_get", lambda ip, port, cmd, params=None:
                            sent.append(("GET", cmd, params)) or body[cmd])
        monkeypatch.setattr(cli, "_post", lambda ip, port, cmd, params:
                            sent.append(("POST", cmd, params)) or "success")
        out = [cli.version("h", 1), cli.fetch_rules("h", 1, "flow"),
               cli.fetch_rules("h", 1, "gatewayFlow"),
               cli.fetch_rules("h", 1, "gatewayApi"),
               [dataclasses.asdict(n)
                for n in cli.fetch_metrics("h", 1, 0, 10)],
               cli.fetch_cluster_nodes("h", 1), cli.fetch_json_tree("h", 1),
               cli.fetch_system_status("h", 1),
               cli.fetch_obs("h", 1, trace="9"),
               cli.fetch_topk("h", 1, tick=True),
               cli.fetch_control("h", 1, tick=True),
               cli.fetch_trace("h", 1), cli.fetch_trace("h", 1, "5"),
               cli.get_cluster_mode("h", 1), cli.set_cluster_mode("h", 1, 1),
               cli.fetch_origin_stats("h", 1, "svc"),
               cli.fetch_cluster_server_info("h", 1),
               cli.fetch_cluster_server_metrics("h", 1, "ns"),
               cli.set_cluster_client_config("h", 1, "s", 2, 30),
               cli.fetch_cluster_server_config("h", 1, "ns"),
               cli.set_cluster_server_flow_config("h", 1, "ns", 5.0),
               cli.set_cluster_server_namespace_set("h", 1, ["a"]),
               cli.set_rules("h", 1, "flow", [{"resource": "r"}]),
               cli.set_rules("h", 1, "gatewayApi", [])]
        got[name] = (out, sent)
    assert got["torch"] == got["jax"]
    assert got["jax"][0][4][0]["resource"] == "svc"


def test_unreachable_agent_raises_agent_unreachable():
    for side in SIDES.values():
        cli = side.client.SentinelApiClient(timeout_s=0.5)
        with pytest.raises(side.client.AgentUnreachable):
            cli.version("127.0.0.1", 1)
