"""Port parity: the ``cluster/server/*`` commands
(``sentinel_tpu_torch.cluster.commands``) against
``sentinel_tpu.cluster.commands``.

The twin of ``tests/test_cluster_commands.py``: each scenario runs on both
packages against a live embedded token server, wired the way an agent
wires it — ``ClusterCoordinator.bind(state, command_center)`` on a center
that holds the default handlers — with twin ManualClocks. Every response
(status and body, JSON compared parsed), every token verdict the scenario
asks the engine for and the engine's windows
(``convert.cluster_to_numpy``) must agree. Left out, and only these: the
token server's bound port (``port``, ``serverPort``, ``transport.port``),
an ephemeral port that differs from run to run.
"""

import json

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu import transport as jtr
from sentinel_tpu.cluster import commands as jcmd
from sentinel_tpu.cluster import coordinator as jcoord
from sentinel_tpu.parallel import cluster as jcl
from sentinel_tpu_torch import convert
from sentinel_tpu_torch import transport as ttr
from sentinel_tpu_torch.cluster import commands as tcmd
from sentinel_tpu_torch.cluster import coordinator as tcoord
from sentinel_tpu_torch.parallel import cluster as tcl

torch.set_num_threads(2)

T0 = 1_785_000_000_000
PKGS = {"jax": stpu, "torch": stt}
MODS = {"jax": dict(tr=jtr, cmd=jcmd, coord=jcoord, cl=jcl),
        "torch": dict(tr=ttr, cmd=tcmd, coord=tcoord, cl=tcl)}
PORT_KEYS = ("port", "serverPort")

#: the JAX engines' jitted steps by geometry (every coordinator builds an
#: engine of one spec: later ones reuse the first one's program)
_JAX_STEPS = {}

FLOW_RULES = [{
    "resource": "svc", "count": 5.0, "grade": 1, "clusterMode": True,
    "clusterConfig": {"flowId": 101, "thresholdType": 1},
}]
PARAM_RULES = [{"resource": "svc", "paramIdx": 0, "count": 2.0,
                "clusterMode": True, "clusterConfig": {"flowId": 202},
                "paramFlowItemList": [
                    {"object": "vip", "count": 50, "classType": "String"}]}]


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


class Serving:
    """One package's agent in SERVER mode: runtime, coordinator bound to
    a command center with the default handlers, live engine and server."""

    def __init__(self, name: str, mode: int = 1):
        self.name, self.pkg, self.m = name, PKGS[name], MODS[name]
        pkg, m = self.pkg, self.m
        self.clk = pkg.ManualClock(start_ms=T0)
        extra = {"device": "cpu"} if pkg is stt else {}
        self.sph = pkg.Sentinel(pkg.load_config(
            max_resources=64, max_flow_rules=16, max_degrade_rules=16,
            max_authority_rules=16, host_fast_path=False),
            clock=self.clk, **extra)
        self.coord = m["coord"].ClusterCoordinator(
            self.sph, namespace="ns-a", clock=self.clk)
        self.center = m["tr"].CommandCenter()
        self.cstate = m["tr"].register_default_handlers(self.center,
                                                        self.sph)
        self.coord.bind(self.cstate, self.center)
        if mode is not None:
            self.call("setClusterMode", mode=mode)

    @property
    def eng(self):
        eng = self.coord.server.engine
        if self.pkg is stpu:
            eng._step = _JAX_STEPS.setdefault(eng.spec, eng._step)
        return eng

    def call(self, name, **params):
        resp = self.center.handle(name, self.m["tr"].CommandRequest(
            parameters={k: str(v) for k, v in params.items()}))
        return resp

    def close(self):
        self.coord.stop()
        self.sph.close()


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in PORT_KEYS}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def observe(resp):
    """(success, code, body) with the body parsed when it is JSON."""
    try:
        body = _strip(json.loads(resp.result))
    except ValueError:
        body = resp.result
    return resp.success, resp.code, body


def _same(a, b) -> bool:
    if isinstance(a, dict) and a and all(isinstance(v, np.ndarray)
                                         for v in a.values()):
        return convert.leaf_diff(a, b) == []
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def twin(scenario, mode=1):
    got = {}
    for name in PKGS:
        s = Serving(name, mode)
        # the JAX coordinator's engine takes the shared step at once
        if s.coord.server is not None:
            s.eng
        try:
            got[name] = scenario(s)
        finally:
            s.close()
    assert _same(got["torch"], got["jax"])
    return got["torch"]


def _tokens(s, ids, n=None):
    res = s.eng.request_tokens(list(ids), [1] * len(ids),
                               now_ms=s.clk.now_ms())
    return [tuple(int(x) for x in r) for r in res]


def _fetch(s, what, **params):
    return observe(s.call(f"cluster/server/{what}", **params))


# ---------------------------------------------------------------- scenarios

def sc_flow_rule_modify_fetch_roundtrip_and_enforcement(s):
    out = [observe(s.call("cluster/server/modifyFlowRules",
                          namespace="ns-a", data=json.dumps(FLOW_RULES)))]
    out.append(_fetch(s, "flowRules", namespace="ns-a"))
    toks = _tokens(s, [101] * 8)
    assert sum(1 for st, _w, _r in toks if st == 0) == 5
    out += [toks, convert.cluster_to_numpy(s.eng)]
    return out


def sc_param_rule_roundtrip(s):
    out = [observe(s.call("cluster/server/modifyParamRules",
                          namespace="ns-a", data=json.dumps(PARAM_RULES)))]
    out.append(_fetch(s, "paramRules", namespace="ns-a"))
    out.append(dict(s.eng._param_rules[202].items))
    return out


def sc_fetch_config_and_flow_config_modify(s):
    out = [_fetch(s, "fetchConfig")]
    out.append(observe(s.call("cluster/server/modifyNamespaceSet",
                              data=json.dumps(["ns-a", "ns-b"]))))
    out.append(_fetch(s, "fetchConfig"))
    out.append(observe(s.call("cluster/server/modifyFlowConfig",
                              namespace="ns-a",
                              data=json.dumps({"maxAllowedQps": 123.0}))))
    out.append(_fetch(s, "fetchConfig", namespace="ns-a"))
    out.append(_fetch(s, "info"))
    assert out[-2][2]["flow"]["maxAllowedQps"] == 123.0
    return out


def sc_metric_list_reports_flow_traffic(s):
    s.call("cluster/server/modifyFlowRules", namespace="ns-a",
           data=json.dumps(FLOW_RULES))
    toks = _tokens(s, [101] * 8)
    nodes = _fetch(s, "metricList", namespace="ns-a")
    assert nodes[2][0]["passQps"] == 5.0 and nodes[2][0]["blockQps"] == 3.0
    return [toks, nodes]


def sc_fetch_config_unknown_namespace_does_not_allocate(s):
    before = dict(s.eng._ns_ids)
    out = [_fetch(s, "fetchConfig", namespace=f"typo-{i}")
           for i in range(8)]
    assert s.eng._ns_ids == before
    s.eng.namespace_id("legit-ns")
    return out


def sc_fetch_rules_reflect_engine_loaded_state(s):
    cl = s.m["cl"]
    s.eng.load_rules("ns-a", [cl.ClusterFlowRule(flow_id=777, count=3.0,
                                                 threshold_type=1)])
    out = [_fetch(s, "flowRules", namespace="ns-a")]
    out.append(_tokens(s, [777] * 5))
    out.append(_fetch(s, "metricList", namespace="ns-a"))
    s.eng.load_param_rules("ns-a", [cl.ClusterParamFlowRule(
        flow_id=888, count=9.0, items={"vip": 50.0})])
    out.append(_fetch(s, "paramRules", namespace="ns-a"))
    out.append(_fetch(s, "flowRules", namespace="ns-a"))
    return out


def sc_fetch_enforcement_fields_track_engine_after_direct_reload(s):
    cl = s.m["cl"]
    s.call("cluster/server/modifyFlowRules", namespace="ns-a",
           data=json.dumps(FLOW_RULES))
    s.eng.load_rules("ns-a", [cl.ClusterFlowRule(flow_id=101, count=2.0,
                                                 threshold_type=0)])
    out = [_fetch(s, "flowRules", namespace="ns-a")]
    assert s.call("cluster/server/modifyParamRules", namespace="ns-a",
                  data=json.dumps(PARAM_RULES)).success
    s.eng.load_param_rules("ns-a", [cl.ClusterParamFlowRule(
        flow_id=202, count=9.0, items={"vip": 5.0})])
    out.append(_fetch(s, "paramRules", namespace="ns-a"))
    return out


def sc_fetch_round_trips_non_cluster_mode_beans(s):
    mixed = FLOW_RULES + [{"resource": "local-only", "count": 9.0,
                           "grade": 1, "clusterMode": False}]
    out = [observe(s.call("cluster/server/modifyFlowRules",
                          namespace="ns-a", data=json.dumps(mixed)))]
    out.append(_fetch(s, "flowRules", namespace="ns-a"))
    return out


def sc_transport_config_modify(s):
    old = s.coord.server.port
    out = [observe(s.call("cluster/server/modifyTransportConfig",
                          data=json.dumps({"idleSeconds": 99})))]
    assert s.coord.server.port == old and s.coord.server.idle_seconds == 99
    out.append(_fetch(s, "info"))
    out.append(observe(s.call("cluster/server/modifyTransportConfig",
                              data="{bad")))
    return out


def sc_metric_list_top_params_for_param_flows(s):
    rules = [{"resource": "svc", "paramIdx": 0, "count": 100.0,
              "clusterMode": True, "clusterConfig": {"flowId": 303}}]
    out = [observe(s.call("cluster/server/modifyParamRules",
                          namespace="ns-a", data=json.dumps(rules)))]
    now = s.clk.now_ms()
    res = s.eng.request_param_tokens(
        [303] * 6, [1] * 6, [("vip",), ("vip",), ("vip",), ("basic",),
                             ("basic",), ("solo",)], now_ms=now)
    out.append([tuple(int(x) for x in r) for r in res])
    out.append(_fetch(s, "metricList", namespace="ns-a"))
    w = s.eng.spec.window.win_ms * s.eng.spec.window.buckets
    out.append(s.eng.top_params(303, now_ms=now + w))
    out.append(s.eng.top_params(303, now_ms=now + 2 * w + 1))
    assert out[2][2][0]["topParams"] == {"vip": 3, "basic": 2, "solo": 1}
    return out


def sc_bad_requests(s):
    out = []
    for what, params in [
            ("flowRules", {}), ("paramRules", {}), ("metricList", {}),
            ("modifyFlowRules", {"data": "[]"}),
            ("modifyFlowRules", {"namespace": "ns-a"}),
            ("modifyFlowRules", {"namespace": "ns-a", "data": "{nope"}),
            ("modifyParamRules", {"namespace": "ns-a", "data": "[1]"}),
            ("modifyFlowConfig", {"data": "{}"}),
            ("modifyFlowConfig", {"namespace": "ns-a", "data": "[x"}),
            ("modifyNamespaceSet", {"data": "{}"}),
            ("modifyNamespaceSet", {"data": "nope"})]:
        out.append((what, _fetch(s, what, **params)))
    return out


def sc_embedded_server_serves_the_agents_own_rules(s):
    """The agent's own cluster rule through ``entry()`` while the
    dashboard manages the embedded server over the commands."""
    pkg = s.pkg
    s.sph.load_flow_rules([pkg.FlowRule(
        resource="svc", count=1000, cluster_mode=True, cluster_flow_id=101,
        cluster_fallback_to_local=True)])
    s.call("cluster/server/modifyFlowRules", namespace="ns-a",
           data=json.dumps(FLOW_RULES))
    out = []
    for _ in range(7):
        try:
            with s.sph.entry("svc"):
                out.append("pass")
        except pkg.BlockException as exc:
            out.append(type(exc).__name__)
    assert out.count("pass") == 5
    out.append(_fetch(s, "metricList", namespace="ns-a"))
    out.append(observe(s.call("getClusterMode")))
    return out


SCENARIOS = [v for k, v in list(globals().items()) if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=lambda f: f.__name__[3:])
def test_scenario_matches_reference(scenario):
    twin(scenario)


def test_info_and_not_running_failures():
    """With no server running every engine command fails alike; ``info``
    still answers."""
    def scenario(s):
        return [_fetch(s, "modifyFlowRules", namespace="x", data="[]"),
                _fetch(s, "modifyFlowRules", namespace="x",
                       data=json.dumps(FLOW_RULES)),
                _fetch(s, "metricList", namespace="x"),
                _fetch(s, "modifyTransportConfig", data="{}"),
                _fetch(s, "modifyNamespaceSet", data="[]"),
                _fetch(s, "flowRules", namespace="x"),
                _fetch(s, "fetchConfig"),
                _fetch(s, "info")]
    out = twin(scenario, mode=None)
    assert out[1][0] is False and "not running" in out[1][2]
    assert out[-1][0] is True


def test_standalone_registration_with_a_fixed_engine():
    """``register_cluster_server_handlers(center, engine=...)`` — the
    standalone token-server process's wiring — in both packages."""
    got = {}
    for name in PKGS:
        m = MODS[name]
        clk = PKGS[name].ManualClock(start_ms=T0)
        spec = m["cl"].ClusterSpec(n_shards=1, flows_per_shard=8,
                                   namespaces=4)
        eng = (tcl.ClusterEngine(spec, device="cpu") if name == "torch"
               else jcl.ClusterEngine(spec))
        if name == "jax":
            eng._step = _JAX_STEPS.setdefault(spec, eng._step)
        center = m["tr"].CommandCenter()
        cmds = m["cmd"].register_cluster_server_handlers(center, engine=eng,
                                                         clock=clk)
        assert isinstance(cmds, m["cmd"].ClusterServerCommands)
        req = m["tr"].CommandRequest
        out = [sorted(center.names().items())]
        for cmd, params in [
                ("cluster/server/modifyFlowRules",
                 {"namespace": "ns-s", "data": json.dumps(FLOW_RULES)}),
                ("cluster/server/flowRules", {"namespace": "ns-s"}),
                ("cluster/server/fetchConfig", {}),
                ("cluster/server/info", {})]:
            out.append(observe(center.handle(cmd, req(parameters=params))))
        res = eng.request_tokens([101] * 7, [1] * 7, now_ms=clk.now_ms())
        out.append([tuple(int(x) for x in r) for r in res])
        out.append(observe(center.handle("cluster/server/metricList", req(
            parameters={"namespace": "ns-s"}))))
        got[name] = out
    assert _same(got["torch"], got["jax"])
