"""Port parity of the command plane as a whole: one operator session
against a running agent, on both packages.

The session (twin ManualClocks; the port's runtime on the CPU) starts the
transport on an ephemeral port over the facade's runtime, pushes rules of
every type over HTTP (``setRules``, ``setParamFlowRules``), sends
application traffic through ``api.entry``, a ``@sentinel_resource``
function and a WSGI app, persists a push through a writable file
datasource and reloads the rules from a file datasource mid-traffic,
switches to the embedded token server over HTTP (``setClusterMode``
through a bound ``ClusterCoordinator``), manages it with the
``cluster/server/*`` commands, sends cluster-ruled traffic and reads
``metric`` after the metric timer wrote its seconds. Every verdict, every
response (status and body; JSON compared parsed, less the token
server's ephemeral port), the runtime's engine state and the embedded
engine's windows
must agree.
"""

import io
import json
import os
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu.adapters as jad
import sentinel_tpu.api as japi
import sentinel_tpu_torch as stt
import sentinel_tpu_torch.adapters as tad
import sentinel_tpu_torch.api as tapi
from sentinel_tpu import datasource as jds
from sentinel_tpu import transport as jtr
from sentinel_tpu.cluster import coordinator as jcoord
from sentinel_tpu.metrics import searcher as jsearcher
from sentinel_tpu.metrics import timer as jtimer
from sentinel_tpu.metrics import writer as jwriter
from sentinel_tpu_torch import convert
from sentinel_tpu_torch import datasource as tds
from sentinel_tpu_torch import transport as ttr
from sentinel_tpu_torch.cluster import coordinator as tcoord
from sentinel_tpu_torch.metrics import searcher as tsearcher
from sentinel_tpu_torch.metrics import timer as ttimer
from sentinel_tpu_torch.metrics import writer as twriter

torch.set_num_threads(2)

T0 = 1_785_000_000_000
APP = "session-app"
SIDES = {
    "jax": dict(pkg=stpu, api=japi, ad=jad, ds=jds, tr=jtr, coord=jcoord,
                timer=jtimer, searcher=jsearcher, writer=jwriter),
    "torch": dict(pkg=stt, api=tapi, ad=tad, ds=tds, tr=ttr, coord=tcoord,
                  timer=ttimer, searcher=tsearcher, writer=twriter),
}


@pytest.fixture(autouse=True)
def _hygiene(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    yield
    for side in SIDES.values():
        side["api"].reset()


def _http(port, method, name, params=None, body=None):
    url = f"http://127.0.0.1:{port}/{name}"
    if method == "GET" and params:
        url += "?" + urllib.parse.urlencode(params)
    data = urllib.parse.urlencode(params or {}).encode() \
        if method == "POST" else None
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, text = r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as exc:
        status, text = exc.code, exc.read().decode("utf-8")
    try:
        doc = json.loads(text)
    except ValueError:
        return status, text
    return status, _strip(name, doc)


def _strip(name, doc):
    if isinstance(doc, dict):
        return {k: _strip(name, v) for k, v in doc.items()
                if k not in ("port", "serverPort")}
    if isinstance(doc, list):
        return [_strip(name, v) for v in doc]
    return doc


def _rules(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    flow = [{"resource": f"svc{i}", "count": float(rng.integers(2, 6))}
            for i in range(4)]
    flow.append({"resource": "GET:/shop", "count": 3.0})
    flow.append({"resource": "deco", "count": 2.0})
    return {
        "flow": json.dumps(flow),
        "degrade": json.dumps([{"resource": "svc3", "grade": 2,
                                "count": 2, "timeWindow": 5,
                                "minRequestAmount": 1}]),
        "authority": json.dumps([{"resource": "svc0", "limitApp": "evil",
                                  "strategy": 1}]),
        "system": json.dumps([{"qps": 5000}]),
        "paramFlow": json.dumps([{"resource": "svc1", "paramIdx": 0,
                                  "count": 2}]),
    }


def _session(name: str, tmp_path) -> dict:
    s = SIDES[name]
    pkg = s["pkg"]
    clk = pkg.ManualClock(start_ms=T0)
    extra = {"device": "cpu"} if name == "torch" else {}
    base = tmp_path / name
    cfg = pkg.load_config(max_resources=128, max_origins=16,
                          max_flow_rules=32, max_degrade_rules=16,
                          max_authority_rules=16, max_param_rules=16,
                          host_fast_path=False, minute_enabled=True,
                          app_name=APP,
                          metric_log_dir=str(base / "metrics"))
    sph = s["api"].init(cfg, clock=clk, **extra)
    sph._cpu.sample = lambda: (0.5, 0.25)
    timer = s["timer"].MetricTimerListener(sph)
    searcher = s["searcher"].MetricSearcher(
        cfg.metric_dir(), s["writer"].form_metric_file_name(APP))
    registry = s["ds"].WritableDataSourceRegistry()
    flow_file = str(base / "flow.json")
    registry.register("flow", s["ds"].FileWritableDataSource(
        flow_file, s["ds"].rule_encoder("flow")))
    rt = s["tr"].start_transport(sph, host="127.0.0.1", port=0,
                                 metric_searcher=searcher,
                                 writable_registry=registry)
    coord = s["coord"].ClusterCoordinator(sph, namespace="sess-ns",
                                          n_shards=1, flows_per_shard=16,
                                          param_keys_per_shard=64,
                                          clock=clk)
    coord.bind(rt.cluster_state, rt.center)
    port = rt.port
    out = {"http": [], "verdicts": []}

    def call(method, cmd, params=None):
        out["http"].append((cmd, _http(port, method, cmd, params)))

    def entry(res, **kw):
        try:
            with s["api"].entry(res, **kw):
                return "pass"
        except pkg.BlockException as exc:
            return type(exc).__name__

    @s["ad"].sentinel_resource("deco", sentinel=sph,
                               block_handler=lambda exc: "deco-blocked")
    def deco():
        return "deco-ok"

    def shop(environ, start_response):
        start_response("200 OK", [("Content-Type", "text/plain")])
        return [b"bought"]
    wsgi = s["ad"].SentinelWSGIMiddleware(shop, sph)

    def web(path):
        seen = {}

        def start_response(status, headers):
            seen["status"] = status
        body = b"".join(wsgi({"REQUEST_METHOD": "GET", "PATH_INFO": path,
                              "wsgi.input": io.BytesIO(b"")},
                             start_response))
        return seen["status"], body.decode()

    def traffic(seed, n=48):
        rng = np.random.default_rng(seed)
        for k in range(n):
            pick = int(rng.integers(0, 7))
            if pick < 4:
                origin = ["", "good", "evil"][int(rng.integers(0, 3))]
                args = (int(rng.integers(0, 3)),)
                out["verdicts"].append(entry(f"svc{pick}", origin=origin,
                                             args=args))
            elif pick == 4:
                out["verdicts"].append(deco())
            elif pick == 5:
                out["verdicts"].append(web("/shop"))
            else:
                e = None
                try:
                    e = s["api"].entry("svc3")
                    s["api"].trace(RuntimeError("biz"))
                    out["verdicts"].append("traced")
                except pkg.BlockException as exc:
                    out["verdicts"].append(type(exc).__name__)
                finally:
                    if e is not None:
                        e.exit()
            if k % 12 == 11:
                clk.advance_ms(250)

    try:
        docs = _rules(5)
        call("GET", "version")
        call("POST", "setRules", {"type": "flow", "data": docs["flow"]})
        for rtype in ("degrade", "authority", "system"):
            call("GET", "setRules", {"type": rtype, "data": docs[rtype]})
        call("POST", "setParamFlowRules", {"data": docs["paramFlow"]})
        for rtype in ("flow", "degrade", "authority", "system"):
            call("GET", "getRules", {"type": rtype})
        call("GET", "getParamFlowRules")
        out["written"] = open(flow_file).read()
        traffic(1)
        call("GET", "clusterNode")
        call("GET", "origin", {"id": "svc0"})
        # a config centre's file datasource takes over the flow rules
        # mid-traffic
        reload_file = base / "centre-flow.json"
        reload_file.write_text(json.dumps(
            [{"resource": f"svc{i}", "count": 1.0} for i in range(4)]))
        src = s["ds"].FileRefreshableDataSource(
            str(reload_file), s["ds"].rule_converter("flow"),
            start_thread=False)
        src.get_property().add_listener(sph.load_flow_rules)
        traffic(2, 24)
        reload_file.write_text(json.dumps(
            [{"resource": f"svc{i}", "count": 6.0} for i in range(4)]
            + [{"resource": "GET:/shop", "count": 1.0}]))
        os.utime(reload_file, (os.path.getmtime(reload_file) + 5,) * 2)
        out["reloaded"] = src.refresh_now()
        src.close()
        traffic(3, 24)
        call("GET", "getRules", {"type": "flow"})
        # the embedded token server, managed over HTTP
        call("POST", "setClusterMode", {"mode": "1"})
        call("GET", "getClusterMode")
        call("POST", "cluster/server/modifyFlowRules", {
            "namespace": "sess-ns", "data": json.dumps([
                {"resource": "csvc", "count": 3.0, "clusterMode": True,
                 "clusterConfig": {"flowId": 501, "thresholdType": 1}}])})
        sph.load_flow_rules(sph.get_flow_rules() + [pkg.FlowRule(
            resource="csvc", count=100.0, cluster_mode=True,
            cluster_flow_id=501, cluster_fallback_to_local=True)])
        for k in range(10):
            out["verdicts"].append(entry("csvc"))
            if k == 5:
                clk.advance_ms(400)
        call("GET", "cluster/server/metricList", {"namespace": "sess-ns"})
        call("GET", "cluster/server/info")
        call("GET", "cluster/server/flowRules", {"namespace": "sess-ns"})
        out["cluster"] = convert.cluster_to_numpy(coord.server.engine)
        call("POST", "setClusterMode", {"mode": "-1"})
        out["verdicts"].append(entry("csvc"))
        clk.advance_ms(2000)
        out["ticked"] = timer.tick()
        call("GET", "metric", {"startTime": str(T0 - 1000),
                               "endTime": str(T0 + 60_000)})
        call("GET", "jsonTree")
        call("GET", "obs", {"spans": "8", "events": "8"})
        out["state"] = convert.engine_to_numpy(sph)
    finally:
        coord.stop()
        rt.stop()
        sph.close()
    return out


def test_operator_session_matches_reference(tmp_path):
    want = _session("jax", tmp_path)
    got = _session("torch", tmp_path)
    assert got["written"] == want["written"]
    assert got["reloaded"] is want["reloaded"] is True
    assert got["verdicts"] == want["verdicts"]
    assert got["ticked"] == want["ticked"] > 0
    assert [h[0] for h in got["http"]] == [h[0] for h in want["http"]]
    for (name, g), (_n, w) in zip(got["http"], want["http"]):
        assert g == w, name
    assert convert.leaf_diff(want["state"], got["state"]) == []
    assert convert.leaf_diff(want["cluster"], got["cluster"]) == []
    # the session did reach what it is there for
    v = got["verdicts"]
    for what in ("pass", "FlowException", "AuthorityException",
                 "ParamFlowException", "deco-blocked", "deco-ok",
                 ("200 OK", "bought")):
        assert what in v, what
    assert any(isinstance(x, tuple) and x[0].startswith("429") for x in v)
    metric = dict(got["http"])["metric"]
    assert metric[0] == 200 and "|svc0|" in metric[1]
    assert dict(got["http"])["cluster/server/metricList"][1][0][
        "passQps"] > 0
