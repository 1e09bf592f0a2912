"""Port parity: the command plane (``sentinel_tpu_torch.transport``)
against ``sentinel_tpu.transport``.

One command script runs against the JAX package's command center on a JAX
``Sentinel`` and against the port's on a ``Sentinel(device="cpu")``, twin
ManualClocks and the same numpy-seeded traffic between the commands. It
drives every command of ``register_default_handlers`` — ``setRules`` for
all five rule types, ``metric`` after the metric timer wrote minutes,
``clusterNode``/``cnode``/``origin``/``tree``/``jsonTree``,
``systemStatus``, ``obs``, ``topk``, ``control``, ``trace``,
``getSwitch``/``setSwitch``, cluster mode and client config, the
reference dashboard's aliases — and a bad request of each kind. Status
codes and bodies must be equal (JSON bodies compared parsed). The script
runs directly against the center, through the threaded server, the
asyncio server and the mounted WSGI and ASGI apps.

No field is left out: the metric timer is ticked explicitly under the
twin clocks (never by its wall-clock thread) and the system-load sample
is fixed, so the versions, timestamps and totals agree, and ``obs``
carries every counter, ``compile_cache.*`` and ``tune.*`` included.

Also here: port auto-increment, a heartbeat to a stub dashboard (the
messages byte-equal), the JAX package's own dashboard client
(``sentinel_tpu.dashboard.client.SentinelApiClient``) reading the same
rules, metrics, nodes and cluster info from the port's center as from the
JAX one, the ``metric_log`` wiring of ``start_transport`` and its
gateway and exporter wiring (the gateway commands over HTTP,
``exporterPort``). Every server binds an ephemeral port.
"""

import asyncio
import http.server
import io
import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu import control as jcontrol
from sentinel_tpu import datasource as jds
from sentinel_tpu import transport as jtr
from sentinel_tpu.core import logs as jlogs
from sentinel_tpu.metrics import searcher as jsearcher
from sentinel_tpu.metrics import timer as jtimer
from sentinel_tpu.metrics import writer as jwriter
from sentinel_tpu import gateway as jgw
from sentinel_tpu.rules import codec as jcodec
from sentinel_tpu.transport import async_http_server as jasync
from sentinel_tpu_torch import control as tcontrol
from sentinel_tpu_torch import convert
from sentinel_tpu_torch import gateway as tgw
from sentinel_tpu_torch import datasource as tds
from sentinel_tpu_torch import transport as ttr
from sentinel_tpu_torch.core import logs as tlogs
from sentinel_tpu_torch.metrics import searcher as tsearcher
from sentinel_tpu_torch.metrics import timer as ttimer
from sentinel_tpu_torch.metrics import writer as twriter
from sentinel_tpu_torch.rules import codec as tcodec
from sentinel_tpu_torch.transport import async_http_server as tasync

torch.set_num_threads(2)

T0 = 1_785_000_000_000
PKGS = {"jax": stpu, "torch": stt}
MODS = {
    "jax": dict(tr=jtr, ds=jds, ctl=jcontrol, logs=jlogs, timer=jtimer,
                searcher=jsearcher, writer=jwriter, codec=jcodec,
                aio=jasync),
    "torch": dict(tr=ttr, ds=tds, ctl=tcontrol, logs=tlogs, timer=ttimer,
                  searcher=tsearcher, writer=twriter, codec=tcodec,
                  aio=tasync),
}
APP = "twin-app"
BASE_CFG = dict(max_resources=64, max_origins=32, max_flow_rules=32,
                max_degrade_rules=16, max_authority_rules=16,
                max_param_rules=16, host_fast_path=False,
                minute_enabled=True, app_name=APP)
FORM = "application/x-www-form-urlencoded"
#: counter families the comparison leaves out (see the module docstring)


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


class Agent:
    """One package's agent: a runtime under a ManualClock, its metric
    timer (ticked by hand) and searcher, a writable flow datasource, a
    control loop, and the command center with the default handlers."""

    def __init__(self, name: str, tmp_path, **cfg):
        self.name = name
        self.pkg = pkg = PKGS[name]
        self.mods = m = MODS[name]
        self.dir = tmp_path / name
        self.clock = pkg.ManualClock(start_ms=T0)
        config = pkg.load_config(**{**BASE_CFG, **cfg},
                                 metric_log_dir=str(self.dir / "metrics"))
        extra = {"device": "cpu"} if pkg is stt else {}
        self.sph = sph = pkg.Sentinel(config=config, clock=self.clock,
                                      **extra)
        sph._cpu.sample = lambda: (0.5, 0.25)
        sph.block_log.close()
        sph.block_log = m["logs"].BlockStatLogger(
            self.clock, base_dir=str(self.dir / "blocklog"))
        self.timer = m["timer"].MetricTimerListener(sph)
        self.searcher = m["searcher"].MetricSearcher(
            config.metric_dir(), m["writer"].form_metric_file_name(APP))
        self.registry = m["ds"].WritableDataSourceRegistry()
        self.flow_file = str(self.dir / "flow-rules.json")
        self.registry.register("flow", m["ds"].FileWritableDataSource(
            self.flow_file, m["ds"].rule_encoder("flow")))
        self.control = m["ctl"].ControlLoop(sph)
        self.center = m["tr"].CommandCenter()
        self.cstate = m["tr"].register_default_handlers(
            self.center, sph, metric_searcher=self.searcher,
            writable_registry=self.registry)

    def close(self) -> None:
        self.sph.close()


# ------------------------------------------------------------ transports

def _split(path: str):
    parsed = urllib.parse.urlparse(path)
    return parsed.path, parsed.query


class Direct:
    """The center itself, with the servers' request parsing."""

    def __init__(self, agent):
        self.center = agent.center

    def __call__(self, method, path, body=b"", ctype=FORM):
        name, query = _split(path)
        params = {k: v[-1] for k, v in urllib.parse.parse_qs(query).items()}
        if body and ctype == FORM:
            try:
                text = body.decode("utf-8")
            except UnicodeDecodeError:
                return 400, "invalid request body"
            for k, v in urllib.parse.parse_qs(text).items():
                params[k] = v[-1]
        name = name.strip("/")
        if not name:
            return 400, "Command name cannot be empty"
        mod = MODS["torch"]["tr"] if isinstance(
            self.center, ttr.CommandCenter) else MODS["jax"]["tr"]
        resp = self.center.handle(name, mod.CommandRequest(
            parameters=params, body=body))
        return (200 if resp.success else resp.code), resp.result

    def close(self):
        pass


class Http:
    """A real server on an ephemeral loopback port, driven by urllib."""

    def __init__(self, agent, kind: str):
        tr = agent.mods["tr"]
        cls = (tr.SimpleHttpCommandCenter if kind == "threaded"
               else agent.mods["aio"].AsyncHttpCommandCenter)
        self.srv = cls(agent.center, host="127.0.0.1", port=0)
        self.port = self.srv.start()

    def __call__(self, method, path, body=b"", ctype=FORM):
        url = f"http://127.0.0.1:{self.port}{path}"
        req = urllib.request.Request(
            url, data=body if method == "POST" else None, method=method,
            headers={"Content-Type": ctype} if method == "POST" else {})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read().decode("utf-8")
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read().decode("utf-8")

    def close(self):
        self.srv.stop()


class Wsgi:
    def __init__(self, agent):
        self.app = agent.mods["tr"].command_wsgi_app(agent.center,
                                                     prefix="/sentinel")

    def __call__(self, method, path, body=b"", ctype=FORM):
        name, query = _split(path)
        seen = {}

        def start_response(status, headers):
            seen["status"] = int(status.split()[0])
            seen["headers"] = dict(headers)
        out = b"".join(self.app({
            "PATH_INFO": "/sentinel" + name, "QUERY_STRING": query,
            "REQUEST_METHOD": method, "CONTENT_LENGTH": str(len(body)),
            "CONTENT_TYPE": ctype if method == "POST" else "",
            "wsgi.input": io.BytesIO(body)}, start_response))
        assert int(seen["headers"]["Content-Length"]) == len(out)
        return seen["status"], out.decode("utf-8")

    def close(self):
        pass


class Asgi:
    def __init__(self, agent):
        self.app = agent.mods["tr"].command_asgi_app(agent.center,
                                                     prefix="/sentinel")

    def __call__(self, method, path, body=b"", ctype=FORM):
        name, query = _split(path)
        sent = []
        chunks = [body[:3], body[3:]] if body else [b""]

        async def receive():
            chunk = chunks.pop(0)
            return {"type": "http.request", "body": chunk,
                    "more_body": bool(chunks)}

        async def send(msg):
            sent.append(msg)
        headers = [(b"content-type", ctype.encode())] \
            if method == "POST" else []
        asyncio.run(asyncio.wait_for(self.app(
            {"type": "http", "method": method, "path": "/sentinel" + name,
             "query_string": query.encode("latin-1"), "headers": headers},
            receive, send), 60))
        return (sent[0]["status"],
                b"".join(m.get("body", b"") for m in sent[1:])
                .decode("utf-8"))

    def close(self):
        pass


TRANSPORTS = {
    "direct": Direct,
    "threaded": lambda a: Http(a, "threaded"),
    "async": lambda a: Http(a, "async"),
    "wsgi": Wsgi,
    "asgi": Asgi,
}


# -------------------------------------------------------------- the script

def _q(name: str, **params) -> str:
    return "/" + name + ("?" + urllib.parse.urlencode(params)
                         if params else "")


def _form(**params) -> bytes:
    return urllib.parse.urlencode(params).encode("utf-8")


def _rule_docs() -> dict:
    """Rules of every type as the dashboard's JSON."""
    return {
        "flow": json.dumps([
            {"resource": "api", "count": 4, "grade": 1},
            {"resource": "api", "count": 2, "limitApp": "app-a"},
            {"resource": "slow", "count": 5, "controlBehavior": 2,
             "maxQueueingTimeMs": 400},
            {"resource": "thr", "count": 2, "grade": 0}]),
        "degrade": json.dumps([
            {"resource": "flaky", "grade": 2, "count": 3, "timeWindow": 5,
             "minRequestAmount": 1}]),
        "system": json.dumps([{"qps": 1000}]),
        "authority": json.dumps([
            {"resource": "guarded", "limitApp": "app-bad", "strategy": 1}]),
        "paramFlow": json.dumps([
            {"resource": "hot", "paramIdx": 0, "count": 2,
             "paramFlowItemList": [{"object": "7", "count": 5,
                                    "classType": "int"}]}]),
    }


def _traffic(pkg, sph, clk, seed: int) -> list:
    """Application traffic between commands: outcomes of ``entry()``
    calls over every ruled resource (with origins, arguments, business
    errors and an entry batch), the clock stepping 100 ms every 8 calls."""
    rng = np.random.default_rng(seed)
    names = ["api", "slow", "thr", "flaky", "guarded", "hot", "free"]
    origins = ["", "app-a", "app-b", "app-bad"]
    out = []
    for k in range(64):
        res = names[int(rng.integers(0, len(names)))]
        origin = origins[int(rng.integers(0, len(origins)))]
        args = (int(rng.choice([7, 8, 9])),) if res == "hot" else ()
        try:
            e = sph.entry(res, origin=origin, args=args, sleep=False)
            if res == "flaky" and rng.random() < 0.7:
                e.trace(RuntimeError("boom"))
            e.exit()
            out.append(("pass", e.wait_ms))
        except pkg.BlockException as exc:
            out.append(type(exc).__name__)
        if k % 8 == 7:
            clk.advance_ms(100)
    v = sph.entry_batch(["api", "free", "hot"] * 4,
                        origins=["app-b", "", "app-a"] * 4)
    out.append((np.asarray(v.allow).tolist(),
                np.asarray(v.reason).tolist()))
    return out


def _script(agent, call) -> list:
    """The command script → [(label, status, body) | traffic outcomes]."""
    pkg, sph, clk = agent.pkg, agent.sph, agent.clock
    out = []

    def cmd(label, method, path, body=b"", ctype=FORM):
        status, text = call(method, path, body, ctype)
        out.append((label, status, text))

    docs = _rule_docs()
    cmd("version", "GET", _q("version"))
    cmd("api", "GET", _q("api"))
    cmd("basicInfo", "GET", _q("basicInfo"))
    for rtype in docs:
        cmd("getRules", "GET", _q("getRules", type=rtype))
    # the five rule types, each pushed its own way: a form POST, a query
    # parameter, a raw body, the param-rule aliases
    cmd("setRules", "POST", _q("setRules"),
        _form(type="flow", data=docs["flow"]))
    cmd("setRules", "GET", _q("setRules", type="degrade",
                              data=docs["degrade"]))
    cmd("setRules", "POST", _q("setRules", type="system"),
        docs["system"].encode(), "application/json")
    cmd("setRules", "POST", _q("setRules"),
        _form(type="authority", data=docs["authority"]))
    cmd("setParamFlowRules", "POST", _q("setParamFlowRules"),
        _form(data=docs["paramFlow"]))
    for rtype in docs:
        cmd("getRules", "GET", _q("getRules", type=rtype))
    cmd("getParamFlowRules", "GET", _q("getParamFlowRules"))
    out.append(("written", open(agent.flow_file).read()))

    out.append(_traffic(pkg, sph, clk, 11))
    cmd("clusterNode", "GET", _q("clusterNode"))
    cmd("clusterNodeById", "GET", _q("clusterNodeById", id="api"))
    cmd("cnode", "GET", _q("cnode", id="hot"))
    cmd("origin", "GET", _q("origin", id="api"))
    cmd("tree", "GET", _q("tree"))
    cmd("jsonTree", "GET", _q("jsonTree"))
    cmd("systemStatus", "GET", _q("systemStatus"))
    clk.advance_ms(1500)
    out.append(_traffic(pkg, sph, clk, 12))
    clk.advance_ms(2000)
    out.append(("ticked", agent.timer.tick()))
    cmd("metric", "GET", _q("metric", startTime=T0 - 1000,
                            endTime=T0 + 60_000))
    cmd("metric", "GET", _q("metric", startTime=T0, endTime="x"))
    cmd("metric", "GET", _q("metric", startTime=T0 + 1000,
                            identity="api"))
    cmd("metric", "GET", _q("metric", startTime="bad"))
    cmd("obs", "GET", _q("obs"))
    cmd("obs", "GET", _q("obs", spans=4, events=2))
    cmd("obs", "GET", _q("obs", trace=1))
    cmd("topk", "GET", _q("topk", tick=1))
    cmd("topk", "GET", _q("topk", timeline=5))
    cmd("control", "GET", _q("control", tick=1))
    cmd("control", "GET", _q("control", actions=4))
    cmd("trace", "GET", _q("trace"))
    cmd("trace", "GET", _q("trace", id=1))
    # the global switch: off → everything passes
    cmd("getSwitch", "GET", _q("getSwitch"))
    cmd("setSwitch", "GET", _q("setSwitch", value="false"))
    out.append(_traffic(pkg, sph, clk, 13))
    cmd("getSwitch", "GET", _q("getSwitch"))
    cmd("setSwitch", "POST", _q("setSwitch"), _form(value="TRUE"))
    out.append(_traffic(pkg, sph, clk, 14))
    # cluster mode and the token client's config
    cmd("getClusterMode", "GET", _q("getClusterMode"))
    cmd("setClusterMode", "GET", _q("setClusterMode", mode=0))
    cmd("getClusterMode", "GET", _q("getClusterMode"))
    cmd("setClusterMode", "POST", _q("setClusterMode"), _form(mode=-1))
    cmd("getClusterClientConfig", "GET", _q("getClusterClientConfig"))
    cmd("setClusterClientConfig", "POST", _q("setClusterClientConfig"),
        _form(data=json.dumps({"serverHost": "10.0.0.9",
                               "serverPort": 18730})))
    cmd("cluster/client/modifyConfig", "POST",
        _q("cluster/client/modifyConfig"),
        json.dumps({"serverHost": "10.0.0.7", "serverPort": "18731",
                    "requestTimeout": 40}).encode(), "application/json")
    cmd("cluster/client/fetchConfig", "GET",
        _q("cluster/client/fetchConfig"))
    cmd("getClusterClientConfig", "GET", _q("getClusterClientConfig"))
    # a bad request of each kind
    cmd("unknown", "GET", _q("nope"))
    cmd("empty", "GET", "/")
    cmd("getRules", "GET", _q("getRules", type="nope"))
    cmd("getRules", "GET", _q("getRules"))
    cmd("setRules", "POST", _q("setRules"), _form(type="nope", data="[]"))
    cmd("setRules", "POST", _q("setRules"),
        _form(type="flow", data="{not json"))
    cmd("setRules", "POST", _q("setRules"),
        _form(type="flow", data='[{"count": 1}]'))
    cmd("setRules", "POST", _q("setRules", type="degrade"),
        b"\xff\xfe", "application/json")
    cmd("setParamFlowRules", "POST", _q("setParamFlowRules"),
        _form(data="[1, 2]"))
    cmd("setSwitch", "GET", _q("setSwitch", value="maybe"))
    cmd("setSwitch", "GET", _q("setSwitch"))
    cmd("origin", "GET", _q("origin"))
    cmd("obs", "GET", _q("obs", spans="x"))
    cmd("obs", "GET", _q("obs", trace="x"))
    cmd("topk", "GET", _q("topk", timeline="x"))
    cmd("control", "GET", _q("control", actions="x"))
    cmd("trace", "GET", _q("trace", id="x"))
    cmd("setClusterMode", "GET", _q("setClusterMode", mode="x"))
    cmd("setClusterMode", "GET", _q("setClusterMode", mode=5))
    cmd("setClusterClientConfig", "POST", _q("setClusterClientConfig"),
        _form(data="{}"))
    cmd("setClusterClientConfig", "POST", _q("setClusterClientConfig"),
        _form(data="not json"))
    cmd("setClusterClientConfig", "POST", _q("setClusterClientConfig"),
        b"\xff\xfe", "application/octet-stream")
    cmd("badForm", "POST", _q("setRules"), b"\xff\xfe\xfd")
    out.append(("rules", [tcodec.rules_to_json("flow", sph.get_flow_rules())
                          if pkg is stt else
                          jcodec.rules_to_json("flow", sph.get_flow_rules())]))
    return out


def normalize(label: str, body: str):
    """A body as compared: JSON parsed, with the fields named in the
    module docstring left out; anything else verbatim."""
    try:
        doc = json.loads(body)
    except ValueError:
        return body
    return doc


def compare(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple) and len(w) == 3 and isinstance(w[1], int):
            assert g[:2] == w[:2], (w[0], g[1], w[1], g[2][:300],
                                    w[2][:300])
            assert normalize(g[0], g[2]) == normalize(w[0], w[2]), w[0]
        else:
            assert g == w


def run_twins(tmp_path, transport: str, script=_script, **cfg):
    """``script(agent, call)`` on both packages' agents → (port agent,
    its results); results must agree, and so must the engine states."""
    got, agents = {}, {}
    for name in PKGS:
        agent = Agent(name, tmp_path, **cfg)
        call = TRANSPORTS[transport](agent)
        try:
            got[name] = script(agent, call)
        finally:
            call.close()
        agents[name] = agent
    compare(got["torch"], got["jax"])
    assert convert.leaf_diff(convert.engine_to_numpy(agents["jax"].sph),
                             convert.engine_to_numpy(agents["torch"].sph)) \
        == []
    agents["jax"].close()
    return agents["torch"], got["torch"]


@pytest.mark.parametrize("transport", list(TRANSPORTS))
def test_command_script_twins(tmp_path, transport):
    agent, out = run_twins(tmp_path, transport)
    try:
        by = {}
        for item in out:
            if isinstance(item, tuple) and len(item) == 3:
                by.setdefault(item[0], []).append(item[1:])
        # the script did reach what it is there for
        assert all(s == 200 for s, _ in by["setRules"][:4])
        assert [s for s, _ in by["unknown"]] == [404]
        assert by["empty"][0][0] == 400
        metric = by["metric"][0][1]
        assert "|api|" in metric and metric.count("\n") >= 4
        nodes = json.loads(by["clusterNode"][0][1])
        assert {n["resource"] for n in nodes} >= {"api", "hot", "free"}
        assert json.loads(by["control"][0][1])
        assert by["badForm"][0][0] == 400
        statuses = {s for item in by.values() for s, _ in item}
        assert {200, 400, 404} <= statuses
    finally:
        agent.close()


def test_script_saw_blocks_of_every_rule_type(tmp_path):
    agent, out = run_twins(tmp_path, "direct")
    try:
        seen = set()
        for item in out:
            if isinstance(item, list):
                seen |= {o for o in item if isinstance(o, str)}
        assert {"FlowException", "DegradeException", "AuthorityException",
                "ParamFlowException"} <= seen
    finally:
        agent.close()


# ---------------------------------------------------- servers and heartbeat

@pytest.mark.parametrize("kind", ["threaded", "async"])
def test_port_auto_increment(tmp_path, kind):
    """A taken port moves the server up by one, up to
    ``MAX_PORT_ATTEMPTS`` (as in the reference), in both packages."""
    assert ttr.http_server.MAX_PORT_ATTEMPTS == \
        jtr.http_server.MAX_PORT_ATTEMPTS == 3
    agent = Agent("torch", tmp_path)
    mods = agent.mods
    cls = (mods["tr"].SimpleHttpCommandCenter if kind == "threaded"
           else mods["aio"].AsyncHttpCommandCenter)
    first = cls(agent.center, host="127.0.0.1", port=0)
    p0 = first.start()
    second = cls(agent.center, host="127.0.0.1", port=p0)
    try:
        try:
            p1 = second.start()
        except OSError:
            pytest.fail("no free port within the auto-increment window")
        assert p1 in (p0 + 1, p0 + 2)
        with urllib.request.urlopen(f"http://127.0.0.1:{p1}/version",
                                    timeout=10) as r:
            assert r.read() == b"0.1.0"
    finally:
        second.stop()
        first.stop()
        agent.close()


def test_start_transport_advertises_the_bound_port(tmp_path):
    """The second of two agents asking for one port binds the next and
    advertises it in its heartbeat and ``basicInfo``, in both packages."""
    got = {}
    for name in PKGS:
        agent = Agent(name, tmp_path)
        tr = agent.mods["tr"]
        rt1 = tr.start_transport(agent.sph, host="127.0.0.1", port=0,
                                 metric_log=False)
        rt2 = tr.start_transport(agent.sph, host="127.0.0.1",
                                 port=rt1.port, metric_log=False,
                                 dashboard_addr="127.0.0.1:1",
                                 heartbeat_interval_ms=60_000)
        try:
            info = json.loads(rt2.center.handle(
                "basicInfo", tr.CommandRequest()).result)
            got[name] = (rt2.port - rt1.port,
                         rt2.heartbeat.message()["port"] == str(rt2.port),
                         info["apiPort"] == rt2.port,
                         sorted(rt2.center.names()))
        finally:
            rt2.stop()
            rt1.stop()
            agent.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == (1, True, True)


class _StubDashboard(http.server.BaseHTTPRequestHandler):
    """Records every heartbeat POST body (``/registry/machine``)."""

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", "0"))
        self.server.beats.append((self.path, self.rfile.read(n)))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


def test_heartbeat_to_stub_dashboard(tmp_path):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _StubDashboard)
    srv.beats = []
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    addr = f"127.0.0.1:{srv.server_address[1]}"
    sent = {}
    try:
        for name in PKGS:
            clk = PKGS[name].ManualClock(start_ms=T0)
            hb = MODS[name]["tr"].HeartbeatSender(
                addr, app_name=APP, app_type=1, api_port=18999,
                interval_ms=60_000, clock=clk)
            assert hb.send_once(timeout=10)
            clk.advance_ms(10_000)
            assert hb.send_once(timeout=10)
            sent[name] = srv.beats[-2:]
            assert hb.sent_count == 2 and hb.last_ok
            # the thread's first beat, then a clean stop
            hb.start()
            hb.stop()
    finally:
        srv.shutdown()
        srv.server_close()
    assert sent["torch"] == sent["jax"]
    path, body = sent["torch"][1]
    msg = dict(urllib.parse.parse_qsl(body.decode()))
    assert path == "/registry/machine"
    assert msg["app"] == APP and msg["port"] == "18999"
    assert msg["version"] == str(T0 + 10_000) and msg["v"] == stt.__version__
    # nothing listening: False, no raise
    dead = ttr.HeartbeatSender("127.0.0.1:1", app_name=APP)
    assert not dead.send_once(timeout=0.5)


# ----------------------------------------------------- a real dashboard

def _dashboard_reads(tmp_path, name: str) -> dict:
    """What the JAX package's dashboard client reads from one package's
    agent over HTTP, with a token server bound through the coordinator."""
    from sentinel_tpu.dashboard.client import SentinelApiClient
    coord_mod = {"jax": "sentinel_tpu.cluster.coordinator",
                 "torch": "sentinel_tpu_torch.cluster.coordinator"}[name]
    import importlib
    coord = importlib.import_module(coord_mod)
    agent = Agent(name, tmp_path)
    pkg, sph, clk = agent.pkg, agent.sph, agent.clock
    co = coord.ClusterCoordinator(sph, namespace="dash-ns", n_shards=1,
                                  flows_per_shard=8,
                                  param_keys_per_shard=64, clock=clk)
    co.bind(agent.cstate, agent.center)
    http_ = Http(agent, "threaded")
    client = SentinelApiClient(timeout_s=30)
    ip, port = "127.0.0.1", http_.port
    out = {}
    try:
        out["version"] = client.version(ip, port)
        for rtype, doc in _rule_docs().items():
            assert client.set_rules(ip, port, rtype, json.loads(doc))
        for rtype in _rule_docs():
            out[f"rules.{rtype}"] = client.fetch_rules(ip, port, rtype)
        out["traffic"] = _traffic(pkg, sph, clk, 21)
        out["nodes"] = client.fetch_cluster_nodes(ip, port)
        out["tree"] = client.fetch_json_tree(ip, port)
        out["origins"] = client.fetch_origin_stats(ip, port, "api")
        out["system"] = client.fetch_system_status(ip, port)
        clk.advance_ms(3000)
        agent.timer.tick()
        out["metrics"] = [(n.timestamp, n.resource, n.pass_qps,
                           n.block_qps, n.success_qps, n.exception_qps,
                           n.rt) for n in client.fetch_metrics(
                               ip, port, T0 - 1000, T0 + 60_000)]
        assert client.set_cluster_mode(ip, port, 1)
        mode = client.get_cluster_mode(ip, port)
        out["mode"] = {k: v for k, v in mode.items() if k != "serverPort"}
        assert client.set_cluster_server_namespace_set(ip, port,
                                                       ["dash-ns"])
        assert client.set_cluster_server_flow_config(ip, port, "dash-ns",
                                                     500.0)
        info = client.fetch_cluster_server_info(ip, port)
        out["server_info"] = {k: v for k, v in info.items()
                              if k != "port" and k != "serverPort"}
        conf = client.fetch_cluster_server_config(ip, port)
        conf.pop("transport", None)
        out["server_config"] = conf
        out["server_ns_config"] = client.fetch_cluster_server_config(
            ip, port, "dash-ns")
        out["server_metrics"] = client.fetch_cluster_server_metrics(
            ip, port, "dash-ns")
        assert client.set_cluster_client_config(ip, port, "10.1.1.1",
                                                18730, 30)
        assert client.set_cluster_mode(ip, port, -1)
        out["mode_after"] = client.get_cluster_mode(ip, port)
        out["obs_keys"] = sorted(client.fetch_obs(ip, port))
        out["topk"] = client.fetch_topk(ip, port, tick=True)
        out["trace"] = client.fetch_trace(ip, port)
    finally:
        http_.close()
        co.stop()
        agent.close()
    return out


def test_reference_dashboard_client_reads_the_same(tmp_path):
    want = _dashboard_reads(tmp_path, "jax")
    got = _dashboard_reads(tmp_path, "torch")
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert want["metrics"] and want["nodes"] and want["rules.flow"]
    assert want["mode"]["mode"] == 1 and want["mode"]["effectiveMode"] == 1


# ----------------------------------------------------------------- wiring

def test_start_transport_metric_log_wiring(tmp_path):
    """``metric_log=True`` starts the metric timer and the cadence
    scheduler and configures the block-event, flight and telemetry logs
    under the metric directory, in both packages; ``stop`` stops them."""
    got = {}
    for name in PKGS:
        agent = Agent(name, tmp_path)
        rt = agent.mods["tr"].start_transport(agent.sph, host="127.0.0.1",
                                              port=0)
        try:
            got[name] = (type(rt.metric_timer).__name__,
                         type(rt.cadence).__name__ if rt.cadence else None,
                         rt.heartbeat is None,
                         type(rt.http).__name__,
                         sorted(rt.center.names()))
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{rt.port}/metric", timeout=30) as r:
                assert r.status == 200
        finally:
            rt.stop()
            agent.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "MetricTimerListener"


def test_unported_paths_raise_naming_the_roadmap(tmp_path):
    """Once the raising paths, now the gateway and exporter wiring of
    ``start_transport`` in both packages: the four ``gateway/*`` commands
    over HTTP (bodies equal byte for byte), ``exporterPort`` in
    ``basicInfo`` and the heartbeat, ``register_default_handlers`` with
    an API manager alone; and no ``NotImplementedError`` naming A12 is
    left in the port's transport."""
    import os
    got = {}
    rules = json.dumps([
        {"resource": "route-a", "count": 2.0,
         "paramItem": {"parseStrategy": 0}},
        {"resource": "route-a", "count": 5.0, "intervalSec": 2}])
    apis = json.dumps([{"apiName": "g", "predicateItems": [
        {"pattern": "/g/**", "matchStrategy": 1}]}])
    for name in PKGS:
        agent = Agent(name, tmp_path)
        gw = jgw if name == "jax" else tgw
        tr = agent.mods["tr"]
        mgr = gw.GatewayRuleManager(agent.sph)
        api_mgr = gw.GatewayApiDefinitionManager()
        rt = tr.start_transport(agent.sph, host="127.0.0.1", port=0,
                                metric_log=False, gateway_manager=mgr,
                                api_definition_manager=api_mgr,
                                exporter_port=9464,
                                dashboard_addr="127.0.0.1:1",
                                heartbeat_interval_ms=60_000)
        try:
            out = []
            for cmd, data in (("gateway/updateRules", rules),
                              ("gateway/getRules", None),
                              ("gateway/updateApiDefinitions", apis),
                              ("gateway/getApiDefinitions", None),
                              ("gateway/updateRules", "{bad")):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{rt.port}/{cmd}",
                    data=(urllib.parse.urlencode({"data": data}).encode()
                          if data else None),
                    method="POST" if data else "GET")
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        out.append((cmd, r.status, r.read()))
                except urllib.error.HTTPError as exc:
                    out.append((cmd, exc.code, exc.read()[:40]))
            info = json.loads(rt.center.handle(
                "basicInfo", tr.CommandRequest()).result)
            out += [info["exporterPort"],
                    rt.heartbeat.message()["exporterPort"],
                    sorted(rt.center.names()),
                    [str(r) for r in agent.sph.get_param_flow_rules()]]
            center = tr.CommandCenter()
            tr.register_default_handlers(center, agent.sph,
                                         api_definition_manager=api_mgr)
            out.append(sorted(n for n in center.names() if "gateway" in n))
            got[name] = out
        finally:
            rt.stop()
            agent.close()
    assert got["torch"] == got["jax"]
    body = json.loads(got["torch"][1][2])
    assert got["torch"][1][1] == 200 and [r["count"] for r in body] \
        == [2.0, 5.0] and body[0]["paramItem"]["parseStrategy"] == 0
    assert got["torch"][4][1] == 400
    assert got["torch"][5:7] == [9464, "9464"]
    assert got["torch"][-1] == ["gateway/getApiDefinitions",
                                "gateway/updateApiDefinitions"]
    for mod in (ttr.bootstrap, ttr.handlers):
        with open(mod.__file__) as fh:
            assert "NotImplementedError" not in fh.read(), mod.__name__


def test_start_transport_without_a_card_raises():
    """The bootstrap uses the runtime it is given; the facade's default
    one is on ``cuda`` and never falls back to the CPU."""
    if torch.cuda.is_available():
        assert stt.Sentinel(stt.load_config(max_resources=32)) \
            .device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.start_transport(stt.Sentinel(), host="127.0.0.1", port=0)
