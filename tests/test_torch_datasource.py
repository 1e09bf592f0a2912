"""Port parity: the datasources (``sentinel_tpu_torch.datasource``) against
``sentinel_tpu.datasource``.

The fake servers of ``tests/test_datasource_http.py`` and
``tests/test_datasource_push.py`` serve both packages' drivers: file,
conditional-GET poll, long poll, in-process push, and the named drivers
(Consul, Nacos, Etcd, Eureka, Spring Cloud Config, Apollo, ZooKeeper with
an injected client, Redis with an injected client module). A seeded
sequence of rule documents goes through each; every refresh must report
the same change in both packages, and the same rule sequence must reach
twin runtimes (compared as the rule JSON both runtimes report, and as
their compiled rule tables at the end). ``setRules`` writes through a
registered writable source in both packages, and a file source reading
that file brings the same rules back.
"""

import base64
import hashlib
import json
import os
import sys
import threading
import time
import types
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu import datasource as jds
from sentinel_tpu import transport as jtr
from sentinel_tpu.rules import codec as jcodec
from sentinel_tpu_torch import convert
from sentinel_tpu_torch import datasource as tds
from sentinel_tpu_torch import transport as ttr
from sentinel_tpu_torch.rules import codec as tcodec

torch.set_num_threads(2)

T0 = 1_785_000_000_000
PKGS = {"jax": stpu, "torch": stt}
DS = {"jax": jds, "torch": tds}
CODEC = {"jax": jcodec, "torch": tcodec}
SLOW_POLL_MS = 60_000


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


def _docs(seed: int, n: int = 6) -> list:
    """``n`` flow-rule documents drawn from ``seed``; neighbours may repeat
    (a refresh that must then report no change)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if out and rng.random() < 0.25:
            out.append(out[-1])
            continue
        out.append(json.dumps([
            {"resource": f"r{int(rng.integers(0, 4))}-{k}",
             "count": float(rng.integers(1, 40)),
             "grade": int(rng.integers(0, 2)),
             "controlBehavior": int(rng.choice([0, 2]))}
            for k in range(int(rng.integers(1, 4)))]))
    return out


class Twins:
    """Twin runtimes whose flow rules follow one datasource each: every
    property update is logged as the rules' JSON."""

    def __init__(self):
        self.sph, self.seen = {}, {"jax": [], "torch": []}
        for name, pkg in PKGS.items():
            extra = {"device": "cpu"} if pkg is stt else {}
            self.sph[name] = pkg.Sentinel(
                pkg.load_config(max_resources=64, max_flow_rules=32,
                                max_degrade_rules=8, max_authority_rules=8,
                                host_fast_path=False),
                clock=pkg.ManualClock(start_ms=T0), **extra)

    def attach(self, name: str, ds) -> None:
        sph, codec, seen = self.sph[name], CODEC[name], self.seen[name]
        prop = ds.get_property()

        def on(rules):
            sph.load_flow_rules(rules or [])
            seen.append(codec.rules_to_json("flow", rules or []))
        prop.add_listener(on)
        if prop.get() is not None:
            on(prop.get())

    def check(self) -> None:
        assert self.seen["torch"] == self.seen["jax"]
        assert convert.leaf_diff(
            convert.to_numpy(convert.ruleset_from_numpy(
                convert.to_numpy(self.sph["jax"]._ruleset))),
            convert.to_numpy(self.sph["torch"]._ruleset)) == []
        assert tcodec.rules_to_json(
            "flow", self.sph["torch"].get_flow_rules()) == \
            jcodec.rules_to_json("flow", self.sph["jax"].get_flow_rules())

    def close(self) -> None:
        for sph in self.sph.values():
            sph.close()


def _drive(twins, sources: dict, docs: list, publish) -> list:
    """``publish(doc)`` each document, refresh both packages' sources,
    → the refresh results (equal in both packages)."""
    results = []
    for doc in docs:
        publish(doc)
        got = {name: ds.refresh_now() for name, ds in sources.items()}
        assert got["torch"] == got["jax"], doc
        results.append(got["torch"])
    twins.check()
    return results


# --------------------------------------------------------------------- file

def test_file_refreshable_twins(tmp_path):
    path = tmp_path / "flow.json"
    docs = _docs(3)
    path.write_text(docs[0])
    twins = Twins()
    sources = {name: DS[name].FileRefreshableDataSource(
        str(path), DS[name].rule_converter("flow"), start_thread=False)
        for name in PKGS}
    try:
        for name, ds in sources.items():
            twins.attach(name, ds)
        mtime = [os.path.getmtime(path)]

        def publish(doc):
            path.write_text(doc)
            mtime[0] += 5               # the file's mtime gates the reload
            os.utime(path, (mtime[0],) * 2)
        results = _drive(twins, sources, docs[1:], publish)
        assert True in results
        # unchanged file: no reload in either
        assert [ds.refresh_now() for ds in sources.values()] == [False] * 2
    finally:
        for ds in sources.values():
            ds.close()
        twins.close()


def test_missing_file_and_bad_document_alike(tmp_path):
    for name in PKGS:
        ds = DS[name].FileRefreshableDataSource(
            str(tmp_path / "absent.json"), DS[name].rule_converter("degrade"),
            start_thread=False)
        assert ds.load_config() == []
        ds.close()
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    errs = {}
    for name in PKGS:
        try:
            DS[name].FileRefreshableDataSource(
                str(bad), DS[name].rule_converter("flow"),
                start_thread=False).close()
            errs[name] = None
        except Exception as exc:
            errs[name] = type(exc).__name__
    assert errs["torch"] == errs["jax"]


def test_file_writable_and_registry_alike(tmp_path):
    for name in PKGS:
        d = DS[name]
        reg = d.WritableDataSourceRegistry()
        out = tmp_path / f"{name}.json"
        reg.register("flow", d.FileWritableDataSource(
            str(out), d.rule_encoder("flow")))
        assert reg.get("degrade") is None
        assert not reg.write_if_registered("degrade", [])
        rules = [PKGS[name].FlowRule(resource="w", count=3.0)]
        assert reg.write_if_registered("flow", rules)
        reg.clear()
        assert reg.get("flow") is None
    assert (tmp_path / "torch.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()


# ---------------------------------------------------------------- HTTP poll

class _ConfigHandler(BaseHTTPRequestHandler):
    state = None

    def do_GET(self):  # noqa: N802
        st = self.state
        st["requests"].append(self.path)
        if self.headers.get("If-None-Match") == st["etag"]:
            self.send_response(304)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        body = st["body"].encode()
        self.send_response(200)
        self.send_header("ETag", st["etag"])
        self.send_header("X-Consul-Index", st["index"])
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass


@pytest.fixture
def config_server():
    state = {"body": "[]", "etag": "v0", "index": "1", "requests": []}
    handler = type("H", (_ConfigHandler,), {"state": state})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", state
    srv.shutdown()
    srv.server_close()


def _etag_publisher(state):
    def publish(doc):
        if doc != state["body"]:
            state["body"] = doc
            state["etag"] = "v" + hashlib.md5(doc.encode()).hexdigest()[:8]
            state["index"] = str(int(state["index"]) + 1)
    return publish


@pytest.mark.parametrize("kind", ["poll", "long_poll"])
def test_http_sources_twins(config_server, kind):
    base, state = config_server
    docs = _docs(5 if kind == "poll" else 8)
    _etag_publisher(state)(docs[0])
    twins = Twins()
    sources = {}
    for name in PKGS:
        d = DS[name]
        cls = (d.HttpRefreshableDataSource if kind == "poll"
               else d.HttpLongPollDataSource)
        sources[name] = cls(f"{base}/rules", d.rule_converter("flow"),
                            start_thread=False)
        twins.attach(name, sources[name])
    try:
        results = _drive(twins, sources, docs[1:], _etag_publisher(state))
        assert True in results
        if kind == "long_poll":
            # the follow-up requests carried the blocking-query index
            waits = [p for p in state["requests"] if "wait=" in p]
            assert waits and all("index=" in p for p in waits)
    finally:
        for ds in sources.values():
            ds.close()
        twins.close()


def test_http_pull_survives_an_unreachable_server():
    for name in PKGS:
        ds = DS[name].HttpRefreshableDataSource(
            "http://127.0.0.1:1/unreachable", DS[name].rule_converter("flow"),
            start_thread=False, timeout_s=0.3)
        assert ds.refresh_now() is False
        assert ds.get_property().get() is None
        ds.close()


def test_in_process_push_twins():
    docs = _docs(9, 8)
    twins = Twins()
    sources = {name: DS[name].InProcessDataSource(
        DS[name].rule_converter("flow")) for name in PKGS}
    for name, ds in sources.items():
        twins.attach(name, ds)
    try:
        pushed = [[ds.push(doc) for ds in sources.values()] for doc in docs]
        assert all(a == b for a, b in pushed)
        twins.check()
    finally:
        twins.close()


# ------------------------------------------------------------ named drivers

class _NamedHandler(BaseHTTPRequestHandler):
    state = None

    def _reply(self, body: bytes, headers=()):
        self.send_response(200)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        st = self.state
        st["paths"].append(self.path)
        if self.path.startswith("/v1/kv/"):
            self._reply(st["body"].encode(),
                        [("X-Consul-Index", st["index"])])
        elif self.path.startswith("/nacos/v1/cs/configs"):
            self._reply(st["body"].encode())
        elif self.path.startswith("/configs/"):
            self._reply(json.dumps(
                {"configurations": {"rules": st["body"]}}).encode())
        elif self.path.startswith("/eureka/"):
            self._reply(st["body"].encode())
        else:
            self._reply(json.dumps({"propertySources": [
                {"source": {"sentinel.rules": st["body"]}}]}).encode())

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n).decode()
        if self.path.startswith("/nacos/"):
            # the listener answers at once: changed when the MD5 differs
            listening = urllib.parse.parse_qs(raw).get(
                "Listening-Configs", [""])[0]
            md5 = listening.split("\x02")[2].split("\x01")[0]
            now = hashlib.md5(self.state["body"].encode()).hexdigest()
            out = urllib.parse.quote(
                "dataId\x02group\x01" if md5 != now else "").encode()
            self._reply(out)
            return
        req = json.loads(raw)
        self.state["etcd_keys"].append(base64.b64decode(req["key"]).decode())
        self._reply(json.dumps({"kvs": [{"value": base64.b64encode(
            self.state["body"].encode()).decode()}]}).encode())

    def log_message(self, fmt, *args):
        pass


@pytest.fixture
def named_server():
    state = {"body": "[]", "index": "7", "paths": [], "etcd_keys": []}
    handler = type("N", (_NamedHandler,), {"state": state})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield "127.0.0.1", srv.server_address[1], state
    srv.shutdown()
    srv.server_close()


def _named(d, driver: str, host: str, port: int):
    conv = d.rule_converter("flow")
    addr = f"{host}:{port}"
    if driver == "consul":
        return d.ConsulDataSource(host, port, "sentinel/flow", conv,
                                  start_thread=False)
    if driver == "nacos":
        return d.NacosDataSource(addr, "flow-rules", "DEFAULT_GROUP", conv,
                                 start_thread=False, listen_timeout_ms=500)
    if driver == "etcd":
        return d.EtcdDataSource(host, port, "sentinel/rules", conv,
                                start_thread=False)
    if driver == "eureka":
        return d.EurekaDataSource(f"http://{addr}/eureka/rules", conv,
                                  start_thread=False)
    if driver == "spring":
        return d.SpringCloudConfigDataSource(addr, "app", "prod", "main",
                                             "sentinel.rules", conv,
                                             start_thread=False)
    return d.ApolloDataSource(addr, "app", "default", "ns", "rules", conv,
                              start_thread=False)


@pytest.mark.parametrize("driver", ["consul", "nacos", "etcd", "eureka",
                                    "spring", "apollo"])
def test_named_drivers_twins(named_server, driver):
    host, port, state = named_server
    docs = _docs(17)
    state["body"] = docs[0]
    twins = Twins()
    sources = {name: _named(DS[name], driver, host, port) for name in PKGS}
    for name, ds in sources.items():
        twins.attach(name, ds)

    def publish(doc):
        state["body"] = doc
        state["index"] = str(int(state["index"]) + 1)
    try:
        results = _drive(twins, sources, docs[1:], publish)
        assert True in results
        if driver == "consul":
            assert sources["torch"]._index == sources["jax"]._index \
                == state["index"]
        if driver == "etcd":
            assert set(state["etcd_keys"]) == {"sentinel/rules"}
    finally:
        for ds in sources.values():
            ds.close()
        twins.close()


class _FakeKazoo:
    """A kazoo-compatible client: DataWatch fires at once and on every
    ``set``."""

    def __init__(self):
        self._data, self._watches = {}, {}
        self.started = self.stopped = False

    def start(self):
        self.started = True

    def stop(self):
        self.stopped = True

    def DataWatch(self, path, fn):  # noqa: N802
        self._watches.setdefault(path, []).append(fn)
        fn(self._data.get(path), None)

    def set(self, path, data: bytes):
        self._data[path] = data
        for fn in self._watches.get(path, []):
            fn(data, None)


def test_zookeeper_twins():
    docs = _docs(23)
    zk = {name: _FakeKazoo() for name in PKGS}
    for c in zk.values():
        c.set("/sentinel/rules", docs[0].encode())
    twins = Twins()
    sources = {name: DS[name].ZooKeeperDataSource(
        "ignored:2181", "/sentinel/rules", DS[name].rule_converter("flow"),
        client=zk[name]) for name in PKGS}
    try:
        for name, ds in sources.items():
            assert zk[name].started
            twins.attach(name, ds)
        for doc in docs[1:]:
            for c in zk.values():
                c.set("/sentinel/rules", doc.encode())
        twins.check()
    finally:
        for ds in sources.values():
            ds.close()
        twins.close()
    assert all(c.stopped for c in zk.values())


def test_zookeeper_and_redis_gated_without_their_clients(monkeypatch):
    monkeypatch.setitem(sys.modules, "kazoo", None)
    monkeypatch.setitem(sys.modules, "kazoo.client", None)
    monkeypatch.setitem(sys.modules, "redis", None)
    for d in DS.values():
        with pytest.raises(ImportError):
            d.ZooKeeperDataSource("h:2181", "/p", d.rule_converter("flow"))
        with pytest.raises(ImportError, match="redis"):
            d.RedisDataSource("localhost", 6379, "k", "ch",
                              d.rule_converter("flow"))


def _fake_redis_module(store: dict, subscribers: list):
    """A ``redis`` module stand-in: ``get`` reads ``store``; a published
    message reaches the subscribed handlers at once."""
    class _Thread:
        def stop(self):
            pass

    class _PubSub:
        def subscribe(self, **handlers):
            subscribers.extend(handlers.values())

        def run_in_thread(self, sleep_time=0.1, daemon=True):
            return _Thread()

        def close(self):
            pass

    class Redis:
        def __init__(self, host, port, db=0, password=None):
            pass

        def get(self, key):
            v = store.get(key)
            return None if v is None else v.encode()

        def pubsub(self):
            return _PubSub()

        def close(self):
            pass
    return types.SimpleNamespace(Redis=Redis)


def test_redis_twins(monkeypatch):
    docs = _docs(31)
    store = {"rules": docs[0]}
    subscribers = []
    monkeypatch.setitem(sys.modules, "redis",
                        _fake_redis_module(store, subscribers))
    twins = Twins()
    sources = {name: DS[name].RedisDataSource(
        "localhost", 6379, "rules", "ch", DS[name].rule_converter("flow"))
        for name in PKGS}
    try:
        for name, ds in sources.items():
            twins.attach(name, ds)
        for doc in docs[1:]:
            for fn in subscribers:
                fn({"type": "message", "data": doc.encode()})
            for fn in subscribers:
                fn({"type": "subscribe", "data": 1})
        twins.check()
        assert len(twins.seen["torch"]) > 1
    finally:
        for ds in sources.values():
            ds.close()
        twins.close()


# ------------------------------------------------------------- push timing

def test_nacos_listener_pushes_within_a_second(named_server):
    """The port's Nacos driver with its listener thread: a change is seen
    well inside the (60 s) poll interval."""
    host, port, state = named_server
    state["body"] = docs0 = _docs(4)[0]
    ds = tds.NacosDataSource(f"{host}:{port}", "dataId", "group",
                             tds.rule_converter("flow"),
                             refresh_ms=SLOW_POLL_MS, listen_timeout_ms=500)
    try:
        assert tcodec.rules_to_json("flow", ds.get_property().get()) == \
            tcodec.rules_to_json("flow", tcodec.rules_from_json("flow",
                                                                docs0))
        seen = []
        ds.get_property().add_listener(seen.append)
        t0 = time.monotonic()
        state["body"] = json.dumps([{"resource": "r", "count": 9}])
        deadline = time.monotonic() + 5
        while not (seen and seen[-1][0].count == 9) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert seen and seen[-1][0].count == 9
        assert time.monotonic() - t0 < 1.5
    finally:
        ds.close()


# ---------------------------------------------- setRules → writable source

def test_set_rules_writes_through_and_a_file_source_reads_it_back(tmp_path):
    """``setRules`` persists through the registered writable source in
    both packages (the same bytes), and a ``FileRefreshableDataSource``
    on that file brings the same rules back into a fresh runtime."""
    twins = Twins()
    tr = {"jax": jtr, "torch": ttr}
    docs = _docs(41, 4)
    back = Twins()
    files = {}
    try:
        for name in PKGS:
            d = DS[name]
            reg = d.WritableDataSourceRegistry()
            files[name] = tmp_path / f"{name}-flow.json"
            reg.register("flow", d.FileWritableDataSource(
                str(files[name]), d.rule_encoder("flow")))
            center = tr[name].CommandCenter()
            tr[name].register_default_handlers(center, twins.sph[name],
                                               writable_registry=reg)
            reader = d.FileRefreshableDataSource(
                str(files[name]), d.rule_converter("flow"),
                start_thread=False)
            back.attach(name, reader)
            mtime = 0
            for doc in docs:
                resp = center.handle("setRules", tr[name].CommandRequest(
                    parameters={"type": "flow", "data": doc}))
                assert resp.success, resp.result
                mtime += 5
                os.utime(files[name], (os.path.getmtime(files[name])
                                       + mtime,) * 2)
                reader.refresh_now()
            reader.close()
            twins.seen[name] = [CODEC[name].rules_to_json(
                "flow", twins.sph[name].get_flow_rules())]
        assert files["torch"].read_bytes() == files["jax"].read_bytes()
        twins.check()
        back.check()
        assert back.seen["torch"][-1] == twins.seen["torch"][-1]
    finally:
        twins.close()
        back.close()
