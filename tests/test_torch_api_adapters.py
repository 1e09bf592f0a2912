"""Port parity: the static facade (``sentinel_tpu_torch.api``) and the web
adapters (``sentinel_tpu_torch.adapters``) against ``sentinel_tpu``'s.

Twins of ``tests/test_api_facade.py`` and ``tests/test_adapters.py``: each
scenario runs on both packages (twin ManualClocks; the port's runtime on
the CPU) through ``api.entry``/``try_entry``/``exit``/``trace*``, the
``@sentinel_resource`` decorator, the WSGI and ASGI middlewares and
``async_entry``. Verdicts, handler results, traced exceptions, node
totals and engine state must agree exactly. The outbound HTTP guards
(``guarded_urlopen`` against a loopback ``http.server``, and
``SentinelSession`` where ``requests`` is installed) and the gRPC server
and client interceptors (where ``grpc`` is installed, on a loopback grpc
server) are twinned here too: pass, block before connecting, a 5xx or a
non-OK status traced, a transport error traced and re-raised. The aiohttp
middleware and session are twinned in
``tests/test_torch_aiohttp_adapter.py``, the gateway's ASGI adapter in
``tests/test_torch_gateway.py``.
"""

import asyncio
import functools
import http.server
import importlib
import io
import socket
import threading
import types
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
from sentinel_tpu.rules import degrade as jdeg
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.rules import degrade as tdeg

torch.set_num_threads(2)

T0 = 1_785_000_000_000
SIDES = {
    "jax": types.SimpleNamespace(pkg=stpu, api=japi, ad=jad, deg=jdeg),
    "torch": types.SimpleNamespace(pkg=stt, api=tapi, ad=tad, deg=tdeg),
}


@pytest.fixture(autouse=True)
def _hygiene(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    # the port's facade builds its lazy instance on the CPU here
    monkeypatch.setattr(tapi, "Sentinel",
                        functools.partial(stt.Sentinel, device="cpu"))
    yield
    for side in SIDES.values():
        side.api.reset()
        side.api.set_exceptions_to_trace(Exception)
        side.api.set_exceptions_to_ignore()


def _cfg(pkg):
    return pkg.load_config(max_resources=64, max_flow_rules=16,
                           max_degrade_rules=16, max_authority_rules=16,
                           host_fast_path=False)


def _totals(sph, *names):
    out = {}
    for n in names:
        t = sph.node_totals(n)
        t.pop("avg_rt", None)
        out[n] = t
    return out


def twin(scenario, facade: bool = False):
    """``scenario(x)`` on both packages; ``x`` carries ``pkg``, ``api``,
    ``ad`` (adapters), ``sph`` and ``clk``. With ``facade`` the runtime is
    the facade's (``api.init``). → the port's observations."""
    got, engines = {}, {}
    for name, side in SIDES.items():
        clk = side.pkg.ManualClock(start_ms=T0)
        extra = {"device": "cpu"} if name == "torch" else {}
        if facade:
            sph = side.api.init(_cfg(side.pkg), clock=clk, **extra)
        else:
            sph = side.pkg.Sentinel(_cfg(side.pkg), clock=clk, **extra)
        x = types.SimpleNamespace(**vars(side), sph=sph, clk=clk)
        got[name] = scenario(x)
        engines[name] = sph
    assert got["torch"] == got["jax"]
    assert convert.leaf_diff(convert.to_numpy(engines["jax"]._state),
                             convert.to_numpy(engines["torch"]._state)) == []
    for sph in engines.values():
        sph.close()
    return got["torch"]


def _outcome(x, fn):
    try:
        return ("ok", fn())
    except x.pkg.BlockException as exc:
        return ("block", type(exc).__name__)
    except Exception as exc:                # noqa: BLE001 — compared
        return ("raise", type(exc).__name__, str(exc))


# ------------------------------------------------------------------ facade

def fa_entry_context_manager_and_block(x):
    x.api.instance().load_flow_rules([x.pkg.FlowRule(resource="r",
                                                     count=1)])

    def once():
        with x.api.entry("r"):
            return "in"
    return [_outcome(x, once), _outcome(x, once), _totals(x.sph, "r")]


def fa_try_entry_boolean_no_raise(x):
    x.api.instance().load_flow_rules([x.pkg.FlowRule(resource="b",
                                                     count=2)])
    out = []
    for _ in range(4):
        if x.api.try_entry("b"):
            out.append("pass")
            x.api.exit()
        else:
            out.append("block")
    return out + [_totals(x.sph, "b")]


def fa_trace_feeds_innermost_entry(x):
    e = x.api.entry("outer")
    x.api.entry("inner")
    x.api.trace(ValueError("boom"))
    x.api.exit(2)
    return [x.api.current_entry() is None, e._exited,
            _totals(x.sph, "inner", "outer")]


def fa_nested_exit_unwinds_in_order(x):
    e1 = x.api.entry("a")
    e2 = x.api.entry("b")
    out = [x.api.current_entry() is e2]
    x.api.exit()
    out.append(x.api.current_entry() is e1)
    x.api.exit()
    out.append(x.api.current_entry() is None)
    return out + [_totals(x.sph, "a", "b")]


def fa_when_terminate_hook_runs_once(x):
    fired = []
    e = x.api.entry("hooked")
    e.when_terminate(lambda entry: fired.append(entry.resource))
    e.exit()
    out = [list(fired), _outcome(x, e.exit), list(fired)]
    return out


def fa_tracer_exception_class_filters(x):
    class BizError(Exception):
        pass

    class Uninteresting(Exception):
        pass

    out = []
    x.api.set_exceptions_to_trace(BizError)
    e = x.api.entry("traced")
    x.api.trace(Uninteresting("skip"))
    out.append(x.api.current_entry().error is None)
    x.api.trace(BizError("count me"))
    out.append(type(x.api.current_entry().error).__name__)
    e.exit()
    x.api.set_exceptions_to_trace(Exception)
    x.api.set_exceptions_to_ignore(BizError)
    e = x.api.entry("traced")
    x.api.trace(BizError("ignored"))
    out.append(x.api.current_entry().error is None)
    x.api.trace_entry(ValueError("explicit entry"), e)
    out.append(type(e.error).__name__)
    e.exit()
    out.append(x.api.should_trace(KeyError("k")))
    return out + [_totals(x.sph, "traced")]


def fa_breaker_transition_observer(x):
    inst = x.api.instance()
    inst.load_degrade_rules([x.pkg.DegradeRule(
        resource="frail", grade=x.deg.GRADE_EXCEPTION_COUNT, count=2,
        time_window=10, min_request_amount=1)])
    seen = []
    inst.add_breaker_observer(lambda res, old, new: seen.append(
        (res, old, new)))
    out = [inst.check_breaker_transitions()]
    for _ in range(3):
        try:
            with x.api.entry("frail"):
                x.api.trace(RuntimeError("boom"))
        except x.pkg.BlockException:
            break
        if seen:
            break
    out += [list(seen), inst.check_breaker_transitions(), list(seen)]
    assert seen == [("frail", x.deg.STATE_CLOSED, x.deg.STATE_OPEN)]
    return out + [_totals(inst, "frail")]


def fa_random_stream_through_the_facade(x):
    """A seeded stream of ``entry``/``try_entry`` calls, nested entries,
    traced errors and ``exit(n)`` over a QPS and a breaker rule."""
    inst = x.api.instance()
    inst.load_flow_rules([x.pkg.FlowRule(resource="q", count=5)])
    inst.load_degrade_rules([x.pkg.DegradeRule(
        resource="e", grade=x.deg.GRADE_EXCEPTION_RATIO, count=0.5,
        time_window=2, min_request_amount=4)])
    rng = np.random.default_rng(99)
    out = []
    for k in range(120):
        res = ["q", "e", "free"][int(rng.integers(0, 3))]
        depth = int(rng.integers(1, 3))
        opened = 0
        for _ in range(depth):
            if x.api.try_entry(res):
                opened += 1
                if res == "e" and rng.random() < 0.6:
                    x.api.trace(RuntimeError("biz"))
            else:
                out.append(("block", res))
        x.api.exit(opened)
        out.append((res, opened, x.api.current_entry() is None))
        if k % 10 == 9:
            x.clk.advance_ms(250)
    return out + [_totals(inst, "q", "e", "free")]


FACADE = [v for k, v in list(globals().items()) if k.startswith("fa_")]


@pytest.mark.parametrize("scenario", FACADE, ids=lambda f: f.__name__[3:])
def test_facade_scenario_matches_reference(scenario):
    twin(scenario, facade=True)


def test_lazy_default_instance_and_init_idempotence():
    got = {}
    for name, side in SIDES.items():
        prev = side.pkg.set_global_clock(side.pkg.ManualClock(start_ms=T0))
        try:
            side.api.reset()
            with side.api.entry("lazy"):
                pass
            inst = side.api.instance()
            got[name] = (inst.node_totals("lazy")["pass"],
                         side.api.init() is inst,
                         side.api.instance() is inst)
            inst.close()
        finally:
            side.pkg.set_global_clock(prev)
            side.api.reset()
    assert got["torch"] == got["jax"] == (1, True, True)


def test_reset_invalidates_open_entries_alike():
    got = {}
    for name, side in SIDES.items():
        extra = {"device": "cpu"} if name == "torch" else {}
        side.api.init(_cfg(side.pkg), clock=side.pkg.ManualClock(
            start_ms=T0), **extra)
        e = side.api.entry("x")
        side.api.reset()
        side.api.init(_cfg(side.pkg), clock=side.pkg.ManualClock(
            start_ms=T0), **extra)
        got[name] = (side.api.current_entry() is None, e._exited)
        e.exit()
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------- decorator

def ad_decorator_passes_and_blocks(x):
    x.sph.load_flow_rules([x.pkg.FlowRule(resource="api", count=2)])

    @x.ad.sentinel_resource("api", sentinel=x.sph)
    def handler(v):
        return v * 2
    return [_outcome(x, lambda: handler(i)) for i in range(4)] + [
        _totals(x.sph, "api")]


def ad_decorator_block_handler(x):
    x.sph.load_flow_rules([x.pkg.FlowRule(resource="api", count=1)])

    @x.ad.sentinel_resource("api", sentinel=x.sph,
                            block_handler=lambda v, exc: f"blocked:{v}")
    def handler(v):
        return f"ok:{v}"

    @x.ad.sentinel_resource("api", sentinel=x.sph,
                            default_fallback=lambda exc: type(exc).__name__)
    def other(v):
        return v
    return [handler(1), handler(2), other(3), _totals(x.sph, "api")]


def ad_decorator_fallback_and_ignore(x):
    calls = []

    @x.ad.sentinel_resource("fb", sentinel=x.sph,
                            fallback=lambda v, exc: f"fb:{v}",
                            exceptions_to_ignore=(KeyError,))
    def handler(v):
        calls.append(v)
        if v == "key":
            raise KeyError(v)
        raise ValueError(v)
    return [_outcome(x, lambda: handler("v")),
            _outcome(x, lambda: handler("key")), calls,
            _totals(x.sph, "fb")]


def ad_decorator_exception_feeds_breaker(x):
    x.sph.load_degrade_rules([x.pkg.DegradeRule(
        resource="flaky", grade=x.pkg.GRADE_EXCEPTION_COUNT, count=2,
        time_window=10, min_request_amount=1, stat_interval_ms=1000)])

    @x.ad.sentinel_resource("flaky", sentinel=x.sph)
    def handler():
        raise ValueError("boom")
    return [_outcome(x, handler) for _ in range(5)] + [
        _totals(x.sph, "flaky")]


def ad_decorator_default_name_late_binding_and_params(x):
    x.sph.load_param_flow_rules([x.pkg.ParamFlowRule(
        resource="p", param_idx=0, count=2)])

    @x.ad.sentinel_resource(sentinel=lambda: x.sph)
    def my_func():
        return 1

    @x.ad.sentinel_resource("p", sentinel=x.sph, args_as_params=True)
    def by_user(user):
        return user

    unbound = x.ad.sentinel_resource("u")(lambda: 0)
    return [my_func(), my_func.__sentinel_resource__.split(":")[-1],
            [_outcome(x, lambda: by_user(u)) for u in (1, 1, 1, 2)],
            _outcome(x, unbound)[:2], _totals(x.sph, "p")]


# --------------------------------------------------------------------- WSGI

def _wsgi_call(app, path="/", method="GET", headers=None):
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "wsgi.input": io.BytesIO(b"")}
    environ.update(headers or {})
    seen = {}

    def start_response(status, headers_list):
        seen["status"] = status
        seen["headers"] = headers_list
    body = b"".join(app(environ, start_response))
    return seen["status"], seen["headers"], body


def ad_wsgi_pass_block_and_counters(x):
    def inner(environ, start_response):
        start_response("200 OK", [("Content-Type", "text/plain")])
        return [b"hello"]
    app = x.ad.SentinelWSGIMiddleware(inner, x.sph)
    x.sph.load_flow_rules([x.pkg.FlowRule(resource="GET:/hi", count=2)])
    out = [_wsgi_call(app, "/hi") for _ in range(3)]
    out.append(_wsgi_call(app, "/hi", method="POST"))
    return out + [_totals(x.sph, "GET:/hi", "POST:/hi")]


def ad_wsgi_url_cleaner_origin_and_blank_resource(x):
    def inner(environ, start_response):
        start_response("200 OK", [])
        return [b"ok"]
    app = x.ad.SentinelWSGIMiddleware(
        inner, x.sph,
        url_cleaner=lambda p: ("/order/{id}" if p.startswith("/order/")
                               else "" if p == "/skip" else p),
        origin_parser=lambda env: env.get("HTTP_S_USER", ""))
    x.sph.load_authority_rules([x.pkg.AuthorityRule(
        resource="GET:/order/{id}", limit_app="evil",
        strategy=x.pkg.STRATEGY_BLACK)])
    out = [_wsgi_call(app, "/order/123"),
           _wsgi_call(app, "/order/456", headers={"HTTP_S_USER": "evil"}),
           _wsgi_call(app, "/skip")]
    plain = x.ad.SentinelWSGIMiddleware(inner, x.sph,
                                        http_method_specify=False)
    out.append(_wsgi_call(plain, "/plain"))
    return out + [_totals(x.sph, "GET:/order/{id}", "/plain")]


def ad_wsgi_traces_app_exception(x):
    def inner(environ, start_response):
        raise RuntimeError("app broke")
    app = x.ad.SentinelWSGIMiddleware(inner, x.sph)
    return [_outcome(x, lambda: _wsgi_call(app, "/boom")),
            _totals(x.sph, "GET:/boom")]


# --------------------------------------------------------------------- ASGI

def _asgi_call(app, path="/", method="GET"):
    scope = {"type": "http", "method": method, "path": path, "headers": []}
    sent = []

    async def receive():
        return {"type": "http.request", "body": b""}

    async def send(msg):
        sent.append(msg)
    asyncio.run(asyncio.wait_for(app(scope, receive, send), 60))
    status = next(m["status"] for m in sent
                  if m["type"] == "http.response.start")
    body = b"".join(m.get("body", b"") for m in sent
                    if m["type"] == "http.response.body")
    return status, body


def ad_asgi_pass_block_and_pacing(x):
    async def inner(scope, receive, send):
        await send({"type": "http.response.start", "status": 200,
                    "headers": []})
        await send({"type": "http.response.body", "body": b"async-ok"})
    app = x.ad.SentinelASGIMiddleware(inner, x.sph)
    x.sph.load_flow_rules([
        x.pkg.FlowRule(resource="GET:/a", count=1),
        x.pkg.FlowRule(resource="GET:/paced", count=20,
                       control_behavior=x.pkg.BEHAVIOR_RATE_LIMITER,
                       max_queueing_time_ms=500)])
    out = [_asgi_call(app, "/a"), _asgi_call(app, "/a")]
    out += [_asgi_call(app, "/paced") for _ in range(3)]
    return out + [_totals(x.sph, "GET:/a", "GET:/paced")]


def ad_asgi_non_http_passthrough_and_app_error(x):
    seen = []

    async def inner(scope, receive, send):
        seen.append(scope["type"])
        if scope["type"] == "http":
            raise RuntimeError("handler broke")
    app = x.ad.SentinelASGIMiddleware(inner, x.sph)
    asyncio.run(app({"type": "lifespan"}, None, None))
    out = [_outcome(x, lambda: _asgi_call(app, "/err"))]
    return out + [seen, _totals(x.sph, "GET:/err")]


# ------------------------------------------------------------------ asyncio

def ad_async_entry_block_trace_and_context(x):
    from importlib import import_module
    ctx = import_module(x.pkg.__name__ + ".core.context")
    x.sph.load_flow_rules([x.pkg.FlowRule(resource="aio", count=1)])

    async def work():
        with ctx.ContextScope("entrance-a", origin="app-z"):
            async with x.ad.async_entry(x.sph, "aio") as e:
                return e.resource

    async def failing():
        ae = x.ad.async_entry(x.sph, "aio2", acquire=2)
        async with ae:
            raise ValueError(ae.context.origin)
    out = [_outcome(x, lambda: asyncio.run(work())),
           _outcome(x, lambda: asyncio.run(work())),
           _outcome(x, lambda: asyncio.run(failing()))]
    return out + [_totals(x.sph, "aio", "aio2")]


ADAPTERS = [v for k, v in list(globals().items()) if k.startswith("ad_")]


@pytest.mark.parametrize("scenario", ADAPTERS, ids=lambda f: f.__name__[3:])
def test_adapter_scenario_matches_reference(scenario):
    twin(scenario)


def test_adapters_export_what_is_ported():
    assert set(tad.__all__) == {"sentinel_resource", "SentinelWSGIMiddleware",
                                "SentinelASGIMiddleware", "async_entry",
                                "SentinelAiohttpSession", "SentinelSession",
                                "guarded_urlopen", "AsgiRequestItemParser",
                                "SentinelGatewayASGIMiddleware"}
    assert set(tad.__all__) == set(jad.__all__)
    for name in tad.__all__:
        assert getattr(tad, name).__module__.startswith("sentinel_tpu_torch.")


# ------------------------------------------------------------- HTTP client

class _Upstream(http.server.BaseHTTPRequestHandler):
    """``/ok`` answers 200 ``hi``, ``/flaky`` 503, anything else 404."""
    protocol_version = "HTTP/1.0"

    def do_GET(self):  # noqa: N802
        status, body = {"/ok": (200, b"hi"),
                        "/flaky": (503, b"down")}.get(self.path,
                                                       (404, b"none"))
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def upstream():
    """One loopback server for both packages' scenarios (the resource
    names carry its port, so both sides see the same names)."""
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Upstream)
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    t.join(30)
    assert not t.is_alive()


def _dead_port() -> int:
    """A loopback port with nothing listening."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http_outcome(x, fn):
    """``_outcome`` of an HTTP call, a response as (status, body)."""
    def call():
        resp = fn()
        status = getattr(resp, "status", None) or resp.status_code
        body = resp.read() if hasattr(resp, "read") else resp.content
        resp.close()
        return status, body.decode()
    return _outcome(x, call)


def test_guarded_urlopen_blocks_before_connecting():
    """Twin of the reference's test of that name: denied before any
    socket opens, so the caller sees BlockException, not URLError."""
    def scenario(x):
        url = "http://127.0.0.1:1/x"
        x.sph.load_flow_rules([x.pkg.FlowRule(
            resource="httpclient:GET:127.0.0.1:1/x", count=0)])
        out = _outcome(x, lambda: x.ad.guarded_urlopen(x.sph, url,
                                                        timeout=0.2))
        assert out == ("block", "FlowException")
        return [out, _totals(x.sph, "httpclient:GET:127.0.0.1:1/x")]
    assert twin(scenario)[1]["httpclient:GET:127.0.0.1:1/x"]["block"] == 1


def test_guarded_urlopen_pass_block_5xx_and_exception(upstream):
    dead = _dead_port()

    def scenario(x):
        ok = f"httpclient:GET:{upstream}/ok"
        x.sph.load_flow_rules([x.pkg.FlowRule(resource=ok, count=2)])
        out = [_http_outcome(x, lambda: x.ad.guarded_urlopen(
            x.sph, f"http://{upstream}/ok", timeout=30)) for _ in range(3)]
        # a 5xx raises HTTPError from urlopen: traced, then re-raised
        out.append(_outcome(x, lambda: x.ad.guarded_urlopen(
            x.sph, f"http://{upstream}/flaky", timeout=30)))
        out.append(_outcome(x, lambda: x.ad.guarded_urlopen(
            x.sph, f"http://127.0.0.1:{dead}/gone", timeout=5))[:2])
        req = urllib.request.Request(f"http://{upstream}/ok", method="GET")
        out.append(_http_outcome(x, lambda: x.ad.guarded_urlopen(
            x.sph, req, timeout=30,
            resource_extractor=lambda m, u: f"custom:{m}")))
        return out + [_totals(x.sph, ok, f"httpclient:GET:{upstream}/flaky",
                              f"httpclient:GET:127.0.0.1:{dead}/gone",
                              "custom:GET")]
    out = twin(scenario)
    assert [o[0] for o in out[:6]] == ["ok", "ok", "block", "raise",
                                       "raise", "ok"]
    assert out[6][f"httpclient:GET:{upstream}/flaky"]["exception"] == 1


def test_sentinel_session_pass_block_5xx_and_exception(upstream):
    pytest.importorskip("requests")
    dead = _dead_port()

    def scenario(x):
        ok = f"httpclient:GET:{upstream}/ok"
        flaky = f"httpclient:GET:{upstream}/flaky"
        x.sph.load_flow_rules([x.pkg.FlowRule(resource=ok, count=2)])
        session = x.ad.SentinelSession(x.sph)
        try:
            out = [_http_outcome(x, lambda: session.get(
                f"http://{upstream}/ok", timeout=30)) for _ in range(3)]
            # a 5xx is returned to the caller and traced
            out.append(_http_outcome(x, lambda: session.get(
                f"http://{upstream}/flaky", timeout=30)))
            out.append(_outcome(x, lambda: session.get(
                f"http://127.0.0.1:{dead}/gone", timeout=5))[:2])
        finally:
            session.close()
        named = x.ad.SentinelSession(
            x.sph, resource_extractor=lambda m, u: f"custom:{m}")
        try:
            out.append(_http_outcome(x, lambda: named.get(
                f"http://{upstream}/ok", timeout=30)))
        finally:
            named.close()
        return out + [_totals(x.sph, ok, flaky,
                              f"httpclient:GET:127.0.0.1:{dead}/gone",
                              "custom:GET")]
    out = twin(scenario)
    assert [o[0] for o in out[:6]] == ["ok", "ok", "block", "ok", "raise",
                                       "ok"]
    assert out[3][1][0] == 503
    assert out[6][f"httpclient:GET:{upstream}/flaky"]["exception"] == 1


# -------------------------------------------------------------------- gRPC

def _grpc_server(grpc, interceptors, methods):
    from concurrent import futures
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2),
                         interceptors=interceptors)
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "test.Echo", {name: grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=lambda b: b,
            response_serializer=lambda b: b)
            for name, fn in methods.items()}),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, port


def _grpc_outcome(x, grpc, fn):
    try:
        return ("ok", fn())
    except x.pkg.BlockException as exc:
        return ("block", type(exc).__name__)
    except grpc.RpcError as exc:
        return ("rpc", str(exc.code()), exc.details())


def test_grpc_server_interceptor_blocks():
    """Twin of the reference's test of that name, plus a handler that
    raises (traced, exited) and the caller's origin from metadata."""
    grpc = pytest.importorskip("grpc")

    def scenario(x):
        gi = importlib.import_module(x.pkg.__name__
                                     + ".adapters.grpc_interceptor")
        method = "/test.Echo/Say"
        x.sph.load_flow_rules([x.pkg.FlowRule(resource=method, count=2)])
        x.sph.load_authority_rules([x.pkg.AuthorityRule(
            resource="/test.Echo/Who", limit_app="evil",
            strategy=x.pkg.STRATEGY_BLACK)])

        def boom(request, context):
            raise RuntimeError("handler broke")
        server, port = _grpc_server(
            grpc, [gi.SentinelServerInterceptor(x.sph)],
            {"Say": lambda req, ctx: req + b"!", "Boom": boom,
             "Who": lambda req, ctx: b"you"})
        out = []
        try:
            with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                def stub(name):
                    return ch.unary_unary(f"/test.Echo/{name}",
                                          request_serializer=lambda b: b,
                                          response_deserializer=lambda b: b)
                for req in (b"hi", b"yo", b"third"):
                    out.append(_grpc_outcome(x, grpc,
                                             lambda: stub("Say")(req)))
                out.append(_grpc_outcome(x, grpc,
                                         lambda: stub("Boom")(b"x"))[:2])
                for origin in ("good", "evil"):
                    out.append(_grpc_outcome(x, grpc, lambda: stub("Who")(
                        b"?", metadata=(("sentinel-origin", origin),))))
        finally:
            server.stop(None).wait(30)
        return out + [_totals(x.sph, method, "/test.Echo/Boom",
                              "/test.Echo/Who")]
    out = twin(scenario)
    assert out[2] == ("rpc", "StatusCode.RESOURCE_EXHAUSTED",
                      "Blocked by Sentinel (flow limiting)")
    assert out[-1]["/test.Echo/Say"]["pass"] == 2
    assert out[-1]["/test.Echo/Say"]["block"] == 1
    assert out[-1]["/test.Echo/Boom"]["exception"] == 1
    assert out[5][0] == "rpc"


def test_grpc_client_interceptor_guards_outbound():
    grpc = pytest.importorskip("grpc")

    def scenario(x):
        gi = importlib.import_module(x.pkg.__name__
                                     + ".adapters.grpc_interceptor")

        def fail(request, context):
            context.abort(grpc.StatusCode.INTERNAL, "nope")
        server, port = _grpc_server(
            grpc, [], {"Say": lambda req, ctx: req + b"!", "Fail": fail})
        x.sph.load_flow_rules([x.pkg.FlowRule(resource="/test.Echo/Say",
                                              count=2)])
        out = []
        try:
            with grpc.insecure_channel(f"127.0.0.1:{port}") as raw:
                ch = grpc.intercept_channel(
                    raw, gi.SentinelClientInterceptor(x.sph))

                def stub(name):
                    return ch.unary_unary(f"/test.Echo/{name}",
                                          request_serializer=lambda b: b,
                                          response_deserializer=lambda b: b)
                for req in (b"a", b"b", b"c"):
                    out.append(_grpc_outcome(x, grpc,
                                             lambda: stub("Say")(req)))
                out.append(_grpc_outcome(x, grpc, lambda: stub("Fail")(b"")))
        finally:
            server.stop(None).wait(30)
        return out + [_totals(x.sph, "/test.Echo/Say", "/test.Echo/Fail")]
    out = twin(scenario)
    # a blocked outbound call surfaces as the adapter's RpcError
    assert out[2] == ("rpc", "StatusCode.RESOURCE_EXHAUSTED",
                      "Blocked by Sentinel (flow limiting)")
    assert out[3] == ("rpc", "StatusCode.INTERNAL", "nope")
    assert out[-1]["/test.Echo/Fail"]["exception"] == 1
