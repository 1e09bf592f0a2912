"""Port parity: the aiohttp adapters (``sentinel_tpu_torch.adapters.
aiohttp_server.sentinel_middleware`` and ``adapters.http_client.
SentinelAiohttpSession``) against ``sentinel_tpu``'s.

Twins of the 3 tests of ``tests/test_aiohttp_adapter.py``: each scenario
runs on both packages (twin ManualClocks, the port's runtime on the CPU)
over a real aiohttp server on a real event loop. Statuses, bodies,
verdicts and node totals must agree, and so must the engine state. The
upstream server of the client cases binds an ephemeral port, which is
part of the resource names: it is replaced by ``<upstream>`` before the
comparison. Every event loop runs under ``asyncio.wait_for``.
"""

import asyncio
import importlib
import types

import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu_torch import convert

aiohttp = pytest.importorskip("aiohttp")
from aiohttp import web  # noqa: E402
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

torch.set_num_threads(2)

T0 = 1_700_000_000_000
LOOP_S = 60
PKGS = {"jax": stpu, "torch": stt}


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


def twin(scenario):
    """``scenario(x)`` on both packages (``x.pkg``, ``x.sph``, ``x.server``
    the aiohttp middleware module, ``x.client`` the HTTP-client module) →
    the port's observations, equal to the reference's."""
    got, engines = {}, {}
    for name, pkg in PKGS.items():
        cfg = pkg.load_config(max_resources=64, max_flow_rules=16,
                              max_degrade_rules=16, max_authority_rules=16)
        extra = {"device": "cpu"} if pkg is stt else {}
        sph = pkg.Sentinel(config=cfg, clock=pkg.ManualClock(start_ms=T0),
                           **extra)
        x = types.SimpleNamespace(
            pkg=pkg, sph=sph,
            server=importlib.import_module(
                f"{pkg.__name__}.adapters.aiohttp_server"),
            client=importlib.import_module(
                f"{pkg.__name__}.adapters.http_client"))
        got[name] = scenario(x)
        engines[name] = sph
    assert got["torch"] == got["jax"]
    assert convert.leaf_diff(convert.engine_to_numpy(engines["jax"]),
                             convert.engine_to_numpy(engines["torch"])) == []
    for sph in engines.values():
        sph.close()
    return got["torch"]


def _totals(sph, rename=None):
    out = {}
    for name, _row, t in sph.all_node_totals():
        t = dict(t)
        t.pop("avg_rt", None)
        out[rename(name) if rename else name] = t
    return out


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, LOOP_S))


def test_server_middleware_limits_and_traces():
    def scenario(x):
        x.sph.load_flow_rules([x.pkg.FlowRule(resource="GET:/api", count=2)])

        async def api(request):
            return web.json_response({"ok": True})

        async def boom(request):
            raise web.HTTPInternalServerError(text="boom")

        async def run():
            app = web.Application(
                middlewares=[x.server.sentinel_middleware(x.sph)])
            app.router.add_get("/api", api)
            app.router.add_get("/boom", boom)
            async with TestClient(TestServer(app)) as client:
                out = []
                for _ in range(5):
                    r = await client.get("/api")
                    out.append((r.status, await r.text()))
                r = await client.get("/boom")
                out.append((r.status, await r.text()))
            return out

        out = _run(run())
        assert [s for s, _ in out] == [200, 200, 429, 429, 429, 500]
        assert "Blocked by Sentinel" in out[2][1]
        totals = _totals(x.sph)
        assert totals["GET:/api"]["pass"] == 2
        assert totals["GET:/api"]["block"] == 3
        assert totals["GET:/boom"]["exception"] == 1
        assert totals["GET:/boom"]["threads"] == 0
        return [out, totals]
    twin(scenario)


def test_client_session_guards_outbound():
    def scenario(x):
        async def upstream(request):
            if request.path == "/flaky":
                return web.Response(status=503)
            return web.Response(text="hi")

        async def run():
            app = web.Application()
            app.router.add_get("/ok", upstream)
            app.router.add_get("/flaky", upstream)
            server = TestServer(app)
            await server.start_server()
            host = f"{server.host}:{server.port}"
            resource = f"httpclient:GET:{host}/ok"
            x.sph.load_flow_rules([x.pkg.FlowRule(resource=resource,
                                                  count=2)])
            session = x.client.SentinelAiohttpSession(x.sph)
            out = []
            try:
                for _ in range(5):
                    try:
                        r = await session.get(f"http://{host}/ok")
                        out.append((r.status, await r.text()))
                    except x.pkg.BlockException as exc:
                        out.append(type(exc).__name__)
                r = await session.get(f"http://{host}/flaky")
                out.append(r.status)
            finally:
                await session.close()
                await server.close()
            return host, out

        host, out = _run(run())
        assert out == [(200, "hi"), (200, "hi"), "FlowException",
                       "FlowException", "FlowException", 503]
        totals = _totals(x.sph, lambda n: n.replace(host, "<upstream>"))
        assert totals["httpclient:GET:<upstream>/ok"]["pass"] == 2
        assert totals["httpclient:GET:<upstream>/ok"]["block"] == 3
        assert totals["httpclient:GET:<upstream>/flaky"]["exception"] == 1
        assert all(t["threads"] == 0 for t in totals.values())
        return [out, totals]
    twin(scenario)


def test_entry_exits_at_headers_time():
    """The guarded session's entry exits when response headers arrive,
    not when the body is released (the reference's pinned divergence
    from WebFlux, kept by the port)."""
    def scenario(x):
        async def run():
            gate = asyncio.Event()

            async def slow(request):
                resp = web.StreamResponse()
                await resp.prepare(request)
                await resp.write(b"head")
                await gate.wait()
                await resp.write(b"tail")
                await resp.write_eof()
                return resp

            app = web.Application()
            app.router.add_get("/slow", slow)
            server = TestServer(app)
            await server.start_server()
            host = f"{server.host}:{server.port}"
            resource = f"httpclient:GET:{host}/slow"
            x.sph.load_flow_rules([x.pkg.FlowRule(
                resource=resource, count=1, grade=x.pkg.GRADE_THREAD)])
            session = x.client.SentinelAiohttpSession(x.sph)
            try:
                r1 = await session.get(f"http://{host}/slow")
                live = _totals(x.sph)[resource]["threads"]
                r2 = await session.get(f"http://{host}/slow")
                gate.set()
                bodies = [await r1.read(), await r2.read()]
                out = [r1.status, live, r2.status, bodies]
            finally:
                await session.close()
                await server.close()
            return host, out

        host, out = _run(run())
        assert out == [200, 0, 200, [b"headtail", b"headtail"]]
        totals = _totals(x.sph, lambda n: n.replace(host, "<upstream>"))
        assert totals["httpclient:GET:<upstream>/slow"]["pass"] == 2
        assert totals["httpclient:GET:<upstream>/slow"]["block"] == 0
        return [out, totals]
    twin(scenario)
