"""HTTP transport for the ingest tier: POST an entry, get a verdict.

Port of ``sentinel_tpu/frontend/server.py``. It imports ``aiohttp``,
which a machine may lack: the package, the runtime and ``chip_smoke.py``
never import this module. It exposes the decision engine itself as a
service: a sidecar / central flow-control endpoint that remote callers
consult before doing work. Handlers are thin
wrappers over :meth:`AdaptiveBatcher.submit`, so every HTTP request
rides the same deadline-driven batching as in-process callers.

Routes (``make_app``):

* ``POST /v1/entry`` — body ``{"resource": str, "count"?: int,
  "prioritized"?: bool, "origin"?: str, "deadline_ms"?: int}`` →
  ``200 {"allow", "reason", "reason_name", "wait_ms", "latency_ms"}``;
  ``429`` when blocked is NOT used — blocks are verdicts, not errors —
  but backpressure shed and shutdown map to ``503``.
* ``POST /v1/entry_batch`` — body ``{"entries": [entry, ...]}`` →
  ``200 {"verdicts": [verdict-or-{"error": ...}, ...]}`` (positional).
* ``GET /healthz`` — liveness + pending depth.
* ``GET /stats`` — frontend counters + request-latency histogram
  snapshot (the full payload stays on the dashboard/transport tier).

Usage::

    batcher = sph.frontend()
    runner = await start_server(batcher, host="0.0.0.0", port=8719)
    ...
    await runner.cleanup()
"""

from __future__ import annotations

import asyncio
from typing import Optional

from aiohttp import web

from sentinel_tpu_torch.frontend.batcher import (
    AdaptiveBatcher, FrontendClosed, IngestOverload, RequestVerdict,
)

DEFAULT_PORT = 8719


def _verdict_json(v: RequestVerdict) -> dict:
    return {
        "allow": v.allow,
        "reason": v.reason,
        "reason_name": v.reason_name,
        "wait_ms": v.wait_ms,
        "latency_ms": round(v.latency_ms, 3),
        "trace_id": v.trace_id,
    }


def _parse_entry(body: dict) -> dict:
    resource = body.get("resource")
    if not isinstance(resource, str) or not resource:
        raise web.HTTPBadRequest(text="missing or non-string 'resource'")
    kwargs = {"resource": resource}
    if "count" in body:
        kwargs["count"] = int(body["count"])
    if "prioritized" in body:
        kwargs["prioritized"] = bool(body["prioritized"])
    if "origin" in body:
        kwargs["origin"] = str(body["origin"])
    if "deadline_ms" in body:
        kwargs["deadline_ms"] = int(body["deadline_ms"])
    return kwargs


async def _submit_one(batcher: AdaptiveBatcher, kwargs: dict):
    resource = kwargs.pop("resource")
    return await batcher.submit(resource, **kwargs)


def make_app(batcher: AdaptiveBatcher) -> web.Application:
    """The ingest endpoint as an aiohttp app (mountable as a subapp)."""

    async def entry(request: web.Request) -> web.Response:
        try:
            body = await request.json()
            kwargs = _parse_entry(body if isinstance(body, dict) else {})
        except web.HTTPBadRequest:
            raise
        except Exception:
            raise web.HTTPBadRequest(text="body must be a JSON object")
        try:
            verdict = await _submit_one(batcher, kwargs)
        except (IngestOverload, FrontendClosed) as exc:
            raise web.HTTPServiceUnavailable(text=str(exc))
        return web.json_response(_verdict_json(verdict))

    async def entry_batch(request: web.Request) -> web.Response:
        try:
            body = await request.json()
            entries = body.get("entries") if isinstance(body, dict) else None
            if not isinstance(entries, list):
                raise ValueError
            parsed = [_parse_entry(e if isinstance(e, dict) else {})
                      for e in entries]
        except web.HTTPBadRequest:
            raise
        except Exception:
            raise web.HTTPBadRequest(
                text="body must be {\"entries\": [...]}")
        results = await asyncio.gather(
            *(_submit_one(batcher, k) for k in parsed),
            return_exceptions=True)
        out = []
        for r in results:
            if isinstance(r, RequestVerdict):
                out.append(_verdict_json(r))
            elif isinstance(r, (IngestOverload, FrontendClosed)):
                out.append({"error": type(r).__name__, "detail": str(r)})
            elif isinstance(r, BaseException):
                raise r
        return web.json_response({"verdicts": out})

    async def healthz(request: web.Request) -> web.Response:
        return web.json_response({"ok": not batcher._closed,
                                  "pending": batcher.pending})

    async def stats(request: web.Request) -> web.Response:
        obs = batcher._s.obs
        counters = {k: v for k, v in obs.counters.snapshot().items()
                    if k.startswith("frontend.") or k.startswith("pipeline.")}
        return web.json_response({
            "counters": counters,
            "hist_request_to_verdict": obs.hist_request.snapshot(),
            "pending": batcher.pending,
        })

    app = web.Application()
    app.add_routes([
        web.post("/v1/entry", entry),
        web.post("/v1/entry_batch", entry_batch),
        web.get("/healthz", healthz),
        web.get("/stats", stats),
    ])
    return app


async def start_server(batcher: AdaptiveBatcher, host: str = "127.0.0.1",
                       port: int = DEFAULT_PORT,
                       app: Optional[web.Application] = None):
    """Bind and serve; returns the ``AppRunner`` (``await
    runner.cleanup()`` to stop). The batcher itself stops via
    ``Sentinel.close()`` / ``batcher.close()``."""
    runner = web.AppRunner(app if app is not None else make_app(batcher))
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    return runner
