"""ASYNC001 — blocking calls in coroutines; locks held across ``await``.

The transport/cluster/dashboard servers run single-threaded event loops
fronting a device engine: one blocking call in a coroutine stalls every
connection on that loop (the cluster batcher already routes engine steps
through ``asyncio.to_thread`` for exactly this reason). Two shapes:

1. a known-blocking call (``time.sleep``, sync sockets/HTTP/subprocess)
   lexically inside an ``async def`` — nested sync ``def``s are excluded
   (they may legitimately run via ``to_thread``);
2. a synchronous ``with <lock>`` whose body contains ``await``: the
   coroutine parks holding a *thread* lock, and the next thread that
   wants it blocks the whole loop (classic async-deadlock shape).
"""

from __future__ import annotations

import ast
from typing import Iterator, List

from sentinel_tpu_torch.analysis.core import Finding, ModuleContext, Rule
from sentinel_tpu_torch.analysis.rules import _shared

BLOCKING_EXACT = frozenset({
    "time.sleep",
    "socket.create_connection", "socket.getaddrinfo", "socket.socket",
    "os.system", "os.waitpid", "os.wait",
    "select.select",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output",
    "urllib.request.urlopen",
})

BLOCKING_PREFIXES = (
    "requests.",
    "http.client.",
)

#: Codebase-tuned: the engine/token-client decision surfaces are blocking
#: host→device round-trips (or socket RPCs) — and on a multi-process mesh
#: a *collective*. Coroutines must route them through asyncio.to_thread
#: the way cluster/server.py's batcher does (await to_thread(engine.f, ...)
#: passes the method as a value, which this rule correctly ignores).
BLOCKING_SUFFIXES = (
    ".request_tokens", ".request_param_tokens",
    ".request_tokens_batch", ".request_param_tokens_batch",
    ".request_token", ".request_param_token",
)

_ASYNC_ALTERNATIVE = {
    "time.sleep": "await asyncio.sleep(...)",
}


class AsyncBlockingRule(Rule):
    id = "ASYNC001"
    name = "blocking-call-in-coroutine"
    rationale = (
        "one blocking call in a coroutine stalls every connection on "
        "the event loop; route through asyncio primitives or "
        "asyncio.to_thread")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _shared.iter_functions(ctx.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            yield from self._scan_coroutine(ctx, fn)

    def _scan_coroutine(self, ctx: ModuleContext, fn) -> Iterator[Finding]:
        for node in _shared.walk_without_nested_functions(fn):
            if isinstance(node, ast.Call):
                name = ctx.call_name(node)
                if _shared.name_matches(name, exact=BLOCKING_EXACT,
                                        prefixes=BLOCKING_PREFIXES,
                                        suffixes=BLOCKING_SUFFIXES):
                    alt = _ASYNC_ALTERNATIVE.get(name, "asyncio.to_thread")
                    yield self.finding(
                        ctx, node,
                        "blocking '%s' inside coroutine '%s' stalls the "
                        "event loop; use %s" % (name, fn.name, alt))
            elif isinstance(node, ast.With):
                if any(_shared.is_lockish(i.context_expr, ctx)
                       for i in node.items) and _holds_await(node):
                    yield self.finding(
                        ctx, node,
                        "thread lock held across 'await' in coroutine "
                        "'%s': the parked coroutine keeps the lock and "
                        "any thread contending for it blocks the loop; "
                        "narrow the critical section or use "
                        "asyncio.Lock" % fn.name)


def _holds_await(with_node: ast.With) -> bool:
    for stmt in with_node.body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
                return True
            if isinstance(node, _shared.FUNC_NODES + (ast.Lambda,)):
                break
    return False
