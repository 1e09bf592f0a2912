"""LOCK001 — module-level mutable state shared across async + threaded
contexts without a lock.

The runtime spans three execution domains — daemon threads (metric
writers, reconnect loops, the device-step thread), asyncio loops
(transport/cluster/dashboard servers), and plain sync callers. A
module-level dict/list/set mutated from BOTH an ``async def`` (loop
thread) and a plain ``def`` (any thread) is a data race unless every
mutation site holds a lock: CPython dict/list ops are atomic only
individually, and check-then-act sequences interleave.

Only *container mutations* count (subscript/attr assignment, augmented
assignment, mutating method calls, ``global``-rebind); reads don't flag.
A mutation site under any enclosing ``with <lock>`` is protected. The
rule fires only when the same name is mutated in both domains and at
least one site is unprotected — each unprotected site gets a finding.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from sentinel_tpu_torch.analysis.core import Finding, ModuleContext, Rule
from sentinel_tpu_torch.analysis.rules import _shared

_MUTATING_METHODS = frozenset({
    "append", "extend", "insert", "add", "update", "setdefault", "pop",
    "popitem", "remove", "discard", "clear", "appendleft", "popleft",
})

_MUTABLE_FACTORIES = frozenset({
    "dict", "list", "set", "collections.defaultdict", "defaultdict",
    "collections.OrderedDict", "OrderedDict", "collections.deque", "deque",
})


class SharedStateRule(Rule):
    id = "LOCK001"
    name = "unlocked-cross-context-module-state"
    rationale = (
        "module-level containers mutated from both coroutines and "
        "threads interleave check-then-act sequences; every mutation "
        "site needs the same lock (or the state needs to move into one "
        "owner)")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        shared = _module_level_mutables(ctx)
        if not shared:
            return
        # (name) -> list of (site_node, is_async_ctx, protected)
        sites: Dict[str, List[Tuple[ast.AST, bool, bool]]] = {}
        collector = _SiteCollector(ctx, shared, sites)
        collector.run(ctx.tree)
        for name, lst in sites.items():
            domains = {is_async for (_, is_async, _) in lst}
            if len(domains) < 2:
                continue
            for node, is_async, protected in lst:
                if not protected:
                    yield self.finding(
                        ctx, node,
                        "module-level '%s' mutated here (%s context) and "
                        "also from %s context; this site holds no lock"
                        % (name,
                           "async" if is_async else "threaded",
                           "threaded" if is_async else "async"))


def _module_level_mutables(ctx: ModuleContext) -> Set[str]:
    out: Set[str] = set()
    for stmt in ctx.tree.body:
        targets: List[ast.expr] = []
        value = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is None:
            continue
        if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                              ast.ListComp, ast.SetComp)):
            mutable = True
        elif isinstance(value, ast.Call):
            mutable = ctx.call_name(value) in _MUTABLE_FACTORIES
        else:
            mutable = False
        if mutable:
            for t in targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


class _SiteCollector(_shared.AncestorVisitor):
    """Collect mutation sites of the shared names, tagged with execution
    domain (inside async def vs sync def) and lock protection."""

    def __init__(self, ctx, shared, sites):
        self.ctx = ctx
        self.shared = shared
        self.sites = sites

    def visit(self, node, ancestors):
        name = self._mutated_name(node)
        if name is not None and name in self.shared and \
                not self._is_local(name, ancestors):
            is_async = any(isinstance(a, ast.AsyncFunctionDef)
                           for a in ancestors) or False
            in_fn = any(isinstance(a, _shared.FUNC_NODES) for a in ancestors)
            if in_fn:
                protected = _shared.enclosing_with_lock(ancestors, self.ctx)
                self.sites.setdefault(name, []).append(
                    (node, is_async, protected))
        return True

    def _mutated_name(self, node: ast.AST):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name):
                    return t.value.id
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATING_METHODS and \
                isinstance(node.func.value, ast.Name):
            return node.func.value.id
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name):
                    return t.value.id
        return None

    def _is_local(self, name: str, ancestors) -> bool:
        """Shadowed by a function parameter or a plain local assignment
        in any enclosing function → not the module global."""
        for anc in ancestors:
            if isinstance(anc, _shared.FUNC_NODES):
                args = anc.args
                all_args = (args.posonlyargs + args.args + args.kwonlyargs
                            + ([args.vararg] if args.vararg else [])
                            + ([args.kwarg] if args.kwarg else []))
                if any(a.arg == name for a in all_args):
                    return True
                declared_global = False
                for n in ast.walk(anc):
                    if isinstance(n, (ast.Global, ast.Nonlocal)) and \
                            name in n.names:
                        declared_global = True
                if declared_global:
                    return False
                for n in _shared.walk_without_nested_functions(anc):
                    if isinstance(n, ast.Assign):
                        for t in n.targets:
                            if isinstance(t, ast.Name) and t.id == name:
                                return True
        return False
