"""AST helpers shared by the graftlint rule families."""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from sentinel_tpu_torch.analysis.core import ModuleContext

FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def iter_import_time_nodes(tree: ast.Module) -> Iterator[ast.AST]:
    """Every AST node whose expression evaluates at *import time*: module
    body, class bodies, function decorators, and function default
    arguments — but NOT function/lambda bodies (those run at call time)."""

    def walk(node: ast.AST) -> Iterator[ast.AST]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, FUNC_NODES):
                for d in child.decorator_list:
                    yield from ast.walk(d)
                args = child.args
                for dflt in list(args.defaults) + [
                        d for d in args.kw_defaults if d is not None]:
                    yield from ast.walk(dflt)
            elif isinstance(child, ast.Lambda):
                continue
            elif isinstance(child, ast.ClassDef):
                yield child
                yield from walk(child)
            else:
                yield child
                yield from walk(child)

    yield from walk(tree)


def iter_functions(tree: ast.Module):
    """All function definitions (sync and async), at any nesting level."""
    for node in ast.walk(tree):
        if isinstance(node, FUNC_NODES):
            yield node


def walk_without_nested_functions(node: ast.AST) -> Iterator[ast.AST]:
    """Walk ``node``'s body but stop at nested function/class boundaries
    (their bodies run in a different execution context)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, FUNC_NODES + (ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(n))


def name_matches(dotted: Optional[str], exact=(), prefixes=(),
                 suffixes=()) -> bool:
    if dotted is None:
        return False
    if dotted in exact:
        return True
    if any(dotted.startswith(p) for p in prefixes):
        return True
    if any(dotted.endswith(s) for s in suffixes):
        return True
    return False


def enclosing_with_lock(ancestors: List[ast.AST],
                        ctx: ModuleContext) -> bool:
    """True when any enclosing ``with``/``async with`` in ``ancestors``
    acquires something lock-like (dotted name mentioning lock/mutex)."""
    for anc in ancestors:
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                if is_lockish(item.context_expr, ctx):
                    return True
    return False


def is_lockish(expr: ast.AST, ctx: ModuleContext) -> bool:
    """Heuristic: does this with-item expression acquire a lock?

    Catches ``self._lock``, ``self._state_lock``, ``REGISTRY_LOCK``,
    ``lock.acquire_timeout(...)``, ``threading.Lock()`` — any dotted
    chain (or call on one) whose text mentions lock/mutex/semaphore.
    """
    if isinstance(expr, ast.Call):
        expr = expr.func
    dotted = ctx.dotted(expr)
    if dotted is None:
        return False
    low = dotted.lower()
    return any(tok in low for tok in ("lock", "mutex", "semaphore"))


class AncestorVisitor:
    """Generic walk that maintains the ancestor stack. Subclass and
    override ``visit(node, ancestors)``; return False to skip children."""

    def run(self, root: ast.AST) -> None:
        self._walk(root, [])

    def _walk(self, node: ast.AST, ancestors: List[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if self.visit(child, ancestors) is not False:
                ancestors.append(child)
                self._walk(child, ancestors)
                ancestors.pop()

    def visit(self, node: ast.AST, ancestors: List[ast.AST]):
        raise NotImplementedError


def terminates_block(stmts: List[ast.stmt]) -> bool:
    """Does this statement list end by leaving the enclosing function or
    loop iteration (return/raise/continue/break)?"""
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def assigned_names(target: ast.AST) -> Iterator[str]:
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            yield n.id
