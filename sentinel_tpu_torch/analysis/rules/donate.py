"""DONATE001 — a staging slot rewritten while a dispatch may still read it.

The reference's rule has two halves, one contract — *a buffer handed to
the device is not yours until the dispatch settles*:

* **Donated operands** (``jax.jit(..., donate_argnums=...)``): torch
  donates no buffers — an eager op never frees or aliases its inputs —
  so this half has no counterpart in the port. A call through a name
  the reference would have seen as donating is an ordinary call here.
* **Staging slots.** ``runtime._StagingRing.acquire()`` hands out
  preallocated pinned host buffers that the step copies to the card
  with ``non_blocking=True``: the copy reads the slot *asynchronously*,
  after the dispatching call has returned. Rewriting a slot
  (``pad_into(slot[...], ...)``, a subscript store, ``slot.copy_(...)``
  / ``.fill_()`` / ``.zero_()``) after it was passed into a dispatch
  or a non-blocking copy but before ``release(slot)`` / a settle is the
  staging-ring bug: the in-flight copy reads the next batch's bytes.

Detection is flow-sensitive per function over a straight-line
approximation (statements ordered by source line, branches treated as
sequential), as in the reference:

1. A slot from ``<ring/staging>.acquire()`` becomes in-flight when it
   (or a view of it: ``v = pad_into(slot[...], ...)``) is passed to a
   dispatch-named callable (``*step*``, ``*decide*``, ``*dispatch*``),
   or is the source of a non-blocking copy: ``<slot>.to(...,
   non_blocking=True)``, ``<slot>.cuda(non_blocking=True)``,
   ``dst.copy_(<slot>, non_blocking=True)``.
2. Any later write into the slot before ``release(slot)`` flags.

Any settle-like call — ``.settle()`` / ``.result()`` / ``.join()`` /
``.wait()`` / ``.synchronize()`` (``Event`` and ``Stream``) /
``torch.cuda.synchronize()`` — conservatively clears all tracked state:
after a settle the device has consumed the slot, so the rule never flags
past one. Cross-function settles (the caller settles the returned
handle) therefore never false-positive: the rule only flags *writes*,
never a missing settle.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from sentinel_tpu_torch.analysis.core import Finding, ModuleContext, Rule
from sentinel_tpu_torch.analysis.rules import _shared

_SETTLE_METHODS = frozenset({
    "settle", "result", "join", "wait", "synchronize",
})
_SETTLE_CALLS = frozenset({"torch.cuda.synchronize"})
#: Callee-name fragments that mark a call as a device dispatch.
_DISPATCH_FRAGMENTS = ("step", "decide", "dispatch")
#: Tensor methods that start an asynchronous read of their receiver
#: (``to`` / ``cuda``) or of their first argument (``copy_``) when
#: called with ``non_blocking=True``.
_ASYNC_COPY_METHODS = frozenset({"to", "cuda", "copy_"})
#: Writers that fill a buffer in place.
_FILL_CALLS = frozenset({"pad_into", "copyto", "numpy.copyto"})
#: Tensor methods that write their receiver in place.
_INPLACE_METHODS = frozenset({"copy_", "fill_", "zero_"})
_RINGISH = ("ring", "staging", "slab")


class UseAfterDispatchRule(Rule):
    id = "DONATE001"
    name = "use-after-dispatch-of-staged-buffer"
    rationale = (
        "an acquired staging slot belongs to the in-flight dispatch or "
        "non-blocking copy until settle/release; rewriting it early is "
        "the staging-ring bug (the copy reads the next batch's bytes)")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _shared.iter_functions(ctx.tree):
            yield from _FunctionScan(self, ctx).run(fn)


class _FunctionScan:
    """One function's straight-line scan. Tracks staged slots, slot
    views, and in-flight slots."""

    def __init__(self, rule: UseAfterDispatchRule, ctx: ModuleContext):
        self.rule = rule
        self.ctx = ctx
        self.staged: Set[str] = set()
        self.views: Dict[str, str] = {}                 # view -> slot
        self.inflight: Dict[str, Tuple[str, int]] = {}  # slot -> (callee, line)

    def run(self, fn: ast.AST) -> Iterator[Finding]:
        stmts = sorted(
            (n for n in _shared.walk_without_nested_functions(fn)
             if isinstance(n, ast.stmt)),
            key=lambda n: (n.lineno, n.col_offset))
        for stmt in stmts:
            yield from self._scan_stmt(stmt)

    @staticmethod
    def _own_nodes(stmt: ast.stmt) -> Iterator[ast.AST]:
        """The nodes this statement itself evaluates. Compound statements
        contribute only their header expressions — their body statements
        are scanned individually."""
        if isinstance(stmt, (ast.If, ast.While)):
            roots: List[ast.AST] = [stmt.test]
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            roots = [stmt.target, stmt.iter]
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            roots = [i.context_expr for i in stmt.items]
            roots += [i.optional_vars for i in stmt.items
                      if i.optional_vars is not None]
        elif isinstance(stmt, (ast.Try, ast.ClassDef) + _shared.FUNC_NODES):
            roots = []
        else:
            roots = [stmt]
        for r in roots:
            yield from ast.walk(r)

    # ------------------------------------------------------------------
    def _scan_stmt(self, stmt: ast.stmt) -> Iterator[Finding]:
        # 1. flag rewrites of in-flight slots (before this statement's
        #    own calls are processed)
        yield from self._flag_writes(stmt)
        # 2. rebinds kill stale tracking BEFORE this statement's calls
        #    are processed — ``slot = ring.acquire()`` must end with the
        #    fresh staging, not have it killed by its own rebind
        for name in self._rebound_names(stmt):
            if name in self.views:
                del self.views[name]
            if name in self.staged:
                self.staged.discard(name)
                self.inflight.pop(name, None)
        # 3. process calls in this statement: settles, releases,
        #    dispatches and copies, acquires, view bindings
        for node in self._own_nodes(stmt):
            if isinstance(node, ast.Call):
                self._process_call(node, stmt)

    def _flag_writes(self, stmt: ast.stmt) -> Iterator[Finding]:
        for node in self._own_nodes(stmt):
            slot = self._written_slot(node)
            if slot is not None and slot in self.inflight:
                callee, line = self.inflight[slot]
                yield self.rule.finding(
                    self.ctx, node,
                    "staging slot '%s' is rewritten here while the "
                    "dispatch or non-blocking copy through '%s' (line %d) "
                    "may still read it — release the slot on settlement "
                    "first (the staging-ring bug)" % (slot, callee, line))
                del self.inflight[slot]

    # ------------------------------------------------------------------
    def _process_call(self, call: ast.Call, stmt: ast.stmt) -> None:
        name = self.ctx.call_name(call)
        attr = call.func.attr if isinstance(call.func, ast.Attribute) \
            else None
        # settle: conservatively clears everything
        if attr in _SETTLE_METHODS or name in _SETTLE_CALLS:
            self.inflight.clear()
            return
        # release(slot)
        if attr == "release" or (isinstance(call.func, ast.Name)
                                 and call.func.id == "release"):
            for arg in call.args:
                key = _ref_key(arg)
                if key is not None:
                    self.inflight.pop(key, None)
                    self.staged.discard(key)
            return
        # slot = ring.acquire()
        if attr == "acquire" and self._ringish_receiver(call.func.value):
            target = _assign_target(stmt, call)
            if target is not None:
                self.staged.add(target)
                self.inflight.pop(target, None)
            return
        # view = pad_into(slot[...], ...)
        if name is not None and name.rsplit(".", 1)[-1] in _FILL_CALLS:
            slot = self._slot_of_args(call.args[:1])
            if slot is not None:
                target = _assign_target(stmt, call)
                if target is not None:
                    self.views[target] = slot
            return
        # <slot>.to(..., non_blocking=True) / dst.copy_(<slot>, ...)
        if attr in _ASYNC_COPY_METHODS and any(
                kw.arg == "non_blocking" and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is False)
                for kw in call.keywords):
            source = (call.args[:1] if attr == "copy_"
                      else [call.func.value])
            slot = self._slot_of_args(source)
            if slot is not None:
                self.inflight.setdefault(slot, (attr, call.lineno))
            return
        # dispatch
        bare = (attr or (call.func.id if isinstance(call.func, ast.Name)
                         else None))
        if self._dispatchish(bare):
            slot = self._slot_of_args(call.args) or \
                self._slot_of_args(kw.value for kw in call.keywords)
            if slot is not None:
                self.inflight.setdefault(slot, (bare or "<call>",
                                                call.lineno))

    # ------------------------------------------------------------------
    def _ringish_receiver(self, recv: ast.AST) -> bool:
        dotted = self.ctx.dotted(recv)
        if dotted is None:
            return False
        low = dotted.lower()
        return any(tok in low for tok in _RINGISH)

    def _dispatchish(self, bare: Optional[str]) -> bool:
        if bare is None:
            return False
        low = bare.lower()
        return any(tok in low for tok in _DISPATCH_FRAGMENTS)

    def _slot_of_args(self, args) -> Optional[str]:
        """First staged slot referenced by these argument expressions
        (directly, via subscript, or via a recorded view name)."""
        for arg in args:
            for node in ast.walk(arg):
                if isinstance(node, ast.Name):
                    if node.id in self.staged:
                        return node.id
                    if node.id in self.views:
                        return self.views[node.id]
        return None

    def _written_slot(self, node: ast.AST) -> Optional[str]:
        """slot for ``slot[...] = x`` / ``slot["c"][...] = x`` stores,
        in-place fill calls (``pad_into(slot[...], ...)``) and in-place
        tensor writes (``slot["c"].copy_(x)`` / ``.fill_`` / ``.zero_``)."""
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript):
                    base = t
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    if isinstance(base, ast.Name) and base.id in self.staged:
                        return base.id
        elif isinstance(node, ast.Call):
            name = self.ctx.call_name(node)
            if name is not None and \
                    name.rsplit(".", 1)[-1] in _FILL_CALLS and node.args:
                return self._slot_of_args(node.args[:1])
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _INPLACE_METHODS:
                return self._slot_of_args([node.func.value])
        return None

    def _rebound_names(self, stmt: ast.stmt) -> Set[str]:
        out: Set[str] = set()
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Delete):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            targets = [stmt.target]
        for t in targets:
            key = _ref_key(t)
            if key is not None:
                out.add(key)
            for n in ast.walk(t):
                k = _ref_key(n)
                if k is not None:
                    out.add(k)
        return out


def _ref_key(node: ast.AST) -> Optional[str]:
    """Canonical tracking key: bare Name → ``x``; ``self.attr`` →
    ``self.attr``. Other expressions don't track."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return "self." + node.attr
    return None


def _assign_target(stmt: ast.stmt, call: ast.Call) -> Optional[str]:
    """Name the statement binds the call's result to, if any."""
    if isinstance(stmt, ast.Assign) and stmt.value is call and \
            len(stmt.targets) == 1:
        return _ref_key(stmt.targets[0])
    return None
