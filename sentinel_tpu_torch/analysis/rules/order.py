"""ORDER001 — free/evict must not precede its pending-intent record.

The tiering demote TOCTOU: the tiering ticker freed a registry row
(``evict_name``) *before* recording the demote intent
(``_pending_demote[row] = name`` + shadow-map deletion). A racing
re-intern of the same name in that window classified hot against the
stale shadow entry, and the next drain invalidated the row without
queuing its promotion — silently zeroing a resident key. The shipped
fix is an ordering contract: **inside one locked region, intent lands
before the row is freed.**

This rule checks that contract mechanically over a configurable pair
table: for every call to a free/evict/invalidate primitive inside a
locked region (a lockish ``with`` block, or the whole body of a
``*_locked`` / documented-lock-contract method), any *later* mutation
of the paired pending-intent structure in the same region flags the
free call — the intent should have been recorded first. Intent
mutations are subscript stores, ``setdefault``, and (for shadow-map
style intents) ``del`` / ``pop``.

Aliases are tracked per function: ``evict = getattr(reg, "evict_name",
None)`` (the registry's optional-method idiom) makes later ``evict(...)``
calls count as ``evict_name`` calls.

Known limitations: ordering is by source line within the region —
branch-aware paths (intent in the ``if``, free in the ``else``) are
treated as sequential, which can over-flag mutually exclusive arms;
suppress with the branch argument when that happens. Frees and intent
records split across *different* locked regions of the same method are
not paired (each region is checked independently).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

from sentinel_tpu_torch.analysis.core import Finding, ModuleContext, Rule
from sentinel_tpu_torch.analysis.rules import _shared

#: free/evict primitive → pending-intent structures whose mutation must
#: precede it in the same locked region. Extend here when a new
#: free-with-intent protocol ships.
DEFAULT_PAIRS: Dict[str, Tuple[str, ...]] = {
    "evict_name": ("_pending_demote", "_shadow"),
    "invalidate_resource_rows": ("_pending_demote", "_shadow"),
    "release": ("_pending_demote", "_shadow"),
    "free_row": ("_pending_demote", "_shadow"),
}

_INTENT_METHODS = frozenset({"setdefault", "pop", "update"})


class IntentBeforeFreeRule(Rule):
    id = "ORDER001"
    name = "free-before-pending-intent"
    rationale = (
        "freeing/evicting a row before recording its pending-intent "
        "opens the demote TOCTOU: a racing re-intern classifies against "
        "stale state; record intent first, then free")

    def __init__(self, pairs: Optional[Dict[str, Tuple[str, ...]]] = None):
        self.pairs = dict(DEFAULT_PAIRS if pairs is None else pairs)

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _shared.iter_functions(ctx.tree):
            aliases = _free_aliases(fn, self.pairs)
            for region in _locked_regions(ctx, fn):
                yield from self._check_region(ctx, region, aliases)

    # ------------------------------------------------------------------
    def _check_region(self, ctx: ModuleContext, region: List[ast.stmt],
                      aliases: Dict[str, str]) -> Iterator[Finding]:
        frees: List[Tuple[int, ast.Call, str]] = []
        intents: List[Tuple[int, str]] = []
        for stmt in region:
            for node in _shared.walk_without_nested_functions(stmt):
                free = _free_call_name(node, aliases, self.pairs)
                if free is not None:
                    frees.append((node.lineno, node, free))
                intent = _intent_mutation(node)
                if intent is not None:
                    intents.append((node.lineno, intent))
            # the region statements themselves can BE the mutation
            intent = _intent_mutation(stmt)
            if intent is not None:
                intents.append((stmt.lineno, intent))
        for line, call, free in frees:
            paired = self.pairs[free]
            late = sorted({i for l, i in intents
                           if l > line and i in paired})
            if late:
                yield self.finding(
                    ctx, call,
                    "'%s' frees state before the paired pending-intent "
                    "(%s mutated at a later line in the same locked "
                    "region) — record intent BEFORE freeing, or a "
                    "racing re-intern classifies against stale state" % (
                        free, ", ".join("'%s'" % i for i in late)))


# ----------------------------------------------------------------------

def _free_aliases(fn: ast.AST, pairs: Dict[str, Tuple[str, ...]]
                  ) -> Dict[str, str]:
    """local alias → free primitive: ``evict = getattr(reg,
    "evict_name", None)`` or ``evict = reg.evict_name``."""
    out: Dict[str, str] = {}
    for node in _shared.walk_without_nested_functions(fn):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        value = node.value
        target = node.targets[0].id
        if isinstance(value, ast.Attribute) and value.attr in pairs:
            out[target] = value.attr
        elif isinstance(value, ast.Call) and \
                isinstance(value.func, ast.Name) and \
                value.func.id == "getattr" and len(value.args) >= 2 and \
                isinstance(value.args[1], ast.Constant) and \
                value.args[1].value in pairs:
            out[target] = value.args[1].value
    return out


def _free_call_name(node: ast.AST, aliases: Dict[str, str],
                    pairs: Dict[str, Tuple[str, ...]]) -> Optional[str]:
    if not isinstance(node, ast.Call):
        return None
    if isinstance(node.func, ast.Attribute) and node.func.attr in pairs:
        return node.func.attr
    if isinstance(node.func, ast.Name):
        if node.func.id in pairs:
            return node.func.id
        if node.func.id in aliases:
            return aliases[node.func.id]
    return None


def _intent_base_attr(expr: ast.AST) -> Optional[str]:
    """``self._pending_demote[row]`` / ``shadow[row]`` → base attr/name."""
    if isinstance(expr, ast.Subscript):
        base = expr.value
        if isinstance(base, ast.Attribute):
            return base.attr
        if isinstance(base, ast.Name):
            return base.id
    return None


def _intent_mutation(node: ast.AST) -> Optional[str]:
    """Name of the intent structure this node mutates, else None."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            base = _intent_base_attr(t)
            if base is not None:
                return base
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            base = _intent_base_attr(t)
            if base is not None:
                return base
    elif isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) and \
            node.func.attr in _INTENT_METHODS:
        recv = node.func.value
        if isinstance(recv, ast.Attribute):
            return recv.attr
        if isinstance(recv, ast.Name):
            return recv.id
    return None


def _locked_regions(ctx: ModuleContext, fn: ast.AST) -> List[List[ast.stmt]]:
    """Statement lists that run under a lock: lockish ``with`` bodies,
    plus the whole body of a method that declares a lock contract by
    name (``*_locked``)."""
    regions: List[List[ast.stmt]] = []
    if getattr(fn, "name", "").endswith("_locked"):
        regions.append(list(fn.body))
    for node in _shared.walk_without_nested_functions(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _shared.is_lockish(item.context_expr, ctx)
                for item in node.items):
            regions.append(list(node.body))
    return regions
