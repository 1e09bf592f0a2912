"""SPMD001 — collectives reachable under rank-divergent branches.

A ``torch.distributed`` collective — ``all_reduce``, ``all_gather``,
``broadcast``, ``barrier`` ... and the process-group lifecycle calls
``init_process_group`` / ``destroy_process_group``, which rendezvous
too — is a meeting point: every rank in the group must execute it, in
the same order, or the group hangs (NCCL waits forever; gloo times out
after 30 minutes). Any collective that is only reachable when a branch
on ``get_rank()`` / the port's ``process_index`` / coordinator-ness /
environment variables (``RANK``, ``LOCAL_RANK``) goes one way is
therefore a deadlock wired in and waiting for traffic. The port's own
collective entry points count too: ``multihost.initialize``, the fleet
aggregates of ``multihost/obs_agg``, and any ``barrier`` /
``all_gather`` / ``all_reduce_sum`` / ``all_reduce_bits`` (the
runtime's and the mesh's methods, which run one ``torch.distributed``
collective each). So does the row-sharded engine's rank-local read seam:
on a ``"rows"`` mesh that spans processes a per-lane read of
``RowBlocks`` (``table[rows]``) or its ``sum()`` is one ``all_reduce``.
The rule knows a name as row blocks within a function when it is a
parameter annotated ``RowBlocks`` or bound from ``RowBlocks(...)``,
``RowBlocks.split(...)`` or a mesh's ``blocks_of(...)``.

Two shapes are detected, as in the reference:

1. **Lexical**: a collective call inside the body (or else-branch) of an
   ``if``/``while``/ternary/short-circuit whose test is rank-divergent.
2. **Guard-return**: a rank-divergent ``if`` whose body leaves the
   function (``return``/``raise``/``continue``/``break``) followed — later
   in the same suite — by a collective call. Only the surviving ranks
   reach the rendezvous.
"""

from __future__ import annotations

import ast
from typing import Iterator, List

from sentinel_tpu_torch.analysis.core import Finding, ModuleContext, Rule
from sentinel_tpu_torch.analysis.rules import _shared

_DIST = "torch.distributed."

#: Fully-qualified collective entry points (exact names).
COLLECTIVE_EXACT = frozenset(_DIST + n for n in (
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "broadcast_object_list", "barrier", "monitored_barrier",
    "all_to_all", "all_to_all_single", "gather", "gather_object",
    "scatter", "scatter_object_list", "reduce",
    "init_process_group", "destroy_process_group", "new_group",
)) | frozenset("sentinel_tpu_torch.multihost." + n for n in (
    "initialize", "bootstrap.initialize",
    "obs_agg.aggregate_counters", "obs_agg.aggregate_topk",
    "obs_agg.aggregate_resource_hist", "obs_agg.coordinator_report",
))

#: Bare names distinctive enough to be collectives whatever their
#: receiver (``broadcast`` / ``gather`` / ``scatter`` / ``reduce`` are
#: not: tensors and functools have methods of those names).
_COLLECTIVE_LEAVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "reduce_scatter_tensor", "barrier", "monitored_barrier",
    "all_to_all_single", "init_process_group", "destroy_process_group",
    "all_reduce_sum", "all_reduce_bits",
})

#: calls whose result is row blocks (``parallel/row_blocks.py``)
_ROW_BLOCK_MAKERS = ("RowBlocks", "RowBlocks.split", "blocks_of")

#: Rank-divergent signals inside a branch test.
_DIVERGENT_SUFFIXES = (".get_rank", ".get_node_local_rank",
                       ".is_coordinator", ".process_index")
_DIVERGENT_EXACT = frozenset({
    "torch.distributed.get_rank", "torch.distributed.get_node_local_rank",
    "get_rank", "is_coordinator", "process_index",
    "socket.gethostname", "platform.node", "os.getpid",
})
_DIVERGENT_PREFIXES = ("os.environ", "os.getenv")


class SpmdRule(Rule):
    id = "SPMD001"
    name = "collective-under-divergent-branch"
    rationale = (
        "collectives are rendezvous points: every rank must execute "
        "them in lockstep, so one reachable only under a per-rank "
        "branch deadlocks the process group")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        yield from self._lexical(ctx)
        yield from self._row_reads_lexical(ctx)
        yield from self._guard_return(ctx)

    def _row_reads_lexical(self, ctx: ModuleContext) -> Iterator[Finding]:
        """Shape 1 for the rank-local read seam, function by function
        (the row-block names are a function's own)."""
        seen = set()
        for fn in _shared.iter_functions(ctx.tree):
            names = _row_block_names(fn, ctx)
            if not names:
                continue
            for node in _shared.walk_without_nested_functions(fn):
                for b in _divergent_branches(node, ctx):
                    for read, label in _row_reads(b, names):
                        if id(read) in seen:
                            continue
                        seen.add(id(read))
                        yield self.finding(
                            ctx, read,
                            "rank-local row read '%s' (a RowBlocks "
                            "per-lane read or sum: one all_reduce over "
                            "the \"rows\" mesh) reachable only under a "
                            "rank-divergent branch; every rank must make "
                            "the same reads or the process group "
                            "deadlocks" % label)

    # ------------------------------------------------------------------
    def _lexical(self, ctx: ModuleContext) -> Iterator[Finding]:
        seen = set()
        for node in ast.walk(ctx.tree):
            for b in _divergent_branches(node, ctx):
                for call in ast.walk(b):
                    if isinstance(call, ast.Call) and id(call) not in seen:
                        name = ctx.call_name(call)
                        if _collective(name):
                            seen.add(id(call))
                            yield self.finding(
                                ctx, call,
                                "collective '%s' reachable only under a "
                                "rank-divergent branch (test involves "
                                "get_rank/process_index/coordinator/env); "
                                "every rank "
                                "must reach this rendezvous or the "
                                "process group deadlocks" % name)

    def _guard_return(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in _shared.iter_functions(ctx.tree):
            yield from self._scan_suite(ctx, fn.body, gated=False,
                                        names=_row_block_names(fn, ctx))

    def _scan_suite(self, ctx: ModuleContext, stmts, gated: bool,
                    names=frozenset()) -> Iterator[Finding]:
        for stmt in stmts:
            if gated:
                for call in ast.walk(stmt):
                    if isinstance(call, ast.Call):
                        name = ctx.call_name(call)
                        if _collective(name):
                            yield self.finding(
                                ctx, call,
                                "collective '%s' follows a rank-"
                                "divergent early exit above it: ranks "
                                "that took the exit never reach this "
                                "rendezvous and the rest hang" % name)
                for read, label in _row_reads(stmt, names):
                    yield self.finding(
                        ctx, read,
                        "rank-local row read '%s' (one all_reduce over "
                        "the \"rows\" mesh) follows a rank-divergent "
                        "early exit above it: ranks that took the exit "
                        "never join it and the rest hang" % label)
            if (isinstance(stmt, ast.If) and _divergent(stmt.test, ctx)
                    and _shared.terminates_block(stmt.body)
                    and not stmt.orelse):
                gated = True
                continue
            # recurse into nested suites with the current gating state
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub and not isinstance(stmt, _shared.FUNC_NODES):
                    # findings inside nested suites of a gated region were
                    # already reported by the blanket walk above
                    if not gated:
                        yield from self._scan_suite(ctx, sub, gated=False,
                                                    names=names)


def _divergent_branches(node: ast.AST, ctx: ModuleContext) -> List[ast.AST]:
    """The parts of ``node`` (a branch statement or expression) that run
    only on the ranks whose rank-divergent test went their way."""
    if isinstance(node, (ast.If, ast.While)):
        if _divergent(node.test, ctx):
            return list(node.body) + list(getattr(node, "orelse", []))
    elif isinstance(node, ast.IfExp):
        if _divergent(node.test, ctx):
            return [node.body, node.orelse]
    elif isinstance(node, ast.BoolOp):
        if any(_divergent(v, ctx) for v in node.values[:-1]):
            return list(node.values[1:])
    return []


def _is_row_blocks(annotation) -> bool:
    if isinstance(annotation, ast.Constant):
        return str(annotation.value).split(".")[-1] == "RowBlocks"
    if isinstance(annotation, ast.Name):
        return annotation.id == "RowBlocks"
    return (isinstance(annotation, ast.Attribute)
            and annotation.attr == "RowBlocks")


def _row_block_names(fn, ctx: ModuleContext) -> frozenset:
    """Names that hold row blocks in ``fn``: parameters annotated
    ``RowBlocks`` and names bound from one of :data:`_ROW_BLOCK_MAKERS`."""
    args = fn.args
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs
             if a.annotation is not None and _is_row_blocks(a.annotation)}
    for node in _shared.walk_without_nested_functions(fn):
        if isinstance(node, ast.AnnAssign) and _is_row_blocks(
                node.annotation) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                         ast.Call):
            made = ctx.call_name(node.value)
            if made is not None and any(
                    made == m or made.endswith("." + m)
                    for m in _ROW_BLOCK_MAKERS):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
    return frozenset(names)


def _row_reads(node: ast.AST, names) -> Iterator:
    """``(node, label)`` for each row-block read in ``node``: a subscript
    load of a row-block name, or its ``sum()``."""
    if not names:
        return
    for n in ast.walk(node):
        if (isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Load)
                and isinstance(n.value, ast.Name) and n.value.id in names):
            yield n, "%s[...]" % n.value.id
        elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
              and n.func.attr == "sum"
              and isinstance(n.func.value, ast.Name)
              and n.func.value.id in names):
            yield n, "%s.sum()" % n.func.value.id


def _collective(name) -> bool:
    return _shared.name_matches(name, exact=COLLECTIVE_EXACT) or (
        name is not None and name.split(".")[-1] in _COLLECTIVE_LEAVES
        and not name.startswith(("self.", "cls.")))


def _divergent(test: ast.AST, ctx: ModuleContext) -> bool:
    for node in ast.walk(test):
        name = None
        if isinstance(node, (ast.Attribute, ast.Name)):
            name = ctx.dotted(node)
        elif isinstance(node, ast.Call):
            name = ctx.call_name(node)
        if name is None:
            continue
        if (name in _DIVERGENT_EXACT
                or name.startswith(_DIVERGENT_PREFIXES)
                or any(name.endswith(s) for s in _DIVERGENT_SUFFIXES)):
            return True
    return False
