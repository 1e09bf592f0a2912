"""TRACE001 — host synchronization inside device-step code.

The reference flags host syncs inside functions JAX traces. The port
traces nothing: its engine steps are eager PyTorch launched back to back
from the dispatching thread, and they must never wait for the card — a
wait stalls the dispatch pipeline behind every launch already queued,
and a step captured into a CUDA graph (``torch.cuda.graph``,
``make_graphed_callables``) or compiled (``torch.compile``) either fails
the capture or bakes one host value into every replay. This is the
static twin of ``chip_smoke.py``'s ``no_host_sync``, which runs the
steps under PyTorch's sync debug mode set to "error".

Device-step discovery:

1. decorator-based — ``@torch.compile`` / ``@torch.compile(...)`` /
   ``@partial(torch.compile, ...)``;
2. wrap-site-based — a ``def f`` whose name is passed to
   ``torch.compile(f)`` / ``torch.cuda.make_graphed_callables(f, ...)``
   in the module, or (pass 1, :mod:`..project`) from another module;
3. capture bodies — the statements under ``with torch.cuda.graph(g):``;
4. the declared table :data:`DEVICE_STEPS` of the port's step functions:
   the counterparts of every reference ``jax.jit`` / ``shard_map`` wrap
   site, which the port calls eagerly (declared config, as ORDER001's
   pair table is; a test holds it against the reference's wrap sites).

Nested defs inside a device-step function are device-step code too.

A host sync is: ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``;
``bool`` / ``int`` / ``float`` of a non-literal that is not static
metadata (``.shape``, ``len``); a Python ``if`` / ``while`` on a
tensor-valued test; ``torch.nonzero`` / ``.nonzero()``; a boolean-mask
index (``x[mask_expr]`` with a comparison or ``~`` in the index);
``torch.cuda.synchronize`` and ``.synchronize()``; a tensor made from a
Python value on the device (``torch.tensor(..., device=...)``); and a
``numpy`` call on a value (it pulls the tensor to the host).
"""

from __future__ import annotations

import ast
from typing import Iterator, List, NamedTuple, Optional, Sequence, Set

from sentinel_tpu_torch.analysis import project
from sentinel_tpu_torch.analysis.core import Finding, ModuleContext, Rule
from sentinel_tpu_torch.analysis.rules import _shared


class DeviceStep(NamedTuple):
    """One declared device-step function of the port."""

    module: str          # dotted module, suffix-matched
    function: str        # function or method name in it
    counterpart: str     # the reference wrap site it stands for


_REF = "sentinel_tpu."

#: The port's device-step functions, one entry per reference wrap site
#: (cross-module ``jax.jit(f)`` targets by their dotted path, sites local
#: to a reference module as ``<module>.<function>``).
DEVICE_STEPS = (
    DeviceStep("engine.pipeline", "decide_entries",
               _REF + "engine.pipeline.decide_entries"),
    DeviceStep("engine.pipeline", "record_exits",
               _REF + "engine.pipeline.record_exits"),
    DeviceStep("engine.pipeline", "decide_and_record_exits",
               _REF + "engine.pipeline.decide_and_record_exits"),
    DeviceStep("engine.pipeline", "invalidate_resource_rows",
               _REF + "engine.pipeline.invalidate_resource_rows"),
    DeviceStep("engine.pipeline", "record_blocks",
               _REF + "engine.pipeline.record_blocks"),
    DeviceStep("engine.pipeline", "uncount_reserved",
               _REF + "engine.pipeline.uncount_reserved"),
    DeviceStep("engine.pipeline", "extract_resource_rows",
               _REF + "engine.pipeline.extract_resource_rows"),
    DeviceStep("engine.pipeline", "restore_resource_rows",
               _REF + "engine.pipeline.restore_resource_rows"),
    DeviceStep("engine.pipeline", "init_state",
               _REF + "engine.pipeline._init_state_traced"),
    DeviceStep("stats.window", "bucket_snapshot",
               _REF + "stats.window.bucket_snapshot"),
    DeviceStep("stats.window", "settle_occupied",
               _REF + "stats.window.settle_occupied"),
    DeviceStep("rules.param_flow", "invalidate_param_keys",
               _REF + "rules.param_flow.invalidate_param_keys"),
    DeviceStep("rules.param_flow", "apply_overrides",
               _REF + "rules.param_flow.apply_overrides"),
    DeviceStep("obs.telemetry", "telemetry_tick",
               _REF + "obs.telemetry.telemetry_tick"),
    DeviceStep("obs.telemetry", "telemetry_tick",
               _REF + "obs.telemetry.body"),
    DeviceStep("parallel.cluster", "cluster_step",
               _REF + "parallel.cluster._shard_step"),
    DeviceStep("parallel.cluster", "cluster_step",
               _REF + "parallel.cluster.tgt"),
    DeviceStep("tiering.sketch", "update_sketch",
               _REF + "tiering.sketch.update_sketch"),
    DeviceStep("tiering.sketch", "halve_sketch",
               _REF + "tiering.sketch.halve_sketch"),
    DeviceStep("tiering.sketch", "tick_read",
               _REF + "tiering.sketch.tick_read"),
    DeviceStep("ops.scatter_add", "scatter_add",
               _REF + "ops.pallas_kernels.scatter_add_pallas"),
    # the reference's single-dispatch programs: the sketch update fused
    # into the decide (``step``) and the epilogue's telemetry / tiering
    # carries; the port runs them eagerly in the fused tail
    DeviceStep("runtime", "_fused_epilogue_locked", _REF + "runtime.step"),
    DeviceStep("runtime", "_fused_epilogue_locked",
               _REF + "runtime.step_epi"),
    DeviceStep("runtime", "_fused_epilogue_locked",
               _REF + "runtime.tel_run"),
    DeviceStep("runtime", "_fused_epilogue_locked",
               _REF + "runtime.tel_skip"),
    DeviceStep("runtime", "_fused_epilogue_locked",
               _REF + "runtime.tier_run"),
    DeviceStep("runtime", "_fused_epilogue_locked",
               _REF + "runtime.tier_skip"),
    # the donation-safe breaker column copy (``jax.jit(jnp.copy)``)
    DeviceStep("runtime", "_breaker_snapshot_locked", "jax.numpy.copy"),
)

#: numpy metadata calls that never touch array *values*.
_SAFE_NP = frozenset({"iinfo", "finfo", "dtype"})

_HOST_SYNC_METHODS = frozenset({
    "item", "tolist", "cpu", "numpy", "nonzero", "synchronize",
})

_HOST_SYNC_CALLS = frozenset({"torch.nonzero", "torch.cuda.synchronize"})

#: torch functions that only read metadata (no value).
_SAFE_TORCH = frozenset({
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.numel", "torch.device", "torch.iinfo", "torch.finfo",
    "torch.get_default_dtype", "torch.is_grad_enabled",
})

_CAPTURE_LABEL = "<torch.cuda.graph capture>"


class TraceHygieneRule(Rule):
    id = "TRACE001"
    name = "host-sync-in-device-step"
    rationale = (
        "a host sync inside a device step stalls the dispatch behind "
        "every queued launch, breaks a CUDA graph capture and freezes "
        "one host value into a compiled replay; branch with torch.where "
        "and keep values on the card")

    def __init__(self, steps: Optional[Sequence[DeviceStep]] = None):
        self.steps = tuple(DEVICE_STEPS if steps is None else steps)

    def prepare(self, contexts) -> None:
        self._index = project.shared_index(contexts)

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        index = getattr(self, "_index", None)
        if index is None:
            index = project.shared_index([ctx])
        wrapped = {t for t in project.wrap_site_targets(ctx)
                   if "." not in t}
        mod_name = ctx.module_name
        for mod, fns in index.device_steps.items():
            if project.module_matches(mod_name, mod):
                wrapped |= fns
        for step in self.steps:
            if project.module_matches(mod_name, step.module):
                wrapped.add(step.function)
        for fn in _traced_functions(ctx, wrapped):
            yield from self._scan(ctx, fn.name, list(ast.walk(fn)))
        for body in _capture_bodies(ctx):
            nodes: List[ast.AST] = []
            for stmt in body:
                nodes.extend(ast.walk(stmt))
            yield from self._scan(ctx, _CAPTURE_LABEL, nodes)

    # ------------------------------------------------------------------
    def _scan(self, ctx: ModuleContext, where: str,
              nodes: List[ast.AST]) -> Iterator[Finding]:
        for node in nodes:
            if isinstance(node, ast.Call):
                name = ctx.call_name(node)
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _HOST_SYNC_METHODS
                        and not (name or "").startswith("torch.")):
                    yield self.finding(
                        ctx, node,
                        "'.%s()' inside device-step code '%s' waits for "
                        "the card (a host sync)" % (node.func.attr, where))
                elif name in _HOST_SYNC_CALLS:
                    yield self.finding(
                        ctx, node,
                        "'%s' inside device-step code '%s' waits for the "
                        "card (a host sync)" % (name, where))
                elif name in ("float", "int", "bool") and node.args and \
                        not isinstance(node.args[0], ast.Constant) and \
                        not _static_valued(node.args[0]):
                    yield self.finding(
                        ctx, node,
                        "'%s(...)' on a non-literal inside device-step "
                        "code '%s' reads a tensor value on the host" % (
                            name, where))
                elif name == "torch.tensor" and any(
                        k.arg == "device" for k in node.keywords):
                    yield self.finding(
                        ctx, node,
                        "'torch.tensor(..., device=)' inside device-step "
                        "code '%s' copies a Python value to the card "
                        "synchronously; build it once outside the step "
                        "or use torch.full" % where)
                elif (name is not None and name.startswith("numpy.")
                      and name.split(".")[1] not in _SAFE_NP):
                    yield self.finding(
                        ctx, node,
                        "'%s' inside device-step code '%s' pulls the value "
                        "to the host; use torch" % (name, where))
            elif isinstance(node, (ast.If, ast.While)) and \
                    _tensor_valued(node.test, ctx):
                yield self.finding(
                    ctx, node,
                    "Python branch on a tensor-valued expression inside "
                    "device-step code '%s' waits for the card; use "
                    "torch.where" % where)
            elif isinstance(node, ast.Subscript) and _mask_index(node.slice):
                yield self.finding(
                    ctx, node,
                    "boolean-mask index inside device-step code '%s' sizes "
                    "its result on the host (a sync); use torch.where or "
                    "a fixed-size gather" % where)


def _static_valued(arg: ast.AST) -> bool:
    """``int(x.shape[0])`` / ``float(len(xs))`` read *static* metadata,
    which needs no sync — don't flag those."""
    for node in ast.walk(arg):
        if isinstance(node, ast.Attribute) and node.attr in (
                "shape", "ndim", "size", "dtype"):
            return True
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and node.func.id == "len":
            return True
    return False


def _tensor_valued(test: ast.AST, ctx: ModuleContext) -> bool:
    """Conservative: the test computes a tensor (a ``torch.*`` call other
    than a metadata query, or an ``.any()`` / ``.all()`` / ``.item()``
    method) — static config attributes and plain names do NOT flag."""
    for node in ast.walk(test):
        if isinstance(node, ast.Call):
            name = ctx.call_name(node)
            if name is not None and name.startswith("torch.") and \
                    name not in _SAFE_TORCH and \
                    not name.startswith("torch.cuda."):
                return True
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("any", "all", "item"):
                return True
    return False


def _mask_index(index: ast.AST) -> bool:
    """An index that is a boolean mask built in place: a comparison, or
    ``~`` / ``&`` / ``|`` over one."""
    if isinstance(index, ast.Compare):
        return True
    if isinstance(index, ast.UnaryOp) and isinstance(index.op, ast.Invert):
        return True
    if isinstance(index, ast.BinOp) and isinstance(
            index.op, (ast.BitAnd, ast.BitOr)):
        return _mask_index(index.left) or _mask_index(index.right)
    return False


def _capture_bodies(ctx: ModuleContext) -> List[List[ast.stmt]]:
    out: List[List[ast.stmt]] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and ctx.call_name(item.context_expr)
                in project.CAPTURE_CONTEXTS for item in node.items):
            out.append(list(node.body))
    return out


def _traced_functions(ctx: ModuleContext, wrapped: Set[str]):
    traced: List[ast.AST] = []
    for fn in _shared.iter_functions(ctx.tree):
        if fn.name in wrapped or any(
                _is_wrapper_decorator(d, ctx) for d in fn.decorator_list):
            traced.append(fn)
    # nested defs inside a device-step function run with it
    seen = set(id(f) for f in traced)
    for fn in list(traced):
        for sub in ast.walk(fn):
            if isinstance(sub, _shared.FUNC_NODES) and id(sub) not in seen:
                seen.add(id(sub))
                traced.append(sub)
    return traced


def _is_wrapper_decorator(dec: ast.AST, ctx: ModuleContext) -> bool:
    if isinstance(dec, ast.Call):
        name = ctx.call_name(dec)
        if name in project.GRAPH_WRAPPERS:
            return True
        if name in ("functools.partial", "partial") and dec.args:
            return ctx.dotted(dec.args[0]) in project.GRAPH_WRAPPERS
        return False
    return ctx.dotted(dec) in project.GRAPH_WRAPPERS

