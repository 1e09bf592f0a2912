"""graftlint pass 1 — the whole-program project model (the port's copy).

Several rules need *project* facts — which attributes a class guards
with which lock, which functions a thread can reach, which functions
another module hands to ``torch.compile``, what the counter catalog and
knob registry actually declare — so pass 1 is a shared index built ONCE
per analysis run:

* :class:`ClassIndex` — per-class attribute access sites, each tagged
  with the set of ``self.*`` / module-level locks held at that point,
  plus base-class names and method table.
* thread entry points (``threading.Thread(target=...)``, ``Timer``,
  ``executor.submit``, ``asyncio.to_thread``, ``run_in_executor``,
  ``run`` methods of Thread subclasses) and a name-based call graph,
  closed transitively into :attr:`ProjectIndex.thread_reachable`.
* device-step provenance — every ``torch.compile(f)`` /
  ``torch.cuda.make_graphed_callables(f, ...)`` wrap site (through one
  level of ``functools.partial``) whose ``f`` is imported maps the
  defining module to ``f`` (:attr:`ProjectIndex.device_steps`), so the
  defining module scans it as device-step code (TRACE001; the rule adds
  its declared table of the port's eager step functions). Torch donates
  no buffers, so the reference's ``donate_argnums`` provenance has no
  counterpart here.
* declaration registries parsed from source, never imported: the
  counter catalog (a module named ``counters.py`` with a top-level
  ``CATALOG`` tuple), the knob registry (``knobs.py`` with a top-level
  ``KNOBS`` tuple of ``KnobSpec(...)`` calls + ``OPERATIONAL_ENVS``),
  and the ``SentinelConfig`` dataclass fields (``config.py``) that the
  ``SENTINEL_TPU_<FIELD>`` env mapping derives from.

Sharing: :func:`core.analyze_paths` wraps its context list in
:class:`ContextSet`; :func:`shared_index` memoizes the built index on
that object so the rules' ``prepare`` passes pay for pass 1 once. A
plain list (the ``analyze_source`` single-module path) just builds a
fresh index — one module is cheap.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from sentinel_tpu_torch.analysis.core import ModuleContext
from sentinel_tpu_torch.analysis.rules import _shared


class ContextSet(list):
    """List of ModuleContexts that can carry the memoized pass-1 index
    (plain lists cannot take attributes)."""


def shared_index(contexts: Sequence[ModuleContext]) -> "ProjectIndex":
    cached = getattr(contexts, "_graftlint_index", None)
    if cached is not None:
        return cached
    index = ProjectIndex(contexts)
    try:
        contexts._graftlint_index = index  # type: ignore[attr-defined]
    except AttributeError:
        pass
    return index


# ----------------------------------------------------------------------
# Constant-expression evaluation (clamp bounds, keys)
# ----------------------------------------------------------------------

def const_eval(node: ast.AST, names: Optional[Dict[str, object]] = None):
    """Evaluate the tiny constant-expression language the registries are
    written in: literals, ``-x``, ``a + b``, ``a * b``, ``a << b``,
    ``a // b``, tuples, and names resolvable through ``names``.
    Returns None when the expression is not statically known (callers
    must treat that as "unknown", never as a value)."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name) and names and node.id in names:
        return names[node.id]
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = const_eval(node.operand, names)
        return -v if isinstance(v, (int, float)) else None
    if isinstance(node, ast.Tuple):
        items = [const_eval(e, names) for e in node.elts]
        return None if any(i is None for i in items) else tuple(items)
    if isinstance(node, ast.BinOp):
        left = const_eval(node.left, names)
        right = const_eval(node.right, names)
        if left is None or right is None:
            return None
        try:
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.LShift):
                return left << right
            if isinstance(node.op, ast.FloorDiv):
                return left // right
            if isinstance(node.op, ast.Pow):
                return left ** right
        except TypeError:
            return None
    return None


def module_string_constants(ctx: ModuleContext) -> Dict[str, str]:
    """Module-level ``NAME = "literal"`` (and const-concat) bindings."""
    out: Dict[str, str] = {}
    for stmt in ctx.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            v = const_eval(stmt.value, out)
            if isinstance(v, str):
                out[stmt.targets[0].id] = v
    return out


# ----------------------------------------------------------------------
# Per-class access index (LOCK002 / ORDER001 substrate)
# ----------------------------------------------------------------------

#: Methods where unlocked access to guarded state is definitionally
#: fine: the object is not yet (or no longer) shared.
CONSTRUCTION_METHODS = frozenset({
    "__init__", "__new__", "__post_init__", "__del__", "__repr__",
})

#: Docstring shapes that declare a lock contract ("callers hold
#: ``_lock``"), the repo's documented-precondition idiom; a method whose
#: name ends in ``_locked`` declares the same contract by naming.
_LOCK_CONTRACT_RE = re.compile(
    r"caller[s]?\s+(?:must\s+)?hold|hold[s]?\s+(?:the\s+)?[`_\w.]*lock"
    r"|with\s+[`_\w.]*lock\s+held|under\s+[`_\w.]*lock",
    re.IGNORECASE)


@dataclasses.dataclass
class AttrAccess:
    """One ``self.<attr>`` load/store inside a method body."""

    attr: str
    node: ast.AST
    method: str
    is_store: bool
    locks_held: FrozenSet[str]     # lock names held at this point


@dataclasses.dataclass
class ClassIndex:
    name: str
    module: str                    # dotted module name
    path: str
    node: ast.ClassDef
    bases: Tuple[str, ...]
    methods: Dict[str, ast.AST]
    accesses: List[AttrAccess]

    def lock_contract_methods(self) -> Set[str]:
        out = set()
        for name, fn in self.methods.items():
            if name.endswith("_locked"):
                out.add(name)
                continue
            doc = ast.get_docstring(fn) or ""
            if doc and _LOCK_CONTRACT_RE.search(doc):
                out.add(name)
        return out


def _lock_name(expr: ast.AST, ctx: ModuleContext) -> Optional[str]:
    """``with self._lock:`` → ``_lock``; ``with REGISTRY_LOCK:`` →
    ``REGISTRY_LOCK``; calls (``lock.acquire_timeout()``) unwrap."""
    if isinstance(expr, ast.Call):
        expr = expr.func
        if isinstance(expr, ast.Attribute):       # lock.acquire_timeout
            expr = expr.value
    if not _shared.is_lockish(expr, ctx):
        return None
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


class _ClassWalker(_shared.AncestorVisitor):
    """Collect every self.<attr> access in a class body, tagged with the
    set of locks held (enclosing lockish ``with`` items) and the method
    it sits in. Nested defs inside a method attribute to that method
    (closures run on the same thread discipline as their home method for
    our purposes — thread-target closures are seeded separately)."""

    def __init__(self, ctx: ModuleContext, cls: ClassIndex):
        self.ctx = ctx
        self.cls = cls

    def visit(self, node, ancestors):
        if isinstance(node, ast.ClassDef):
            return False                      # nested classes: own index
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            method = None
            locks: Set[str] = set()
            for anc in ancestors:
                if isinstance(anc, _shared.FUNC_NODES) and method is None:
                    method = anc.name
                if isinstance(anc, (ast.With, ast.AsyncWith)):
                    for item in anc.items:
                        ln = _lock_name(item.context_expr, self.ctx)
                        if ln is not None:
                            locks.add(ln)
            if method is not None:
                self.cls.accesses.append(AttrAccess(
                    attr=node.attr, node=node, method=method,
                    is_store=isinstance(node.ctx, (ast.Store, ast.Del)),
                    locks_held=frozenset(locks)))
        return True


# ----------------------------------------------------------------------
# Thread entry points + name-based call graph
# ----------------------------------------------------------------------

_THREAD_FACTORIES = frozenset({
    "threading.Thread", "Thread", "threading.Timer", "Timer",
})
_SUBMIT_METHODS = frozenset({
    "submit", "run_in_executor", "call_soon_threadsafe", "to_thread",
    "start_new_thread", "defer",
})
_THREAD_BASES = frozenset({"threading.Thread", "Thread"})


def _callable_bare_name(arg: ast.AST) -> Optional[str]:
    """``self._serve`` → ``_serve``; ``serve`` → ``serve``; lambdas and
    calls → None (their bodies are walked where they appear)."""
    if isinstance(arg, ast.Attribute):
        return arg.attr
    if isinstance(arg, ast.Name):
        return arg.id
    return None


def _thread_target_names(ctx: ModuleContext) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = ctx.call_name(node)
        if name in _THREAD_FACTORIES:
            for kw in node.keywords:
                if kw.arg == "target":
                    t = _callable_bare_name(kw.value)
                    if t:
                        out.add(t)
            # Timer(interval, fn) / Thread(None, fn) positional form
            for arg in node.args[1:2]:
                t = _callable_bare_name(arg)
                if t:
                    out.add(t)
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SUBMIT_METHODS:
            pos = 1 if node.func.attr == "run_in_executor" else 0
            if len(node.args) > pos:
                t = _callable_bare_name(node.args[pos])
                if t:
                    out.add(t)
        elif name in ("asyncio.to_thread",) and node.args:
            t = _callable_bare_name(node.args[0])
            if t:
                out.add(t)
    return out


def _call_graph(ctx: ModuleContext,
                graph: Dict[str, Set[str]]) -> None:
    """name-based call edges: for each function/method def, the bare
    names it calls (``self.m()`` / ``obj.m()`` / ``m()``) and the bare
    names of callables it passes as thread/executor targets."""
    for fn in _shared.iter_functions(ctx.tree):
        edges = graph.setdefault(fn.name, set())
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute):
                    edges.add(node.func.attr)
                elif isinstance(node.func, ast.Name):
                    edges.add(node.func.id)


def _transitive_closure(seeds: Set[str],
                        graph: Dict[str, Set[str]]) -> Set[str]:
    seen = set(seeds)
    frontier = list(seeds)
    while frontier:
        cur = frontier.pop()
        for nxt in graph.get(cur, ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return seen


# ----------------------------------------------------------------------
# Device-step provenance (the TRACE001 seed)
# ----------------------------------------------------------------------

#: Callables that turn the function passed to them into device-step
#: code: a compiled graph or a captured CUDA graph replays what the
#: function did on the device, so a host sync inside it breaks the
#: capture or bakes one host value into every replay.
GRAPH_WRAPPERS = frozenset({
    "torch.compile", "torch.cuda.make_graphed_callables",
})

#: Context managers whose ``with`` body is captured into a CUDA graph.
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph"})


def partial_target(value: ast.AST, ctx: ModuleContext) -> Optional[str]:
    """``functools.partial(f, ...)`` → dotted name of ``f``."""
    if isinstance(value, ast.Call) and \
            ctx.call_name(value) in ("functools.partial", "partial") and \
            value.args and isinstance(value.args[0],
                                      (ast.Name, ast.Attribute)):
        return ctx.dotted(value.args[0])
    return None


def wrap_site_targets(ctx: ModuleContext) -> Set[str]:
    """Dotted names of functions passed to a :data:`GRAPH_WRAPPERS`
    callable, including through one level of ``functools.partial`` —
    directly (``torch.compile(partial(f, spec))``) or via an intermediate
    variable (``body = partial(f, spec); torch.compile(body)``). A local
    ``def`` yields its bare name; an imported function yields its
    fully-qualified dotted path (the cross-module seed)."""
    partial_of: Dict[str, str] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            inner = partial_target(node.value, ctx)
            if inner is not None:
                partial_of[node.targets[0].id] = inner
    out: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and \
                ctx.call_name(node) in GRAPH_WRAPPERS:
            for arg in node.args[:1]:
                target = None
                if isinstance(arg, ast.Name) and arg.id in partial_of:
                    target = partial_of[arg.id]
                elif isinstance(arg, (ast.Name, ast.Attribute)):
                    target = ctx.dotted(arg)
                elif isinstance(arg, ast.Call):
                    target = partial_target(arg, ctx)
                if target is not None:
                    out.add(target)
    return out


def module_matches(mod_name: str, mod: str) -> bool:
    """Suffix match of dotted module names (analysis may run on absolute
    or relative paths, and imports may name a package prefix)."""
    return (mod_name == mod or mod_name.endswith("." + mod)
            or mod.endswith("." + mod_name))


# ----------------------------------------------------------------------
# Registry declarations (CAT001 substrate)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class CounterDecl:
    path: str
    node: ast.AST                  # the CATALOG assignment
    constants: Dict[str, str]      # NAME -> key string
    catalog: List[str]             # evaluated CATALOG order
    prefixes: Set[str]             # declared dynamic-key prefixes


@dataclasses.dataclass
class KnobDecl:
    path: str
    specs: Dict[str, Tuple[object, object]]    # env -> (lo, hi)
    kinds: Dict[str, str]                      # env -> kind
    operational: Set[str]


def _parse_counters_module(ctx: ModuleContext) -> Optional[CounterDecl]:
    consts = module_string_constants(ctx)
    cat_node = None
    for stmt in ctx.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                stmt.targets[0].id == "CATALOG":
            cat_node = stmt
    if cat_node is None:
        return None
    cat = const_eval(cat_node.value, consts)
    if not isinstance(cat, tuple) or \
            not all(isinstance(k, str) for k in cat):
        return None
    prefixes = {v for v in consts.values() if v.endswith(".")}
    return CounterDecl(ctx.path, cat_node, consts, list(cat), prefixes)


def _parse_knobs_module(ctx: ModuleContext) -> Optional[KnobDecl]:
    consts = module_string_constants(ctx)
    specs: Dict[str, Tuple[object, object]] = {}
    kinds: Dict[str, str] = {}
    operational: Set[str] = set()
    found = False
    for stmt in ctx.tree.body:
        if not (isinstance(stmt, ast.Assign) or
                isinstance(stmt, ast.AnnAssign)):
            continue
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        value = stmt.value
        if value is None or len(targets) != 1 or \
                not isinstance(targets[0], ast.Name):
            continue
        tname = targets[0].id
        if tname == "KNOBS" and isinstance(value, ast.Tuple):
            for el in value.elts:
                if not (isinstance(el, ast.Call) and
                        isinstance(el.func, ast.Name) and
                        el.func.id == "KnobSpec" and len(el.args) >= 5):
                    continue
                env = const_eval(el.args[0], consts)
                kind = const_eval(el.args[1], consts)
                lo = const_eval(el.args[3], consts)
                hi = const_eval(el.args[4], consts)
                if isinstance(env, str):
                    specs[env] = (lo, hi)
                    kinds[env] = kind if isinstance(kind, str) else ""
                    found = True
        elif tname == "OPERATIONAL_ENVS" and isinstance(value, ast.Dict):
            for k in value.keys:
                kv = const_eval(k, consts)
                if isinstance(kv, str):
                    operational.add(kv)
            found = True
    if not found:
        return None
    return KnobDecl(ctx.path, specs, kinds, operational)


def _parse_config_fields(ctx: ModuleContext) -> Set[str]:
    """``SENTINEL_TPU_<FIELD>`` env keys derivable from the
    ``SentinelConfig`` dataclass fields (core/config.py)."""
    out: Set[str] = set()
    for node in ctx.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "SentinelConfig":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name):
                    out.add("SENTINEL_TPU_" + stmt.target.id.upper())
    return out


# ----------------------------------------------------------------------
# The index
# ----------------------------------------------------------------------

class ProjectIndex:
    """Everything pass 2 needs, built once over all parsed modules."""

    def __init__(self, contexts: Sequence[ModuleContext]):
        self.classes: List[ClassIndex] = []
        self.module_constants: Dict[str, Dict[str, str]] = {}
        #: defining module -> functions another module wraps
        self.device_steps: Dict[str, Set[str]] = {}
        self.counters: Optional[CounterDecl] = None
        self.knobs: Optional[KnobDecl] = None
        self.config_field_envs: Set[str] = set()
        graph: Dict[str, Set[str]] = {}
        thread_seeds: Set[str] = set()

        for ctx in contexts:
            self.module_constants[ctx.module_name] = \
                module_string_constants(ctx)
            for target in wrap_site_targets(ctx):
                if "." in target:
                    mod, fn = target.rsplit(".", 1)
                    self.device_steps.setdefault(mod, set()).add(fn)
            thread_seeds |= _thread_target_names(ctx)
            _call_graph(ctx, graph)
            for node in ctx.tree.body:
                if isinstance(node, ast.ClassDef):
                    self._index_class(ctx, node, thread_seeds)
            base = ctx.path.replace("\\", "/").rsplit("/", 1)[-1]
            if base == "counters.py" and self.counters is None:
                self.counters = _parse_counters_module(ctx)
            elif base == "knobs.py" and self.knobs is None:
                self.knobs = _parse_knobs_module(ctx)
            elif base == "config.py":
                self.config_field_envs |= _parse_config_fields(ctx)

        self.call_graph = graph
        self.thread_entry_names = thread_seeds
        self.thread_reachable = _transitive_closure(thread_seeds, graph)

    def _index_class(self, ctx: ModuleContext, node: ast.ClassDef,
                     thread_seeds: Set[str]) -> None:
        bases = tuple(b for b in (ctx.dotted(x) for x in node.bases) if b)
        cls = ClassIndex(
            name=node.name, module=ctx.module_name, path=ctx.path,
            node=node, bases=bases,
            methods={s.name: s for s in node.body
                     if isinstance(s, _shared.FUNC_NODES)},
            accesses=[])
        _ClassWalker(ctx, cls).run(node)
        self.classes.append(cls)
        if any(b in _THREAD_BASES for b in bases) and "run" in cls.methods:
            thread_seeds.add("run")

    # ------------------------------------------------------------------
    def classes_in(self, path: str) -> List[ClassIndex]:
        return [c for c in self.classes if c.path == path]

    def resolve_string(self, ctx: ModuleContext,
                       node: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute/Constant to a string constant using
        this module's bindings, import aliases, and every indexed
        module's constants (suffix-matched on the dotted prefix)."""
        if isinstance(node, ast.Constant):
            return node.value if isinstance(node.value, str) else None
        dotted = ctx.dotted(node)
        if dotted is None:
            return None
        local = self.module_constants.get(ctx.module_name, {})
        if dotted in local:
            return local[dotted]
        if "." in dotted:
            mod, leaf = dotted.rsplit(".", 1)
            mod = mod.lstrip(".")
            for mod_name, consts in self.module_constants.items():
                if (mod_name == mod or mod_name.endswith("." + mod)
                        or mod.endswith("." + mod_name)) and leaf in consts:
                    return consts[leaf]
        return None
