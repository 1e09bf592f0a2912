"""CAT001 — cross-module registry drift, caught at lint time.

Two registries hold the runtime's contract with its operators and its
multihost peers, and both previously relied on *test-pinned* audits to
stay honest:

* **Counter catalog** (``obs/counters.py`` ``CATALOG``): the ordered
  key set IS the wire format of the multihost counter vector — a key
  incremented on the hot path but missing from ``CATALOG`` silently
  drops from pod-wide aggregation; a reordered ``CATALOG`` corrupts
  every mixed-version allgather. The rule resolves each key passed to
  the counter API (``<anything>.counters.add(KEY)`` or a local
  ``counters`` alias) through import aliases and cross-module string
  constants, and flags resolved keys absent from ``CATALOG``. Keys
  built from a declared dynamic prefix (a constant ending in ``.`` —
  ``block_reason.``, ``flight.trigger.``) aggregate through the
  transport surface by design and are skipped. ``CATALOG`` itself is
  checked against the checked-in manifest
  (``obs/counters_catalog.txt``): the manifest must be an exact
  *prefix* of ``CATALOG`` (appended-last ordering), and every new key
  must land in the manifest in the same change.
* **Knob registry** (``tune/knobs.py``): every ``os.environ`` read of
  a ``SENTINEL_*`` key must be declared — a ``KnobSpec``, an
  ``OPERATIONAL_ENVS`` entry, or a ``SENTINEL_TPU_<FIELD>`` config
  mapping — or typos ship silently (the
  ``SENTINEL_PIPLINE_DEPTH`` lesson). Where the read site is one of
  the clamped helpers (``_env_int(env, default, lo, hi)`` /
  ``_env_num(...)``), the literal clamp bounds must equal the
  ``KnobSpec``'s — the drift ``test_tune.py`` pins at runtime, now a
  file:line lint failure.

Both registries are parsed from *source* in pass 1 (never imported);
when the counters/knobs module is outside the analyzed path set, the
corresponding checks stay silent rather than guessing. The manifest
file is the one filesystem input a rule reads (it is declared config,
like the ORDER001 pair table — fixtures carry their own).
"""

from __future__ import annotations

import ast
import os
from typing import Iterator, List, Optional, Sequence, Set

from sentinel_tpu_torch.analysis import project
from sentinel_tpu_torch.analysis.core import Finding, ModuleContext, Rule

MANIFEST_NAME = "counters_catalog.txt"

_ENV_HELPER_PREFIXES = ("_env_",)
_ENV_READ_CALLS = frozenset({"os.environ.get", "os.getenv"})


class RegistryDriftRule(Rule):
    id = "CAT001"
    name = "registry-drift"
    rationale = (
        "counter keys outside CATALOG drop from multihost aggregation "
        "and CATALOG order is the wire format; SENTINEL_* env reads "
        "without a KnobSpec ship typos silently and read-site clamps "
        "must match the registry")

    def prepare(self, contexts: Sequence[ModuleContext]) -> None:
        self._index = project.shared_index(contexts)
        self._manifest: Optional[List[str]] = None
        decl = self._index.counters
        if decl is not None:
            path = os.path.join(os.path.dirname(decl.path) or ".",
                                MANIFEST_NAME)
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    self._manifest = [ln.strip() for ln in fh
                                      if ln.strip()
                                      and not ln.startswith("#")]
            except OSError:
                self._manifest = None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        index = getattr(self, "_index", None)
        if index is None:
            self.prepare([ctx])
            index = self._index
        decl = index.counters
        if decl is not None and ctx.path == decl.path:
            yield from self._check_manifest(ctx, decl)
        if decl is not None:
            yield from self._check_counter_keys(ctx, index, decl)
        if index.knobs is not None:
            yield from self._check_env_reads(ctx, index)

    # ------------------------------------------------------------------
    # CATALOG vs manifest
    # ------------------------------------------------------------------
    def _check_manifest(self, ctx: ModuleContext,
                        decl: project.CounterDecl) -> Iterator[Finding]:
        if self._manifest is None:
            yield self.finding(
                ctx, decl.node,
                "CATALOG has no checked-in manifest (%s next to this "
                "module) — the append-only wire order is unenforceable "
                "without it; write one line per key, in order"
                % MANIFEST_NAME)
            return
        for i, key in enumerate(self._manifest):
            if i >= len(decl.catalog):
                yield self.finding(
                    ctx, decl.node,
                    "CATALOG lost manifest key '%s' (entry %d) — the "
                    "catalog is append-only; removing or reordering "
                    "keys corrupts mixed-version counter vectors"
                    % (key, i))
                return
            if decl.catalog[i] != key:
                yield self.finding(
                    ctx, decl.node,
                    "CATALOG order diverges from the manifest at entry "
                    "%d: manifest has '%s', CATALOG has '%s' — the "
                    "catalog is append-only (new keys go LAST, and "
                    "into the manifest)" % (i, key, decl.catalog[i]))
                return
        for key in decl.catalog[len(self._manifest):]:
            yield self.finding(
                ctx, decl.node,
                "CATALOG key '%s' is not in the manifest — append it "
                "to %s in the same change (the manifest is the "
                "reviewed wire order)" % (key, MANIFEST_NAME))

    # ------------------------------------------------------------------
    # counter API call sites
    # ------------------------------------------------------------------
    def _check_counter_keys(self, ctx: ModuleContext,
                            index: project.ProjectIndex,
                            decl: project.CounterDecl) -> Iterator[Finding]:
        catalog = set(decl.catalog)
        aliases = _counter_aliases(ctx)
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr == "add" and node.args):
                continue
            if not _is_counter_receiver(ctx, node.func.value, aliases):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.BinOp):
                # PREFIX + dynamic: fine when the prefix is declared
                left = index.resolve_string(ctx, arg.left)
                if left is not None and left not in decl.prefixes \
                        and not left.endswith("."):
                    yield self.finding(
                        ctx, node,
                        "counter key built from '%s' which is not a "
                        "declared dynamic prefix (constants ending "
                        "'.') — dynamic keys drop from multihost "
                        "aggregation" % left)
                continue
            key = index.resolve_string(ctx, arg)
            if key is None:
                continue
            if key not in catalog and \
                    not any(key.startswith(p) for p in decl.prefixes):
                yield self.finding(
                    ctx, node,
                    "counter key '%s' is not in counters.CATALOG — "
                    "it will silently drop from the multihost "
                    "aggregation vector; append it to CATALOG (and "
                    "the manifest)" % key)

    # ------------------------------------------------------------------
    # SENTINEL_* env reads
    # ------------------------------------------------------------------
    def _check_env_reads(self, ctx: ModuleContext,
                         index: project.ProjectIndex) -> Iterator[Finding]:
        knobs = index.knobs
        if ctx.path == knobs.path:
            return                      # the registry defines, not reads
        known: Set[str] = (set(knobs.specs) | knobs.operational
                           | index.config_field_envs)
        for node in ast.walk(ctx.tree):
            key = None
            clamp = None
            if isinstance(node, ast.Call):
                name = ctx.call_name(node)
                bare = node.func.id if isinstance(node.func, ast.Name) \
                    else None
                if name in _ENV_READ_CALLS and node.args:
                    key = index.resolve_string(ctx, node.args[0])
                elif bare is not None and \
                        bare.startswith(_ENV_HELPER_PREFIXES) and node.args:
                    key = index.resolve_string(ctx, node.args[0])
                    if key is not None and len(node.args) >= 4:
                        lo = project.const_eval(node.args[2])
                        hi = project.const_eval(node.args[3])
                        if lo is not None and hi is not None:
                            clamp = (lo, hi)
            elif isinstance(node, ast.Subscript) and \
                    ctx.dotted(node.value) == "os.environ":
                key = index.resolve_string(ctx, node.slice)
            if key is None or not key.startswith("SENTINEL_"):
                continue
            if key not in known:
                yield self.finding(
                    ctx, node,
                    "env knob '%s' is read here but declared nowhere — "
                    "add a KnobSpec (tunable) or OPERATIONAL_ENVS entry "
                    "(operational) in tune/knobs.py, or typos of it "
                    "ship silently" % key)
                continue
            spec = knobs.specs.get(key)
            if clamp is not None and spec is not None and \
                    None not in spec and clamp != spec:
                yield self.finding(
                    ctx, node,
                    "read-site clamp [%s, %s] for '%s' disagrees with "
                    "its KnobSpec [%s, %s] in tune/knobs.py — one of "
                    "them is lying to the autotuner" % (
                        clamp[0], clamp[1], key, spec[0], spec[1]))


# ----------------------------------------------------------------------

def _counter_aliases(ctx: ModuleContext) -> Set[str]:
    """Local names bound from a ``.counters`` attribute chain:
    ``counters = self._obs.counters`` → ``counters``."""
    out: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Attribute) and \
                node.value.attr == "counters":
            out.add(node.targets[0].id)
    return out


def _is_counter_receiver(ctx: ModuleContext, recv: ast.AST,
                         aliases: Set[str]) -> bool:
    if isinstance(recv, ast.Name):
        return recv.id == "counters" or recv.id in aliases
    dotted = ctx.dotted(recv)
    return dotted is not None and dotted.rsplit(".", 1)[-1] == "counters"
