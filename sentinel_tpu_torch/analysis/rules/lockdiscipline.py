"""LOCK002 — inferred lock discipline for instance attributes.

The fast path's over-admission race had exactly this shape: ``_seen_idx``
was *written* under ``self._lock`` everywhere (the discipline is
obvious from the code), but one fast-path flush *read* it outside the
lock, and a decide landing between that read and the locked restamp
resurrected spent admission budget mid-window. The discipline was
real — it just wasn't checkable. This rule makes it checkable by
inference instead of annotation:

1. For every class, collect each ``self.<attr>`` store and the set of
   locks held at that point (pass 1, :mod:`..project`). An attribute
   written under the same ``self.*`` lock in **≥ 2 distinct sites**
   (outside ``__init__``) is treated as lock-guarded — two locked
   writes are the author declaring a discipline, not a coincidence.
2. Every read or write of a guarded attribute that holds *none* of the
   attribute's guard locks is flagged — but only in methods reachable
   from a thread entry point (``threading.Thread(target=...)``,
   ``Timer``, ``executor.submit``, ``asyncio.to_thread``,
   ``run_in_executor``, ``run`` of a Thread subclass), closed over the
   project's name-based call graph. A class no thread can reach is
   single-threaded by construction and stays silent.

Escape hatches (both are *documented contracts*, not suppressions):
a method named ``*_locked`` or whose docstring declares "callers hold
``_lock``" is treated as running under the lock — the repo's existing
idiom for helpers with a locking precondition. Anything else needs a
``# graftlint: disable=LOCK002 -- <why>`` with the actual argument for
why the unlocked access is safe (seqlock read, monotonic flag, ...).

Known limitations: the guard inference is name-based per class (two
locks with the same attribute name in different classes are distinct,
but re-entrant acquisition through a helper is invisible); reachability
is call-graph-by-name, so a method name shared with an unrelated
threaded function is conservatively treated as reachable.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Set

from sentinel_tpu_torch.analysis import project
from sentinel_tpu_torch.analysis.core import Finding, ModuleContext, Rule

#: Locked-write sites required before an attribute counts as guarded.
MIN_GUARDED_WRITES = 2


class LockDisciplineRule(Rule):
    id = "LOCK002"
    name = "guarded-attribute-accessed-outside-lock"
    rationale = (
        "an attribute written under self._lock in 2+ sites has an "
        "inferred lock discipline; reading or writing it without the "
        "lock from thread-reachable code is the fast-path over-admission "
        "race shape")

    def prepare(self, contexts) -> None:
        self._index = project.shared_index(contexts)

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        index = getattr(self, "_index", None)
        if index is None:
            index = project.shared_index([ctx])
        for cls in index.classes_in(ctx.path):
            yield from self._check_class(ctx, index, cls)

    # ------------------------------------------------------------------
    def _check_class(self, ctx: ModuleContext, index: project.ProjectIndex,
                     cls: project.ClassIndex) -> Iterator[Finding]:
        guards = self._guarded_attrs(cls)
        if not guards:
            return
        contract = cls.lock_contract_methods()
        reachable = index.thread_reachable
        for acc in cls.accesses:
            locks = guards.get(acc.attr)
            if locks is None:
                continue
            if acc.method in project.CONSTRUCTION_METHODS or \
                    acc.method in contract:
                continue
            if acc.locks_held & locks:
                continue
            if acc.method not in reachable:
                continue
            yield self.finding(
                ctx, acc.node,
                "'self.%s' %s outside %s in thread-reachable method "
                "'%s.%s' — %d locked write site(s) establish the lock "
                "discipline; hold the lock here or document the "
                "contract (method docstring / *_locked name)" % (
                    acc.attr,
                    "written" if acc.is_store else "read",
                    " / ".join("self.%s" % l for l in sorted(locks)),
                    cls.name, acc.method,
                    self._site_counts[acc.attr]))

    def _guarded_attrs(self, cls: project.ClassIndex) -> Dict[str, Set[str]]:
        """attr → guard-lock names, for attrs with ≥2 locked writes."""
        locked_sites: Dict[str, List] = {}
        locks_of: Dict[str, Set[str]] = {}
        for acc in cls.accesses:
            low = acc.attr.lower()
            if "lock" in low or "mutex" in low or "semaphore" in low:
                continue                      # locks themselves never flag
            if acc.is_store and acc.locks_held and \
                    acc.method not in project.CONSTRUCTION_METHODS:
                locked_sites.setdefault(acc.attr, []).append(acc.node)
                locks_of.setdefault(acc.attr, set()).update(acc.locks_held)
        self._site_counts = {a: len(s) for a, s in locked_sites.items()}
        return {a: locks_of[a] for a, sites in locked_sites.items()
                if len(sites) >= MIN_GUARDED_WRITES}
