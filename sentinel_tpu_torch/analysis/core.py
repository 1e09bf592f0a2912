"""graftlint core: findings, suppressions, and the per-module analysis context.

The engine is deliberately self-hosted on stdlib ``ast`` + ``tokenize`` —
no third-party linter framework. Rules receive a :class:`ModuleContext`
(parsed tree + import alias map + raw source) and yield :class:`Finding`
objects; the engine then applies per-line suppression comments and emits
meta-findings for malformed or stale suppressions so the baseline can only
ratchet down.

Suppression syntax (one physical line, reason REQUIRED)::

    risky_call()  # graftlint: disable=ASYNC001 -- bounded 1ms sleep at startup

A suppression comment on a line of its own applies to the next code line::

    # graftlint: disable=LOCK001 -- single-writer by construction (boot thread)
    _REGISTRY["x"] = 1
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

#: Meta rule ids emitted by the engine itself (not suppressible).
MALFORMED_SUPPRESSION = "GL000"
UNUSED_SUPPRESSION = "GL002"
PARSE_ERROR = "GL999"

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_,\s]+?)"
    r"(?:\s+--\s+(.+?))?\s*$")


@dataclasses.dataclass
class Finding:
    """One diagnostic at a source location."""

    rule_id: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    suppress_reason: str = ""
    baselined: bool = False        # matched a --baseline entry

    @property
    def sort_key(self) -> Tuple[str, int, int, str]:
        return (self.path, self.line, self.col, self.rule_id)

    @property
    def active(self) -> bool:
        """Counts against the zero-unsuppressed CI gate."""
        return not self.suppressed and not self.baselined

    def to_dict(self) -> dict:
        return {
            "rule": self.rule_id,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "suppressed": self.suppressed,
            "suppress_reason": self.suppress_reason,
            "baselined": self.baselined,
        }

    def format(self) -> str:
        tag = ""
        if self.suppressed:
            tag = " [suppressed: %s]" % self.suppress_reason
        elif self.baselined:
            tag = " [baselined]"
        return "%s:%d:%d: %s %s%s" % (
            self.path, self.line, self.col, self.rule_id, self.message, tag)


@dataclasses.dataclass
class Suppression:
    """One parsed ``# graftlint: disable=...`` comment."""

    comment_line: int          # line the comment sits on
    target_line: int           # code line the suppression governs
    rule_ids: Tuple[str, ...]
    reason: str
    used: bool = False


class Rule:
    """Base class for graftlint rules.

    Subclasses set ``id``/``name``/``rationale`` and implement
    :meth:`check`, yielding findings. Keep rules pure functions of the
    :class:`ModuleContext` — no filesystem or interpreter-state access —
    so fixtures and real modules analyze identically.
    """

    id: str = "GL???"
    name: str = ""
    rationale: str = ""

    def prepare(self, contexts: Sequence["ModuleContext"]) -> None:
        """Optional whole-run pre-pass over every module being analyzed.

        Lets a rule gather *cross-module* facts before per-module checks
        run — e.g. TRACE001 records which imported functions a module
        passes to ``torch.compile`` so the defining module scans them as
        device-step code. Called exactly once per analysis run, before any
        :meth:`check`; instance state set here is overwritten on the next
        run.
        """

    def check(self, ctx: "ModuleContext") -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "ModuleContext", node: ast.AST,
                message: str) -> Finding:
        return Finding(self.id, ctx.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


class ModuleContext:
    """Parsed module plus the name-resolution helpers every rule needs."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.aliases = _collect_aliases(tree)

    @property
    def module_name(self) -> str:
        """Dotted module name derived from the file path (best effort:
        correct when analysis runs from the repo root, and cross-module
        consumers suffix-match so absolute paths still resolve)."""
        p = self.path
        if p.endswith(".py"):
            p = p[:-3]
        if p.endswith("/__init__") or p.endswith("\\__init__"):
            p = p[:-9]
        return p.replace("\\", "/").strip("/").replace("/", ".")

    # ------------------------------------------------------------------
    def dotted(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a Name/Attribute chain, aliases expanded.

        ``F.relu`` → ``torch.nn.functional.relu`` (given ``import
        torch.nn.functional as F``); ``self._lock`` → ``self._lock``; non-name expressions
        (calls, subscripts) terminate the chain → None.
        """
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    def call_name(self, call: ast.Call) -> Optional[str]:
        return self.dotted(call.func)


def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
    """alias → fully-qualified dotted prefix, from every import statement
    in the module (function-local imports included: rules care about what
    a name *means*, not where it was bound)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = ("." * node.level) + (node.module or "")
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{mod}.{a.name}" if mod else a.name
    return out


# ----------------------------------------------------------------------
# Suppressions
# ----------------------------------------------------------------------

def parse_suppressions(path: str, source: str,
                       known_rule_ids: Sequence[str],
                       ) -> Tuple[List[Suppression], List[Finding]]:
    """Scan ``source`` for graftlint suppression comments.

    Returns (suppressions, meta_findings). A comment with no ``-- reason``
    tail, an empty rule list, or an unknown rule id yields a GL000
    meta-finding and the suppression is NOT honored.
    """
    sups: List[Suppression] = []
    meta: List[Finding] = []
    lines = source.splitlines()
    known = set(known_rule_ids)
    for i, col, text in _iter_comments(source):
        m = _SUPPRESS_RE.search(text)
        if not m:
            if "graftlint:" in text:
                meta.append(Finding(
                    MALFORMED_SUPPRESSION, path, i, 0,
                    "unparseable graftlint comment (expected "
                    "'# graftlint: disable=<RULE,...> -- <reason>')"))
            continue
        rule_ids = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = (m.group(2) or "").strip()
        if not reason:
            meta.append(Finding(
                MALFORMED_SUPPRESSION, path, i, 0,
                "suppression missing required reason "
                "('# graftlint: disable=%s -- <why>')" % ",".join(rule_ids)))
            continue
        unknown = [r for r in rule_ids if r not in known]
        if unknown or not rule_ids:
            meta.append(Finding(
                MALFORMED_SUPPRESSION, path, i, 0,
                "suppression names unknown rule id(s): %s"
                % (", ".join(unknown) or "<none>")))
            continue
        target = i
        if not lines[i - 1][:col].strip():
            # comment on a line of its own: governs the next code line
            target = _next_code_line(lines, i)
        sups.append(Suppression(i, target, rule_ids, reason))
    return sups, meta


def _iter_comments(source: str):
    """(line, col, comment_text) for every real COMMENT token — string
    literals that merely *mention* graftlint syntax don't count."""
    import io
    import tokenize
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.start[1], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return


def _next_code_line(lines: List[str], after: int) -> int:
    for j in range(after, len(lines)):
        s = lines[j].strip()            # lines[j] is line j+1
        if s and not s.startswith("#"):
            return j + 1
    return after  # trailing comment: governs nothing real


# ----------------------------------------------------------------------
# Per-module analysis
# ----------------------------------------------------------------------

def analyze_source(path: str, source: str,
                   rules: Sequence[Rule]) -> List[Finding]:
    """Run ``rules`` over one module's source (single-module convenience:
    cross-module ``prepare`` sees just this file)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(PARSE_ERROR, path, exc.lineno or 1,
                        exc.offset or 0, "syntax error: %s" % exc.msg)]
    ctx = ModuleContext(path, source, tree)
    for rule in rules:
        rule.prepare([ctx])
    return _check_module(ctx, rules)


def _registry_rule_ids() -> List[str]:
    """Every registered rule id + the meta ids — suppression comments
    are validated against the FULL registry, not the (possibly
    ``--rule``-filtered) active set, so a subset run never misreads a
    valid suppression as naming an unknown rule."""
    from sentinel_tpu_torch.analysis.rules import RULES_BY_ID
    return list(RULES_BY_ID)


def _check_module(ctx: ModuleContext,
                  rules: Sequence[Rule]) -> List[Finding]:
    """Per-module rule run + suppression application + meta-findings
    (malformed/unused suppressions). ``prepare`` must already have run."""
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.check(ctx))

    sups, meta = parse_suppressions(ctx.path, ctx.source,
                                    _registry_rule_ids())
    by_line: Dict[int, List[Suppression]] = {}
    for s in sups:
        by_line.setdefault(s.target_line, []).append(s)
    for f in findings:
        for s in by_line.get(f.line, ()):
            if f.rule_id in s.rule_ids:
                f.suppressed = True
                f.suppress_reason = s.reason
                s.used = True
    active_ids = {r.id for r in rules}
    for s in sups:
        # a suppression whose rules were all filtered out this run
        # (``--rule`` subset) cannot have been consumed — not "unused"
        if not s.used and set(s.rule_ids) & active_ids:
            meta.append(Finding(
                UNUSED_SUPPRESSION, ctx.path, s.comment_line, 0,
                "unused suppression for %s (finding fixed? delete the "
                "comment so the baseline ratchets down)"
                % ",".join(s.rule_ids)))
    findings.extend(meta)
    findings.sort(key=lambda f: f.sort_key)
    return findings


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    import os
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", ".git", "node_modules"))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)
        elif p.endswith(".py"):
            yield p


def parse_contexts(files: Iterable[str]):
    """Parse every file into a ModuleContext. Returns ``(contexts,
    errors)`` where errors are GL999 findings for unreadable/unparsable
    files. The context list is a :class:`~.project.ContextSet` so the
    pass-1 project index built by the first rule's ``prepare`` is
    shared by the rest (and by parallel workers, per process)."""
    from sentinel_tpu_torch.analysis.project import ContextSet
    errors: List[Finding] = []
    contexts = ContextSet()
    for fp in files:
        try:
            with open(fp, "r", encoding="utf-8") as fh:
                source = fh.read()
        except (OSError, UnicodeDecodeError) as exc:
            errors.append(Finding(PARSE_ERROR, fp, 1, 0,
                                  "unreadable: %s" % exc))
            continue
        try:
            tree = ast.parse(source, filename=fp)
        except SyntaxError as exc:
            errors.append(Finding(PARSE_ERROR, fp, exc.lineno or 1,
                                  exc.offset or 0,
                                  "syntax error: %s" % exc.msg))
            continue
        contexts.append(ModuleContext(fp, source, tree))
    return contexts, errors


def check_context(ctx: ModuleContext,
                  rules: Sequence[Rule]) -> List[Finding]:
    """Pass-2 for one already-prepared module (the per-file unit the
    ``--jobs`` worker pool distributes)."""
    return _check_module(ctx, rules)


def analyze_paths(paths: Iterable[str],
                  rules: Sequence[Rule]) -> List[Finding]:
    """Whole-run analysis: parse every module first, give each rule its
    cross-module ``prepare`` pass over all of them, then check each."""
    contexts, out = parse_contexts(iter_python_files(paths))
    for rule in rules:
        rule.prepare(contexts)
    for ctx in contexts:
        out.extend(_check_module(ctx, rules))
    return out
