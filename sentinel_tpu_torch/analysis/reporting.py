"""graftlint reporters: human text, machine JSON, SARIF 2.1.0, and the
baseline ratchet.

The documents name the tool ``graftlint`` as the reference's do, so a
reader of either package's report sees one schema; the rule help links
point at ``docs/LINT_TORCH.md``.

SARIF is the GitHub code-scanning ingestion format — the port's CI lint
job uploads ``graftlint-torch.sarif`` so findings annotate pull-request diffs inline.
Suppressed findings ship with a SARIF ``suppressions`` entry (kind
``inSource``) and baselined findings with ``baselineState:
"unchanged"`` so code scanning shows both without failing the run.

The baseline (``--baseline graftlint-torch-baseline.json``) exists for scope
widening: pre-existing findings in test/bench files are recorded once
(``--write-baseline``) and matched by ``(path, rule, message)``
multiset — line numbers are deliberately NOT part of the fingerprint so
unrelated edits don't churn it. New findings never match and still fail
the gate; fixed findings leave stale entries that the report counts so
the baseline only ratchets down.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, List, Sequence, TextIO, Tuple

from sentinel_tpu_torch.analysis.core import Finding

BASELINE_VERSION = 1
SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def split_findings(findings: Sequence[Finding]):
    """(active, muted): muted = suppressed in source OR baselined."""
    active = [f for f in findings if f.active]
    muted = [f for f in findings if not f.active]
    return active, muted


def render_human(findings: Sequence[Finding], stream: TextIO,
                 show_suppressed: bool = False) -> None:
    active, muted = split_findings(findings)
    for f in active:
        stream.write(f.format() + "\n")
    if show_suppressed:
        for f in muted:
            stream.write(f.format() + "\n")
    by_rule: Dict[str, int] = {}
    for f in active:
        by_rule[f.rule_id] = by_rule.get(f.rule_id, 0) + 1
    summary = ", ".join("%s=%d" % kv for kv in sorted(by_rule.items()))
    n_sup = sum(1 for f in muted if f.suppressed)
    n_base = sum(1 for f in muted if f.baselined)
    base_tag = ", %d baselined" % n_base if n_base else ""
    stream.write(
        "graftlint: %d finding(s)%s, %d suppressed%s\n"
        % (len(active), " (%s)" % summary if summary else "",
           n_sup, base_tag))


def render_json(findings: Sequence[Finding], files_scanned: int) -> str:
    active, muted = split_findings(findings)
    return json.dumps({
        "tool": "graftlint",
        "version": 1,
        "files_scanned": files_scanned,
        "unsuppressed_count": len(active),
        "suppressed_count": sum(1 for f in muted if f.suppressed),
        "baselined_count": sum(1 for f in muted if f.baselined),
        "findings": [f.to_dict() for f in findings],
    }, indent=2, sort_keys=False)


# ----------------------------------------------------------------------
# SARIF 2.1.0
# ----------------------------------------------------------------------

def _sarif_uri(path: str) -> str:
    p = path.replace("\\", "/")
    while p.startswith("./"):
        p = p[2:]
    return p


def render_sarif(findings: Sequence[Finding], rules) -> str:
    """One-run SARIF document. ``rules`` is the rule instances that ran
    (their id/name/rationale become the tool's rule metadata, which
    GitHub renders in the finding details pane)."""
    rule_meta = [{
        "id": r.id,
        "name": r.name or r.id,
        "shortDescription": {"text": r.name or r.id},
        "fullDescription": {"text": r.rationale or r.name or r.id},
        "helpUri": "https://github.com/sentinel-tpu/sentinel-tpu/blob/"
                   "main/docs/LINT_TORCH.md",
        "defaultConfiguration": {"level": "error"},
    } for r in rules]
    rule_index = {m["id"]: i for i, m in enumerate(rule_meta)}
    results = []
    for f in findings:
        res = {
            "ruleId": f.rule_id,
            "level": "error" if f.active else "note",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": _sarif_uri(f.path),
                        "uriBaseId": "%SRCROOT%",
                    },
                    "region": {
                        "startLine": max(f.line, 1),
                        "startColumn": max(f.col, 0) + 1,
                    },
                },
            }],
        }
        if f.rule_id in rule_index:
            res["ruleIndex"] = rule_index[f.rule_id]
        if f.suppressed:
            res["suppressions"] = [{
                "kind": "inSource",
                "justification": f.suppress_reason,
            }]
        if f.baselined:
            res["baselineState"] = "unchanged"
        results.append(res)
    return json.dumps({
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri": "https://github.com/sentinel-tpu/"
                                  "sentinel-tpu/blob/main/docs/LINT_TORCH.md",
                "semanticVersion": "2.0.0",
                "rules": rule_meta,
            }},
            "columnKind": "utf16CodeUnits",
            "results": results,
        }],
    }, indent=2)


# ----------------------------------------------------------------------
# Baseline ratchet
# ----------------------------------------------------------------------

def _fingerprint(f: Finding) -> Tuple[str, str, str]:
    return (_sarif_uri(f.path), f.rule_id, f.message)


def write_baseline(findings: Sequence[Finding], path: str) -> int:
    """Record every currently-unsuppressed finding. Returns the entry
    count. Suppressed findings are NOT baselined — their suppression
    comment already carries the reviewed reason."""
    entries = [{"path": _sarif_uri(f.path), "rule": f.rule_id,
                "message": f.message}
               for f in sorted((f for f in findings if f.active),
                               key=lambda f: f.sort_key)]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"tool": "graftlint", "baseline_version":
                   BASELINE_VERSION, "entries": entries}, fh, indent=2)
        fh.write("\n")
    return len(entries)


def apply_baseline(findings: Sequence[Finding],
                   path: str) -> Tuple[int, int]:
    """Mark findings matching baseline entries as ``baselined``
    in place. Returns ``(matched, stale)`` — stale entries match
    nothing anymore and should be deleted from the baseline file."""
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    budget: Counter = Counter(
        (e["path"], e["rule"], e["message"]) for e in doc.get("entries", ()))
    matched = 0
    for f in findings:
        if not f.active:
            continue
        fp = _fingerprint(f)
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            f.baselined = True
            matched += 1
    stale = sum(budget.values())
    return matched, stale
