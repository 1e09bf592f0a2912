"""graftlint CLI for the port.

``python -m sentinel_tpu_torch.analysis sentinel_tpu_torch/ chip_smoke.py
tests/test_torch_*.py demos/torch/ --exclude tests/fixtures/graftlint`` —
exit 0 iff zero unsuppressed findings (the port's CI gate). See
``docs/LINT_TORCH.md``.

Exit codes: 0 clean, 1 unsuppressed findings, 2 usage error,
3 ``--budget-s`` wall-time budget exceeded (findings still reported).

``--jobs N`` fans pass-2 (per-file checks) over a process pool. Pass 1
(the cross-module project index) needs every module, so each worker
parses the full file set once in its initializer and runs every rule's
``prepare`` — the index is then shared across all files that worker
checks. Findings are order-merged so ``--jobs N`` output is
byte-identical to ``--jobs 1``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional

from sentinel_tpu_torch.analysis import core, reporting
from sentinel_tpu_torch.analysis.rules import ALL_RULES, RULES_BY_ID


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m sentinel_tpu_torch.analysis",
        description="graftlint for the PyTorch port: AST static analysis "
                    "for collective, host-sync, concurrency, and "
                    "device-contract safety")
    p.add_argument("paths", nargs="*",
                   help="files or directories to analyze")
    p.add_argument("--select", metavar="IDS",
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--rule", metavar="ID", action="append", default=[],
                   help="run only this rule id (repeatable; combines "
                        "with --select)")
    p.add_argument("--ignore", metavar="IDS",
                   help="comma-separated rule ids to skip")
    p.add_argument("--exclude", metavar="PATHFRAG", action="append",
                   default=[],
                   help="skip files whose path contains this fragment "
                        "(repeatable; e.g. tests/fixtures/graftlint)")
    p.add_argument("--jobs", type=int, default=1, metavar="N",
                   help="parallel per-file analysis processes sharing "
                        "the pass-1 project index (default: 1)")
    p.add_argument("--format", choices=("human", "json"), default="human")
    p.add_argument("--json-out", metavar="FILE",
                   help="also write the JSON report to FILE")
    p.add_argument("--sarif-out", metavar="FILE",
                   help="also write a SARIF 2.1.0 report to FILE "
                        "(GitHub code scanning)")
    p.add_argument("--baseline", metavar="FILE",
                   help="demote findings matching this baseline file "
                        "(path+rule+message multiset) to non-gating")
    p.add_argument("--write-baseline", metavar="FILE",
                   help="record current unsuppressed findings as the "
                        "baseline and exit 0")
    p.add_argument("--budget-s", type=float, metavar="SECONDS",
                   help="fail (exit 3) when analysis wall time exceeds "
                        "this budget — keeps the CI quick tier honest")
    p.add_argument("--show-suppressed", action="store_true",
                   help="print suppressed/baselined findings too "
                        "(human format)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


# ----------------------------------------------------------------------
# --jobs worker pool (module-level for picklability under spawn)
# ----------------------------------------------------------------------

_WORKER: dict = {}


def _worker_init(files: List[str], rule_ids: List[str]) -> None:
    contexts, errors = core.parse_contexts(files)
    rules = [RULES_BY_ID[i] for i in rule_ids]
    for rule in rules:
        rule.prepare(contexts)
    _WORKER["contexts"] = {ctx.path: ctx for ctx in contexts}
    _WORKER["errors"] = errors
    _WORKER["rules"] = rules


def _worker_check(path: str) -> List[core.Finding]:
    ctx = _WORKER["contexts"].get(path)
    if ctx is None:
        return [e for e in _WORKER["errors"] if e.path == path]
    return core.check_context(ctx, _WORKER["rules"])


def _analyze(files: List[str], rules, jobs: int) -> List[core.Finding]:
    if jobs <= 1 or len(files) < 2:
        return core.analyze_paths(files, rules)
    import concurrent.futures as cf
    import multiprocessing as mp
    rule_ids = [r.id for r in rules]
    try:
        mp_ctx = mp.get_context("fork")
    except ValueError:
        mp_ctx = None
    pool_kw = {"max_workers": min(jobs, len(files))}
    if mp_ctx is not None:
        # build the pass-1 index ONCE in the parent; forked workers
        # inherit it copy-on-write, so only pass 2 is distributed
        _worker_init(files, rule_ids)
        pool_kw["mp_context"] = mp_ctx
    else:
        pool_kw["initializer"] = _worker_init
        pool_kw["initargs"] = (files, rule_ids)
    findings: List[core.Finding] = []
    with cf.ProcessPoolExecutor(**pool_kw) as pool:
        for per_file in pool.map(_worker_check, files, chunksize=4):
            findings.extend(per_file)
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print("%s  %s\n    %s" % (r.id, r.name, r.rationale))
        return 0

    select = {s.strip() for s in (args.select or "").split(",") if s.strip()}
    for rid in args.rule:
        select |= {s.strip() for s in rid.split(",") if s.strip()}
    ignore = {s.strip() for s in (args.ignore or "").split(",") if s.strip()}
    unknown = (select | ignore) - set(RULES_BY_ID)
    if unknown:
        print("unknown rule id(s): %s" % ", ".join(sorted(unknown)),
              file=sys.stderr)
        return 2
    rules = [r for r in ALL_RULES
             if (not select or r.id in select) and r.id not in ignore]

    if not args.paths:
        print("error: no paths given (try: python -m "
              "sentinel_tpu_torch.analysis sentinel_tpu_torch/)",
              file=sys.stderr)
        return 2

    files = list(dict.fromkeys(core.iter_python_files(args.paths)))
    if args.exclude:
        norm = [frag.replace("\\", "/") for frag in args.exclude]
        files = [f for f in files
                 if not any(frag in f.replace("\\", "/") for frag in norm)]
    if not files:
        print("error: no Python files under %s" % ", ".join(args.paths),
              file=sys.stderr)
        return 2

    t0 = time.monotonic()
    findings = _analyze(files, rules, args.jobs)
    findings.sort(key=lambda f: f.sort_key)
    elapsed = time.monotonic() - t0

    if args.write_baseline:
        n = reporting.write_baseline(findings, args.write_baseline)
        print("graftlint: wrote %d baseline entries to %s"
              % (n, args.write_baseline))
        return 0
    stale = 0
    if args.baseline:
        try:
            _, stale = reporting.apply_baseline(findings, args.baseline)
        except (OSError, ValueError, KeyError) as exc:
            print("error: cannot read baseline %s: %s"
                  % (args.baseline, exc), file=sys.stderr)
            return 2

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            fh.write(reporting.render_json(findings, len(files)) + "\n")
    if args.sarif_out:
        with open(args.sarif_out, "w", encoding="utf-8") as fh:
            fh.write(reporting.render_sarif(findings, rules) + "\n")
    if args.format == "json":
        print(reporting.render_json(findings, len(files)))
    else:
        reporting.render_human(findings, sys.stdout,
                               show_suppressed=args.show_suppressed)
        if stale:
            print("graftlint: %d stale baseline entr%s (fixed findings "
                  "— delete them so the baseline ratchets down)"
                  % (stale, "y" if stale == 1 else "ies"))

    if args.budget_s is not None and elapsed > args.budget_s:
        print("graftlint: wall time %.1fs exceeded --budget-s %.1fs"
              % (elapsed, args.budget_s), file=sys.stderr)
        return 3
    active, _ = reporting.split_findings(findings)
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
