"""Port parity: graftlint for the PyTorch port
(``sentinel_tpu_torch.analysis``) against ``sentinel_tpu.analysis``.

Twins of ``tests/test_graftlint.py``. For the framework-free rules
(ASYNC001, LOCK001, LOCK002, ORDER001, CAT001) and the engine
(suppression grammar, the GL meta rules, JSON, SARIF, the baseline
ratchet, the CLI), both analyzers run on the reference's own fixtures
and must give the same findings, field for field. The four rules the
reference keys on JAX names (DEV001, SPMD001, TRACE001, DONATE001) are
keyed on torch's spelling in the port; their fixtures are under
``tests/fixtures/graftlint/torch/`` (inside the path both gates exclude),
each with a true positive, a suppressed case and a negative. Fixture
files are parsed, never imported.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

import sentinel_tpu_torch
from sentinel_tpu.analysis import ALL_RULES as REF_RULES
from sentinel_tpu.analysis import analyze_paths as ref_analyze_paths
from sentinel_tpu.analysis import analyze_source as ref_analyze_source
from sentinel_tpu.analysis import reporting as ref_reporting
from sentinel_tpu_torch.analysis import (
    ALL_RULES, RULES_BY_ID, analyze_paths, analyze_source,
)
from sentinel_tpu_torch.analysis import reporting
from sentinel_tpu_torch.analysis.core import (
    MALFORMED_SUPPRESSION, UNUSED_SUPPRESSION, iter_python_files,
)
from sentinel_tpu_torch.analysis.rules import order as order_rule
from sentinel_tpu_torch.analysis.rules import trace as trace_rule

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "graftlint")
TORCH_FIXTURES = os.path.join(FIXTURES, "torch")
PORT_DIR = os.path.dirname(sentinel_tpu_torch.__file__)

#: The rules whose behaviour the port keeps unchanged.
FRAMEWORK_FREE = ("ASYNC001", "LOCK001", "LOCK002", "ORDER001", "CAT001")

#: The port's lint scope (``docs/LINT_TORCH.md``). LOCK002's reachability
#: closure is whole-program, so the gate is defined over THIS scope.
PORT_SCOPE = ([os.path.join(REPO_ROOT, p)
               for p in ("sentinel_tpu_torch", "chip_smoke.py")]
              + sorted(os.path.join(REPO_ROOT, "tests", f)
                       for f in os.listdir(os.path.join(REPO_ROOT, "tests"))
                       if f.startswith("test_torch_") and f.endswith(".py"))
              + [os.path.join(REPO_ROOT, "demos", "torch")])
EXCLUDE = os.path.join("tests", "fixtures", "graftlint")


def port_scope_files():
    return [f for f in iter_python_files(PORT_SCOPE) if EXCLUDE not in f]


def lint_fixture(name, rules=ALL_RULES):
    return analyze_paths([os.path.join(FIXTURES, name)], rules)


def lint_torch(name, rules=ALL_RULES):
    return analyze_paths([os.path.join(TORCH_FIXTURES, name)], rules)


def both(name):
    """(port findings, reference findings) on a reference fixture."""
    path = os.path.join(FIXTURES, name)
    return analyze_paths([path], ALL_RULES), \
        ref_analyze_paths([path], REF_RULES)


def fields(findings):
    return sorted((f.rule_id, f.path, f.line, f.col, f.message,
                   f.suppressed, f.suppress_reason, f.baselined)
                  for f in findings)


def active(findings, rule_id=None):
    return [f for f in findings
            if not f.suppressed and (rule_id is None or f.rule_id == rule_id)]


def suppressed(findings, rule_id):
    return [f for f in findings if f.suppressed and f.rule_id == rule_id]


def source_line(path, lineno):
    with open(path) as fh:
        return fh.read().splitlines()[lineno - 1]


def torch_line(name, lineno):
    return source_line(os.path.join(TORCH_FIXTURES, name), lineno)


def fixture_line(name, lineno):
    return source_line(os.path.join(FIXTURES, name), lineno)


def _run_cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "sentinel_tpu_torch.analysis", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO_ROOT,
        env={**os.environ, "PYTHONPATH": REPO_ROOT})


def _run_ref_cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "sentinel_tpu.analysis", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO_ROOT,
        env={**os.environ, "PYTHONPATH": REPO_ROOT, "JAX_PLATFORMS": "cpu"})


# ----------------------------------------------------------------------
# The acceptance gate: the port is clean at its own scope
# ----------------------------------------------------------------------

def test_port_is_clean_at_ci_scope():
    findings = analyze_paths(port_scope_files(), ALL_RULES)
    assert active(findings) == [], "\n".join(
        f.format() for f in active(findings))
    # the lock-discipline suppressions carried over from the reference
    # are all consumed (none reads as GL002 at this scope)
    assert len(suppressed(findings, "LOCK002")) >= 14


# ----------------------------------------------------------------------
# The framework-free rules and the engine: equal to the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "async_cases.py", "lock_cases.py", "lock_discipline_cases.py",
    "order_cases.py", "cat_drift", "catproj"])
def test_framework_free_findings_equal_the_reference(name):
    path = os.path.join(FIXTURES, name)
    sub = [RULES_BY_ID[r] for r in FRAMEWORK_FREE]
    ref_sub = [r for r in REF_RULES if r.id in FRAMEWORK_FREE]
    port = analyze_paths([path], sub)
    ref = ref_analyze_paths([path], ref_sub)
    assert ref or name == "catproj"   # the clean mini project is empty
    assert fields(port) == fields(ref)


def test_async001_positive_and_negative():
    findings, ref = both("async_cases.py")
    assert fields(active(findings, "ASYNC001")) == \
        fields(active(ref, "ASYNC001"))
    hits = active(findings, "ASYNC001")
    msgs = " | ".join(f.message for f in hits)
    assert len(hits) == 4
    assert "time.sleep" in msgs
    assert "socket.create_connection" in msgs
    assert "request_tokens" in msgs
    assert "lock held across 'await'" in msgs
    assert len(suppressed(findings, "ASYNC001")) == 1
    for f in hits:
        assert "tn_" not in fixture_line("async_cases.py", f.line)


def test_lock001_positive_and_negative():
    findings, ref = both("lock_cases.py")
    hits = active(findings, "LOCK001")
    assert fields(hits) == fields(active(ref, "LOCK001"))
    assert len(hits) == 2
    assert all("_REGISTRY" in f.message for f in hits)
    assert {("async" in f.message.split("also from")[0])
            for f in hits} == {True, False}
    assert len(suppressed(findings, "LOCK001")) == 2
    assert not any("_SAFE" in f.message for f in hits)


SUPPRESSION_SOURCES = {
    "requires_reason": "import time\nasync def f():\n"
                       "    time.sleep(1)  # graftlint: disable=ASYNC001\n",
    "unknown_rule": "import time\nasync def f():\n"
                    "    time.sleep(1)  # graftlint: disable=NOPE42 -- "
                    "because\n",
    "unused": "x = 1  # graftlint: disable=DEV001 -- stale reason\n",
    "string_literal": 's = "# graftlint: disable=DEV001 -- inside a '
                      'string"\n',
    "standalone": ("import time\n"
                   "async def f():\n"
                   "    # graftlint: disable=ASYNC001 -- startup probe, "
                   "loop idle\n"
                   "    time.sleep(1)\n"
                   "    time.sleep(2)\n"),
}


def _src_both(key):
    src = SUPPRESSION_SOURCES[key]
    port = analyze_source("x.py", src, ALL_RULES)
    assert fields(port) == fields(ref_analyze_source("x.py", src,
                                                     REF_RULES))
    return port


def test_suppression_requires_reason():
    findings = _src_both("requires_reason")
    ids = [f.rule_id for f in findings if not f.suppressed]
    assert MALFORMED_SUPPRESSION in ids
    assert "ASYNC001" in ids


def test_suppression_unknown_rule_rejected():
    findings = _src_both("unknown_rule")
    assert any(f.rule_id == MALFORMED_SUPPRESSION and "NOPE42" in f.message
               for f in findings)


def test_unused_suppression_flagged_for_ratchet():
    findings = _src_both("unused")
    assert [f.rule_id for f in findings] == [UNUSED_SUPPRESSION]


def test_string_literals_are_not_suppressions():
    assert _src_both("string_literal") == []


def test_standalone_comment_governs_next_code_line():
    findings = _src_both("standalone")
    a = [f for f in findings if f.rule_id == "ASYNC001"]
    assert [f.suppressed for f in sorted(a, key=lambda f: f.line)] == \
        [True, False]


def test_rule_catalog_is_stable():
    assert set(RULES_BY_ID) == {r.id for r in REF_RULES} == {
        "SPMD001", "DEV001", "TRACE001", "ASYNC001", "LOCK001",
        "LOCK002", "DONATE001", "ORDER001", "CAT001"}
    assert [r.id for r in ALL_RULES] == [r.id for r in REF_RULES]
    for rule in ALL_RULES:
        assert rule.name and rule.rationale


def test_lock002_flags_unlocked_read_in_thread_reachable_method():
    findings, ref = both("lock_discipline_cases.py")
    hits = active(findings, "LOCK002")
    assert fields(hits) == fields(active(ref, "LOCK002"))
    assert len(hits) == 1
    assert "_seen_idx" in hits[0].message and "_poll" in hits[0].message
    assert "self._seen_idx" in fixture_line("lock_discipline_cases.py",
                                            hits[0].line)


def test_lock002_escape_hatches_stay_silent():
    findings, ref = both("lock_discipline_cases.py")
    sup = suppressed(findings, "LOCK002")
    assert len(sup) == 1 and "_audit" in sup[0].message
    all_lock002 = [f for f in findings if f.rule_id == "LOCK002"]
    assert fields(all_lock002) == fields(
        [f for f in ref if f.rule_id == "LOCK002"])
    assert len(all_lock002) == 2
    assert not any("SingleWriterIsClean" in f.message for f in all_lock002)


def test_order001_flags_free_before_intent_in_locked_region():
    findings, ref = both("order_cases.py")
    hits = active(findings, "ORDER001")
    assert fields(hits) == fields(active(ref, "ORDER001"))
    assert len(hits) == 2
    for f in hits:
        assert "evict_name" in f.message
        assert "record intent BEFORE freeing" in f.message
    assert len(suppressed(findings, "ORDER001")) == 1


def test_order001_intent_first_and_unlocked_are_silent():
    findings = lint_fixture("order_cases.py")
    lines = {fixture_line("order_cases.py", f.line)
             for f in active(findings, "ORDER001")}
    assert not any("intent recorded first" in ln for ln in lines)
    assert not any("not a locked region" in ln for ln in lines)


def test_order001_pairs_name_the_ports_tiering_protocol():
    """The pair table names the free primitive and the intent structures
    the port's tiering manager uses, and that code records its intent
    before the free (clean under the rule)."""
    path = os.path.join(PORT_DIR, "tiering", "manager.py")
    with open(path) as fh:
        src = fh.read()
    assert order_rule.DEFAULT_PAIRS["evict_name"] == (
        "_pending_demote", "_shadow")
    for name in ("evict_name", "self._pending_demote[row]",
                 "self._shadow"):
        assert name in src
    rule = RULES_BY_ID["ORDER001"]
    assert [f for f in analyze_paths([path], [rule])
            if not f.suppressed] == []


def test_cat001_clean_mini_project_is_silent():
    findings, ref = both("catproj")
    assert active(findings, "CAT001") == [] == active(ref, "CAT001")


def test_cat001_flags_all_four_drift_shapes():
    findings, ref = both("cat_drift")
    assert fields([f for f in findings if f.rule_id == "CAT001"]) == \
        fields([f for f in ref if f.rule_id == "CAT001"])
    msgs = [f.message for f in active(findings, "CAT001")]
    assert len(msgs) == 4
    assert any("'entry.typo' is not in counters.CATALOG" in m for m in msgs)
    assert any("'tier.promoted' is not in the manifest" in m for m in msgs)
    assert any("'SENTINEL_CAT_MISSING' is read here but declared nowhere"
               in m for m in msgs)
    assert any("clamp [1, 128]" in m and "KnobSpec [1, 64]" in m
               for m in msgs)
    assert len(suppressed(findings, "CAT001")) == 1


def test_cat001_real_catalog_matches_checked_in_manifest():
    from sentinel_tpu_torch.obs.counters import CATALOG
    manifest = os.path.join(PORT_DIR, "obs", "counters_catalog.txt")
    keys = [ln.strip() for ln in open(manifest)
            if ln.strip() and not ln.startswith("#")]
    assert list(CATALOG) == keys


# ----------------------------------------------------------------------
# DEV001 — CUDA at import time
# ----------------------------------------------------------------------

def test_dev001_flags_module_scope_cuda_tensor():
    findings = lint_torch("window_regression.py")
    hits = active(findings, "DEV001")
    assert len(hits) == 1
    line = torch_line("window_regression.py", hits[0].line)
    assert line.startswith("NEVER") and 'device="cuda"' in line
    assert "torch.tensor" in hits[0].message


def test_dev001_import_time_contexts_and_negatives():
    findings = lint_torch("dev_cases.py")
    hits = active(findings, "DEV001")
    flagged = [torch_line("dev_cases.py", f.line).split("#")[0].strip()
               for f in hits]
    for needle in ("torch.cuda.Stream()", ".cuda()", 'device="cuda:0"',
                   "pin_memory=True", '.to(torch.device("cuda"))',
                   'torch.Generator(device="cuda")',
                   "dist.get_world_size()"):
        assert sum(needle in s for s in flagged) == 1, needle
    assert len(hits) == 7
    assert len(suppressed(findings, "DEV001")) == 1
    for s in flagged:
        assert not s.startswith(("SAFE", "_compiled", "return"))


def test_current_stats_window_is_clean():
    findings = analyze_paths(
        [os.path.join(PORT_DIR, "stats", "window.py")], ALL_RULES)
    assert active(findings, "DEV001") == []


def test_dev001_reference_fixtures_are_jax_and_stay_silent():
    """The reference's JAX-spelled fixtures touch no torch: the port's
    DEV001 finds nothing there."""
    for name in ("window_regression.py", "dev_cases.py"):
        findings = lint_fixture(name, [RULES_BY_ID["DEV001"]])
        assert active(findings, "DEV001") == []


# ----------------------------------------------------------------------
# SPMD001 — torch.distributed collectives under rank-divergent branches
# ----------------------------------------------------------------------

def test_spmd001_positive_and_negative():
    findings = lint_torch("spmd_cases.py")
    hits = active(findings, "SPMD001")
    msgs = [f.message for f in hits]
    assert len(hits) == 3
    assert any("torch.distributed.all_reduce" in m and "rank-divergent "
               "branch" in m for m in msgs)                   # lexical
    assert any("torch.distributed.broadcast" in m for m in msgs)  # env
    assert any("early exit" in m and "all_gather_into_tensor" in m
               for m in msgs)                                 # guard-return
    assert len(suppressed(findings, "SPMD001")) == 1
    for f in hits:
        assert "tn_" not in torch_line("spmd_cases.py", f.line)


def test_spmd001_multihost_entry_points():
    """The port's own rendezvous (``multihost.initialize``, the fleet
    aggregates, the runtime's and the mesh's collectives) under a branch
    on the runtime's ``process_index`` or coordinator-ness."""
    findings = lint_torch("spmd_multihost_cases.py")
    hits = active(findings, "SPMD001")
    msgs = [f.message for f in hits]
    assert len(hits) == 4, msgs
    assert any("rt.barrier" in m and "rank-divergent branch" in m
               for m in msgs)
    assert any("obs_agg.aggregate_counters" in m for m in msgs)
    assert any("early exit" in m and "all_reduce_sum" in m for m in msgs)
    assert any("multihost.initialize" in m for m in msgs)
    for f in hits:
        assert "tn_" not in torch_line("spmd_multihost_cases.py", f.line)


def test_spmd001_rank_local_row_reads():
    """The row-sharded engine over processes: a ``RowBlocks`` per-lane
    read or ``sum()`` is an ``all_reduce`` — flagged under a branch on
    ``process_index`` or after a coordinator-only early exit, as is the
    mesh's ``all_reduce_bits``; reads every rank makes, and a plain
    tensor's index under the branch, stay silent."""
    findings = lint_torch("spmd_rows_cases.py")
    hits = active(findings, "SPMD001")
    msgs = [f.message for f in hits]
    assert len(hits) == 3, msgs
    assert any("table[...]" in m and "rank-divergent branch" in m
               for m in msgs)
    assert any("blocks.sum()" in m and "early exit" in m for m in msgs)
    assert any("all_reduce_bits" in m for m in msgs)
    for f in hits:
        assert "tn_" not in torch_line("spmd_rows_cases.py", f.line)


# ----------------------------------------------------------------------
# TRACE001 — host syncs in device-step code
# ----------------------------------------------------------------------

def test_trace001_positive_and_negative():
    findings = lint_torch("trace_cases.py")
    hits = active(findings, "TRACE001")
    msgs = " | ".join(f.message for f in hits)
    assert len(hits) == 4
    assert "'.item()'" in msgs                         # @torch.compile
    assert "branch on a tensor-valued" in msgs         # partial(compile)
    assert "boolean-mask index" in msgs and "_graphed_body" in msgs
    assert "<torch.cuda.graph capture>" in msgs        # capture body
    assert len(suppressed(findings, "TRACE001")) == 1
    for f in hits:
        assert "tn_" not in f.message
        assert "declared_step" not in f.message


def test_trace001_cross_module_wrap_site():
    defs = os.path.join(TORCH_FIXTURES, "compile_defs.py")
    findings = analyze_paths(
        [defs, os.path.join(TORCH_FIXTURES, "compile_site.py")], ALL_RULES)
    hits = active(findings, "TRACE001")
    assert len(hits) == 1
    assert hits[0].path.endswith("compile_defs.py")
    assert "body_fn" in hits[0].message
    assert active(analyze_paths([defs], ALL_RULES), "TRACE001") == []


def test_trace001_declared_table_seeds_eager_steps():
    """A function named in the declared table is device-step code even
    though nothing compiles or captures it."""
    table = [trace_rule.DeviceStep("trace_cases", "declared_step",
                                   "fixture")]
    rule = trace_rule.TraceHygieneRule(steps=table)
    hits = active(lint_torch("trace_cases.py", [rule]), "TRACE001")
    declared = [f for f in hits if "declared_step" in f.message]
    assert len(declared) == 1 and "'.tolist()'" in declared[0].message
    assert len(hits) == 5


def _reference_wrap_sites():
    """Every function the reference hands to jax.jit / shard_map (cross-
    module targets by their dotted path) or traces by decorator or local
    wrap site (``<module>.<function>``), derived from its source."""
    from sentinel_tpu.analysis.core import iter_python_files as ref_iter
    from sentinel_tpu.analysis.core import parse_contexts
    from sentinel_tpu.analysis.rules import trace as ref_trace
    import sentinel_tpu
    pkg = os.path.dirname(sentinel_tpu.__file__)
    contexts, _ = parse_contexts(ref_iter([pkg]))
    sites = set()
    for ctx in contexts:
        targets = ref_trace._wrap_site_targets(ctx)
        sites |= {t for t in targets if "." in t}
        module = "sentinel_tpu" + ctx.path[len(pkg):-3].replace(
            os.sep, ".").replace(".__init__", "")
        for fn in ref_trace._traced_functions(
                ctx, {t for t in targets if "." not in t}):
            sites.add(module + "." + fn.name)
    return sites


def test_trace001_table_covers_every_reference_wrap_site():
    sites = _reference_wrap_sites()
    declared = {s.counterpart for s in trace_rule.DEVICE_STEPS}
    assert len(sites) >= 25
    assert sites <= declared, sorted(sites - declared)
    assert declared <= sites, sorted(declared - sites)   # no stale entry
    # and every port function the table names exists where it says
    for step in trace_rule.DEVICE_STEPS:
        path = os.path.join(PORT_DIR, *step.module.split(".")) + ".py"
        with open(path) as fh:
            tree = ast.parse(fh.read())
        names = {n.name for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        assert step.function in names, step


def test_trace001_scans_the_ports_step_functions():
    """Over the port's package, the table's functions are scanned and
    none waits for the card."""
    from sentinel_tpu_torch.analysis.core import parse_contexts
    contexts, errors = parse_contexts(iter_python_files([PORT_DIR]))
    assert errors == []
    rule = RULES_BY_ID["TRACE001"]
    rule.prepare(contexts)
    scanned = set()
    for ctx in contexts:
        wrapped = {s.function for s in trace_rule.DEVICE_STEPS
                   if ctx.module_name.endswith(s.module)}
        scanned |= {(ctx.module_name.rsplit("sentinel_tpu_torch.", 1)[-1],
                     fn.name)
                    for fn in trace_rule._traced_functions(ctx, wrapped)}
        assert [f for f in rule.check(ctx)] == []
    assert {(s.module, s.function)
            for s in trace_rule.DEVICE_STEPS} <= scanned


# ----------------------------------------------------------------------
# DONATE001 — the staging-slot half (torch donates no buffers)
# ----------------------------------------------------------------------

def test_donate001_reference_donation_fixtures_are_negatives():
    """Torch has no ``donate_argnums``: the reference's donated-operand
    reads are plain reads in the port, so its reviewed suppression of
    one reads as unused (GL002) and only the staging-slot rewrite stays."""
    findings = lint_fixture("donate_cases.py")
    hits = active(findings, "DONATE001")
    assert not any("donated" in f.message for f in hits)
    assert [f.rule_id for f in active(findings)
            if f.rule_id != "DONATE001"] == [UNUSED_SUPPRESSION]
    unused = [f for f in findings if f.rule_id == UNUSED_SUPPRESSION][0]
    assert "disable=DONATE001" in fixture_line("donate_cases.py",
                                               unused.line)
    assert suppressed(findings, "DONATE001") == []


def test_donate001_flags_staging_slot_rewrite():
    ref_hits = [f for f in active(ref_analyze_paths(
        [os.path.join(FIXTURES, "donate_cases.py")], REF_RULES),
        "DONATE001") if "staging slot" in f.message]
    port_hits = active(lint_fixture("donate_cases.py"), "DONATE001")
    assert [(f.line, f.col) for f in port_hits] == \
        [(f.line, f.col) for f in ref_hits]
    assert "slot[:8] = 0" in fixture_line("donate_cases.py",
                                          port_hits[0].line)
    torch_hits = active(lint_torch("donate_cases.py"), "DONATE001")
    assert len(torch_hits) == 2
    lines = [torch_line("donate_cases.py", f.line) for f in torch_hits]
    assert 'slot["rows"][:8] = 0' in lines[0]
    assert "through 'to'" in torch_hits[0].message
    assert "slot.fill_(0)" in lines[1]
    assert "through 'decide_step'" in torch_hits[1].message


def test_donate001_settle_release_twins_are_clean():
    findings = lint_torch("donate_cases.py")
    hits = active(findings, "DONATE001")
    with open(os.path.join(TORCH_FIXTURES, "donate_cases.py")) as fh:
        tree = ast.parse(fh.read())
    spans = {fn.name: (fn.lineno, fn.end_lineno) for fn in tree.body
             if isinstance(fn, ast.FunctionDef)}
    clean = [n for n in spans if n.endswith("_is_clean")]
    assert len(clean) == 5
    for name in clean:
        lo, hi = spans[name]
        assert not any(lo <= f.line <= hi for f in hits), name
    assert len(suppressed(findings, "DONATE001")) == 1
    assert [f for f in findings if f.rule_id != "DONATE001"] == []


# ----------------------------------------------------------------------
# Reporters + CLI
# ----------------------------------------------------------------------

def test_json_report_shape():
    findings = lint_torch("window_regression.py")
    doc = json.loads(reporting.render_json(findings, files_scanned=1))
    assert doc["tool"] == "graftlint"
    assert doc["files_scanned"] == 1
    assert doc["unsuppressed_count"] == 1
    rec = [r for r in doc["findings"] if r["rule"] == "DEV001"][0]
    assert rec["path"].endswith("window_regression.py")
    assert rec["line"] > 0 and not rec["suppressed"]
    # one schema for both packages' reports, document for document
    port, ref = both("order_cases.py")
    assert reporting.render_json(port, 1) == \
        ref_reporting.render_json(ref, 1)


def test_sarif_report_shape_and_suppressions():
    findings, ref = both("order_cases.py")
    doc = json.loads(reporting.render_sarif(findings, ALL_RULES))
    ref_doc = json.loads(ref_reporting.render_sarif(ref, REF_RULES))
    assert doc["version"] == ref_doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "graftlint"
    assert run["results"] == ref_doc["runs"][0]["results"]
    rule_ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
    assert rule_ids == [r["id"] for r in
                        ref_doc["runs"][0]["tool"]["driver"]["rules"]]
    assert all(r["helpUri"].endswith("docs/LINT_TORCH.md")
               for r in run["tool"]["driver"]["rules"])
    sup = [r for r in run["results"] if r.get("suppressions")]
    assert len(sup) == 1
    assert sup[0]["suppressions"][0]["kind"] == "inSource"
    assert sup[0]["level"] == "note"


def test_baseline_roundtrip_matches_and_ratchets(tmp_path):
    findings = lint_fixture("order_cases.py")
    path = str(tmp_path / "baseline.json")
    assert reporting.write_baseline(findings, path) == 2
    ref_path = str(tmp_path / "ref_baseline.json")
    ref_reporting.write_baseline(both("order_cases.py")[1], ref_path)
    assert open(path).read() == open(ref_path).read()
    fresh = lint_fixture("order_cases.py")
    assert reporting.apply_baseline(fresh, path) == (2, 0)
    assert all(f.baselined for f in fresh
               if f.rule_id == "ORDER001" and not f.suppressed)
    act, _muted = reporting.split_findings(fresh)
    assert act == []
    clean = lint_fixture("lock_discipline_cases.py")
    assert reporting.apply_baseline(clean, path) == (0, 2)


def test_cli_gate_green_at_port_scope(tmp_path):
    rel = [os.path.relpath(p, REPO_ROOT) for p in PORT_SCOPE]
    report = tmp_path / "report.json"
    proc = _run_cli(*rel, "--exclude", EXCLUDE, "--jobs", "4",
                    "--baseline", "graftlint-torch-baseline.json",
                    "--json-out", str(report))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout
    doc = json.loads(report.read_text())
    assert doc["unsuppressed_count"] == 0
    assert doc["files_scanned"] == len(port_scope_files())
    with open(os.path.join(REPO_ROOT, "graftlint-torch-baseline.json")) as fh:
        baseline = json.load(fh)
    assert baseline == {"tool": "graftlint", "baseline_version": 1,
                        "entries": []}
    # the CLI imported the port (and torch), never JAX
    probe = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys\n"
         "sys.argv = ['x', '--list-rules']\n"
         "try:\n"
         "    runpy.run_module('sentinel_tpu_torch.analysis', "
         "run_name='__main__')\n"
         "except SystemExit:\n"
         "    pass\n"
         "print('JAX=' + ','.join(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('jax', 'sentinel_tpu'))))"],
        capture_output=True, text=True, timeout=120, cwd=REPO_ROOT,
        env={**os.environ, "PYTHONPATH": REPO_ROOT})
    assert probe.returncode == 0, probe.stderr
    assert probe.stdout.strip().splitlines()[-1] == "JAX="


def test_cli_gate_red_on_regression_fixture(tmp_path):
    report = tmp_path / "report.json"
    proc = _run_cli(os.path.join(TORCH_FIXTURES, "window_regression.py"),
                    "--json-out", str(report))
    assert proc.returncode == 1
    assert "DEV001" in proc.stdout
    assert json.loads(report.read_text())["unsuppressed_count"] == 1


def test_cli_rule_filter_runs_only_selected_rule():
    target = os.path.join(FIXTURES, "order_cases.py")
    proc = _run_cli(target, "--rule", "CAT001")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = _run_cli(target, "--rule", "ORDER001")
    assert proc.returncode == 1
    assert "ORDER001" in proc.stdout


def test_cli_exclude_drops_matching_paths():
    proc = _run_cli(FIXTURES, "--rule", "ORDER001",
                    "--exclude", "order_cases")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_jobs_output_parity():
    target = os.path.join(FIXTURES, "catproj")
    one = _run_cli(target, "--jobs", "1")
    two = _run_cli(target, "--jobs", "2")
    assert one.stdout == two.stdout
    assert one.returncode == two.returncode == 0
    assert one.stdout == _run_ref_cli(target, "--jobs", "2").stdout


def test_cli_budget_overrun_exits_3():
    proc = _run_cli(os.path.join(FIXTURES, "order_cases.py"),
                    "--rule", "CAT001", "--budget-s", "0")
    assert proc.returncode == 3
    assert "exceeded" in proc.stderr


def test_cli_write_then_apply_baseline(tmp_path):
    base = str(tmp_path / "b.json")
    target = os.path.join(FIXTURES, "order_cases.py")
    proc = _run_cli(target, "--write-baseline", base)
    assert proc.returncode == 0
    assert len(json.loads(open(base).read())["entries"]) == 2
    proc = _run_cli(target, "--baseline", base)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 baselined" in proc.stdout
