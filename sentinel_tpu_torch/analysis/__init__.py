"""graftlint for the PyTorch / CUDA port — self-hosted AST static analysis
for collective, device-initialisation, host-sync and concurrency safety.

The port's own copy of ``sentinel_tpu/analysis`` (same module layout,
rule ids, CLI, suppression grammar, report schemas and exit codes; see
``docs/LINT_TORCH.md`` for the catalog). The framework-free rules behave
exactly as the reference's; the four rules the reference keys on JAX
names are keyed on torch's spelling of the same bug classes:

* **SPMD001** — ``torch.distributed`` collectives reachable under
  rank-divergent branches (``get_rank``, ``RANK`` / ``LOCAL_RANK``
  env reads, ``is_coordinator``): a process-group deadlock.
* **DEV001** — CUDA touched at import time (``torch.cuda.*`` context
  calls, ``.cuda()``, ``.pin_memory()``, tensors or generators with a
  CUDA ``device=``, ``torch.distributed.*``): it poisons forked workers
  and runs before ``CUDA_VISIBLE_DEVICES`` / ``set_device`` /
  ``init_process_group`` can take effect.
* **TRACE001** — host syncs inside device-step code: functions wrapped
  by ``torch.compile`` / ``torch.cuda.make_graphed_callables``, bodies
  captured under ``torch.cuda.graph``, and the declared table of the
  port's step functions.
* **ASYNC001** — blocking calls in coroutines; thread locks held across
  ``await``.
* **LOCK001** — module-level mutable state mutated from both async and
  threaded contexts without a lock.
* **LOCK002** — unlocked access to an inferred lock-guarded attribute
  from a thread-reachable method.
* **DONATE001** — a pinned staging slot rewritten while a non-blocking
  copy or a dispatch may still read it (torch donates no buffers, so the
  reference's donation half has no counterpart).
* **ORDER001** — resource freed before the intent record inside a
  locked region.
* **CAT001** — registry drift: counter keys vs ``CATALOG`` and its
  wire-order manifest; ``SENTINEL_*`` env reads and read-site clamps
  vs the knob/config registries.

Usage::

    python -m sentinel_tpu_torch.analysis sentinel_tpu_torch/ chip_smoke.py \\
        tests/test_torch_*.py demos/torch/ --exclude tests/fixtures/graftlint

Programmatic::

    from sentinel_tpu_torch.analysis import analyze_paths, ALL_RULES
    findings = analyze_paths(["sentinel_tpu_torch/"], ALL_RULES)

This package is dependency-free (stdlib ``ast`` only): it parses source,
never imports the modules it analyzes, and touches no device.
"""

from sentinel_tpu_torch.analysis.core import (      # noqa: F401
    Finding, ModuleContext, Rule, analyze_paths, analyze_source,
    iter_python_files, parse_suppressions,
)
from sentinel_tpu_torch.analysis.rules import ALL_RULES, RULES_BY_ID  # noqa: F401

__all__ = [
    "Finding", "ModuleContext", "Rule", "analyze_paths", "analyze_source",
    "iter_python_files", "parse_suppressions", "ALL_RULES", "RULES_BY_ID",
]
