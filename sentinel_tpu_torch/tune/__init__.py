"""Measurement-driven serving autotuner: the port of ``sentinel_tpu/tune``.

* :mod:`~sentinel_tpu_torch.tune.knobs` — the typed knob registry
  (type / clamp / default / runtime-vs-trace scope) + the startup
  ``SENTINEL_*`` environment validator;
* :mod:`~sentinel_tpu_torch.tune.search` — the PURE coordinate-descent +
  successive-halving policy core (clock-injected, synthetic trials in
  the tests);
* :mod:`~sentinel_tpu_torch.tune.episode` — one open-loop workload-zoo
  episode through the full serving path;
* :mod:`~sentinel_tpu_torch.tune.runner` — real trials: seeded episodes
  scored from obs plumbing, with a verdict bit-parity spot-check per
  trial;
* :mod:`~sentinel_tpu_torch.tune.artifact` — ``TUNED.json``: the
  hardware-fingerprinted pinned config ``SENTINEL_TUNED_CONFIG`` loads
  at ``Sentinel`` startup (fingerprint mismatch → defaults, logged).

Operator entry point: ``python -m sentinel_tpu_torch.tune`` runs a sweep
on the GPU (``--device cpu`` on the CPU).
"""

from sentinel_tpu_torch.tune.artifact import (           # noqa: F401
    TUNED_CONFIG_ENV, fingerprint, fingerprints_match, load_tuned,
    overrides_for, provenance, resolve_startup, save_tuned,
)
from sentinel_tpu_torch.tune.knobs import (              # noqa: F401
    FRONTEND_KWARG_ENVS, KNOB_BY_ENV, KNOBS, KnobSpec, coerce_config,
    env_overrides, env_strings, known_envs, trace_knobs, validate_environ,
)
from sentinel_tpu_torch.tune.runner import (             # noqa: F401
    ServingTrialRunner, build_space, run_sweep,
)
from sentinel_tpu_torch.tune.search import (             # noqa: F401
    SearchResult, TrialOutcome, TuneSearch, score_outcome,
)

__all__ = [
    "TUNED_CONFIG_ENV", "KNOBS", "KNOB_BY_ENV", "KnobSpec",
    "FRONTEND_KWARG_ENVS", "TuneSearch", "TrialOutcome", "SearchResult",
    "score_outcome", "fingerprint", "fingerprints_match", "save_tuned",
    "load_tuned", "overrides_for", "provenance", "resolve_startup",
    "validate_environ", "known_envs", "coerce_config", "trace_knobs",
    "env_strings", "env_overrides", "ServingTrialRunner", "build_space",
    "run_sweep",
]
