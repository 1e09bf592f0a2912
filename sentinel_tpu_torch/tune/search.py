"""Coordinate-descent + successive-halving search over the knob space.

Port of ``sentinel_tpu/tune/search.py``. PURE policy core: no engine, no
env mutation, no wall clock — trials are delegated to an injected
``run_trial(config, episode_ms, rung)`` callable and time only enters
through an injected :class:`~sentinel_tpu_torch.core.clock.Clock`
(history timestamps), so the whole search is deterministic under
``ManualClock`` (tests/test_torch_tune.py). The real serving runner
(:mod:`sentinel_tpu_torch.tune.runner`) plugs in the measured trial; the
tests plug in synthetic response surfaces.

Search shape — one PASS is coordinate descent over the knobs in
registry order; each coordinate runs SUCCESSIVE HALVING over its
candidate values:

* rung 0 evaluates every candidate at the shortest episode budget;
* the top ``ceil(n/eta)`` scorers survive to the next rung, whose
  episode budget is ``eta``× longer — cheap episodes eliminate the
  clearly-bad values, the expensive verdict is only paid for finalists;
* the last rung's winner is ADOPTED only if it outscores the incumbent
  value measured at the same budget (the incumbent is always a
  candidate, so a sweep can never leave a knob worse than it found it
  — on the measurements).

Objective (:func:`score_outcome`): maximize decisions/s **subject to**
the p99 SLO — an SLO-violating trial can never outrank a compliant one
(lexicographic: compliant trials compare on throughput, violating
trials compare on how far past the SLO they are), and a trial that
fails the verdict bit-parity spot-check is disqualified outright.

Trials are memoized on (config, episode_ms) so re-measuring the
incumbent at a rung the search already paid for is free.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

from sentinel_tpu_torch.core.clock import Clock
from sentinel_tpu_torch.tune import knobs as knobs_mod

#: Score floor for a disqualified (parity-failing) trial.
DISQUALIFIED = float("-inf")


class TrialOutcome(NamedTuple):
    """What one measured episode reports back to the policy."""

    decisions_per_s: float     # settled requests / episode second (obs)
    p99_ms: Optional[float]    # hist_request p99 (None = no samples)
    parity_ok: bool = True     # verdict bit-parity spot-check vs defaults
    meta: dict = {}            # runner extras (shed, stalls, ...)


class TrialRecord(NamedTuple):
    """One search-history row (``SearchResult.history``)."""

    config: Dict[str, object]
    episode_ms: int
    rung: int
    outcome: TrialOutcome
    score: float
    t_ms: int                  # policy-clock stamp


class Elimination(NamedTuple):
    """One halving cut (``SearchResult.eliminations``): which candidate
    values of which knob were dropped at which rung."""

    env: str
    rung: int
    survivors: Tuple
    eliminated: Tuple


class SearchResult(NamedTuple):
    best_config: Dict[str, object]
    best_outcome: TrialOutcome
    baseline_outcome: TrialOutcome
    history: Tuple[TrialRecord, ...]
    eliminations: Tuple[Elimination, ...]
    converged: bool            # every trial ran, no parity failure


def score_outcome(outcome: TrialOutcome, slo_p99_ms: float) -> float:
    """Lexicographic objective, flattened to one float (see module
    docstring). Compliant scores are positive throughput; violating
    scores are negative and ordered by SLO overshoot, so the two bands
    can never interleave."""
    if not outcome.parity_ok:
        return DISQUALIFIED
    p99 = outcome.p99_ms
    if p99 is not None and p99 > slo_p99_ms:
        return -(p99 - slo_p99_ms)     # closer to the SLO ranks higher
    return max(outcome.decisions_per_s, 0.0)


def _config_key(config: Dict[str, object]) -> Tuple:
    return tuple(sorted(config.items()))


class TuneSearch:
    """One configured search over ``space`` (a sequence of
    :class:`~sentinel_tpu_torch.tune.knobs.KnobSpec`, each with a non-empty
    candidate grid).

    ``rung_ms`` sets the per-rung episode budgets explicitly (its length
    caps the number of halving rungs); ``eta`` is the halving factor.
    """

    def __init__(self, space: Sequence[knobs_mod.KnobSpec], *,
                 slo_p99_ms: float, clock: Clock,
                 rung_ms: Sequence[int] = (150, 450),
                 eta: int = 2, passes: int = 1):
        if not space:
            raise ValueError("empty knob space")
        for spec in space:
            if not spec.values:
                raise ValueError(f"{spec.env} has no candidate grid")
        self.space = tuple(space)
        self.slo_p99_ms = float(slo_p99_ms)
        self.clock = clock
        self.rung_ms = tuple(int(m) for m in rung_ms)
        self.eta = max(2, int(eta))
        self.passes = max(1, int(passes))
        self._memo: Dict[Tuple, TrialOutcome] = {}
        self._history: List[TrialRecord] = []
        self._eliminations: List[Elimination] = []
        self._parity_failed = False

    # ------------------------------------------------------------------

    def _measure(self, run_trial: Callable, config: Dict[str, object],
                 episode_ms: int, rung: int) -> Tuple[TrialOutcome, float]:
        key = (_config_key(config), episode_ms)
        outcome = self._memo.get(key)
        if outcome is None:
            outcome = run_trial(dict(config), episode_ms, rung)
            self._memo[key] = outcome
            s = score_outcome(outcome, self.slo_p99_ms)
            if not outcome.parity_ok:
                self._parity_failed = True
            self._history.append(TrialRecord(
                dict(config), episode_ms, rung, outcome, s,
                self.clock.now_ms()))
            return outcome, s
        return outcome, score_outcome(outcome, self.slo_p99_ms)

    def _halve_coordinate(self, run_trial: Callable, spec: knobs_mod.KnobSpec,
                          base: Dict[str, object], incumbent) -> Tuple:
        """Successive halving over one knob's candidates (incumbent value
        always included). Returns (winner_value, winner_score)."""
        candidates = list(dict.fromkeys(
            (incumbent,) + tuple(spec.coerce(v) for v in spec.values)))
        scores: Dict[object, float] = {}
        for rung, budget in enumerate(self.rung_ms):
            for v in candidates:
                cfg = dict(base)
                cfg[spec.env] = v
                _, scores[v] = self._measure(run_trial, cfg, budget, rung)
            if len(candidates) > 1:
                ranked = sorted(candidates, key=lambda v: scores[v],
                                reverse=True)
                keep = max(1, math.ceil(len(ranked) / self.eta))
                # never eliminate below 2 before the final rung: the
                # last rung must still be a comparison, not a coronation
                if rung < len(self.rung_ms) - 1:
                    keep = max(keep, min(2, len(ranked)))
                survivors, cut = ranked[:keep], ranked[keep:]
                if cut:
                    self._eliminations.append(Elimination(
                        spec.env, rung, tuple(survivors), tuple(cut)))
                candidates = survivors
        best = max(candidates, key=lambda v: scores[v])
        return best, scores[best]

    # ------------------------------------------------------------------

    def run(self, run_trial: Callable[[Dict[str, object], int, int],
                                      TrialOutcome]) -> SearchResult:
        """Execute the search; see the module docstring for the shape."""
        final_ms = self.rung_ms[-1]
        # incumbent = the registry defaults restricted to the space
        # (None-default knobs start from their first grid value)
        current: Dict[str, object] = {}
        for spec in self.space:
            v = spec.default if spec.default is not None \
                else spec.coerce(spec.values[0])
            current[spec.env] = spec.coerce(v)
        baseline, baseline_score = self._measure(
            run_trial, current, final_ms, rung=len(self.rung_ms) - 1)
        best_score = baseline_score
        for _ in range(self.passes):
            for spec in self.space:
                winner, w_score = self._halve_coordinate(
                    run_trial, spec, current, current[spec.env])
                if w_score > best_score:
                    current = dict(current)
                    current[spec.env] = winner
                    best_score = w_score
        best_outcome = self._memo[(_config_key(current), final_ms)]
        converged = (not self._parity_failed
                     and best_score > DISQUALIFIED)
        return SearchResult(
            best_config=current, best_outcome=best_outcome,
            baseline_outcome=baseline,
            history=tuple(self._history),
            eliminations=tuple(self._eliminations),
            converged=converged)
