"""The measured half of the autotuner: real serving episodes as trials.

Port of ``sentinel_tpu/tune/runner.py``. Each trial replays one seeded
workload-zoo episode through the FULL serving path —
``AdaptiveBatcher`` → ``DispatchPipeline`` → engine dispatch on the
runner's device — through :func:`~sentinel_tpu_torch.tune.episode.
run_episode`, the port's copy of the reference's open-loop harness.
Scores come from the engine's own obs plumbing (``hist_request`` p99
via ``p99_obs_ms``, settled-request throughput via ``decisions_per_s``,
shed/stall counters in ``meta``), never from ad-hoc wall clocks around
the replay.

Knob application per trial: runtime-scope knobs (pipeline depth, the
frontend set) pass as explicit batcher kwargs — a fresh
batcher/pipeline over the episode engine reconfigures them in place;
trace-scope knobs (staging, single dispatch, sort-free and its sizing)
apply through :func:`~sentinel_tpu_torch.tune.knobs.env_overrides` so
the fresh engine each episode builds reads them.

Guardrail (after every trial): a verdict bit-parity spot-check against
the DEFAULT config — a fixed seeded batch sequence driven through a
small ``ManualClock`` engine under the trial's trace knobs must produce
byte-identical (allow, reason, wait_ms) streams to the default-config
engine. Runtime knobs cannot change that stream by construction (they
batch the same events differently; the check drives the raw engine
below the batcher), so the check memoizes per trace-knob combination —
every trial still reports a ``parity_ok`` verdict and any failure
disqualifies its config (``tune.parity_fail``).

:func:`run_sweep` is the one-call driver ``python -m
sentinel_tpu_torch.tune`` uses: build the space, search, write
``TUNED.json``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from sentinel_tpu_torch.core.clock import Clock, ManualClock
from sentinel_tpu_torch.obs import counters as obs_keys
from sentinel_tpu_torch.tune import artifact as artifact_mod
from sentinel_tpu_torch.tune import knobs as knobs_mod
from sentinel_tpu_torch.tune.episode import run_episode
from sentinel_tpu_torch.tune.search import TrialOutcome, TuneSearch

#: AdaptiveBatcher kwarg ← knob env, for the runtime-scope trial knobs
#: (run_episode's explicit kwargs — constructor kwargs beat env).
_RUNTIME_KWARGS = {env: kw for kw, env in knobs_mod.FRONTEND_KWARG_ENVS}


def _verdict_signature(trace_cfg: Dict[str, object], *, seed: int,
                       steps: int, events: int, device="cuda") -> bytes:
    """Byte stream of every verdict a fixed seeded batch sequence
    produces on a small ManualClock engine on ``device`` built under
    ``trace_cfg`` — the comparable for the bit-parity spot-check.
    Deterministic: virtual clock, seeded numpy, fixed geometry."""
    import numpy as np
    import sentinel_tpu_torch as stt

    rng = np.random.default_rng(seed)
    clk = ManualClock(start_ms=1_700_000_000_000)
    with knobs_mod.env_overrides(trace_cfg):
        sph = stt.Sentinel(stt.load_config(
            max_resources=256, max_origins=32, max_flow_rules=32,
            max_degrade_rules=8, max_authority_rules=8), clock=clk,
            device=device)
        # tight + generous rules so the stream exercises PASS, BLOCK and
        # pacing verdicts (a parity check over all-pass proves nothing)
        sph.load_flow_rules(
            [stt.FlowRule(resource="tune/hot", count=25.0)]
            + [stt.FlowRule(resource=f"tune/{i}", count=1e6)
               for i in range(8)])
        names = ["tune/hot"] * 4 + [f"tune/{i}" for i in range(8)]
        out = bytearray()
        for _ in range(steps):
            res = rng.choice(names, size=events).tolist()
            acquire = rng.integers(1, 3, size=events).astype(np.int32)
            prio = (rng.random(events) < 0.1)
            origins = ["tune-app" if b else None
                       for b in rng.random(events) < 0.3]
            v = sph.entry_batch_nowait(
                res, acquire=acquire, prioritized=prio,
                origins=origins).result()
            out += np.asarray(v.allow).tobytes()
            out += np.asarray(v.reason).tobytes()
            out += np.asarray(v.wait_ms).tobytes()
            clk.advance_ms(int(rng.integers(50, 300)))
        sph.close()
    return bytes(out)


class ServingTrialRunner:
    """``run_trial`` callable for :class:`TuneSearch` over real serving
    episodes on ``device`` (see module docstring). ``counters`` is any
    :class:`~sentinel_tpu_torch.obs.counters.CounterSet` to receive the
    ``tune.trial`` / ``tune.parity_fail`` ticks (the sweep CLI reads it
    back for the report)."""

    def __init__(self, *, workload: str = "steady", seed: int = 11,
                 rate_rps: float = 2000.0, counters=None,
                 parity_seed: int = 5, parity_steps: int = 3,
                 parity_events: int = 64, device="cuda"):
        self.device = device
        self.workload = workload
        self.seed = int(seed)
        self.rate_rps = float(rate_rps)
        self.counters = counters if counters is not None \
            else obs_keys.CounterSet()
        self._parity_seed = parity_seed
        self._parity_steps = parity_steps
        self._parity_events = parity_events
        self._parity_ref: Optional[bytes] = None
        self._parity_memo: Dict[Tuple, bool] = {}
        self.trials = 0
        self.parity_checks = 0

    # ------------------------------------------------------------------

    def _parity_ok(self, config: Dict[str, object]) -> bool:
        trace_cfg = knobs_mod.trace_knobs(config)
        key = tuple(sorted(trace_cfg.items()))
        memo = self._parity_memo.get(key)
        if memo is not None:
            return memo
        if self._parity_ref is None:
            self._parity_ref = _verdict_signature(
                {}, seed=self._parity_seed, steps=self._parity_steps,
                events=self._parity_events, device=self.device)
        got = _verdict_signature(
            trace_cfg, seed=self._parity_seed, steps=self._parity_steps,
            events=self._parity_events, device=self.device)
        ok = got == self._parity_ref
        self._parity_memo[key] = ok
        self.parity_checks += 1
        if not ok:
            self.counters.add(obs_keys.TUNE_PARITY_FAIL)
        return ok

    def __call__(self, config: Dict[str, object], episode_ms: int,
                 rung: int) -> TrialOutcome:
        kwargs = {}
        for env, kw in _RUNTIME_KWARGS.items():
            if env in config:
                kwargs[kw] = config[env]
        trace_cfg = knobs_mod.trace_knobs(config)
        with knobs_mod.env_overrides(trace_cfg):
            m = run_episode(self.workload, seed=self.seed,
                            duration_ms=float(episode_ms),
                            rate_rps=self.rate_rps, device=self.device,
                            **kwargs)
        self.trials += 1
        self.counters.add(obs_keys.TUNE_TRIAL)
        ok = self._parity_ok(config)
        return TrialOutcome(
            decisions_per_s=float(m.get("decisions_per_s") or 0.0),
            p99_ms=m.get("p99_obs_ms"),
            parity_ok=ok,
            meta={"shed": m.get("shed", 0),
                  "pipe_stall": m.get("pipe_stall", 0),
                  "deadline_miss": m.get("deadline_miss", 0),
                  "completed": m.get("completed", 0),
                  "rung": rung})


def build_space(envs: Sequence[str],
                grids: Optional[Dict[str, Sequence]] = None):
    """Knob names (+ optional per-knob grid overrides) → search space."""
    space = []
    for env in envs:
        spec = knobs_mod.KNOB_BY_ENV.get(env)
        if spec is None:
            raise ValueError(f"unknown tuning knob {env!r}")
        if grids and env in grids:
            spec = spec._replace(values=tuple(grids[env]))
        space.append(spec)
    return space


def run_sweep(*, envs: Sequence[str] = ("SENTINEL_PIPELINE_DEPTH",
                                        "SENTINEL_FRONTEND_BATCH"),
              grids: Optional[Dict[str, Sequence]] = None,
              workload: str = "steady", seed: int = 11,
              rate_rps: float = 2000.0, slo_p99_ms: float = 50.0,
              rung_ms: Sequence[int] = (150, 450), eta: int = 2,
              passes: int = 1, out_path: Optional[str] = None,
              clock: Optional[Clock] = None, device="cuda") -> Dict:
    """One full sweep on ``device``: search the space through real
    serving episodes and (optionally) pin the winner as a ``TUNED.json``
    artifact under ``device``'s fingerprint. Returns ``{"result":
    SearchResult, "artifact": doc|None, ...}``."""
    space = build_space(envs, grids)
    runner = ServingTrialRunner(workload=workload, seed=seed,
                                rate_rps=rate_rps, device=device)
    search = TuneSearch(space, slo_p99_ms=slo_p99_ms,
                        clock=clock or Clock(), rung_ms=rung_ms, eta=eta,
                        passes=passes)
    result = search.run(runner)
    doc = None
    if out_path and result.converged:
        doc = artifact_mod.save_tuned(
            out_path,
            fingerprint=artifact_mod.fingerprint(device),
            knob_values=result.best_config,
            score={"decisions_per_s": result.best_outcome.decisions_per_s,
                   "p99_ms": result.best_outcome.p99_ms},
            baseline={
                "decisions_per_s": result.baseline_outcome.decisions_per_s,
                "p99_ms": result.baseline_outcome.p99_ms},
            slo_p99_ms=slo_p99_ms,
            workload={"name": workload, "seed": seed,
                      "rate_rps": rate_rps,
                      "rung_ms": list(rung_ms)},
            trials=runner.trials,
            parity_checks=runner.parity_checks)
    return {"result": result, "artifact": doc,
            "counters": runner.counters.snapshot(),
            "trials": runner.trials,
            "parity_checks": runner.parity_checks}
