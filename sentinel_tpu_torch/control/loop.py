"""ControlLoop: the closed-loop runner, riding the serving cadence.

Port of ``sentinel_tpu/control/loop.py``. One host-side service with the
tick/drain discipline of telemetry and tiering: ``tick()`` snapshots the
evidence (telemetry timeline + hot set, rolling request histogram,
ingest queue depth), runs the pure policy and QUEUES the actions;
``drain()`` applies them through the actuators and records every applied
action — a typed record in the action log, ``control.*`` counters, and a
flight-recorder pin (trigger kind ``controller_action``, forced past the
per-kind rate limiter). The
:class:`~sentinel_tpu_torch.serving.CadenceScheduler` finds the loop at
``Sentinel.control`` and folds it into its one daemon; ``start()`` is for
standalone use without a scheduler.

Env knobs (constructor kwargs override):

* ``SENTINEL_CONTROL_DISABLE`` — kill switch: the loop never ticks and
  the admission gate stays wide open.
* ``SENTINEL_CONTROL_INTERVAL_MS`` — tick cadence, default 1000.
* ``SENTINEL_CONTROL_P99_HI_MS`` / ``_P99_LO_MS`` — the AIMD hysteresis
  band over the interval p99, defaults 20 / 10.
* ``SENTINEL_CONTROL_MIN_ADMIT`` — shed floor, default 0.05.
* ``SENTINEL_CONTROL_COOLDOWN_MS`` — per-action repeat bound, 2000.
* ``SENTINEL_CONTROL_DEGRADE_RT_MS`` — per-resource RT tail bound driving
  forced breaker transitions; 0 (default) disables the lever. With the
  RT histogram table on it applies to each hot resource's interval p99
  (``obs/resource_hist.ResourceTailTracker``); with
  ``SENTINEL_RESOURCE_HIST_DISABLE``, to the per-second mean RT.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, List, Optional

from sentinel_tpu_torch.control.actuators import Actuators
from sentinel_tpu_torch.control.policy import (
    HistDeltaP99, Observation, OverloadPolicy, PolicyConfig, action_kind)
from sentinel_tpu_torch.obs import counters as obs_keys
from sentinel_tpu_torch.obs.resource_hist import ResourceTailTracker

CONTROL_DISABLE_ENV = "SENTINEL_CONTROL_DISABLE"
CONTROL_INTERVAL_ENV = "SENTINEL_CONTROL_INTERVAL_MS"
CONTROL_P99_HI_ENV = "SENTINEL_CONTROL_P99_HI_MS"
CONTROL_P99_LO_ENV = "SENTINEL_CONTROL_P99_LO_MS"
CONTROL_MIN_ADMIT_ENV = "SENTINEL_CONTROL_MIN_ADMIT"
CONTROL_COOLDOWN_ENV = "SENTINEL_CONTROL_COOLDOWN_MS"
CONTROL_DEGRADE_RT_ENV = "SENTINEL_CONTROL_DEGRADE_RT_MS"

ACTION_LOG_CAP = 256            # in-memory applied-action tail


def control_disabled() -> bool:
    return os.environ.get(CONTROL_DISABLE_ENV, "").lower() in (
        "1", "true", "on", "yes")


def _env_num(name: str, default, lo, hi, cast=float):
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return min(hi, max(lo, cast(raw)))
    except ValueError:
        return default


def control_interval_ms(default: int = 1000) -> int:
    """``SENTINEL_CONTROL_INTERVAL_MS``, clamped to [50, 60000]."""
    return _env_num(CONTROL_INTERVAL_ENV, default, 50, 60_000, cast=int)


def control_p99_hi_ms(default: float = 20.0) -> float:
    """``SENTINEL_CONTROL_P99_HI_MS``, clamped to [1, 60000]."""
    return _env_num(CONTROL_P99_HI_ENV, default, 1.0, 60_000.0)


def control_p99_lo_ms(default: float = 10.0) -> float:
    """``SENTINEL_CONTROL_P99_LO_MS``, clamped to [0.5, 60000]."""
    return _env_num(CONTROL_P99_LO_ENV, default, 0.5, 60_000.0)


def control_min_admit(default: float = 0.05) -> float:
    """``SENTINEL_CONTROL_MIN_ADMIT``, clamped to [0.01, 1.0]."""
    return _env_num(CONTROL_MIN_ADMIT_ENV, default, 0.01, 1.0)


def control_cooldown_ms(default: int = 2000) -> int:
    """``SENTINEL_CONTROL_COOLDOWN_MS``, clamped to [100, 600000]."""
    return _env_num(CONTROL_COOLDOWN_ENV, default, 100, 600_000, cast=int)


def control_degrade_rt_ms(default: float = 0.0) -> float:
    """``SENTINEL_CONTROL_DEGRADE_RT_MS``, clamped to [0, 60000]."""
    return _env_num(CONTROL_DEGRADE_RT_ENV, default, 0.0, 60_000.0)


def config_from_env() -> PolicyConfig:
    """PolicyConfig off the ``SENTINEL_CONTROL_*`` knobs (bootstrap)."""
    return PolicyConfig(
        p99_hi_ms=control_p99_hi_ms(),
        p99_lo_ms=control_p99_lo_ms(),
        min_admit=control_min_admit(),
        cooldown_ms=control_cooldown_ms(),
        degrade_rt_ms=control_degrade_rt_ms(),
    )


class ControlLoop:
    """One per Sentinel; attach as ``sentinel.control`` so the serving
    scheduler folds it into its daemon (serving.py)."""

    def __init__(self, sentinel, batcher=None, *,
                 enabled: Optional[bool] = None,
                 interval_ms: Optional[int] = None,
                 config: Optional[PolicyConfig] = None,
                 seed: int = 0):
        self._s = sentinel
        self.enabled = ((not control_disabled()) if enabled is None
                        else bool(enabled))
        self.interval_ms = (control_interval_ms() if interval_ms is None
                            else max(1, int(interval_ms)))
        cfg = config_from_env() if config is None else config
        self.policy = OverloadPolicy(cfg)
        self.actuators = Actuators(sentinel, None, seed=seed)
        if batcher is not None:
            self.bind_batcher(batcher)
        self._hist_p99 = HistDeltaP99()
        self._res_tails = ResourceTailTracker()
        self._lock = threading.Lock()
        self._pending: List = []            # (Observation, actions)
        self._log: "collections.deque" = collections.deque(
            maxlen=ACTION_LOG_CAP)
        self._ticks = 0
        self.total_actions = 0
        self._last_tick_ms = sentinel.clock.now_ms()
        self._last_obs: Optional[Observation] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        reg = getattr(sentinel, "register_shutdown", None)
        if reg is not None:
            reg(self)
        # CadenceScheduler discovery point (serving.py): the engine's
        # ``control`` attribute IS the attachment — one loop per engine,
        # latest wins (re-attach replaces, matching rules reload idiom)
        sentinel.control = self

    def bind_batcher(self, batcher) -> None:
        """Point the shed/retune levers at a frontend batcher and adopt
        its construction-time tuning as the restore baseline."""
        self.actuators.bind_batcher(batcher)
        self.policy.base_budget_ms = batcher.budget_ms
        self.policy.base_batch_cap = batcher.batch_max

    # ---- service protocol (CadenceScheduler) -------------------------

    def last_tick_ms(self) -> int:
        return self._last_tick_ms

    def tick(self) -> int:
        """Observe + decide (cheap, host-side; safe from any thread).
        Actions queue for :meth:`drain`; → actions decided."""
        if not self.enabled or self._closed:
            return 0
        sn = self._s
        now = sn.clock.now_ms()
        self._last_tick_ms = now
        tel = sn.telemetry
        entry = None
        hot: List[Dict] = []
        if tel.enabled:
            snap = tel.snapshot(timeline_limit=1)
            timeline = snap["timeline"]
            entry = timeline[-1] if timeline else None
            hot = snap["hot"]
        pass_s = float(entry["pass"]) if entry else 0.0
        block_s = float(entry["block"]) if entry else 0.0
        succ = int(entry["success"]) if entry else 0
        rt_avg = (float(entry["rt_sum"]) / succ) if succ else 0.0
        p99 = self._hist_p99.update(
            sn.obs.hist_request.snapshot()["buckets"])
        b = self.actuators.batcher
        depth = b.pending if b is not None else 0
        qmax = b.queue.queue_max if b is not None else 0
        res_rt = ()
        res_p99 = ()
        if self.policy.cfg.degrade_rt_ms > 0:
            res_rt = tuple((h["resource"], float(h.get("rt_ms", 0.0)))
                           for h in hot if h.get("rt_ms", 0.0) > 0)
            # per-resource interval p99 from the cumulative
            # device histogram vectors the telemetry hot set carries —
            # the tail signal the degrade trackers prefer over the mean
            res_p99 = self._res_tails.update(
                (h["resource"], h["rt_hist"]) for h in hot
                if h.get("rt_hist") is not None)
        ob = Observation(now, pass_s, block_s, rt_avg, p99,
                         depth, qmax, res_rt, res_p99)
        actions = self.policy.observe(ob)
        if sn.obs.enabled:
            sn.obs.counters.add(obs_keys.CONTROL_TICK)
            if res_p99:
                sn.obs.counters.add(obs_keys.CONTROL_TAIL_SIGNAL)
        with self._lock:
            self._ticks += 1
            self._last_obs = ob
            if actions:
                self._pending.append((ob, actions))
        return len(actions)

    _ACTION_KEY = {
        "shed_rate": obs_keys.CONTROL_SHED_ACTION,
        "retune_batcher": obs_keys.CONTROL_RETUNE_ACTION,
        "degrade": obs_keys.CONTROL_DEGRADE_ACTION,
    }

    def drain(self) -> int:
        """Apply every queued action (actuators may take the engine
        lock — this runs on the scheduler thread, never inside it);
        → actions applied."""
        with self._lock:
            if not self._pending:
                return 0
            batch = self._pending
            self._pending = []
        obs_rt = self._s.obs
        applied = 0
        for ob, actions in batch:
            for action in actions:
                note = self.actuators.apply(action)
                if note is None:        # no seam bound / unknown target
                    continue
                applied += 1
                kind = action_kind(action)
                rec = {"ts_ms": ob.ts_ms, "kind": kind, "note": note,
                       "action": action._asdict(),
                       "evidence": {"p99_ms": round(ob.p99_ms, 3),
                                    "rt_avg_ms": round(ob.rt_avg_ms, 3),
                                    "queue_depth": ob.queue_depth,
                                    "pass_per_s": ob.pass_per_s,
                                    "block_per_s": ob.block_per_s}}
                with self._lock:
                    self.total_actions += 1
                    self._log.append(rec)
                if obs_rt.enabled:
                    obs_rt.counters.add(self._ACTION_KEY[kind])
                    self._pin(obs_rt, ob, kind, note)
        return applied

    def _pin(self, obs_rt, ob: Observation, kind: str, note: str) -> None:
        """Flight-recorder audit chain for one applied action: mint a
        trace carrying the evidence span, then force-pin it (an action
        must pin even when no request span landed in the window)."""
        tr = obs_rt.request_trace()
        if not tr:
            return
        t0 = obs_rt.spans.now_ns()
        obs_rt.spans.record(tr, "control.action", t0,
                            obs_rt.spans.now_ns(),
                            note=f"{kind} {note}")
        obs_rt.flight.trigger(
            "controller_action", root=tr,
            note=(f"{kind} {note} p99={ob.p99_ms:.2f}ms "
                  f"q={ob.queue_depth} pass/s={ob.pass_per_s:.0f}"),
            worst_ms=ob.p99_ms, force=True)

    def poll(self) -> int:
        """tick + drain in one call (tests / standalone daemon body)."""
        self.tick()
        return self.drain()

    # ---- read surface ------------------------------------------------

    def snapshot(self, limit: int = 32) -> Dict:
        """The ``control`` transport command / dashboard panel body."""
        with self._lock:
            ob = self._last_obs
            return {
                "enabled": self.enabled,
                "interval_ms": self.interval_ms,
                "ticks": self._ticks,
                "total_actions": self.total_actions,
                "policy": self.policy.snapshot(),
                "last_obs": None if ob is None else {
                    "ts_ms": ob.ts_ms, "p99_ms": round(ob.p99_ms, 3),
                    "rt_avg_ms": round(ob.rt_avg_ms, 3),
                    "pass_per_s": ob.pass_per_s,
                    "block_per_s": ob.block_per_s,
                    "queue_depth": ob.queue_depth,
                    "queue_max": ob.queue_max,
                },
                "actions": list(self._log)[-max(0, int(limit)):],
            }

    def action_log(self) -> List[Dict]:
        with self._lock:
            return list(self._log)

    # ---- lifecycle ---------------------------------------------------

    def start(self, interval_sec: Optional[float] = None) -> None:
        """Standalone daemon (when not riding a CadenceScheduler)."""
        if not self.enabled or self._thread is not None:
            return
        period = (self.interval_ms / 1000.0 if interval_sec is None
                  else max(0.005, float(interval_sec)))
        self._stop.clear()

        def body():
            while not self._stop.wait(period):
                try:
                    self.poll()
                except Exception:   # pragma: no cover — keep daemon alive
                    pass

        self._thread = threading.Thread(target=body, daemon=True,
                                        name="sentinel-control")
        self._thread.start()

    def stop(self) -> None:
        """Idempotent (``Sentinel.close()`` runs it via the shutdown
        registry); drops queued-but-unapplied actions — actuating into
        a closing engine would race teardown."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        self._closed = True
        with self._lock:
            self._pending = []
