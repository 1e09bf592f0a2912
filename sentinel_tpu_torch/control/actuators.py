"""Action application through existing runtime seams only.

Port of ``sentinel_tpu/control/actuators.py``. :class:`ShedRate` rides
the ingest queue's ``set_admission`` gate (requests drop before batches
form, deterministically: the drop pattern is a pure function of the seed
and the arrival index); :class:`RetuneBatcher` rides
``AdaptiveBatcher.retune``; :class:`Degrade` rides
``Sentinel.force_breaker`` (the engine evolves the forced slot normally
afterwards). Every apply returns a human-readable note, the evidence the
loop pins into the flight recorder beside the triggering observation.
"""

from __future__ import annotations

from typing import Optional

from sentinel_tpu_torch.control import policy as pol
from sentinel_tpu_torch.rules import degrade as deg_mod

_BREAKER_STATE = {
    pol.DEG_OPEN: deg_mod.STATE_OPEN,
    pol.DEG_HALF_OPEN: deg_mod.STATE_HALF_OPEN,
    pol.DEG_CLOSE: deg_mod.STATE_CLOSED,
}


class Actuators:
    """Bound to one Sentinel (+ optionally its frontend batcher).

    ``seed`` feeds the deterministic admission hash; captured once so
    every :class:`ShedRate` of a run draws from the same stream."""

    def __init__(self, sentinel, batcher=None, *, seed: int = 0):
        self._s = sentinel
        self._b = batcher
        self.seed = int(seed)

    @property
    def batcher(self):
        return self._b

    def bind_batcher(self, batcher) -> None:
        """Late-bind the frontend (it is often constructed after the
        engine); shed/retune actions are no-ops until bound."""
        self._b = batcher

    def apply(self, action) -> Optional[str]:
        """Apply one typed action; → evidence note, or None when the
        action had no seam to land on (no batcher bound / unknown
        resource) — the loop counts but does not pin those."""
        if isinstance(action, pol.ShedRate):
            b = self._b
            if b is None:
                return None
            b.queue.set_admission(action.frac, seed=self.seed)
            return f"admit_frac={action.frac:.3f} seed={self.seed}"
        if isinstance(action, pol.RetuneBatcher):
            b = self._b
            if b is None:
                return None
            b.retune(budget_ms=action.budget_ms,
                     batch_cap=action.batch_cap)
            return (f"budget_ms={b.budget_ms} "
                    f"batch_cap={b.queue.batch_max}")
        if isinstance(action, pol.Degrade):
            ok = self._s.force_breaker(
                action.resource, _BREAKER_STATE[action.transition])
            if not ok:
                return None
            return f"{action.resource}->{action.transition}"
        raise TypeError(f"unknown control action {action!r}")
