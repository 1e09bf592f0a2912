"""Decision counters: the runtime's own "why did that happen" tallies.

The port's copy of ``sentinel_tpu/obs/counters.py``, key for key. One
flat, monotonically increasing integer per named decision outcome,
mutated once per BATCH (not per event) on the dispatch path. Families:

* ``split_route.*`` — which dispatch route a batch took (``scalar`` /
  ``fast`` / ``fast_occupy`` / ``general_sorted``, ``split_fired`` for a
  per-event split, ``fused_exit`` for a fused decide+exit) and, beside
  it, ``sortfree`` when its flow checks grouped segments sort-free;
* ``sortfree.bucket_overflow`` — elements whose step took the sorted
  order because the claim cascade overflowed (ops/sortfree.py);
* ``occupy.*`` — priority bookings: ``granted``, ``carried`` /
  ``settled`` at a rule reload, ``evicted`` with their rows;
* ``pipeline.*`` — ``dispatches`` (device steps the dispatch path
  issued) and ``leaked_handles`` (``PendingVerdicts`` settled by the GC
  because ``.result()`` was never called), plus the serving tier's keys;
* ``block_reason.<ExceptionName>`` — denials by verdict code (custom
  slots by their slot name);
* ``obs.span_ring_wrap`` and ``flight.*`` — span ring overwrites and the
  SLO flight recorder (obs/flight.py);
* the serving, tuning, telemetry, tiering and control tiers' keys, kept
  so that the catalog is the reference's, position for position.

:data:`CATALOG` is the fixed, ordered aggregatable key set
(:func:`catalog_vector` packs a snapshot into one int64 vector). Its
order is a wire format: ``counters_catalog.txt`` beside this module is
its reviewed prefix, identical to the reference's file.
"""

from __future__ import annotations

import threading
from typing import Dict, Mapping

ROUTE_SCALAR = "split_route.scalar"
ROUTE_FAST = "split_route.fast"
ROUTE_FAST_OCCUPY = "split_route.fast_occupy"
ROUTE_GENERAL = "split_route.general_sorted"
ROUTE_SPLIT = "split_route.split_fired"

CACHE_HIT = "compile_cache.hit"
CACHE_MISS = "compile_cache.miss"
CACHE_RETRY = "compile_cache.first_fetch_retry"

OCCUPY_GRANTED = "occupy.granted"
OCCUPY_CARRIED = "occupy.carried"
OCCUPY_SETTLED = "occupy.settled"
OCCUPY_EVICTED = "occupy.evicted"

ROUTE_FUSED = "split_route.fused_exit"

PIPE_DEPTH = "pipeline.depth"
PIPE_STALL = "pipeline.stall"
PIPE_LEAKED = "pipeline.leaked_handles"

FE_ENQUEUE = "frontend.enqueue"
FE_QUEUE_DEPTH = "frontend.queue_depth"
FE_SHED = "frontend.shed"
FE_FLUSH_FULL = "frontend.flush_reason.full"
FE_FLUSH_DEADLINE = "frontend.flush_reason.deadline"
FE_FLUSH_IDLE = "frontend.flush_reason.idle"

BLOCK_PREFIX = "block_reason."

# tracing / flight-recorder health
SPAN_RING_WRAP = "obs.span_ring_wrap"     # spans/links lost to ring wrap
FLIGHT_PINNED = "flight.pinned"           # chains pinned by an SLO trigger
FLIGHT_TRIGGER_PREFIX = "flight.trigger."  # per-kind trigger tallies

# row-sharded (meshed) dispatches and pipeline submits
ROUTE_MESHED = "split_route.meshed"
PIPE_MESHED = "pipeline.meshed_dispatch"

# dispatches whose flow checks grouped segments sort-free (beside the
# route counter), and the claim cascade's overflow tally
ROUTE_SORTFREE = "split_route.sortfree"
SORTFREE_OVERFLOW = "sortfree.bucket_overflow"

# the serving autotuner (the reference's sentinel_tpu/tune/)
TUNE_LOADED = "tune.config_loaded"
TUNE_FALLBACK = "tune.fingerprint_fallback"
TUNE_KNOB_REJECTED = "tune.knob_rejected"
TUNE_TRIAL = "tune.trial"
TUNE_PARITY_FAIL = "tune.parity_fail"

# hot-resource telemetry and the exporter's label-cardinality guard
TELEMETRY_TICK = "telemetry.tick"
TELEMETRY_DROP = "telemetry.readback_drop"
EXPORTER_LABEL_OVERFLOW = "exporter.label_overflow"

# tiered resource state
TIER_HOT_HIT = "tier.hot_hit"
TIER_COLD_MISS = "tier.cold_miss"
TIER_PROMOTED = "tier.promoted"
TIER_DEMOTED = "tier.demoted"
TIER_SKETCH_OVERFLOW = "tier.sketch_overflow"

# device dispatches issued by the dispatch path (decide = 1, split = 2,
# fused decide+exit = 1, exit = 1; rule reloads and eviction drains are
# not counted), and whole-batch dispatches that carried the tiering
# sketch update inside themselves
PIPE_DISPATCH = "pipeline.dispatches"
ROUTE_SINGLE_DISPATCH = "split_route.single_dispatch"

# the closed-loop overload controller
CONTROL_TICK = "control.tick"
CONTROL_SHED_ACTION = "control.action.shed_rate"
CONTROL_RETUNE_ACTION = "control.action.retune_batcher"
CONTROL_DEGRADE_ACTION = "control.action.degrade"
CONTROL_DROPPED = "control.admission_dropped"

# per-resource RT histograms: telemetry landings that carried them, and
# controller ticks that read their tail signal
TELEMETRY_HIST_TICK = "telemetry.hist_tick"
CONTROL_TAIL_SIGNAL = "control.tail_signal"

#: Fixed aggregation catalog (order is the wire format of the multihost
#: counter vector — append only, never reorder).
CATALOG = (
    ROUTE_SCALAR, ROUTE_FAST, ROUTE_FAST_OCCUPY, ROUTE_GENERAL, ROUTE_SPLIT,
    CACHE_HIT, CACHE_MISS, CACHE_RETRY,
    OCCUPY_GRANTED, OCCUPY_CARRIED, OCCUPY_SETTLED, OCCUPY_EVICTED,
    BLOCK_PREFIX + "FlowException",
    BLOCK_PREFIX + "DegradeException",
    BLOCK_PREFIX + "SystemBlockException",
    BLOCK_PREFIX + "AuthorityException",
    BLOCK_PREFIX + "ParamFlowException",
    ROUTE_FUSED,
    PIPE_DEPTH, PIPE_STALL, PIPE_LEAKED,
    FE_ENQUEUE, FE_QUEUE_DEPTH, FE_SHED,
    FE_FLUSH_FULL, FE_FLUSH_DEADLINE, FE_FLUSH_IDLE,
    SPAN_RING_WRAP, FLIGHT_PINNED,
    FLIGHT_TRIGGER_PREFIX + "deadline_miss",
    FLIGHT_TRIGGER_PREFIX + "shed",
    FLIGHT_TRIGGER_PREFIX + "p99",
    FLIGHT_TRIGGER_PREFIX + "block_burst",
    ROUTE_MESHED, PIPE_MESHED,
    ROUTE_SORTFREE, SORTFREE_OVERFLOW,
    TUNE_LOADED, TUNE_FALLBACK, TUNE_KNOB_REJECTED,
    TUNE_TRIAL, TUNE_PARITY_FAIL,
    TELEMETRY_TICK, TELEMETRY_DROP, EXPORTER_LABEL_OVERFLOW,
    TIER_HOT_HIT, TIER_COLD_MISS, TIER_PROMOTED, TIER_DEMOTED,
    TIER_SKETCH_OVERFLOW,
    PIPE_DISPATCH, ROUTE_SINGLE_DISPATCH,
    CONTROL_TICK, CONTROL_SHED_ACTION, CONTROL_RETUNE_ACTION,
    CONTROL_DEGRADE_ACTION, CONTROL_DROPPED,
    TELEMETRY_HIST_TICK, CONTROL_TAIL_SIGNAL,
)


class CounterSet:
    """Locked flat dict of monotonic counters.

    One uncontended ``lock + dict.get + add`` per increment; increments
    happen once per batch on the dispatch path, so the cost is amortized
    over thousands of events."""

    __slots__ = ("_lock", "_c")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {}

    def add(self, key: str, n: int = 1) -> None:
        if n == 0:
            return
        with self._lock:
            self._c[key] = self._c.get(key, 0) + int(n)

    def get(self, key: str) -> int:
        with self._lock:
            return self._c.get(key, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)

    def merge(self, counts: Mapping[str, int]) -> None:
        """Fold another snapshot in (multihost coordinator aggregation)."""
        with self._lock:
            for k, v in counts.items():
                self._c[k] = self._c.get(k, 0) + int(v)

    def clear(self) -> None:
        with self._lock:
            self._c.clear()


def catalog_vector(counts: Mapping[str, int]):
    """Snapshot → int64 vector over :data:`CATALOG` (allgather payload)."""
    import numpy as np
    return np.asarray([int(counts.get(k, 0)) for k in CATALOG], np.int64)


def vector_counts(vec) -> Dict[str, int]:
    """Inverse of :func:`catalog_vector` (tolerates longer vectors from a
    newer peer — extra trailing entries are unknown keys and dropped)."""
    return {k: int(vec[i]) for i, k in enumerate(CATALOG) if i < len(vec)}
