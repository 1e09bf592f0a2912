"""Tiered resource state: the device hot tier and a host cold tier.

Port of ``sentinel_tpu/tiering/``. The engine's row tables are the HOT
tier; an evicted row's window counters, occupy bookings, thread gauges
and RT histogram row spill to a host-memory COLD tier
(:class:`~sentinel_tpu_torch.tiering.coldtier.ColdTier`), and a cold key
interned again is promoted back bit-identically
(:class:`~sentinel_tpu_torch.tiering.manager.TierManager`): the number of
keys is unbounded while the device table keeps its size.

Hot-set discovery runs on the device: a conservative-update count-min
sketch (:mod:`~sentinel_tpu_torch.tiering.sketch`) is updated from each
batch's resource rows under the engine lock (no wait on the device), and
the tiering ticker reads its estimates back asynchronously and demotes
low-estimate rows before LRU pressure can land on a hot one.
"""

from sentinel_tpu_torch.tiering.coldtier import ColdEntry, ColdTier
from sentinel_tpu_torch.tiering.manager import (
    HOT_ROWS_ENV, SKETCH_BITS_ENV, SKETCH_ROWS_ENV, TIER_TICK_MS_ENV,
    TIERING_DISABLE_ENV, TierManager, tier_hot_rows, tier_sketch_bits,
    tier_sketch_rows, tier_tick_ms, tiering_disabled,
)
from sentinel_tpu_torch.tiering.sketch import (
    SKETCH_IMPLS, decay_sketch, estimate_all, init_sketch, update_sketch,
)

__all__ = [
    "ColdEntry", "ColdTier", "TierManager",
    "HOT_ROWS_ENV", "SKETCH_BITS_ENV", "SKETCH_ROWS_ENV",
    "TIER_TICK_MS_ENV", "TIERING_DISABLE_ENV",
    "tier_hot_rows", "tier_sketch_bits", "tier_sketch_rows",
    "tier_tick_ms", "tiering_disabled",
    "SKETCH_IMPLS", "init_sketch", "update_sketch", "decay_sketch",
    "estimate_all",
]
