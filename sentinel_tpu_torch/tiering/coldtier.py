"""Host-memory cold tier: evicted rows' complete state, by name.

Port of ``sentinel_tpu/tiering/coldtier.py`` (host numpy; a copy, since
the port imports nothing of the JAX package). One :class:`ColdEntry` per
demoted resource holds everything
``engine.pipeline.invalidate_resource_rows`` would have destroyed —
second/minute window slices, the thread gauge, the occupy booking ring,
the cumulative RT histogram row, and the hashed alt (resource ×
origin/context) slices keyed by their HOST identity ``(kind, key_id)``
so promotion can re-hash them onto the new row's slots. Window stamps
and booking target windows are absolute indices, so an entry is
time-portable: restored at any later instant it reads exactly as the
live row would have.

The one transform an entry may need before restore is the rule-reload
replay: ``Sentinel.load_flow_rules`` settles every RESIDENT row's
landed occupy bookings into its second window (``settle_occupied``)
and carries pending ones into the fresh ring. A row that was cold at
reload time missed that settle, so :func:`settle_entry_np` replays it
on the host — a numpy copy of ``stats.window.settle_occupied`` for one
row (integer and float32 adds only) — once per reload the entry slept
through, each with THAT reload's ``now_idx``.

Capacity: unbounded by default; ``SENTINEL_TIER_COLD_MAX`` bounds host
memory by dropping the oldest entries (a dropped key re-enters as a
fresh resource).
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

NEVER = -(2 ** 30)
_I32MAX = np.iinfo(np.int32).max


@dataclass
class ColdEntry:
    """One demoted resource's host-side state (numpy, device-free)."""

    # second window slice: counters [B, E], stamps [B], rt_sum/min_rt [B_rt]
    sec_counters: np.ndarray
    sec_stamps: np.ndarray
    sec_rt_sum: np.ndarray
    sec_min_rt: np.ndarray
    # minute window slice (empty arrays when the minute ring is disabled)
    min_counters: np.ndarray
    min_stamps: np.ndarray
    min_rt_sum: np.ndarray
    min_min_rt: np.ndarray
    threads: int
    occ_cnt: np.ndarray            # float32 [B+1]
    occ_win: np.ndarray            # int32 [B+1]
    # (kind, key_id) → (counters [B,E], stamps [B], rt_sum, min_rt, threads)
    alts: Dict[Tuple[int, int], tuple] = field(default_factory=dict)
    reload_gen: int = 0            # flow reloads seen BEFORE demotion
    demoted_ms: int = 0
    # round 20: cumulative per-resource RT histogram row (int32 [HB]);
    # None when the engine has no histogram table or the entry predates
    # the feature. Time-portable by construction (no stamps): it rides
    # demote→promote untouched, and reset_entry_geometry_np deliberately
    # carries it over — the table is cumulative-forever, not windowed.
    rt_hist: Optional[np.ndarray] = None


def settle_entry_np(buckets: int, entry: ColdEntry, now_idx: int,
                    event: int) -> None:
    """In-place replay of one missed flow-rule reload on a cold entry —
    the numpy mirror of ``stats.window.settle_occupied`` for a single
    row. LANDED bookings (``0 <= now_idx - w < buckets``) credit
    ``event`` counts into their target bucket (dead buckets reset and
    restamp first), PENDING ones (``now_idx - w == -1``) survive in the
    ring, anything older expires — exactly what the resident rows got
    from ``_jit_settle_occupied`` at that reload."""
    B = buckets
    track_rt = entry.sec_rt_sum.shape[0] > 0
    pend_cnt = np.zeros_like(entry.occ_cnt)
    pend_win = np.full_like(entry.occ_win, NEVER)
    for s in range(entry.occ_cnt.shape[0]):
        w = int(entry.occ_win[s])
        c = entry.occ_cnt[s]
        age = np.int32(now_idx) - np.int32(w)   # wraparound-safe diff
        if age >= 0 and age < B and c > 0:      # landed
            k = w % B
            if entry.sec_stamps[k] != np.int32(w):   # dead bucket: reset
                entry.sec_counters[k, :] = 0
                if track_rt:
                    entry.sec_rt_sum[k] = 0.0
                    entry.sec_min_rt[k] = _I32MAX
                entry.sec_stamps[k] = np.int32(w)
            entry.sec_counters[k, event] += np.int32(c)
        elif age == -1 and c > 0:               # pending: carry
            pend_cnt[s] = c
            pend_win[s] = w
    entry.occ_cnt = pend_cnt
    entry.occ_win = pend_win


def reset_entry_geometry_np(entry: ColdEntry, buckets: int) -> None:
    """In-place second-window cold-reset of one entry to a NEW bucket
    count — the cold-tier mirror of ``runtime.update_window_geometry``,
    which swaps fresh second windows, booking rings, and flow shaping
    state into every RESIDENT row while the minute ring and thread
    gauges carry over. A cold entry gets exactly the same treatment so
    a later promote (a) scatters shapes that match the new spec and
    (b) restores the row bit-identical to one that stayed resident
    through the change. ``reload_gen`` rewinds to 0: the manager clears
    its reload-replay log at a geometry change (pre-change reloads
    settled into buckets that no longer exist, and the reset entry has
    nothing left to settle)."""
    B = int(buckets)
    ne = entry.sec_counters.shape[-1]
    brt = B if entry.sec_rt_sum.shape[0] else 0
    entry.sec_counters = np.zeros((B, ne), np.int32)
    entry.sec_stamps = np.full(B, NEVER, np.int32)
    entry.sec_rt_sum = np.zeros(brt, np.float32)
    entry.sec_min_rt = np.full(brt, _I32MAX, np.int32)
    entry.occ_cnt = np.zeros(B + 1, np.float32)
    entry.occ_win = np.full(B + 1, NEVER, np.int32)
    entry.alts = {
        ident: (np.zeros((B, ne), np.int32), np.full(B, NEVER, np.int32),
                np.zeros(brt, np.float32), np.full(brt, _I32MAX, np.int32),
                alt[4])
        for ident, alt in entry.alts.items()}
    entry.reload_gen = 0


class ColdTier:
    """Locked name → :class:`ColdEntry` store with optional LRU bound."""

    def __init__(self, max_entries: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, ColdEntry]" = \
            collections.OrderedDict()
        self._max = max_entries if max_entries and max_entries > 0 else None
        self._dropped = 0

    def put(self, name: str, entry: ColdEntry) -> None:
        with self._lock:
            self._entries[name] = entry
            self._entries.move_to_end(name)
            if self._max is not None:
                while len(self._entries) > self._max:
                    self._entries.popitem(last=False)
                    self._dropped += 1

    def pop(self, name: str) -> Optional[ColdEntry]:
        with self._lock:
            return self._entries.pop(name, None)

    def convert_geometry(self, buckets: int) -> None:
        """Cold-reset every entry's second windows + booking ring to a
        new bucket count (live geometry change); see
        :func:`reset_entry_geometry_np`."""
        with self._lock:
            for entry in self._entries.values():
                reset_entry_geometry_np(entry, buckets)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def names(self, limit: int = 32) -> List[str]:
        with self._lock:
            out = []
            for n in reversed(self._entries):
                out.append(n)
                if len(out) >= limit:
                    break
            return out
