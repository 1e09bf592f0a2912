"""Host-side fast path for the single-entry tier.

The PyTorch port's own copy of ``sentinel_tpu/engine/fastpath.py`` (pure
Python: the port imports nothing of the JAX package). On a
device-attached engine every ``entry()`` pays a host→device round trip,
even for resources with no rules. This module decides ON THE HOST for the
two cases that dominate real traffic, while every statistic stays on the
device:

* **FREE** resources — named by NO rule of any kind: admit at once and
  buffer the pass; buffered events flush through the normal decide step
  in batches (rule-free events cannot block, so the flush is pure
  ``StatisticSlot`` recording — pass counts, thread gauge, ENTRY node,
  origin/chain rows land exactly as the device path would record them).

* **LEASED** resources — exactly one simple QPS flow rule
  (DefaultController grade, ``limitApp=default``, DIRECT strategy,
  non-cluster): the host pre-charges a token chunk by pushing ONE decide
  with ``acquire=C`` through the full device pipeline, then hands tokens
  out locally until the chunk is exhausted or the window bucket rotates.
  Every leased admission was counted at the pre-charge, so admitting
  beyond the configured count is STRUCTURALLY impossible; the unused
  remainder at bucket rotation is bounded under-admission (the
  conservative direction), and is subtracted back from the window
  afterwards. When a chunk is denied the row is marked hot for the
  bucket and every event takes the exact device path.

Exclusions (events fall through to the device path): prioritized entries
(a PriorityWait admission must book the next window in the device's
booking ring, which a host lease cannot), origin/non-default-context
entries on LEASED rows (their per-origin stats need per-event recording),
and inbound entries while system rules are loaded (SystemSlot gates
inbound traffic globally).

Thread gauge: leased admissions are excluded from the concurrency gauge on
both sides (entry pre-charge and exit both carry ``count_thread=False``),
so the gauge stays consistent; FREE events are thread-counted exactly.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

FREE = 0
LEASED = 1
INELIGIBLE = 2

# lease_state verdicts
ADMIT = 0      # served from the live lease
RENEW = 1      # no live lease (or exhausted, matching) → try a pre-charge
DEVICE = 2     # take the exact device path for this event


class _Lease:
    __slots__ = ("bucket_idx", "remaining", "is_in", "created_ms")

    def __init__(self, bucket_idx: int, remaining: int, is_in: bool,
                 created_ms: int):
        self.bucket_idx = bucket_idx
        self.remaining = remaining
        self.is_in = is_in
        self.created_ms = created_ms


class HostFastPath:
    """Classification tables + stat buffers + lease book-keeping.

    Thread-safe; the runtime owns WHEN to flush (size/age triggers checked
    by :meth:`due`, plus forced flushes before introspection reads).
    """

    def __init__(self, *, flush_events: int, flush_ms: int,
                 lease_fraction: float, win_ms: int):
        self.flush_events = flush_events
        self.flush_ms = flush_ms
        self.lease_fraction = lease_fraction
        self.win_ms = max(1, win_ms)
        self.sys_active = False
        self._ineligible: Set[int] = set()
        self._lease_count: Dict[int, float] = {}
        self._leases: Dict[int, _Lease] = {}
        self._hot_bucket: Dict[int, int] = {}
        self._renewing: Set[int] = set()   # rows with a pre-charge in flight
        # expired leases' unused tokens awaiting window reversal:
        # (row, created_ms, remaining, is_in)
        self._expired: List[tuple] = []
        self._pass_buf: List[tuple] = []
        self._exit_buf: List[tuple] = []
        self._buf_bucket = -1
        self._last_flush_ms = 0
        self._lock = threading.Lock()
        # bumped on every set_tables: a pre-charge granted under an older
        # generation must not install (its budget belongs to the old rules)
        self.table_gen = 0
        # observability: how many device dispatches the fast path avoided
        self.fast_admits = 0
        self.lease_renewals = 0

    # ---------------------------------------------------------------- tables
    def set_tables(self, ineligible: Set[int], lease_counts: Dict[int, float],
                   sys_active: bool) -> None:
        """Swap in a fresh classification after a rule load. Live leases
        are dropped; their unused pre-charged tokens queue for window
        reversal at the next flush (transiently reserved on device until
        then — never over-admission)."""
        with self._lock:
            self._ineligible = ineligible
            self._lease_count = lease_counts
            self.sys_active = sys_active
            self.table_gen += 1
            self._collect_expired_locked(drop_all=True)
            self._hot_bucket.clear()

    def classify(self, row: int) -> int:
        if row in self._ineligible:
            return INELIGIBLE
        if row in self._lease_count:
            return LEASED
        return FREE

    # ---------------------------------------------------------------- leases
    def bucket_of(self, now_ms: int) -> int:
        return now_ms // self.win_ms

    def _retire_lease_locked(self, row: int, lease) -> None:
        """Queue a dead lease's unused remainder for window reversal at the
        next flush (callers hold the lock and have unlinked the lease)."""
        if lease.remaining > 0:
            self._expired.append((row, lease.created_ms,
                                  lease.remaining, lease.is_in))

    def lease_state(self, row: int, acquire: int, is_in: bool,
                    now_ms: int) -> int:
        """→ ADMIT (token taken from the live lease), RENEW (no live lease
        this bucket, or a matching one is exhausted — a pre-charge may
        help), or DEVICE (live lease with a different entry type: renewing
        would burn budget on a second chunk, so the event takes the exact
        device path). Never decides a denial."""
        b = self.bucket_of(now_ms)
        with self._lock:
            lease = self._leases.get(row)
            if lease is not None and lease.bucket_idx != b:
                # bucket rotated: unused tokens go back to their window
                self._leases.pop(row)
                self._retire_lease_locked(row, lease)
                lease = None
            if lease is not None:
                if lease.is_in != is_in:
                    return DEVICE
                if lease.remaining >= acquire:
                    lease.remaining -= acquire
                    self.fast_admits += 1
                    return ADMIT
            return RENEW

    def begin_renewal(self, row: int) -> bool:
        """Claim the single renewal slot for ``row``; False = another
        thread's pre-charge is in flight (caller takes the device path
        instead of double-charging the window)."""
        with self._lock:
            if row in self._renewing:
                return False
            self._renewing.add(row)
            return True

    def end_renewal(self, row: int) -> None:
        with self._lock:
            self._renewing.discard(row)

    def is_hot(self, row: int, now_ms: int) -> bool:
        """True while the current bucket already had a chunk denied —
        every event goes through the exact device path until rotation."""
        return self._hot_bucket.get(row) == self.bucket_of(now_ms)

    def lease_chunk(self, row: int, acquire: int) -> int:
        """Chunk size for a renewal: a fraction of the per-window budget,
        at least the triggering event's acquire."""
        count = self._lease_count.get(row, 0.0)
        per_window = count * self.win_ms / 1000.0
        return max(int(acquire), int(per_window * self.lease_fraction))

    def install_lease(self, row: int, chunk: int, used: int, is_in: bool,
                      now_ms: int, gen: Optional[int] = None) -> None:
        """Credit a granted pre-charge. MERGES into a live matching lease
        (every granted chunk was already recorded on device — dropping one
        would waste budget, never over-admit). ``gen`` (from
        :attr:`table_gen` before the device pre-charge) guards a renewal
        racing a rule reload: a chunk granted under the OLD tables must not
        serve under the new (possibly lower) limit — its unused remainder
        queues straight for window reversal instead (bounded
        under-admission, the safe direction)."""
        with self._lock:
            if gen is not None and gen != self.table_gen:
                if chunk - used > 0:
                    self._expired.append((row, now_ms, chunk - used, is_in))
                self.fast_admits += 1
                return
            b = self.bucket_of(now_ms)
            lease = self._leases.get(row)
            if (lease is not None and lease.bucket_idx == b
                    and lease.is_in == is_in):
                lease.remaining += chunk - used
            else:
                if lease is not None:
                    self._retire_lease_locked(row, lease)
                self._leases[row] = _Lease(b, chunk - used, is_in, now_ms)
            self.lease_renewals += 1
            self.fast_admits += 1

    def mark_hot(self, row: int, now_ms: int) -> None:
        with self._lock:
            self._hot_bucket[row] = self.bucket_of(now_ms)
            lease = self._leases.pop(row, None)
            if lease is not None:
                self._retire_lease_locked(row, lease)

    def _collect_expired_locked(self, drop_all: bool = False,
                                now_ms: Optional[int] = None) -> None:
        b = None if now_ms is None else self.bucket_of(now_ms)
        for row in list(self._leases):
            lease = self._leases[row]
            if drop_all or lease.bucket_idx != b:
                del self._leases[row]
                self._retire_lease_locked(row, lease)

    def expire_all(self) -> None:
        """Reconcile every live lease (snapshot save / shutdown): unused
        tokens queue for window reversal at the next flush."""
        with self._lock:
            self._collect_expired_locked(drop_all=True)

    # ---------------------------------------------------------------- buffers
    def buffer_pass(self, row: int, o_row: int, c_row: int, acquire: int,
                    is_in: bool, now_ms: int) -> None:
        with self._lock:
            if not self._pass_buf and not self._exit_buf:
                self._buf_bucket = self.bucket_of(now_ms)
            self._pass_buf.append((row, o_row, c_row, acquire, is_in, now_ms))
            self.fast_admits += 1

    def buffer_exit(self, row: int, o_row: int, c_row: int, acquire: int,
                    rt_ms: int, error: bool, is_in: bool,
                    count_thread: bool, now_ms: int) -> None:
        with self._lock:
            if not self._pass_buf and not self._exit_buf:
                self._buf_bucket = self.bucket_of(now_ms)
            self._exit_buf.append((row, o_row, c_row, acquire, rt_ms, error,
                                   is_in, count_thread, now_ms))

    def due(self, now_ms: int) -> bool:
        if self._expired:
            return True            # unused lease tokens awaiting reversal
        n = len(self._pass_buf) + len(self._exit_buf)
        if n == 0:
            return False
        if n >= self.flush_events:
            return True
        # bucket rotation: flush BEFORE buffering into a new window slice so
        # each flush group shares one time stamp (exact window attribution)
        # (read without the lock: a stale read delays a flush by one call)
        if self.bucket_of(now_ms) != self._buf_bucket:
            return True
        return now_ms - self._last_flush_ms >= self.flush_ms

    def drain(self, now_ms: int):
        """→ (passes, exits, expired_leases) and reset (caller dispatches
        them to device; expired leases' unused tokens are subtracted back
        from their window buckets)."""
        with self._lock:
            self._collect_expired_locked(now_ms=now_ms)
            p, self._pass_buf = self._pass_buf, []
            x, self._exit_buf = self._exit_buf, []
            e, self._expired = self._expired, []
            self._last_flush_ms = now_ms
            return p, x, e
