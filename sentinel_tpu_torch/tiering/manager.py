"""TierManager: the hot/cold state machine around the device row table.

Port of ``sentinel_tpu/tiering/manager.py``. Lifecycle of a key under
tiering (on by default; ``SENTINEL_TIERING_DISABLE`` reverts to the lossy
eviction):

* **resident (hot)** — a registry row; the dispatch paths are unchanged.
* **demotion** — when the registry recycles a row (LRU overflow, or the
  ticker's proactive ``evict_name``), the engine's eviction drain FIRST
  gathers the row's complete state into fresh tensors
  (``engine.pipeline.extract_resource_rows``) and starts their copy to
  pinned host memory under the engine lock, without waiting; the
  tiering thread lands it into the
  :class:`~sentinel_tpu_torch.tiering.coldtier.ColdTier` off the lock.
  THEN the usual invalidate runs. ``tier.demoted`` ticks.
* **cold** — host memory only; unbounded cardinality.
* **promotion (the slow path)** — when a cold key is interned again, the
  next eviction drain (under the engine lock, before every decide)
  scatters the cold payload back into the freshly allocated row
  (``restore_resource_rows``), after replaying any flow-rule reloads the
  key slept through
  (:func:`~sentinel_tpu_torch.tiering.coldtier.settle_entry_np`). The
  decide that interned the key sees the row exactly as if it had never
  left. ``tier.cold_miss`` + ``tier.promoted`` tick; the host time lands
  in :attr:`TierManager.migration_hist`.

Hot-set discovery: a conservative-update count-min sketch
(:mod:`~sentinel_tpu_torch.tiering.sketch`) over each batch's resource
rows, updated under the engine lock inside the decide paths. The ticker
(the telemetry ticker's discipline: enqueue under the lock, land off it)
decays the sketch, reads every row's estimate and demotes the
lowest-estimate unpinned rows whenever the resident count exceeds the
``SENTINEL_HOT_ROWS`` target.

Demotion attribution: the registry's eviction queue carries row ids
(the name is gone by then), so the manager keeps a shadow ``row → name``
map, kept at every intern site (:meth:`TierManager.note_interned`). Rows
reallocated by paths that bypass interning resync from
``registry.name_of`` at drain time and their previous owner's state is
dropped unattributed.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.core.pending import start_host_copy, wait_host_copy
from sentinel_tpu_torch.core.registry import ENTRY_NODE_ROW
from sentinel_tpu_torch.obs import counters as obs_keys
from sentinel_tpu_torch.obs.hist import LogHistogram
from sentinel_tpu_torch.stats import events as ev
from sentinel_tpu_torch.tiering import sketch as sk
from sentinel_tpu_torch.tiering.coldtier import (
    ColdEntry, ColdTier, settle_entry_np,
)

HOT_ROWS_ENV = "SENTINEL_HOT_ROWS"
SKETCH_BITS_ENV = "SENTINEL_SKETCH_BITS"
SKETCH_ROWS_ENV = "SENTINEL_SKETCH_ROWS"
TIER_TICK_MS_ENV = "SENTINEL_TIER_TICK_MS"
TIERING_DISABLE_ENV = "SENTINEL_TIERING_DISABLE"
TIER_COLD_MAX_ENV = "SENTINEL_TIER_COLD_MAX"

DEFAULT_TICK_MS = 200
# un-landed demote payloads tolerated before the drain side force-lands
# inline (the ticker normally lands them; this bounds the pinned buffers
# held when no ticker runs, e.g. short-lived test engines)
PENDING_LAND_MAX = 64

NEVER = -(2 ** 30)
_I32MAX = np.iinfo(np.int32).max


def _env_int(env: str, default: Optional[int], lo: int,
             hi: int) -> Optional[int]:
    raw = os.environ.get(env, "")
    if not raw:
        return default
    try:
        return max(lo, min(hi, int(raw)))
    except ValueError:
        return default


def tier_hot_rows(default: Optional[int] = None) -> Optional[int]:
    """Resident-row target for the ticker's proactive demotion; default
    None = the full table (LRU-overflow demotion only)."""
    return _env_int(HOT_ROWS_ENV, default, 64, 1 << 24)


def tier_sketch_bits(default: int = sk.DEFAULT_BITS) -> int:
    return _env_int(SKETCH_BITS_ENV, default, 4, 22)


def tier_sketch_rows(default: int = sk.DEFAULT_ROWS) -> int:
    return _env_int(SKETCH_ROWS_ENV, default, 1, 8)


def tier_tick_ms(default: int = DEFAULT_TICK_MS) -> int:
    return _env_int(TIER_TICK_MS_ENV, default, 10, 60000)


def tier_cold_max(default: int = 0) -> int:
    """Cold-tier entry bound; 0 = unbounded (the default)."""
    return _env_int(TIER_COLD_MAX_ENV, default, 0, 1 << 31)


def tiering_disabled() -> bool:
    return os.environ.get(TIERING_DISABLE_ENV, "").lower() in (
        "1", "true", "on", "yes")


def _pad_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _payload_leaves(p) -> list:
    """The demote payload's tensors in a fixed order (see
    :func:`_payload_arrays`)."""
    out = list(p.second) + list(p.minute) + [p.threads, p.occ_cnt,
                                             p.occ_win]
    out += list(p.alt_second) + [p.alt_threads]
    if p.rt_hist is not None:
        out.append(p.rt_hist)
    return out


def _payload_arrays(arrs: list) -> dict:
    """Numpy arrays of :func:`_payload_leaves` → named groups."""
    return {"second": arrs[0:4], "minute": arrs[4:8], "threads": arrs[8],
            "occ_cnt": arrs[9], "occ_win": arrs[10],
            "alt_second": arrs[11:15], "alt_threads": arrs[15],
            "rt_hist": arrs[16] if len(arrs) > 16 else None}


class TierManager:
    """Per-:class:`~sentinel_tpu_torch.runtime.Sentinel` tiering service
    (``Sentinel.tiering``). Host structures live under a manager-local
    lock; the ``*_locked`` hooks additionally run under the ENGINE lock
    (they touch ``sentinel._state``). Lock order is always engine lock →
    manager lock, never the reverse."""

    def __init__(self, sentinel, *, enabled: Optional[bool] = None) -> None:
        self._sentinel = sentinel
        self._obs = sentinel.obs
        if enabled is None:
            enabled = not tiering_disabled()
        self.enabled = bool(enabled)
        self.hot_rows = tier_hot_rows()
        self.cold = ColdTier(tier_cold_max() or None)
        self.migration_hist = LogHistogram()
        self._lock = threading.Lock()
        # row → current owner name, kept at every intern site
        self._shadow: Dict[int, str] = {}
        # row → FIRST victim name since the last eviction drain (later
        # victims of the same row lived entirely between drains: no
        # decide ever saw them, nothing on the device to save)
        self._pending_demote: Dict[int, str] = {}
        # name → row awaiting a cold→hot restore at the next drain
        self._pending_promote: Dict[str, int] = {}
        # names whose demote payload is copying but not yet landed
        self._pending_land: Dict[str, dict] = {}
        self._land_q: "collections.deque" = collections.deque()
        self._est_q: "collections.deque" = collections.deque()
        # flow-rule reload log: second-window now_idx per reload; a cold
        # entry replays the tail it slept through at promote time
        self._reload_idxs: List[int] = []
        self._sketch = None
        self._ticks = 0
        self._last_est: Optional[np.ndarray] = None
        # epilogue carry cadence: when armed (serving.CadenceScheduler),
        # serving traffic runs the decay+estimate inside its fused
        # dispatch and the scheduler only self-dispatches on idle gaps
        self._carry_ms: Optional[int] = None
        self._last_tick_ms = int(sentinel.clock.now_ms())
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        if self.enabled:
            self._sketch = sk.init_sketch(tier_sketch_rows(),
                                          tier_sketch_bits(),
                                          device=sentinel.device)
        # demote listeners (frontend/batcher.py prunes its name→row
        # cache so a demoted key re-interns — and promotes — instead of
        # dispatching against a recycled row)
        self._demote_listeners: list = []
        reg = getattr(sentinel, "register_shutdown", None)
        if reg is not None:
            reg(self)

    # ---- intern-time hooks (outside the engine lock) ------------------

    def note_interned(self, names, rows, tick: bool = True) -> None:
        """Record name→row ownership for a just-interned batch and
        classify each occurrence: resident name → ``tier.hot_hit``; a
        name the cold tier (or an in-flight demote) knows →
        ``tier.cold_miss`` + a queued promotion; a first-sight name →
        neither. ``tick=False`` (the rule-load pin path) keeps the shadow
        map and the promotion queue exact without counting control-plane
        interns into the serving hit rate."""
        if not self.enabled:
            return
        hot = cold = 0
        with self._lock:
            seen: Dict[str, list] = {}    # name → [count, classification]
            # two passes, so a name's classification cannot depend on
            # its position in the batch: when A's fresh row displaced B
            # and B is also in this batch at a new row, B's cold-miss
            # test must see the demote intent A's displacement records
            fresh: List[Tuple[str, int]] = []
            for i, name in enumerate(names):
                rec = seen.get(name)
                if rec is not None:
                    rec[0] += 1
                    continue
                row = int(rows[i])
                prev = self._shadow.get(row)
                if prev == name:
                    seen[name] = [1, "hot"]
                    continue
                self._shadow[row] = name
                if prev is not None:
                    self._pending_demote.setdefault(row, prev)
                seen[name] = [1, "new"]
                fresh.append((name, row))
            # the names with a demote intent, once (a scan of the intents
            # for every fresh name is quadratic at serving widths)
            demoting = (set(self._pending_demote.values()) if fresh
                        else ())
            for name, row in fresh:
                if (name in self.cold or name in self._pending_land
                        or name in demoting):
                    self._pending_promote[name] = row
                    seen[name][1] = "cold"
            for _name, (cnt, kind) in seen.items():
                if kind == "hot":
                    hot += cnt
                elif kind == "cold":
                    cold += cnt
        if tick and self._obs.enabled:
            if hot:
                self._obs.counters.add(obs_keys.TIER_HOT_HIT, hot)
            if cold:
                self._obs.counters.add(obs_keys.TIER_COLD_MISS, cold)

    def note_hot_hits(self, n: int) -> None:
        """Front-end name→row cache hits: resident by construction (the
        cache is pruned on demotion), counted so the hit rate covers the
        whole serving path."""
        if self.enabled and n and self._obs.enabled:
            self._obs.counters.add(obs_keys.TIER_HOT_HIT, n)

    def add_demote_listener(self, fn) -> None:
        """``fn(names: List[str])`` fires when keys leave the hot tier
        (from the eviction drain, still under the engine lock — keep it
        O(names))."""
        self._demote_listeners.append(fn)

    # ---- engine-lock hooks -------------------------------------------

    def observe_locked(self, rows_dev, valid_dev) -> bool:
        """Sketch update from a decide batch's device row array, no wait
        on the device. This standalone update is the composition with
        ``SENTINEL_SINGLE_DISPATCH`` off; with it on, the runtime runs the
        same :func:`sketch.update_sketch` inside the decide call (see
        :meth:`sketch_for_fuse_locked`). → whether an update was issued
        (the runtime's ``pipeline.dispatches`` accounting)."""
        if self._sketch is None:
            return False
        self._sketch, _overflow = sk.update_sketch(self._sketch, rows_dev,
                                                   valid_dev)
        return True

    # ---- single-dispatch surface -------------------------------------

    def sketch_for_fuse_locked(self):
        """Engine lock held: the sketch table for a decide call that
        updates it itself, or None when tiering (or its sketch) is off —
        None tells the runtime to take the legacy
        :meth:`observe_locked` composition."""
        if not self.enabled or self._closed:
            return None
        return self._sketch

    def set_sketch_locked(self, sketch) -> None:
        """Engine lock held: store the sketch a fused decide returned."""
        self._sketch = sketch

    def arm_carry(self, interval_ms: int) -> None:
        """Let serving traffic carry the decay+estimate tick inside the
        fused dispatch at this cadence (serving.CadenceScheduler)."""
        with self._lock:
            self._carry_ms = max(1, int(interval_ms))
            self._last_tick_ms = int(self._sentinel.clock.now_ms())

    def disarm_carry(self) -> None:
        with self._lock:
            self._carry_ms = None

    def last_tick_ms(self) -> int:
        with self._lock:
            return self._last_tick_ms

    def carry_due_locked(self, now_ms: int) -> bool:
        """Engine lock held: claim one carried tick if the cadence is
        armed and due. The claim moves ``last_tick_ms`` at once — the
        caller runs the epilogue in the same lock hold, so a concurrent
        self-dispatch does not tick twice."""
        if not self.enabled or self._closed or self._sketch is None:
            return False
        with self._lock:
            if (self._carry_ms is None
                    or now_ms - self._last_tick_ms < self._carry_ms):
                return False
            self._last_tick_ms = int(now_ms)
            return True

    def queue_estimates(self, est) -> None:
        """Engine lock held: queue an epilogue-carried estimate (its copy
        to the host starts here). Counted as a tick; :meth:`drain` lands
        it like a self-dispatched one."""
        copy = start_host_copy((est,))
        with self._lock:
            self._est_q.append(copy)
            self._ticks += 1

    def pre_invalidate_locked(self, evicted: List[int], now_ms: int) -> None:
        """Demote snapshot: gather the evicted rows' state BEFORE the
        invalidate destroys it, into fresh tensors whose copy to the host
        starts here; the tiering thread lands them (or a promote
        force-lands one). Stream order makes the gather read the values
        from before the invalidate dispatched right after."""
        if not self.enabled:
            return
        sn = self._sentinel
        victims: List[Tuple[str, int]] = []
        with self._lock:
            for row in evicted:
                name = self._pending_demote.pop(row, None)
                from_queue = name is not None
                if name is None:
                    name = self._shadow.get(row)
                cur = sn.resources.name_of(row)
                if cur is not None:
                    self._shadow[row] = cur
                else:
                    self._shadow.pop(row, None)
                if name is None or row == ENTRY_NODE_ROW:
                    continue    # unattributable (pin-path reallocation)
                if not from_queue and name == cur:
                    continue    # stale duplicate queue entry; still owned
                victims.append((name, row))
        if not victims:
            return
        # alt slots: hashed (resource × origin/context) slices travel
        # with their HOST identity so the promote can re-hash them
        alt_ids: List[Tuple[int, int, int]] = []   # (victim_i, kind, key)
        alt_slots: List[int] = []
        for vi, (_name, row) in enumerate(victims):
            for slot, ident in sn._alt_rows_by_row.get(row, {}).items():
                if ident is None:
                    continue    # identity unknown: slice not portable
                alt_ids.append((vi, ident[0], ident[1]))
                alt_slots.append(slot)
        from sentinel_tpu_torch.engine.pipeline import extract_resource_rows
        k = len(victims)
        kp = _pad_pow2(k)
        ka = _pad_pow2(len(alt_slots)) if alt_slots else 1
        rows_arr = np.full(kp, sn.spec.rows, np.int32)    # pad → dropped
        rows_arr[:k] = [r for _n, r in victims]
        alt_arr = np.full(ka, sn.spec.alt_rows, np.int32)
        if alt_slots:
            alt_arr[:len(alt_slots)] = alt_slots
        payload = extract_resource_rows(sn.spec, sn._state, sn._dev(rows_arr),
                                        sn._dev(alt_arr))
        copy = start_host_copy(_payload_leaves(payload))
        with self._lock:
            rec = {"victims": victims, "alt_ids": alt_ids, "copy": copy,
                   "now_ms": now_ms, "gen": len(self._reload_idxs),
                   "landed": False, "lock": threading.Lock()}
            for name, _row in victims:
                self._pending_land[name] = rec
            self._land_q.append(rec)
            force = len(self._land_q) > PENDING_LAND_MAX
        if self._obs.enabled:
            self._obs.counters.add(obs_keys.TIER_DEMOTED, k)
        if force:
            self._land_all()
        if self._demote_listeners:
            names = [n for n, _r in victims]
            for fn in self._demote_listeners:
                try:
                    fn(names)
                except Exception:
                    pass

    def post_invalidate_locked(self, now_ms: int) -> None:
        """Promote every pending cold key into its freshly allocated
        (and just-invalidated) row — the synchronous half of the slow
        path, under the engine lock, so the decide that interned the key
        sees the restored row."""
        if not self.enabled:
            return
        with self._lock:
            if not self._pending_promote:
                return
            todo = list(self._pending_promote.items())
            self._pending_promote.clear()
        sn = self._sentinel
        t0 = time.monotonic_ns()
        entries: List[Tuple[str, int, ColdEntry]] = []
        for name, row in todo:
            with self._lock:
                if self._shadow.get(row) != name:
                    # row recycled again before this drain; the entry
                    # stays cold for the next intern of the name
                    continue
                pend = self._pending_land.get(name)
            if pend is not None:
                # force-land THIS record: a queue-level _land_all would
                # no-op if the tiering thread already dequeued it and has
                # not finished landing, and the promote below would pop
                # a missing entry; the per-record lock waits it out
                self._land_one(pend)
            entry = self.cold.pop(name)
            if entry is None:
                continue            # dropped (bounded cold tier)
            if entry.sec_counters.shape[0] != sn.spec.second.buckets:
                # extracted under a previous window geometry and missed
                # by the conversion (landed after it): its second windows
                # are void by the cold-reset rule — drop, the key
                # re-enters fresh like a resident row after the change
                continue
            # replay the flow reloads this key slept through, each with
            # THAT reload's now_idx
            with self._lock:
                idxs = self._reload_idxs[entry.reload_gen:]
            for idx in idxs:
                settle_entry_np(sn.spec.second.buckets, entry, idx, ev.PASS)
            entries.append((name, row, entry))
        if not entries:
            return
        self._restore_locked(entries)
        if self._obs.enabled:
            self._obs.counters.add(obs_keys.TIER_PROMOTED, len(entries))
        self.migration_hist.record(time.monotonic_ns() - t0)

    def _restore_locked(self, entries) -> None:
        """One scatter of the whole promote batch into the state."""
        from sentinel_tpu_torch.engine.pipeline import (
            ResourceRowSlice, restore_resource_rows,
        )
        from sentinel_tpu_torch.runtime import _alt_hash
        from sentinel_tpu_torch.stats.window import WindowState
        sn = self._sentinel
        spec = sn.spec
        k = len(entries)
        kp = _pad_pow2(k)
        B = spec.second.buckets
        e0 = entries[0][2]
        ne = e0.sec_counters.shape[-1]
        brt = e0.sec_rt_sum.shape[0]
        mb, mbrt = e0.min_stamps.shape[0], e0.min_rt_sum.shape[0]
        sec_c = np.zeros((kp, B, ne), np.int32)
        sec_s = np.full((kp, B), NEVER, np.int32)
        sec_rt = np.zeros((kp, brt), np.float32)
        sec_mr = np.full((kp, brt), _I32MAX, np.int32)
        min_c = np.zeros((kp, max(mb, 1), ne), np.int32)
        min_s = np.full((kp, max(mb, 1)), NEVER, np.int32)
        min_rt = np.zeros((kp, mbrt), np.float32)
        min_mr = np.full((kp, mbrt), _I32MAX, np.int32)
        thr = np.zeros(kp, np.int32)
        occ_c = np.zeros((kp, B + 1), np.float32)
        occ_w = np.full((kp, B + 1), NEVER, np.int32)
        hb = spec.hist_buckets
        # zeros for entries that predate the histogram table (they
        # restore with an empty — not stale — tail view)
        rt_h = np.zeros((kp, hb), np.int32) if hb else None
        rows_arr = np.full(kp, spec.rows, np.int32)
        alt_rows: List[int] = []
        alt_payload: List[tuple] = []
        for i, (_name, row, e) in enumerate(entries):
            rows_arr[i] = row
            sec_c[i], sec_s[i] = e.sec_counters, e.sec_stamps
            sec_rt[i], sec_mr[i] = e.sec_rt_sum, e.sec_min_rt
            if mb:
                min_c[i], min_s[i] = e.min_counters, e.min_stamps
                min_rt[i], min_mr[i] = e.min_rt_sum, e.min_min_rt
            thr[i] = e.threads
            occ_c[i], occ_w[i] = e.occ_cnt, e.occ_win
            if rt_h is not None and e.rt_hist is not None \
                    and e.rt_hist.shape[0] == hb:
                rt_h[i] = e.rt_hist
            for (kind, key_id), alt in e.alts.items():
                slot = _alt_hash(row, kind, key_id, spec.alt_rows)
                sn._alt_rows_by_row.setdefault(row, {})[slot] = (kind,
                                                                  key_id)
                alt_rows.append(slot)
                alt_payload.append(alt)
        ka = _pad_pow2(len(alt_rows)) if alt_rows else 1
        alt_arr = np.full(ka, spec.alt_rows, np.int32)
        alt_c = np.zeros((ka, B, ne), np.int32)
        alt_s = np.full((ka, B), NEVER, np.int32)
        alt_rt = np.zeros((ka, brt), np.float32)
        alt_mr = np.full((ka, brt), _I32MAX, np.int32)
        alt_thr = np.zeros(ka, np.int32)
        for j, alt in enumerate(alt_payload):
            alt_arr[j] = alt_rows[j]
            alt_c[j], alt_s[j], alt_rt[j], alt_mr[j], alt_thr[j] = alt
        d = sn._dev
        payload = ResourceRowSlice(
            second=WindowState(d(sec_c), d(sec_s), d(sec_rt), d(sec_mr)),
            minute=WindowState(d(min_c), d(min_s), d(min_rt), d(min_mr)),
            threads=d(thr), occ_cnt=d(occ_c), occ_win=d(occ_w),
            alt_second=WindowState(d(alt_c), d(alt_s), d(alt_rt),
                                   d(alt_mr)),
            alt_threads=d(alt_thr),
            rt_hist=d(rt_h) if rt_h is not None else None)
        sn._state = restore_resource_rows(spec, sn._state, d(rows_arr),
                                          payload, d(alt_arr))

    def on_rules_reloaded_locked(self, now_idx: int) -> None:
        """Flow-rule reload: resident rows just had their landed bookings
        settled at ``now_idx``; log it so cold entries replay the same
        settle at promote time."""
        if not self.enabled:
            return
        with self._lock:
            self._reload_idxs.append(int(now_idx))

    def on_geometry_changed_locked(self) -> None:
        """Live second-window geometry change (engine lock held): every
        cold entry and in-flight demote payload holds the OLD bucket
        count. Land every in-flight payload first (the per-record lock
        covers records the tiering thread holds mid-land), then
        cold-reset each entry's second windows and booking ring to the
        new bucket count, the minute ring and gauge carrying over —
        what resident rows get, so demote → change → promote stays
        bit-identical to staying resident. The reload log restarts."""
        if not self.enabled:
            return
        with self._lock:
            recs = list({id(r): r for r in
                         self._pending_land.values()}.values())
        for rec in recs:
            self._land_one(rec)
        with self._lock:
            self._land_q.clear()    # all landed (or marked) above
            self._reload_idxs.clear()
        self.cold.convert_geometry(self._sentinel.spec.second.buckets)

    # ---- landing (tiering thread / forced) ----------------------------

    def _land_all(self) -> int:
        with self._lock:
            batch = list(self._land_q)
            self._land_q.clear()
        for rec in batch:
            self._land_one(rec)
        return len(batch)

    def _land_one(self, rec) -> None:
        # per-record lock: the engine side may force-land a record the
        # tiering thread already dequeued — whoever comes second waits
        # for the first to finish (cold.put done), then no-ops
        with rec["lock"]:
            self._land_one_held(rec)

    def _land_one_held(self, rec) -> None:
        if rec["landed"]:
            return
        p = _payload_arrays(wait_host_copy(*rec["copy"]))
        sec, mnt, alt_sec = p["second"], p["minute"], p["alt_second"]
        threads, alt_thr, rh = p["threads"], p["alt_threads"], p["rt_hist"]
        occ_c, occ_w = p["occ_cnt"], p["occ_win"]
        alts_of: Dict[int, dict] = {}      # victim index → its alt slices
        for j, (avi, kind, key_id) in enumerate(rec["alt_ids"]):
            alts_of.setdefault(avi, {})[(kind, key_id)] = (
                alt_sec[0][j].copy(), alt_sec[1][j].copy(),
                alt_sec[2][j].copy(), alt_sec[3][j].copy(),
                int(alt_thr[j]))
        for vi, (name, _row) in enumerate(rec["victims"]):
            alts = alts_of.get(vi, {})
            entry = ColdEntry(
                sec_counters=sec[0][vi].copy(), sec_stamps=sec[1][vi].copy(),
                sec_rt_sum=sec[2][vi].copy(), sec_min_rt=sec[3][vi].copy(),
                min_counters=mnt[0][vi].copy(), min_stamps=mnt[1][vi].copy(),
                min_rt_sum=mnt[2][vi].copy(), min_min_rt=mnt[3][vi].copy(),
                threads=int(threads[vi]),
                occ_cnt=occ_c[vi].copy(), occ_win=occ_w[vi].copy(),
                alts=alts, reload_gen=rec["gen"], demoted_ms=rec["now_ms"],
                rt_hist=rh[vi].copy() if rh is not None else None)
            self.cold.put(name, entry)
            with self._lock:
                if self._pending_land.get(name) is rec:
                    del self._pending_land[name]
        rec["copy"] = None
        rec["landed"] = True

    # ---- ticker -------------------------------------------------------

    def tick(self) -> bool:
        """One sketch decay + full-table estimate read under the engine
        lock, its copy to the host started, nothing waited on."""
        if not self.enabled or self._closed or self._sketch is None:  # graftlint: disable=LOCK002 -- lock-free early-out; a stale read only skips one tick and the next tick re-reads
            return False
        sn = self._sentinel
        with sn._lock:
            self._sketch, est = sk.tick_read(self._sketch, sn.spec.rows)
            copy = start_host_copy((est,))
        if self._obs.enabled:
            self._obs.counters.add(obs_keys.PIPE_DISPATCH)
        with self._lock:
            self._est_q.append(copy)
            self._ticks += 1
            self._last_tick_ms = int(sn.clock.now_ms())
        return True

    def drain(self) -> int:
        """Land queued demote payloads + sketch estimates OFF the engine
        lock; handle sketch overflow; run proactive demotion against the
        hot-rows target."""
        n = self._land_all()
        with self._lock:
            ests = list(self._est_q)
            self._est_q.clear()
        if ests:
            est = wait_host_copy(*ests[-1])[0]
            self._last_est = est
            # update_sketch already halved at the cap inside the decide
            # calls; an estimate still >= cap/2 means an overflow
            # happened since the last tick — count it and halve again to
            # keep headroom
            if est.size and int(est.max()) >= sk.OVERFLOW_CAP // 2:
                with self._sentinel._lock:
                    self._sketch = sk.halve_sketch(self._sketch)
                if self._obs.enabled:
                    self._obs.counters.add(obs_keys.TIER_SKETCH_OVERFLOW)
            self._demote_cold_rows(est)
        return n + len(ests)

    def _demote_cold_rows(self, est: np.ndarray) -> None:
        """Evict the lowest-estimate unpinned residents down to the
        ``SENTINEL_HOT_ROWS`` target, round-robin across shards (one
        device: one shard)."""
        target = self.hot_rows
        reg = self._sentinel.resources
        evict = getattr(reg, "evict_name", None)
        if target is None or evict is None:
            return
        items = reg.items()
        over = len(items) - int(target)
        if over <= 0:
            return
        from sentinel_tpu_torch.parallel.local_shard import shard_of_rows
        cand = [(int(est[row]), name, row) for name, row in items
                if row != ENTRY_NODE_ROW and row < len(est)]
        cand.sort()
        shards = shard_of_rows(self._sentinel.spec.rows,
                               self._sentinel.mesh,
                               np.asarray([c[2] for c in cand], np.int32))
        by_shard: Dict[int, collections.deque] = {}
        for c, s in zip(cand, shards):
            by_shard.setdefault(int(s), collections.deque()).append(c)
        done = 0
        while done < over and by_shard:
            for s in list(by_shard):
                q = by_shard[s]
                while q:
                    _e, name, row = q.popleft()
                    # record the intent BEFORE evict_name frees the row:
                    # a re-intern of the name between the registry's pop
                    # and the intent would classify hot against the stale
                    # shadow, and the next drain would invalidate the row
                    # without queuing its promotion
                    with self._lock:
                        if self._shadow.get(row) != name:
                            continue    # re-owned since the estimate
                        claimed = row not in self._pending_demote
                        if claimed:
                            self._pending_demote[row] = name
                        del self._shadow[row]
                    if evict(name):
                        done += 1
                        break
                    # evict refused (pinned / raced away): roll back so
                    # the name does not look cold while still resident
                    with self._lock:
                        if (claimed and
                                self._pending_demote.get(row) == name):
                            del self._pending_demote[row]
                        self._shadow.setdefault(row, name)
                if not q:
                    del by_shard[s]
                if done >= over:
                    break

    def poll(self) -> int:
        self.tick()
        return self.drain()

    def start(self, interval_sec: Optional[float] = None) -> None:
        """Start the tiering daemon (no-op when disabled or running)."""
        if not self.enabled or self._thread is not None or self._closed:
            return
        if interval_sec is None:
            interval_sec = tier_tick_ms() / 1000.0
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_sec):
                try:
                    self.poll()
                except Exception:   # pragma: no cover — keep daemon alive
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="sentinel-tiering")
        self._thread.start()

    def stop(self) -> None:
        """Idempotent; registered with ``Sentinel.register_shutdown``."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        if self._closed:
            return
        self._closed = True
        try:
            self._land_all()
        except Exception:   # teardown must not depend on device health
            pass

    # ---- read surface -------------------------------------------------

    def snapshot(self) -> Dict:
        """Counts, cold-tier size and migration percentiles."""
        c = self._obs.counters
        with self._lock:
            pend = len(self._land_q)
            ticks = self._ticks
        p50 = self.migration_hist.percentile(0.50)
        p99 = self.migration_hist.percentile(0.99)
        return {
            "enabled": self.enabled,
            "hot_rows_target": self.hot_rows,
            "resident": len(self._sentinel.resources),
            "cold": len(self.cold),
            "cold_dropped": self.cold.dropped,
            "pending_land": pend,
            "ticks": ticks,
            "hot_hit": c.get(obs_keys.TIER_HOT_HIT),
            "cold_miss": c.get(obs_keys.TIER_COLD_MISS),
            "promoted": c.get(obs_keys.TIER_PROMOTED),
            "demoted": c.get(obs_keys.TIER_DEMOTED),
            "sketch_overflow": c.get(obs_keys.TIER_SKETCH_OVERFLOW),
            "migrate_p50_ms": None if p50 is None else p50 / 1e6,
            "migrate_p99_ms": None if p99 is None else p99 / 1e6,
        }

    def hit_rate(self) -> Optional[float]:
        """hot_hit / (hot_hit + cold_miss) — None before any classified
        intern (first-sight registrations count as neither)."""
        c = self._obs.counters
        h = c.get(obs_keys.TIER_HOT_HIT)
        m = c.get(obs_keys.TIER_COLD_MISS)
        return h / (h + m) if (h + m) else None


__all__ = [
    "HOT_ROWS_ENV", "SKETCH_BITS_ENV", "SKETCH_ROWS_ENV",
    "TIER_TICK_MS_ENV", "TIERING_DISABLE_ENV", "TIER_COLD_MAX_ENV",
    "DEFAULT_TICK_MS", "PENDING_LAND_MAX", "TierManager",
    "tier_hot_rows", "tier_sketch_bits", "tier_sketch_rows",
    "tier_tick_ms", "tier_cold_max", "tiering_disabled",
]
