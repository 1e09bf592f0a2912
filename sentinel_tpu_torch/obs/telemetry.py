"""Device-resident hot-resource telemetry: top-K and a per-second
timeline over the live window state.

Port of ``sentinel_tpu/obs/telemetry.py`` on one GPU. One telemetry tick
(:func:`telemetry_tick`) reads the engine's live ``WindowState`` without
touching the serving path:

* **top-K** — rolling PASS+BLOCK load per row
  (:func:`sentinel_tpu_torch.stats.window.rolling_load`), the global
  ENTRY row masked to -1, ranked with ``torch.topk`` on a key that is
  unique per row, ``load·2^32 + (2^32-1-row)``: ``torch.topk`` does not
  promise which of equal values it returns first, the reference's
  ``lax.top_k`` keeps the lowest index. With the row in the key the
  result equals a host ``argsort(-load, kind="stable")[:k]``, ties
  included, on the CPU and on the card. The hot rows' rolling lanes,
  landed-second lanes and RT histograms are gathered row by row (the
  reference reduces all ``[R, E]`` first and gathers after: the values
  are equal, the bytes are k rows'). On a row-sharded engine each block
  ranks its own rows (``k_local = min(k, rows_per_block)`` candidates,
  keyed on the GLOBAL row, the ENTRY row masked in block 0), the
  candidates join in block order and one final rank picks k
  (:func:`sharded_topk_rows`, the reference's ``_sharded_topk``); the hot
  rows' lanes and histograms are gathered from their owners.
* **timeline** — the ENTRY row's completed-second bucket of the minute
  window appended into a small device ring (:class:`TelemetryRing`) once
  per second.
* **asynchronous readback** — :meth:`HotTelemetry.tick` only enqueues
  the read and the copies to pinned host memory, under the engine lock;
  :meth:`HotTelemetry.drain` waits for those copies (one CUDA event) off
  the lock. When the drain falls :data:`PENDING_MAX` behind, new ticks
  are dropped and counted (``telemetry.readback_drop``): a tick never
  waits on the device.

Host surfaces: per-resource second lines for the top-K only, written as
``<app>-metric`` through :mod:`sentinel_tpu_torch.metrics.writer`, and
the flight recorder's pinned hot set (``obs.flight.hot_provider``).

Env knobs (construction time; kwargs override), the reference's names:
``SENTINEL_TELEMETRY_K`` — hot-set size, default 16, clamped to
[1, :data:`MAX_K`] and to the row count; ``SENTINEL_TELEMETRY_DISABLE``
— telemetry off (``SENTINEL_OBS_DISABLE`` turns it off too).
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core.pending import start_host_copy, wait_host_copy
from sentinel_tpu_torch.core.registry import ENTRY_NODE_ROW
from sentinel_tpu_torch.obs import counters as obs_keys
from sentinel_tpu_torch.obs import resource_hist
from sentinel_tpu_torch.parallel.local_shard import topk_layout
from sentinel_tpu_torch.parallel.row_blocks import RowBlocks
from sentinel_tpu_torch.stats import events as ev
from sentinel_tpu_torch.stats import window

TELEMETRY_K_ENV = "SENTINEL_TELEMETRY_K"
TELEMETRY_DISABLE_ENV = "SENTINEL_TELEMETRY_DISABLE"

DEFAULT_K = 16
MAX_K = 128
RING_SLOTS = 64          # device timeline ring depth (~1 min at 1 Hz)
PENDING_MAX = 2          # un-drained device readbacks before drop-and-count
HOT_TIMELINE_CAP = 120   # host-side timeline tail kept for the readers
FLIGHT_HOT_N = 8         # hot entries pinned into flight trigger records

_LOW32 = (1 << 32) - 1


def telemetry_disabled() -> bool:
    return os.environ.get(TELEMETRY_DISABLE_ENV, "").lower() in (
        "1", "true", "on", "yes")


def telemetry_k(default: int = DEFAULT_K) -> int:
    raw = os.environ.get(TELEMETRY_K_ENV, "")
    if not raw:
        return default
    try:
        return max(1, min(MAX_K, int(raw)))
    except ValueError:
        return default


class TelemetryRing(NamedTuple):
    """Device-resident per-second timeline ring (a few KB; only the
    write index moves)."""

    seconds: torch.Tensor   # int32[S] minute-window idx written (NEVER=empty)
    lanes: torch.Tensor     # int32[S, E] ENTRY-row completed-second lanes
    rt: torch.Tensor        # float32[S] ENTRY-row completed-second rt sum
    cursor: torch.Tensor    # int32[] total appends (slot = cursor % S)


def init_ring(slots: int = RING_SLOTS, num_events: int = ev.NUM_EVENTS,
              device="cpu") -> TelemetryRing:
    return TelemetryRing(
        seconds=torch.full((slots,), window.NEVER, dtype=torch.int32,
                           device=device),
        lanes=torch.zeros((slots, num_events), dtype=torch.int32,
                          device=device),
        rt=torch.zeros((slots,), dtype=torch.float32, device=device),
        cursor=torch.zeros((), dtype=torch.int32, device=device),
    )


def _top_keys(load: torch.Tensor, k: int, base: int = 0) -> torch.Tensor:
    """The ``k`` largest keys ``load·2^32 + (2^32−1−row)`` of a load
    vector whose first entry is global row ``base`` (sorted, unique)."""
    row = torch.arange(load.shape[0], dtype=torch.int64,
                       device=load.device) + base
    key = load.to(torch.int64) * (1 << 32) + (_LOW32 - row)
    return torch.topk(key, k).values


def _split_key(top: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return ((top >> 32).to(torch.int32),
            (_LOW32 - (top & _LOW32)).to(torch.int32))


def topk_rows(load: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """``(int32[k] loads, int32[k] rows)`` of the ``k`` largest loads,
    ties to the lowest row: the order of a host
    ``argsort(-load, kind="stable")``. Loads must fit int32."""
    return _split_key(_top_keys(load, k))


def sharded_topk_rows(load: RowBlocks, k: int) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """:func:`topk_rows` over a row-block load: each block ranks its own
    rows (``min(k, rows_per_block)`` candidates are enough: at most k
    global winners live in one block), the candidates join in block
    order on the home device and one final rank picks ``k``. The keys
    carry the global row, so the result equals the one-block ranking,
    ties included. In the rank-local form each rank's candidates meet in
    one ``all_gather`` (rank order is block order) before the final
    rank, the pattern of ``multihost.obs_agg.aggregate_topk``."""
    per = load.per
    cand = torch.cat([_top_keys(b, min(k, per),
                                (load.first + i) * per).to(load.home)
                      for i, b in enumerate(load.blocks)])
    if load.rank_local:
        cand = load.comm.all_gather(cand).reshape(-1).to(load.home)
    return _split_key(torch.topk(cand, k).values)


def telemetry_tick(second_spec: window.WindowSpec,
                   minute_spec: Optional[window.WindowSpec], k: int,
                   second: window.WindowState, minute: window.WindowState,
                   rt_hist: Optional[torch.Tensor], ring: TelemetryRing,
                   now_idx_s: int, sec_idx_m: int, append: int):
    """One telemetry read over the live state → ``(outs, ring)``.

    ``outs`` = ``(vals, rows, roll_lanes, sec_lanes, sec_rt, entry_lanes,
    entry_rt, hist_k, q_k)``, fresh tensors on the state's device (the
    engine updates its state in place after, so nothing here may alias
    it). ``rt_hist`` None (no table) gives zero-width ``hist_k``/``q_k``;
    ``minute_spec`` None gives zero second and ENTRY lanes. The
    time scalars and ``append`` are host ints; nothing waits on the
    device."""
    dev = second.stamps.device
    load = window.rolling_load(second_spec, second, now_idx_s)
    # the global ENTRY row receives every inbound event: the timeline's
    # source, never a "hot resource" (row 0: block 0 of row blocks,
    # which one rank holds in the rank-local form)
    if not isinstance(load, RowBlocks):
        load.narrow(0, ENTRY_NODE_ROW, 1).fill_(-1)  # no host→device copy
    elif load.first == 0:
        load.blocks[0].narrow(0, ENTRY_NODE_ROW, 1).fill_(-1)
    vals, rows = (sharded_topk_rows(load, k) if isinstance(load, RowBlocks)
                  else topk_rows(load, k))
    r64 = rows.to(torch.int64)
    roll_lanes = window.rolling_totals(second_spec, second, now_idx_s, r64)
    if minute_spec is not None:
        both = torch.cat([r64, torch.full((1,), ENTRY_NODE_ROW,
                                          dtype=torch.int64, device=dev)])
        mc, mrt = window.bucket_snapshot(minute_spec, minute, sec_idx_m,
                                         both)
        sec_lanes, sec_rt = mc[:k], mrt[:k]
        entry_lanes, entry_rt = mc[k], mrt[k]
    else:
        sec_lanes = torch.zeros_like(roll_lanes)
        sec_rt = torch.zeros((k,), dtype=torch.float32, device=dev)
        entry_lanes = torch.zeros((ring.lanes.shape[1],), dtype=torch.int32,
                                  device=dev)
        entry_rt = torch.zeros((), dtype=torch.float32, device=dev)
    if rt_hist is not None:
        hist_k = rt_hist[r64]                        # [k, HB] cumulative
        q_k = resource_hist.quantiles_from_counts(hist_k)
    else:
        hist_k = torch.zeros((k, 0), dtype=torch.int32, device=dev)
        q_k = torch.zeros((k, 0), dtype=torch.float32, device=dev)
    if append:
        slot = (ring.cursor % ring.seconds.shape[0]).to(torch.int64).view(1)
        ring = TelemetryRing(
            seconds=ring.seconds.index_fill(0, slot, sec_idx_m),
            lanes=ring.lanes.index_copy(0, slot, entry_lanes[None]),
            rt=ring.rt.index_copy(0, slot, entry_rt.view(1)),
            cursor=ring.cursor + 1)
    return (vals, rows, roll_lanes, sec_lanes, sec_rt, entry_lanes,
            entry_rt, hist_k, q_k), ring


class HotTelemetry:
    """The per-``Sentinel`` hot-resource telemetry service
    (``Sentinel.telemetry``).

    :meth:`tick` enqueues the device read under the engine lock (no
    wait); :meth:`drain` lands queued readbacks OFF the lock; :meth:`poll`
    is the ticker-thread body. The readers (:meth:`snapshot`,
    :meth:`hot_entries`) serve the last drained host view under a
    telemetry-local lock, never device state."""

    def __init__(self, sentinel, *, k: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 ring_slots: int = RING_SLOTS) -> None:
        self._sentinel = sentinel
        self._obs = sentinel.obs
        if enabled is None:
            enabled = sentinel.obs.enabled and not telemetry_disabled()
        self.enabled = enabled
        spec = sentinel.spec
        self.k = max(1, min(k if k is not None else telemetry_k(),
                            MAX_K, spec.rows))
        self.ring_slots = int(ring_slots)
        self._n_shards, self._rows_per_shard = topk_layout(
            spec, getattr(sentinel, "mesh", None))
        self._lock = threading.Lock()          # telemetry-local host state
        self._pending: "collections.deque" = collections.deque()
        self._drops = 0
        self._ticks = 0
        self._ring: Optional[TelemetryRing] = None
        self._hot: List[Dict] = []
        self._timeline: "collections.deque" = collections.deque(
            maxlen=HOT_TIMELINE_CAP)
        self._last_raw: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._last_ts_ms = 0
        # the first completed second is the one the clock is in minus
        # one; earlier seconds pre-date this service
        self._last_sec = sentinel.clock.now_ms() // 1000 - 1
        # carry cadence for a serving dispatch that runs the tick in its
        # epilogue (armed by serving.CadenceScheduler)
        self._carry_ms: Optional[int] = None
        self._last_tick_ms = int(sentinel.clock.now_ms())
        self.writer = None
        self.base_name: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        reg = getattr(sentinel, "register_shutdown", None)
        if reg is not None:
            reg(self)
        if self.enabled:
            # flight triggers pin the hot set as seen at trigger time
            sentinel.obs.flight.hot_provider = self.flight_hot

    # ---- persistence wiring -----------------------------------------

    def configure(self, base_dir: str, app_name: str, *,
                  single_file_size: int = 50 * 1024 * 1024,
                  total_file_count: int = 6) -> str:
        """Attach the rolling ``<app>-metric`` writer (idempotent per
        instance); → the on-disk base name the searcher should use."""
        from sentinel_tpu_torch.metrics.writer import MetricWriter, \
            form_metric_file_name
        if self.writer is None:
            self.writer = MetricWriter(
                base_dir, app_name + "-metric",
                single_file_size=single_file_size,
                total_file_count=total_file_count)
            self.base_name = form_metric_file_name(app_name + "-metric")
        return self.base_name

    # ---- device side -------------------------------------------------

    def _ring_locked(self) -> TelemetryRing:
        if self._ring is None:
            self._ring = init_ring(self.ring_slots,
                                   device=self._sentinel.device)
        return self._ring

    def _times(self, now_ms: int) -> Tuple[int, int, int]:
        """→ ``(sec, now_idx_s, sec_idx_m)`` of a tick at ``now_ms``: the
        last COMPLETED second and the two windows' indices."""
        spec = self._sentinel.spec
        sec = now_ms // 1000 - 1
        idx_s = spec.second.index_of(now_ms)
        sec_idx_m = (spec.minute.index_of(sec * 1000)
                     if spec.minute is not None else 0)
        return sec, idx_s, sec_idx_m

    def tick(self) -> bool:
        """Enqueue one telemetry read; → True when a readback was queued
        (False: disabled, closed, or dropped because the drain side is
        :data:`PENDING_MAX` behind)."""
        if not self.enabled or self._closed:
            return False
        with self._lock:
            drop = len(self._pending) >= PENDING_MAX
            if drop:
                self._drops += 1
        if drop:
            self._obs.counters.add(obs_keys.TELEMETRY_DROP)
            return False
        sn = self._sentinel
        now_ms = sn.clock.now_ms()
        sec, idx_s, sec_idx_m = self._times(now_ms)
        append = 1 if sec > self._last_sec else 0
        spec = sn.spec
        with sn._lock:
            st = sn._state
            outs, self._ring = telemetry_tick(
                spec.second, spec.minute, self.k, st.second, st.minute,
                st.rt_hist, self._ring_locked(), idx_s, sec_idx_m, append)
            copy = start_host_copy(outs)
        if append:
            self._last_sec = sec
        with self._lock:
            self._pending.append((now_ms, sec, append, copy))
            self._ticks += 1
            self._last_tick_ms = int(now_ms)
        self._obs.counters.add(obs_keys.TELEMETRY_TICK)
        if self._obs.enabled:
            self._obs.counters.add(obs_keys.PIPE_DISPATCH)
        return True

    # ---- carry surface: a serving dispatch that runs the tick ---------

    def arm_carry(self, interval_ms: int) -> None:
        """Let serving traffic carry the telemetry tick at this cadence
        (serving.CadenceScheduler)."""
        with self._lock:
            self._carry_ms = max(1, int(interval_ms))
            self._last_tick_ms = int(self._sentinel.clock.now_ms())

    def disarm_carry(self) -> None:
        with self._lock:
            self._carry_ms = None

    def last_tick_ms(self) -> int:
        with self._lock:
            return self._last_tick_ms

    def carry_due_locked(self, now_ms: int):
        """Engine lock held: claim one carried tick if the cadence is
        armed and due → ``(now_ms, sec, append, now_idx_s, sec_idx_m)``
        for the dispatch that runs it, or None. :meth:`tick`'s host prep
        (same drop-and-count bound, same completed-second bookkeeping)
        minus the dispatch; the claim moves ``last_tick_ms`` at once so a
        concurrent self-dispatch does not tick twice."""
        if not self.enabled or self._closed:
            return None
        with self._lock:
            if (self._carry_ms is None
                    or now_ms - self._last_tick_ms < self._carry_ms):
                return None
            # the due slot is claimed even on a drop: retrying every
            # batch until the drain catches up would count drops far
            # beyond the armed cadence
            self._last_tick_ms = int(now_ms)
            drop = len(self._pending) >= PENDING_MAX
            if drop:
                self._drops += 1
        if drop:
            self._obs.counters.add(obs_keys.TELEMETRY_DROP)
            return None
        sec, idx_s, sec_idx_m = self._times(now_ms)
        append = 1 if sec > self._last_sec else 0
        if append:
            self._last_sec = sec
        return (int(now_ms), int(sec), append, idx_s, sec_idx_m)

    def ring_for_fuse_locked(self) -> TelemetryRing:
        """Engine lock held: the timeline ring operand for a dispatch
        that carries the tick (built on first use, like :meth:`tick`'s)."""
        return self._ring_locked()

    def set_ring_locked(self, ring: TelemetryRing) -> None:
        """Engine lock held: store the ring a carrying dispatch returned
        with its telemetry branch skipped."""
        self._ring = ring

    def queue_carry(self, prep, outs, ring: TelemetryRing) -> None:
        """Engine lock held: queue the readback of a carried tick
        (``prep`` is :meth:`carry_due_locked`'s claim, ``outs`` the
        dispatch's :func:`telemetry_tick` outputs); :meth:`drain` lands it
        like a self-dispatched one."""
        now_ms, sec, append, _idx_s, _sec_idx_m = prep
        self._ring = ring
        copy = start_host_copy(outs)
        with self._lock:
            self._pending.append((now_ms, sec, append, copy))
            self._ticks += 1
        self._obs.counters.add(obs_keys.TELEMETRY_TICK)

    # ---- host side ---------------------------------------------------

    def drain(self) -> int:
        """Land every queued readback into the host view (and the
        ``<app>-metric`` log); → entries drained. Runs OFF the engine
        lock: the wait for the copies blocks only the calling thread."""
        with self._lock:
            batch = list(self._pending)
            self._pending.clear()
        for now_ms, sec, append, (host, event) in batch:
            self._land(now_ms, sec, append, wait_host_copy(host, event))
        return len(batch)

    def _land(self, now_ms: int, sec: int, append: int, outs) -> None:
        (vals, rows, roll_lanes, sec_lanes, sec_rt,
         entry_lanes, entry_rt, hist_k, q_k) = outs
        has_hist = hist_k.shape[1] > 0
        names = dict((row, name)
                     for name, row in self._sentinel.resources.items())
        rtypes = dict(self._sentinel.resource_types)
        interval_s = self._sentinel.spec.second.interval_ms / 1000.0
        hot: List[Dict] = []
        for i in range(len(vals)):
            load = int(vals[i])
            if load <= 0:
                continue
            row = int(rows[i])
            name = names.get(row)
            if name is None:        # stale row (evicted since the tick)
                continue
            lanes = roll_lanes[i]
            succ_s = int(sec_lanes[i][ev.SUCCESS])
            entry = {
                "resource": name, "row": row, "load": load,
                "qps": round(load / interval_s, 3),
                "pass": int(lanes[ev.PASS]), "block": int(lanes[ev.BLOCK]),
                "success": int(lanes[ev.SUCCESS]),
                "exception": int(lanes[ev.EXCEPTION]),
                # mean RT over the landed second (the histogram-off view)
                "rt_ms": round(float(sec_rt[i]) / succ_s, 3) if succ_s
                         else 0.0,
            }
            if has_hist:
                # lifetime-cumulative tail view
                entry["rt_p50_ms"] = round(float(q_k[i][0]), 3)
                entry["rt_p95_ms"] = round(float(q_k[i][1]), 3)
                entry["rt_p99_ms"] = round(float(q_k[i][2]), 3)
                entry["rt_hist"] = hist_k[i].tolist()
            hot.append(entry)
        if has_hist and hot:
            self._obs.counters.add(obs_keys.TELEMETRY_HIST_TICK)
        timeline_entry = None
        nodes = []
        if append and self._sentinel.spec.minute is not None:
            timeline_entry = {
                "sec": int(sec),
                "pass": int(entry_lanes[ev.PASS]),
                "block": int(entry_lanes[ev.BLOCK]),
                "success": int(entry_lanes[ev.SUCCESS]),
                "exception": int(entry_lanes[ev.EXCEPTION]),
                "occupied_pass": int(entry_lanes[ev.OCCUPIED_PASS]),
                "rt_sum": round(float(entry_rt), 3),
            }
            if self.writer is not None:
                from sentinel_tpu_torch.metrics.node import MetricNode
                for i, h in enumerate(hot):
                    c = sec_lanes[i]
                    if not (c[ev.PASS] or c[ev.BLOCK] or c[ev.SUCCESS]
                            or c[ev.EXCEPTION]):
                        continue
                    succ = int(c[ev.SUCCESS])
                    nodes.append(MetricNode(
                        timestamp=sec * 1000, resource=h["resource"],
                        pass_qps=int(c[ev.PASS]),
                        block_qps=int(c[ev.BLOCK]), success_qps=succ,
                        exception_qps=int(c[ev.EXCEPTION]),
                        rt=int(float(sec_rt[i]) / succ) if succ else 0,
                        occupied_pass_qps=int(c[ev.OCCUPIED_PASS]),
                        classification=rtypes.get(h["resource"], 0)))
                nodes.sort(key=lambda n: n.resource)
        with self._lock:
            self._hot = hot
            self._last_raw = (vals, rows)
            self._last_ts_ms = int(now_ms)
            if timeline_entry is not None:
                self._timeline.append(timeline_entry)
        if nodes:   # writer.write serializes internally; seconds ascend
            self.writer.write(sec * 1000, nodes)

    def poll(self) -> int:
        """Ticker-thread body (callable directly in tests): one tick plus
        the drain of everything queued so far."""
        self.tick()
        return self.drain()

    # ---- read surface ------------------------------------------------

    def snapshot(self, timeline_limit: int = 60) -> Dict:
        """The hot set, the timeline tail and the tick counts."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "k": self.k,
                "ts_ms": self._last_ts_ms,
                "n_shards": self._n_shards,
                "rows_per_shard": self._rows_per_shard,
                "hot": list(self._hot),
                "timeline": list(self._timeline)[-timeline_limit:],
                "ticks": self._ticks,
                "drops": self._drops,
            }

    def hot_entries(self, n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            hot = list(self._hot)
        return hot if n is None else hot[:n]

    def flight_hot(self) -> List[Dict]:
        """Compact hot-set view pinned into flight trigger records."""
        return [{"resource": h["resource"], "qps": h["qps"]}
                for h in self.hot_entries(FLIGHT_HOT_N)]

    @property
    def last_topk(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(loads, rows) of the last drained tick, raw and unfiltered."""
        with self._lock:
            return self._last_raw

    # ---- lifecycle ---------------------------------------------------

    def start(self, interval_sec: float = 1.0) -> None:
        """Start the telemetry daemon (no-op when disabled/running)."""
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_sec):
                try:
                    self.poll()
                except Exception:  # pragma: no cover — keep daemon alive
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="sentinel-telemetry")
        self._thread.start()

    def stop(self) -> None:
        """Idempotent: join the daemon, drain what is queued, close the
        writer. Registered with ``Sentinel.register_shutdown``."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        if self._closed:
            return
        self._closed = True
        try:
            self.drain()
        except Exception:   # teardown must not depend on device health
            pass
        self.enabled = False
        if self.writer is not None:
            self.writer.close()


__all__ = [
    "TELEMETRY_K_ENV", "TELEMETRY_DISABLE_ENV", "DEFAULT_K", "MAX_K",
    "RING_SLOTS", "PENDING_MAX", "FLIGHT_HOT_N", "TelemetryRing",
    "init_ring", "telemetry_tick", "telemetry_disabled", "telemetry_k",
    "topk_rows", "HotTelemetry",
]
