"""Host runtime: the public facade (SphU/SphO/Tracer analog) around the
device pipeline.

Port of ``sentinel_tpu/runtime.py``. Each dispatch takes the JAX
runtime's route, decided on the host in numpy before anything is copied
to the device:

* **scalar** — no origin, no origin/chain row, no prioritized event, one
  ``acquire`` >= 1 (the serving headline's batch);
* **fast** — origins, alt rows, contexts or prioritized events present,
  one ``acquire`` >= 1, and the fast path's composite key fits int32
  (``(NF+1)·(RA+1) < 2^31``);
* **general** — anything else (non-uniform ``acquire``, or a key that does
  not fit);
* **split** — a batch mixing kinds, with at least 4096 scalar events and
  one other (and the fast path's conditions): the scalar events take the
  scalar step and the rest (prioritized ones included) the fast step, in
  one lock hold.

Prioritized events (``entry(prioritized=True)``, ``SphU.entryWithPriority``)
may book the next window when denied (occupy). A batch with one makes
every route run its occupy-aware step for the next B+1 windows, while a
booking can still be live: the scalar step then reads landed bookings
into its QPS base, and the fast and general steps may book. Whether the
batch holds a prioritized event is known on the host and handed to the
engine (``any_prio``), in place of the reference's device-side branch.

The host fast path (``host_fast_path``, on by default;
:mod:`sentinel_tpu_torch.engine.fastpath`) decides :meth:`Sentinel.entry`
on the host for resources no rule names and for resources with one
simple QPS rule (from a token lease pre-charged through the device), and
lands their statistics through the device steps in batches.

Hot-parameter rules (:meth:`Sentinel.load_param_flow_rules`) take each
call's arguments (``entry(..., args=...)``, ``entry_batch(...,
args_list=...)``): the values are interned on the host into key rows
(:class:`~sentinel_tpu_torch.rules.param_flow.ParamKeyRegistry`, or
its C++ twin when ``g++`` builds it, as for the names) and the
param slot checks them on the device. User processor slots
(:meth:`Sentinel.register_slot`) are host gates, checked before the
dispatch, and device slots, run inside the engine step.

The fast and general paths group their segments sort-free
(``SENTINEL_SORTFREE``, on unless set to 0; read at construction and at
every rule reload, as in the JAX package). Two API tiers:

* :meth:`Sentinel.entry` — per-call context manager parity with
  ``try (Entry e = SphU.entry(name)) { ... }``: raises a
  :class:`~sentinel_tpu_torch.core.errors.BlockException` subclass on deny,
  sleeps (via the clock) on pass-with-wait verdicts;
* :meth:`Sentinel.entry_batch` / :meth:`Sentinel.exit_batch` and the raw
  ``*_nowait`` forms — numpy arrays in, verdict arrays out.

Cluster-mode flow and param rules ask the token service installed with
:meth:`Sentinel.set_token_service` (a ``ClusterTokenClient``, or the
embedded server's engine through ``cluster.coordinator``) before the
local decide, as the JAX runtime does. ``Sentinel(mesh=...)`` holds the
row-split state as N row blocks (:mod:`~sentinel_tpu_torch.parallel.
local_shard`; one block a device, or several on one). A ``"rows"`` mesh
that spans processes (``multihost.mesh.global_mesh(axis="rows")`` after
``multihost.initialize()``) runs SPMD, as the JAX runtime's does: each
process holds its own blocks, every process makes the same calls in the
same order at the same times, and every per-lane row read is a
collective. Every host branch of the step path reads replicated values
only (the verdicts, the claim overflow, the breaker states, the fast
path's host counts, the tiering sketch), so the processes cannot
diverge; the host readers of whole row-split tables
(:meth:`Sentinel.metrics_snapshot`, the node and origin totals,
:meth:`Sentinel.system_status`, ``core.snapshot.save_state``) raise
:class:`~sentinel_tpu_torch.parallel.row_blocks.RemoteRowsError` there,
as the JAX runtime's raise. A decide step reads nothing back from the
device: the verdicts (and the sort-free steps' claim overflow count) come
home through :class:`PendingVerdicts` (pinned memory, ``non_blocking``
copies, one CUDA event). A lease renewal of the host fast path reads its
one verdict back: one pre-charge serves a chunk of calls.

Self-telemetry (``Sentinel.obs``, :mod:`sentinel_tpu_torch.obs`), the
block log (``Sentinel.block_log``), the statistic callbacks
(``Sentinel.callbacks``) and breaker observers follow the JAX runtime
site by site. Counters that depend on device values (the claim overflow,
occupy grants, breaker states for observers) ride the verdict readback
the dispatch already makes; only an exit batch with observers registered
reads the breaker states itself. Serving-sized batches are staged in a
ring of pinned host slots (``SENTINEL_HOST_STAGING``), each released only
once its dispatch's verdicts have been read.

Tiered resource state (``Sentinel.tiering``,
:mod:`sentinel_tpu_torch.tiering`) is on unless
``SENTINEL_TIERING_DISABLE`` is set: the eviction drain before every
step first gathers recycled rows' state for the host cold tier, and after
the invalidate restores cold keys interned again. With
``SENTINEL_SINGLE_DISPATCH`` on (the default) each decide call also
updates the tiering sketch, and a fused decide+exit call runs a due
telemetry or tiering tick, in the JAX runtime's order and accounting
(``pipeline.dispatches``, ``split_route.single_dispatch``).

The engine runs on ``cuda`` unless the caller passes ``device="cpu"`` (as
the tests do); with no CUDA device and no ``device`` given, construction
raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import os
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core.batching import pad_into, pad_pow2, pad_to
from sentinel_tpu_torch.core.callbacks import StatisticCallbackRegistry
from sentinel_tpu_torch.core.clock import Clock, global_clock
from sentinel_tpu_torch.core.config import SentinelConfig, load_config
from sentinel_tpu_torch.core.context import (
    DEFAULT_CONTEXT_NAME, current_context,
)
from sentinel_tpu_torch.core.errors import (
    BlockException, BlockReason, ErrorEntryFreeError, ParamFlowException,
    block_exception_for, exception_name_for, is_block_exception,
)
from sentinel_tpu_torch.core.logs import BlockStatLogger, record_log
from sentinel_tpu_torch.core.pending import (
    PendingResult, start_host_copy, wait_host_copy,
)
from sentinel_tpu_torch.core.property import SentinelProperty
from sentinel_tpu_torch.core.registry import (
    ENTRY_NODE_ROW, make_origin_registry, make_registry,
    make_resource_registry,
)
from sentinel_tpu_torch.engine import fastpath as fp_mod
from sentinel_tpu_torch.engine import slots as slots_mod
from sentinel_tpu_torch.engine.pipeline import (
    EngineSpec, EntryBatch, ExitBatch, RuleSet, Verdicts,
    decide_and_record_exits, decide_entries, init_state,
    invalidate_resource_rows, record_blocks, record_exits, uncount_reserved,
)
from sentinel_tpu_torch.metrics.node import (
    TOTAL_IN_RESOURCE_NAME, MetricNode,
)
from sentinel_tpu_torch.obs import RuntimeObs
from sentinel_tpu_torch.obs import counters as obs_keys
from sentinel_tpu_torch.obs.resource_hist import engine_hist_buckets
from sentinel_tpu_torch.obs.telemetry import HotTelemetry, telemetry_tick
from sentinel_tpu_torch.parallel import local_shard
from sentinel_tpu_torch.parallel.row_blocks import (
    RemoteRowsError, remote_rows_message, start_host_read, wait_host_read,
)
from sentinel_tpu_torch.rules import authority as auth_mod
from sentinel_tpu_torch.rules import degrade as deg_mod
from sentinel_tpu_torch.rules import flow as flow_mod
from sentinel_tpu_torch.rules import param_flow as pf_mod
from sentinel_tpu_torch.rules import system as sys_mod
from sentinel_tpu_torch.stats import events as ev
from sentinel_tpu_torch.stats.window import (
    MINUTE_SPEC, WindowSpec, bucket_snapshot, init_window, rolling_totals,
    rt_totals, settle_occupied,
)
from sentinel_tpu_torch.tiering import sketch as sk_mod
from sentinel_tpu_torch.tiering.manager import TierManager

ENTRY_TYPE_OUT = 0
ENTRY_TYPE_IN = 1

_log = logging.getLogger("sentinel_tpu_torch.runtime")

#: Depth of the serving dispatch pipeline — how many batches may be in
#: flight before a submit settles the oldest (sizes the staging ring).
PIPELINE_DEPTH_ENV = "SENTINEL_PIPELINE_DEPTH"

#: a mixed batch splits when it has at least this many scalar events
SPLIT_MIN_SCALAR = 4096

# the port's route names → the reference's split_route.* counters
_ROUTE_KEYS = {"scalar": obs_keys.ROUTE_SCALAR, "fast": obs_keys.ROUTE_FAST,
               "fast_occupy": obs_keys.ROUTE_FAST_OCCUPY,
               "general": obs_keys.ROUTE_GENERAL}

_H1 = 0x9E3779B1
_H2 = 0x85EBCA6B
_MASK = 0xFFFFFFFF


def _alt_hash(row: int, kind: int, key_id: int, ra: int) -> int:
    """Stable (resource row, origin (kind 0) / context (kind 1) id) →
    alt-table row: the JAX package's hash, so both packages share rows."""
    h = ((row * _H1) ^ ((key_id * 2 + kind) * _H2)) & _MASK
    return h % ra


def _env_on(name: str) -> bool:
    """On unless the variable says ``0``/``off``/``false``/``disable``/
    ``disabled``."""
    v = os.environ.get(name, "")
    return not v or v.lower() not in ("0", "off", "false", "disable",
                                      "disabled")


def sortfree_enabled() -> bool:
    """``SENTINEL_SORTFREE``: the fast and general paths group segments
    through the claim cascade (ops/sortfree.py)."""
    return _env_on("SENTINEL_SORTFREE")


def single_dispatch_enabled() -> bool:
    """``SENTINEL_SINGLE_DISPATCH`` (on unless set to 0): the tiering
    sketch's update runs inside the decide call, and a fused decide+exit
    call also runs a due telemetry tick and sketch decay+estimate
    (``CadenceScheduler`` carries), so a steady serving batch is ONE
    dispatch (``pipeline.dispatches``). Off, the sketch update is a
    dispatch of its own and the ticks are the scheduler's. The math and
    its order are the same either way."""
    return _env_on("SENTINEL_SINGLE_DISPATCH")


def host_staging_enabled() -> bool:
    """``SENTINEL_HOST_STAGING``: serving-sized batches fill reused
    (pinned, on CUDA) host slots of a :class:`_StagingRing` in place of
    fresh allocations per column per call."""
    return _env_on("SENTINEL_HOST_STAGING")


def pipeline_depth(default: int = 2) -> int:
    """The ``SENTINEL_PIPELINE_DEPTH`` knob, clamped to [1, 64]."""
    raw = os.environ.get(PIPELINE_DEPTH_ENV, "")
    try:
        d = int(raw) if raw else default
    except ValueError:
        return default
    return max(1, min(d, 64))


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda`` — which must exist: with no CUDA
    device and no explicit ``device`` this raises rather than running on
    the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: sentinel_tpu_torch runs on the GPU; "
            "pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda")


class _CpuSampler:
    """(load1, CPU usage) from os.getloadavg and /proc/stat deltas,
    sampled at most once per second of the clock (the JAX package's
    sampler, so twin engines under twin clocks read alike)."""

    def __init__(self, clock: Clock):
        self._clock = clock
        self._last_ms = -10_000
        self._last_total = 0
        self._last_idle = 0
        self._load1 = -1.0
        self._value = -1.0

    def sample(self) -> Tuple[float, float]:
        import os
        now = self._clock.now_ms()
        if now - self._last_ms >= 1000:
            self._last_ms = now
            try:
                self._load1 = os.getloadavg()[0]
            except OSError:  # pragma: no cover
                self._load1 = -1.0
            try:
                with open("/proc/stat") as fh:
                    parts = fh.readline().split()[1:]
                vals = [int(x) for x in parts[:8]]
                total = sum(vals)
                idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
                dt = total - self._last_total
                di = idle - self._last_idle
                if self._last_total and dt > 0:
                    self._value = max(0.0, min(1.0, 1.0 - di / dt))
                self._last_total, self._last_idle = total, idle
            except (OSError, ValueError, IndexError):  # pragma: no cover
                self._value = -1.0
        return self._load1, self._value


class Entry:
    """A granted guarded call. Context manager; reference
    ``Entry``/``CtEntry`` with try-with-resources semantics."""

    __slots__ = ("_rt", "resource", "row", "origin_row", "chain_row",
                 "acquire", "is_in", "create_ms", "error", "_exited",
                 "wait_ms", "_terminate_handlers", "fast", "param_pairs")

    def __init__(self, rt: "Sentinel", resource: str, row: int,
                 origin_row: int, chain_row: int, acquire: int, is_in: bool,
                 create_ms: int, param_pairs=None):
        self._rt = rt
        self.resource = resource
        self.row = row
        self.origin_row = origin_row
        self.chain_row = chain_row
        self.acquire = acquire
        self.is_in = is_in
        self.create_ms = create_ms
        self.error: Optional[BaseException] = None
        self._exited = False
        self.wait_ms = 0   # pacing verdict; >0 only with entry(sleep=False)
        self._terminate_handlers = None
        self.fast = None   # "free"/"leased" when the host fast path admitted
        # (rules [PV], keys [PV], generation, registry, pinned rows) of a
        # call with param pairs, else None
        self.param_pairs = param_pairs

    def trace(self, exc: BaseException) -> None:
        """Reference ``Tracer.trace``: mark a business exception so it
        feeds exception-ratio/count breakers and exception QPS."""
        if exc is not None and not is_block_exception(exc):
            self.error = exc

    def when_terminate(self, fn) -> None:
        """Register ``fn(entry)`` to run after exit."""
        if self._terminate_handlers is None:
            self._terminate_handlers = []
        self._terminate_handlers.append(fn)

    def exit(self) -> None:
        if self._exited:
            raise ErrorEntryFreeError(
                f"entry for {self.resource!r} exited twice")
        self._exited = True
        self._rt._exit_one(self)
        if self._terminate_handlers:
            for fn in self._terminate_handlers:
                fn(self)

    def __enter__(self) -> "Entry":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.trace(exc)
        self.exit()
        return False


def _settle_leaked(cell, on_leak) -> None:
    """GC finalizer for a :class:`PendingVerdicts` dropped without
    ``.result()``: its deferred host bookkeeping (pin release, block log,
    staging-slot release, breaker diffs) must not be lost with the
    handle. The leak callback runs first, so a settle that fails still
    leaves the leak visible."""
    if cell.done:
        return
    try:
        on_leak()
    except Exception:   # telemetry must never mask the settle
        pass
    try:
        cell.settle()
    except Exception:
        _log.debug("leaked PendingVerdicts settle failed", exc_info=True)


class PendingVerdicts(PendingResult):
    """Handle for an in-flight batch decide: ``result()`` waits for the
    verdict copies (one CUDA event), returns numpy
    :class:`~sentinel_tpu_torch.engine.pipeline.Verdicts` and does the
    deferred host bookkeeping (pin release, block log, counters) — call
    it for every handle. One the caller drops anyway is settled by a GC
    finalizer and counted in ``pipeline.leaked_handles``."""

    __slots__ = ("_leak_finalizer",)

    def attach_leak_guard(self, on_leak) -> None:
        f = weakref.finalize(self, _settle_leaked, self._cell, on_leak)
        # never settle during interpreter shutdown: the device may be
        # torn down already, and the process exiting is not a leak
        f.atexit = False
        self._leak_finalizer = f

    def result(self):
        fin = getattr(self, "_leak_finalizer", None)
        if fin is not None:
            fin.detach()
        return self._cell.settle()


class _StagingRing:
    """Reused host staging for the always-present entry-batch columns of
    one padded size: :meth:`Sentinel._entry_batch` fills a free slot in
    place (``pad_into``) instead of allocating and pinning ~9 fresh
    arrays per call.

    On CUDA each slot holds pinned tensors (their ``.numpy()`` views are
    what ``pad_into`` fills) that the step copies over with
    ``non_blocking``, so a copy may still be reading a slot after the
    dispatch call returns. A slot is therefore released only from the
    dispatch's deferred read, after the verdict readback has settled —
    by then the device has consumed it. ``acquire()`` grows the pool
    with a fresh slot rather than ever rewriting one in flight (a
    pipeline deeper than the ring); ``grown`` counts those growths. A
    slot lost on an exception path just shrinks the pool."""

    __slots__ = ("b", "pinned", "_free", "_lock", "grown")

    _INT_COLS = ("rows", "origin_ids", "origin_rows", "context_ids",
                 "chain_rows", "acquire")
    _BOOL_COLS = ("is_in", "prioritized", "valid")

    def __init__(self, b: int, depth: int, pinned: bool):
        self.b = b
        self.pinned = pinned
        self.grown = 0
        self._lock = threading.Lock()
        self._free = [self._new_slot() for _ in range(depth)]

    def _new_slot(self) -> Dict[str, torch.Tensor]:
        def col(dtype):
            return torch.empty(self.b, dtype=dtype, pin_memory=self.pinned)
        return {**{c: col(torch.int32) for c in self._INT_COLS},
                **{c: col(torch.bool) for c in self._BOOL_COLS}}

    def acquire(self) -> Dict[str, torch.Tensor]:
        with self._lock:
            if self._free:
                return self._free.pop()
            self.grown += 1
        return self._new_slot()

    def release(self, slot: Dict[str, torch.Tensor]) -> None:
        with self._lock:
            self._free.append(slot)


class Sentinel:
    """The framework instance (Env/CtSph + rule managers, in one object).

    ``routes`` counts dispatches by route (``scalar``, ``fast``,
    ``fast_occupy`` — the fast route's occupy-aware step —, ``general``,
    ``split``; a fused decide+exit counts ``fused`` alone, as the JAX
    runtime's ``split_route.*`` counters do);
    ``sortfree_overflow`` sums the sort-free steps' claim overflow counts
    (elements that took the sorted order), tallied as verdicts are read."""

    def __init__(self, config: Optional[SentinelConfig] = None,
                 clock: Optional[Clock] = None, device=None, mesh=None):
        """``mesh`` (a :func:`~sentinel_tpu_torch.parallel.local_shard.
        local_mesh`, or a ``multihost.mesh.GlobalMesh`` over the
        ``"rows"`` axis) splits the windows, the thread gauges, the
        occupy ring and the RT histogram into N row blocks on the mesh's
        devices; the rest of the engine runs on its home device
        (``devices[0]``, which ``device`` must name when given), where
        the batch columns are built, so they need no placement step.
        Verdicts and state equal the one-block engine's;
        ``max_resources`` must be a multiple of N. A ``GlobalMesh`` that
        spans processes gives this process its own blocks on its device
        (``is_multihost`` True); that mode is SPMD: every process
        constructs the engine identically and replays the same rule
        loads and batches in the same order at the same times (a
        ``ManualClock``, or the same ``at_ms``)."""
        self.cfg = cfg = config or load_config()
        # (state placements, verdict placements) when meshed
        self._mesh_shardings = None
        self.mesh = None
        if mesh is not None:
            self.mesh = local_shard.as_row_mesh(mesh)
            if device is not None and local_shard.as_device(
                    resolve_device(device)) != self.mesh.home:
                raise ValueError(
                    f"device={device!r} is not the mesh's home device "
                    f"{self.mesh.home}")
            device = self.mesh.home
        self.device = resolve_device(device)
        self.clock = clock or global_clock()

        # the factories pick the native C++ interning table when it builds
        self.resources = make_resource_registry(cfg.max_resources)
        self.origins = make_origin_registry(cfg.max_origins)
        self.contexts = make_registry(2048,
                                      reserved=(DEFAULT_CONTEXT_NAME,))
        self.spec = EngineSpec(
            rows=cfg.max_resources,
            alt_rows=max(2 * cfg.max_resources, 1024),
            second=WindowSpec(cfg.second_sample_count,
                              cfg.second_interval_ms
                              // max(cfg.second_sample_count, 1)),
            minute=MINUTE_SPEC if cfg.minute_enabled else None,
            statistic_max_rt=cfg.statistic_max_rt,
            hist_buckets=engine_hist_buckets(),
            occupy_timeout_ms=cfg.occupy_timeout_ms,
            param_keys=cfg.param_table_slots,
            param_pairs=cfg.param_pairs_per_event,
        )
        self.param_key_registry = pf_mod.make_param_key_registry(
            cfg.param_table_slots)
        self._user_param_rules: List[pf_mod.ParamFlowRule] = []
        self._gateway_param_rules: List[pf_mod.ParamFlowRule] = []
        # bumped at every param-rule reload: pairs resolved against an
        # older (table, registry) carry their generation and are dropped
        self._param_gen = 0
        # the cluster TokenService (client or embedded server facade; set
        # via set_token_service) and the cluster-mode rules by row: flow
        # rules as (rule-slot position, rule), param rules as rules
        self._token_service = None
        self._cluster_rules_by_row: Dict[int, list] = {}
        self._cluster_param_rules_by_row: Dict[int, list] = {}
        self._host_gates: Tuple[slots_mod.HostGate, ...] = ()
        self._device_slots: Tuple[slots_mod.DeviceSlot, ...] = ()
        # process epoch: wraparound-safe int32 relative time base
        self.epoch_ms = self.clock.now_ms()
        # tuned-config startup resolution + knob-registry validation
        # (tune/): a fingerprint-matching ``SENTINEL_TUNED_CONFIG``
        # artifact fills every knob whose env var is UNSET (env wins per
        # knob); a mismatch resolves to {} and serving runs on defaults.
        # The events (artifact load/fallback, unknown or out-of-clamp
        # SENTINEL_* keys) go to RecordLog and the tune.* counters once
        # self.obs exists below.
        from sentinel_tpu_torch.tune import artifact as tune_art
        self._tuned, self._tune_events = tune_art.resolve_startup(
            device=self.device, mesh=self.mesh, spec=self.spec)
        # SORTFREE_BITS/CHUNK have no injection path (ops/sortfree reads
        # the env at every step), so a tuned value pins the unset env var
        # for this process; first engine wins, and the pin is logged
        for _env in ("SENTINEL_SORTFREE_BITS", "SENTINEL_SORTFREE_CHUNK"):
            if _env in self._tuned and _env not in os.environ:
                os.environ[_env] = str(self._tuned[_env])
                self._tune_events.append((
                    None,   # log-only: the artifact load already ticked
                    f"pinned {_env}={self._tuned[_env]} from tuned "
                    f"config (trace-time knob, applied via env)"))
        self._lock = threading.RLock()
        self._state = init_state(self.spec, cfg.max_flow_rules,
                                 cfg.max_degrade_rules, device=self.device)
        if self.mesh is not None:
            local_shard.validate_mesh(self.spec, self.mesh)
            self._refresh_shardings_locked()
        self._sys_rules: List[sys_mod.SystemRule] = []
        self._rule_pins: Dict[str, Tuple[set, set, set]] = {}
        self._cpu = _CpuSampler(self.clock)
        # main row → {alt row: (kind, key id)} it hashed to; an evicted
        # row's alt rows are cleared with it
        self._alt_rows_by_row: Dict[int, Dict[int, Tuple[int, int]]] = {}
        self.routes: "collections.Counter[str]" = collections.Counter()
        self.sortfree_overflow = 0
        # last ms a booking can still be live: until then every step is
        # occupy-aware (bookings last at most B+1 windows)
        self._occupy_live_until_ms = -1
        # highest second-window index any dispatch has stamped (a late
        # fast-path flush older than a full ring is re-stamped to now)
        self._seen_idx = -(2 ** 62)
        self._fast = fp_mod.HostFastPath(
            flush_events=cfg.fast_path_flush_events,
            flush_ms=cfg.fast_path_flush_ms,
            lease_fraction=cfg.fast_path_lease_fraction,
            win_ms=self.spec.second.win_ms)
        self._fast_enabled = bool(cfg.host_fast_path)
        # serializes drain→dispatch of the fast path's buffers: a
        # concurrent flush could otherwise land a buffered exit before the
        # flush that carries its pass, skewing the thread gauge for good
        self._flush_lock = threading.Lock()
        self._compile_empty_rules()

        # rule and window-geometry property cells (the reference's
        # SentinelProperty listeners: a datasource pushes, the runtime
        # reloads)
        self.flow_property: SentinelProperty = SentinelProperty()
        self.degrade_property: SentinelProperty = SentinelProperty()
        self.system_property: SentinelProperty = SentinelProperty()
        self.authority_property: SentinelProperty = SentinelProperty()
        self.param_flow_property: SentinelProperty = SentinelProperty()
        self.flow_property.add_listener(self.load_flow_rules)
        self.degrade_property.add_listener(self.load_degrade_rules)
        self.system_property.add_listener(self.load_system_rules)
        self.authority_property.add_listener(self.load_authority_rules)
        self.param_flow_property.add_listener(self.load_param_flow_rules)
        self.sample_count_property: SentinelProperty = SentinelProperty()
        self.sample_count_property.add_listener(
            lambda sc: self.update_window_geometry(sample_count=int(sc)))
        self.interval_property: SentinelProperty = SentinelProperty()
        self.interval_property.add_listener(
            lambda ms: self.update_window_geometry(interval_ms=int(ms)))

        self._global_on = True      # the reference's setSwitch command
        # resource → ResourceTypeConstants classification (metric lines)
        self.resource_types: Dict[str, int] = {}
        # per-second rolled-up block log (LogSlot → sentinel-block.log)
        self.block_log = BlockStatLogger(self.clock)
        # self-telemetry: spans, decision counters, latency histograms,
        # sampled block events; every site guards on ``obs.enabled``
        self.obs = RuntimeObs(clock=self.clock)
        # the startup tune events: a RecordLog line and one counter tick
        # each (key None = log only)
        if self._tune_events:
            rl = record_log()
            for _key, _msg in self._tune_events:
                (rl.info if _key == obs_keys.TUNE_LOADED
                 else rl.warning)("tune: %s", _msg)
                if _key is not None:
                    self.obs.counters.add(_key)
        # services stopped by close(), LIFO, each once
        self._shutdown_hooks: list = []
        self._closed = False
        # hot-resource telemetry (obs/telemetry.py): a top-K and timeline
        # read of the live window state, read back off the engine lock;
        # self-registers for close() and pins the hot set into flight
        # records. Its ticker starts with telemetry.start() or a
        # serving.CadenceScheduler.
        self.telemetry = HotTelemetry(self)
        # tiered resource state (tiering/): the device table is the HOT
        # tier; recycled rows' windows, gauges, bookings and RT histogram
        # rows spill to a host cold tier and come back bit-identically
        # when the key is interned again. Self-registers for close(); its
        # ticker starts with tiering.start() or a CadenceScheduler.
        # SENTINEL_TIERING_DISABLE reverts to the lossy eviction.
        self.tiering = TierManager(self)
        # the sketch update (and the carried ticks) ride the decide call.
        # self._tuned only carries knobs whose env var is UNSET, so the
        # get() fallback to the env helper keeps env precedence
        self._single_dispatch = bool(self._tuned.get(
            "SENTINEL_SINGLE_DISPATCH", single_dispatch_enabled()))
        # first-dispatch accounting (core/compile_cache.py): the program
        # keys already dispatched, and the step generation they carry
        self._fetched_programs: set = set()
        self._program_gens = itertools.count()
        self._renew_programs_locked()
        self.callbacks = StatisticCallbackRegistry()
        # breaker transition observers: the [ND] state column rides each
        # step's verdict readback and is diffed against ONE shared
        # baseline, in dispatch order (seq), by the thread that reads it
        self._breaker_observers: list = []
        # (seq, rules tuple, states) of the last landed diff
        self._breaker_live: Optional[Tuple[int, tuple, List[int]]] = None
        self._breaker_seq = 0           # dispatch order, under self._lock
        self._breaker_event_lock = threading.Lock()
        # transitions are queued under the event lock (queue order is seq
        # order) and delivered by a single active drainer, with no lock
        # held in user code
        self._breaker_fire_q: "collections.deque" = collections.deque()
        self._breaker_firing = False
        # padded batch size → _StagingRing; the depth covers the deepest
        # dispatch pipeline plus a split's two builds
        self._staging_on = bool(self._tuned.get("SENTINEL_HOST_STAGING",
                                                host_staging_enabled()))
        self._staging: Dict[int, _StagingRing] = {}
        self._staging_depth = max(4, 2 * int(self._tuned.get(
            PIPELINE_DEPTH_ENV, pipeline_depth())) + 2)

        # SPI-discovered slots (SlotChainProvider.newSlotChain analog):
        # every registered ``processor_slot`` provider, a fresh instance
        # for each Sentinel — slot state must not leak across engines
        from sentinel_tpu_torch.core.spi import (
            SERVICE_PROCESSOR_SLOT, SpiLoader,
        )
        for slot in SpiLoader.of(
                SERVICE_PROCESSOR_SLOT).load_new_instance_list_sorted():
            self.register_slot(slot)

    # ------------------------------------------------------------------
    # Rule management (XxxRuleManager.loadRules analog)
    # ------------------------------------------------------------------

    def _compile_flow(self, rules):
        cfg = self.cfg
        return flow_mod.compile_flow_rules(
            rules, resource_registry=self.resources,
            context_registry=self.contexts, capacity=cfg.max_flow_rules,
            k_per_resource=cfg.max_rules_per_resource,
            num_rows=cfg.max_resources, cold_factor=float(cfg.cold_factor),
            origin_registry=self.origins, device=self.device)

    def _compile_degrade(self, rules):
        cfg = self.cfg
        return deg_mod.compile_degrade_rules(
            rules, resource_registry=self.resources,
            capacity=cfg.max_degrade_rules,
            k_per_resource=cfg.max_rules_per_resource,
            num_rows=cfg.max_resources, device=self.device)

    def _compile_authority(self, rules):
        cfg = self.cfg
        return auth_mod.compile_authority_rules(
            rules, resource_registry=self.resources,
            origin_registry=self.origins,
            capacity=cfg.max_authority_rules, k_per_resource=2,
            num_rows=cfg.max_resources, device=self.device)

    def _compile_param(self, rules):
        cfg = self.cfg
        return pf_mod.compile_param_rules(
            rules, resource_registry=self.resources,
            capacity=cfg.max_param_rules,
            k_per_resource=cfg.max_rules_per_resource, device=self.device)

    def _compile_empty_rules(self) -> None:
        self._flow = self._compile_flow([])
        self._deg = self._compile_degrade([])
        self._auth = self._compile_authority([])
        self._sys = sys_mod.compile_system_rules([], device=self.device)
        self._param = self._compile_param([])
        self._ruleset = self._build_ruleset()

    def _build_ruleset(self) -> RuleSet:
        """Assemble the dispatch RuleSet and the step flags from the
        compiled tables (callers hold ``self._lock``, or are __init__).

        The rule-gather width is sliced to the most rules on any ONE
        resource; the flags elide work that is a structural no-op for the
        loaded rules, exactly as the JAX package's runtime does."""
        kf = self._flow.k_used
        kd = self._deg.k_used
        self._scalar_has_rl = any(
            r.control_behavior in (flow_mod.BEHAVIOR_RATE_LIMITER,
                                   flow_mod.BEHAVIOR_WARM_UP_RATE_LIMITER)
            and r.grade == flow_mod.GRADE_QPS for r in self._flow.rules)
        self._skip_auth = self._auth.num_active == 0
        self._skip_sys = not self._sys_rules
        self._sortfree = bool(getattr(self, "_tuned", {}).get(
            "SENTINEL_SORTFREE", sortfree_enabled()))
        prev_skip = getattr(self, "_skip_threads", None)
        # nothing loaded READS live concurrency → the gauge scatters are
        # elided (readers: THREAD-grade flow and param rules, system rules)
        self._skip_threads = (
            not self.cfg.thread_gauge_always
            and self._skip_sys
            and not any(r.grade == flow_mod.GRADE_THREAD
                        for r in self._flow.rules)
            and not any(r.grade == pf_mod.GRADE_THREAD
                        for r in self._param.rules))
        if prev_skip is not None and prev_skip != self._skip_threads:
            # a flip invalidates the gauges: zero them (transient
            # under-count only; decrements clamp at 0)
            self._state.threads.zero_()
            self._state.alt_threads.zero_()
            self._state.param_dyn.threads.zero_()
        fi_np = self._flow.rule_idx_np[:, :kf]
        di_np = self._deg.rule_idx_np[:, :kd]
        joint_np = RuleSet.build_joint_np(fi_np, di_np)
        flow_idx, deg_idx, joint = (torch.from_numpy(np.ascontiguousarray(a))
                                    .to(self.device)
                                    for a in (fi_np, di_np, joint_np))
        return RuleSet(
            flow_table=self._flow.table, flow_idx=flow_idx,
            deg_table=self._deg.table, deg_idx=deg_idx,
            auth_table=self._auth.table, auth_idx=self._auth.rule_idx,
            sys_thresholds=self._sys, param_table=self._param.table,
            joint_idx=joint)

    def _update_rule_pins_locked(self, family: str, res: set, org: set,
                                 ctx: set) -> None:
        """Refcounted rule-pin release: names the previous table of this
        family pinned that no family references any more are unpinned, so
        formerly ruled keys become evictable again."""
        old = self._rule_pins.get(family, (set(), set(), set()))
        new = (set(res), set(org), set(ctx))
        self._rule_pins[family] = new
        regs = (self.resources, self.origins, self.contexts)
        for kind in range(3):
            still: set = set()
            for fam, sets in self._rule_pins.items():
                if fam != family:
                    still |= sets[kind]
            for name in old[kind] - new[kind] - still:
                regs[kind].unpin(name)
        # pin-path interns bypass intern_resources: a newly ruled key in
        # the COLD tier just got a fresh row from the pin's allocation —
        # classify it so the next eviction drain promotes its state before
        # any rule reads the zeroed row. tick=False: rule loads are the
        # control plane, not serving traffic (the hit rate stays pure).
        if self.tiering.enabled and res:
            pairs = [(n, r) for n, r in
                     ((n, self.resources.lookup(n)) for n in res)
                     if r is not None]
            if pairs:
                self.tiering.note_interned(
                    [p[0] for p in pairs], [p[1] for p in pairs],
                    tick=False)

    def _rebuild_fastpath(self) -> None:
        """Recompute the host fast path's classification after a rule
        load (callers hold ``self._lock``): rows named by a degrade,
        authority or param rule, by more than one flow rule or by any but
        one simple QPS rule, or read by a RELATE rule, are INELIGIBLE; a row
        with one DEFAULT QPS rule (default app, DIRECT, local) is
        LEASED; every other row is FREE."""
        if not self._fast_enabled:
            return
        row_of = self.resources.get_or_create
        inel = {row_of(r.resource) for r in self._deg.rules}
        inel.update(row_of(r.resource) for r in self._auth.rules)
        inel.update(self._param.by_row.keys())
        inel.update(self._cluster_rules_by_row.keys())
        inel.update(self._cluster_param_rules_by_row.keys())
        flow_by_row: Dict[int, list] = {}
        for r in self._flow.rules:
            flow_by_row.setdefault(row_of(r.resource), []).append(r)
            if r.strategy == flow_mod.STRATEGY_RELATE and r.ref_resource:
                # RELATE reads the ref row's live counts: fast-path lag
                # there would skew this rule's decisions
                inel.add(row_of(r.ref_resource))
        lease: Dict[int, float] = {}
        for row, rs in flow_by_row.items():
            r = rs[0]
            if (len(rs) == 1 and r.grade == flow_mod.GRADE_QPS
                    and r.control_behavior == flow_mod.BEHAVIOR_DEFAULT
                    and r.strategy == flow_mod.STRATEGY_DIRECT
                    and (r.limit_app or "default") == "default"
                    and not r.cluster_mode):
                lease[row] = float(r.count)
            else:
                inel.add(row)
        lease = {row: c for row, c in lease.items() if row not in inel}
        self._fast.set_tables(inel, lease, sys_active=bool(self._sys_rules))

    def load_flow_rules(self, rules: Sequence[flow_mod.FlowRule]) -> None:
        # buffered fast-path passes were admitted under the OLD tables:
        # land them before the swap, or the flush would re-decide them
        self._flush_fast()
        compiled = self._compile_flow(rules)
        # cluster rules carry their rule-table SLOT position (k within the
        # per-resource rule gather) so a failed token request re-enables
        # exactly that rule locally through a per-event bitmask — per-rule
        # fallbackToLocalOrPass (FlowRuleChecker.java:184-193). The slots
        # are assigned as compile_flow_rules assigns them.
        cluster_map: Dict[int, list] = {}
        slots_used: Dict[int, int] = {}
        for r in compiled.rules:
            row = self.resources.get_or_create(r.resource)
            k = slots_used.get(row, 0)
            slots_used[row] = k + 1
            if r.cluster_mode:
                cluster_map.setdefault(row, []).append((k, r))
        with self._lock:
            self._flow = compiled
            self._cluster_rules_by_row = cluster_map
            self._ruleset = self._build_ruleset()
            # fresh shaping state for the new tables (the reference
            # rebuilds its raters); occupy bookings are row-keyed promises
            # already granted, so they survive: landed ones settle into
            # the second window as PASS, pending ones carry into the ring
            old = self._state.flow_dyn
            now_idx = self.spec.second.index_of(self.clock.now_ms())
            _, pend_cnt, pend_win = settle_occupied(
                self.spec.second, self._state.second, old.occupied_count,
                old.occupied_window, now_idx, ev.PASS)
            if self.obs.enabled:
                # the booking lifecycle at a reload (a cold path: the two
                # device reads are acceptable here)
                prev = int(old.occupied_count.sum().item())
                carried = int(pend_cnt.sum().item())
                self.obs.counters.add(obs_keys.OCCUPY_CARRIED, carried)
                self.obs.counters.add(obs_keys.OCCUPY_SETTLED,
                                      max(0, prev - carried))
            fresh = flow_mod.init_flow_dyn(
                self.cfg.max_flow_rules, self.spec.second.buckets,
                self.spec.rows, device=self.device)
            self._state = self._state._replace(flow_dyn=fresh._replace(
                occupied_count=pend_cnt, occupied_window=pend_win))
            self._pin_state_locked()
            self._rebuild_fastpath()
            res: set = set()
            org: set = set()
            ctxs: set = set()
            for r in compiled.rules:
                res.add(r.resource)
                la = r.limit_app or "default"
                if la not in ("default", "other"):
                    org.add(la)
                if r.strategy == flow_mod.STRATEGY_RELATE:
                    res.add(r.ref_resource)
                elif r.strategy == flow_mod.STRATEGY_CHAIN:
                    ctxs.add(r.ref_resource)
            self._update_rule_pins_locked("flow", res, org, ctxs)
            # cold entries replay this settle at promote time with this
            # exact now_idx (tiering/coldtier.settle_entry_np)
            self.tiering.on_rules_reloaded_locked(now_idx)

    def load_degrade_rules(self, rules: Sequence[deg_mod.DegradeRule]) -> None:
        self._flush_fast()          # see load_flow_rules
        compiled = self._compile_degrade(rules)
        with self._lock:
            self._deg = compiled
            self._ruleset = self._build_ruleset()
            self._state = self._state._replace(
                breakers=deg_mod.init_breaker_state(
                    self.cfg.max_degrade_rules, device=self.device))
            self._pin_state_locked()
            self._rebuild_fastpath()
            self._update_rule_pins_locked(
                "degrade", {r.resource for r in compiled.rules}, set(),
                set())

    def load_system_rules(self, rules: Sequence[sys_mod.SystemRule]) -> None:
        self._flush_fast()          # see load_flow_rules
        with self._lock:
            self._sys_rules = list(rules)
            self._sys = sys_mod.compile_system_rules(rules,
                                                     device=self.device)
            self._ruleset = self._build_ruleset()
            self._rebuild_fastpath()

    def load_authority_rules(self,
                             rules: Sequence[auth_mod.AuthorityRule]) -> None:
        self._flush_fast()          # see load_flow_rules
        compiled = self._compile_authority(rules)
        with self._lock:
            self._auth = compiled
            self._ruleset = self._build_ruleset()
            self._rebuild_fastpath()
            org: set = set()
            for r in compiled.rules:
                org.update(o.strip() for o in r.limit_app.split(",")
                           if o.strip())
            self._update_rule_pins_locked(
                "authority", {r.resource for r in compiled.rules}, org,
                set())

    def load_param_flow_rules(self,
                              rules: Sequence[pf_mod.ParamFlowRule]) -> None:
        """Load the hot-parameter rules (``ParamFlowRuleManager``)."""
        self._reload_param_rules(user=list(rules))

    def set_gateway_param_rules(
            self, rules: Sequence[pf_mod.ParamFlowRule]) -> None:
        """Install param rules converted from gateway rules: they merge
        with the user's into the one param slot."""
        self._reload_param_rules(gateway=list(rules))

    def _reload_param_rules(self, user=None, gateway=None) -> None:
        """Compile the user's and the gateway's param rules together. A
        reload gets a fresh key registry, a new generation (pairs resolved
        before it are dropped, and their exits neither decrement nor
        unpin), fresh key state and its rule pins. Cluster-mode param
        rules ask the token server (ParamFlowChecker.passClusterCheck →
        requestParamToken); only the local ones compile into the device
        table."""
        all_rules = ((self._user_param_rules if user is None else user)
                     + (self._gateway_param_rules if gateway is None
                        else gateway))
        self._flush_fast()          # see load_flow_rules
        cluster_map: Dict[int, list] = {}
        for r in all_rules:
            if r.cluster_mode:
                row = self.resources.get_or_create(r.resource)
                cluster_map.setdefault(row, []).append(r)
        compiled = self._compile_param(
            [r for r in all_rules if not r.cluster_mode])
        with self._lock:
            if user is not None:
                self._user_param_rules = user
            if gateway is not None:
                self._gateway_param_rules = gateway
            self._cluster_param_rules_by_row = cluster_map
            self._param = compiled
            self._ruleset = self._build_ruleset()
            # rule slots changed meaning: fresh interning, cold key state
            self.param_key_registry = pf_mod.make_param_key_registry(
                self.cfg.param_table_slots)
            self._param_gen += 1
            self._state = self._state._replace(
                param_dyn=pf_mod.init_param_dyn(self.spec.param_keys,
                                                device=self.device))
            self._pin_state_locked()
            self._rebuild_fastpath()
            # cluster-mode param rules compile into no device table, but
            # their rows stay resident for the delegation
            self._update_rule_pins_locked(
                "param", {r.resource for r in compiled.rules}
                | {r.resource for r in all_rules if r.cluster_mode},
                set(), set())

    def set_token_service(self, svc) -> None:
        """Install the cluster token service used for cluster-mode flow and
        param rules (reference ``TokenClientProvider`` / embedded-server
        provider): any object with ``request_token(flow_id, count,
        prioritized=False)`` and ``request_param_token(flow_id, count,
        params)`` → TokenResult-like (``status``, ``wait_ms``); with
        ``request_tokens_batch`` (and ``request_param_tokens_batch``) the
        batch tier asks once a batch. ``None`` uninstalls — cluster rules
        then take the fallback path."""
        self._token_service = svc

    # ------------------------------------------------------------------
    # Pluggable processor slots (the SlotChainBuilder SPI;
    # engine/slots.py)
    # ------------------------------------------------------------------

    def register_slot(self, slot) -> None:
        """Register a user processor slot without editing the engine: a
        :class:`~sentinel_tpu_torch.engine.slots.HostGate` runs on the
        host before every dispatch (both tiers); a
        :class:`~sentinel_tpu_torch.engine.slots.DeviceSlot` runs inside
        the engine step, its state carried in the engine state, and turns
        the host fast path off while it is registered (it must see every
        event). Denials surface as :class:`CustomSlotException` with the
        slot's name and are recorded like every other block."""
        # reason codes are int8: DeviceSlot i is CUSTOM_BASE + i (below
        # CUSTOM_GATE_BASE), HostGate i is CUSTOM_GATE_BASE + i (below 128)
        max_dev = int(BlockReason.CUSTOM_GATE_BASE) - int(
            BlockReason.CUSTOM_BASE)
        max_gate = 128 - int(BlockReason.CUSTOM_GATE_BASE)
        if isinstance(slot, slots_mod.DeviceSlot):
            if len(self._device_slots) >= max_dev:
                raise ValueError(f"at most {max_dev} device slots")
            self._flush_fast()      # land buffered stats before the switch
            with self._lock:
                self._device_slots = self._device_slots + (slot,)
                self._fast_enabled = False
                self._reset_custom_states_locked()
        elif isinstance(slot, slots_mod.HostGate):
            if len(self._host_gates) >= max_gate:
                raise ValueError(f"at most {max_gate} host gates")
            with self._lock:
                self._host_gates = self._host_gates + (slot,)
        else:
            raise TypeError(
                "slot must subclass HostGate or DeviceSlot (engine/slots.py)")

    def unregister_slot(self, slot) -> None:
        if isinstance(slot, slots_mod.DeviceSlot):
            with self._lock:
                self._device_slots = tuple(
                    s for s in self._device_slots if s is not slot)
                self._fast_enabled = (bool(self.cfg.host_fast_path)
                                      and not self._device_slots)
                self._reset_custom_states_locked()
        else:
            with self._lock:
                self._host_gates = tuple(
                    g for g in self._host_gates if g is not slot)

    def _custom_init_states(self) -> tuple:
        """Every registered device slot's initial state, on the engine's
        device. Callers hold ``_lock`` (the slot (un)registration's reset,
        and the first-dispatch warm-up, whose caller holds it), so the
        slot tuple cannot change under the states it builds."""
        def place(x):
            if isinstance(x, tuple):
                return tuple(place(v) for v in x)
            return torch.as_tensor(x).to(self.device)
        return tuple(place(s.init_state(self.spec))
                     for s in self._device_slots)

    def _reset_custom_states_locked(self) -> None:
        """Reset every device slot's state (a (un)registration resets
        them all and renews the program keys, as the reference's re-jit
        does)."""
        self._state = self._state._replace(custom=self._custom_init_states())
        self._refresh_shardings_locked()    # custom states change structure
        self._renew_programs_locked()

    @staticmethod
    def _slot_code(kind: str, index: int) -> int:
        """Reason code of a custom slot's denial: CUSTOM_BASE + i for
        device slot i, CUSTOM_GATE_BASE + i for host gate i."""
        return (int(BlockReason.CUSTOM_GATE_BASE) + index if kind == "gate"
                else int(BlockReason.CUSTOM_BASE) + index)

    def slot_name_for_code(self, code: int) -> str:
        """The registered slot's name for a custom reason code."""
        code = int(code)
        if code >= BlockReason.CUSTOM_GATE_BASE:
            i = code - int(BlockReason.CUSTOM_GATE_BASE)
            return (self._host_gates[i].name  # graftlint: disable=LOCK002 -- diagnostic lookup over append-only slot lists; a stale read names the previous slot
                    if i < len(self._host_gates) else "unknown-slot")  # graftlint: disable=LOCK002 -- diagnostic lookup over append-only slot lists; a stale read names the previous slot
        i = code - int(BlockReason.CUSTOM_BASE)
        return (self._device_slots[i].name  # graftlint: disable=LOCK002 -- diagnostic lookup over append-only slot lists; a stale read names the previous slot
                if i < len(self._device_slots) else "unknown-slot")  # graftlint: disable=LOCK002 -- diagnostic lookup over append-only slot lists; a stale read names the previous slot

    def _exception_for(self, code: int, resource: str,
                       origin: str) -> BlockException:
        return block_exception_for(
            code, resource, origin=origin,
            slot_name=(self.slot_name_for_code(code)
                       if code >= BlockReason.CUSTOM_BASE else ""))

    def _run_host_gates_one(self, resource: str, origin: str, acquire: int,
                            args: Sequence, row: int, o_row: int, c_row: int,
                            is_in: bool) -> None:
        """The registered gates for one entry; a denial is recorded on the
        device and raised (a gate's own BlockException propagates)."""
        for gi, gate in enumerate(self._host_gates):  # graftlint: disable=LOCK002 -- gate list is append-only and published whole; iterating a stale snapshot is the SPI contract
            exc = None
            try:
                ok = gate.check(resource, origin, acquire, args)
            except BlockException as e:
                ok, exc = False, e
            if not ok:
                raise self._record_cluster_block(
                    self._slot_code("gate", gi), resource, origin, row,
                    o_row, c_row, acquire, is_in, exc=exc,
                    slot_name=gate.name)

    def _run_host_gates_batch(self, resources, origins, acq, args_list,
                              n: int):
        """→ (blocked bool[n], reasons int32[n]); the denials are logged
        here and recorded on the device by the caller in one batch."""
        blocked = np.zeros(n, np.bool_)
        reasons = np.zeros(n, np.int32)
        for gi, gate in enumerate(self._host_gates):  # graftlint: disable=LOCK002 -- gate list is append-only and published whole; iterating a stale snapshot is the SPI contract
            oks = np.asarray(gate.check_batch(resources, origins, acq,
                                              args_list), np.bool_)
            newly = ~oks & ~blocked
            if newly.any():
                code = self._slot_code("gate", gi)
                reasons[newly] = code
                blocked |= newly
                for i in np.nonzero(newly)[0].tolist():
                    org = (origins[i] if origins is not None
                           and origins[i] else "")
                    self._log_cluster_block(code, resources[i], org,
                                            int(acq[i]))
        return blocked, reasons

    def _record_blocks_locked(self, rows, origin_rows, chain_rows, acquire,
                              is_in, times) -> None:
        """BLOCK records of denials decided on the host (one batch)."""
        m = rows.shape[0]
        b = pad_pow2(m)
        r, ra = self.spec.rows, self.spec.alt_rows
        col = self._dev
        self._state = record_blocks(
            self.spec, self._state, col(pad_to(rows, b, r, np.int32)),
            col(pad_to(origin_rows, b, ra, np.int32)),
            col(pad_to(chain_rows, b, ra, np.int32)),
            col(pad_to(acquire, b, 0, np.int32)),
            col(pad_to(is_in, b, False, np.bool_)),
            col(pad_to(np.ones(m, np.bool_), b, False, np.bool_)), times)

    def _record_cluster_block(self, reason: int, resource: str, origin: str,
                              row: int, o_row: int, c_row: int,
                              acquire: int, is_in: bool, exc=None,
                              slot_name: str = "") -> BlockException:
        """Record a denial decided off the device (a host gate's) → the
        exception for the caller to raise (``exc`` when the gate raised
        its own)."""
        times = self._time_scalars(self.clock.now_ms())
        with self._lock:
            self._record_blocks_locked(
                np.array([row], np.int32), np.array([o_row], np.int32),
                np.array([c_row], np.int32), np.array([acquire], np.int32),
                np.array([is_in], np.bool_), times)
        return self._log_cluster_block(reason, resource, origin, acquire,
                                       exc=exc, slot_name=slot_name)

    def _log_cluster_block(self, reason: int, resource: str, origin: str,
                           acquire: int, exc=None,
                           slot_name: Optional[str] = None
                           ) -> BlockException:
        """Block log, counters and the ``onBlocked`` callbacks of a denial
        decided off the device (a host gate's; the device record is the
        caller's) → the exception for the caller to raise (``exc`` when
        the gate raised its own)."""
        if exc is None:
            exc = (self._exception_for(reason, resource, origin)
                   if slot_name is None else block_exception_for(
                       reason, resource, origin=origin, slot_name=slot_name))
        self.block_log.log(resource, type(exc).__name__, origin=origin)
        if self.obs.enabled:
            self._obs_block(resource, reason, origin, 1)
        if not self.callbacks.empty:
            self.callbacks.fire_blocked(resource, origin, acquire, exc)
        return exc

    def _cluster_check(self, resource: str, origin: str, row: int,
                       o_row: int, c_row: int, acquire: int, is_in: bool,
                       prioritized: bool, crules, sleep: bool = True,
                       record: bool = True) -> Tuple[int, int]:
        """``passClusterCheck`` for this resource's cluster-mode flow
        rules (``crules``: ``(slot_k, rule)`` pairs) → ``(fallback_bits,
        pending_wait_ms)``: bit k re-enables exactly slot k's rule in the
        local pipeline (per-rule ``fallbackToLocalOrPass``,
        FlowRuleChecker.java:184-193). BLOCKED raises FlowException (and,
        with ``record``, records the block on the device); SHOULD_WAIT
        sleeps, or with ``sleep=False`` adds to the returned wait;
        FAIL / NO_RULE / BAD_REQUEST / TOO_MANY_REQUEST (server overload:
        never a denial, FlowRuleChecker.applyTokenResult) take the
        fallback."""
        svc = self._token_service
        fallback_bits = 0
        pending_wait = 0
        for slot_k, r in crules:
            status, wait = -1, 0           # FAIL when no service installed
            if svc is not None:
                try:
                    res = svc.request_token(r.cluster_flow_id, acquire,
                                            prioritized)
                    status = int(res.status)
                    wait = int(getattr(res, "wait_ms", 0))
                except Exception as exc:
                    record_log().warning(
                        "cluster token request failed: %r", exc)
            if status == 0:                # OK
                continue
            if status == 2:                # SHOULD_WAIT → wait, then pass
                if wait > 0:
                    if sleep:
                        self.clock.sleep_ms(wait)
                    else:
                        pending_wait += wait
                continue
            if status == 1:                # BLOCKED
                if record:
                    raise self._record_cluster_block(
                        int(BlockReason.FLOW), resource, origin, row,
                        o_row, c_row, acquire, is_in)
                raise self._log_cluster_block(int(BlockReason.FLOW),
                                              resource, origin, acquire)
            if r.cluster_fallback_to_local:
                fallback_bits |= 1 << slot_k
        return fallback_bits, pending_wait

    def _cluster_param_check(self, resource: str, origin: str, row: int,
                             o_row: int, c_row: int, acquire: int,
                             is_in: bool, args: Sequence, cprules,
                             sleep: bool = True, record: bool = True) -> int:
        """``ParamFlowChecker.passClusterCheck`` → ``requestParamToken``
        for the cluster-mode param rules → the wait to add. BLOCKED raises
        ParamFlowException (recorded with ``record``; the batch tier
        records all its cluster blocks in one device call instead);
        SHOULD_WAIT as in :meth:`_cluster_check`; every other status —
        TOO_MANY_REQUEST included — passes (the param fallback is a
        documented pass-through)."""
        svc = self._token_service
        pending_wait = 0
        for r in cprules:
            idx = r.param_idx if r.param_idx >= 0 else len(args) + r.param_idx
            if idx < 0 or idx >= len(args):
                continue                      # no such arg → rule passes
            status, wait = -1, 0
            if svc is not None:
                try:
                    res = svc.request_param_token(r.cluster_flow_id, acquire,
                                                  [args[idx]])
                    status = int(res.status)
                    wait = int(getattr(res, "wait_ms", 0))
                except Exception as exc:
                    record_log().warning(
                        "cluster param token request failed: %r", exc)
            if status == 0:
                continue
            if status == 2:
                if wait > 0:
                    if sleep:
                        self.clock.sleep_ms(wait)
                    else:
                        pending_wait += wait
                continue
            if status == 1:                   # BLOCKED
                if record:
                    raise self._record_cluster_block(
                        int(BlockReason.PARAM_FLOW), resource, origin, row,
                        o_row, c_row, acquire, is_in)
                raise self._log_cluster_block(int(BlockReason.PARAM_FLOW),
                                              resource, origin, acquire)
        return pending_wait

    def _obs_block(self, resource: str, rcode: int, origin: str,
                   count: int) -> None:
        """Per-reason denial counter, the sampled block-event record and
        the flight recorder's block-burst trigger, keyed by the int8
        verdict code (custom codes by their slot's name)."""
        label = (self.slot_name_for_code(rcode)
                 if rcode >= BlockReason.CUSTOM_BASE
                 else exception_name_for(rcode))
        obs = self.obs
        obs.counters.add(obs_keys.BLOCK_PREFIX + label, count)
        ms = self.clock.now_ms()
        obs.block_events.log(ms, resource, rcode, reason_name=label,
                             origin=origin, count=count)
        obs.flight.note_blocks(count, ms)

    # ------------------------------------------------------------------
    # Time and device helpers
    # ------------------------------------------------------------------

    def _refresh_shardings_locked(self) -> None:
        """Meshed: derive the placement tree from the CURRENT state
        structure (a custom-slot registration or a geometry change alters
        it) and re-place every leaf. Callers hold ``self._lock``."""
        if self.mesh is None:
            return
        self._mesh_shardings = local_shard.shardings_for(
            self.spec, self.mesh, self._state)
        self._state = local_shard.pin_state(self._state,
                                            self._mesh_shardings[0])

    def _pin_state_locked(self) -> None:
        """Re-place state leaves after host code rebuilt some of them (a
        rule reload's fresh tables, a restore): no-op without a mesh, and
        leaves already in place stay. Callers hold ``self._lock``."""
        if self.mesh is not None:
            self._state = local_shard.pin_state(self._state,
                                                self._mesh_shardings[0])

    @property
    def is_multihost(self) -> bool:
        """True on a ``"rows"`` mesh that spans processes (the SPMD
        mode: every process replays the same calls)."""
        return self.mesh is not None and self.mesh.process_count > 1

    def _refuse_remote_rows(self, what: str) -> None:
        """Raise :class:`RemoteRowsError` for a host reader of row-split
        state on a mesh that spans processes — before it flushes or reads
        anything, so it issues no collective from one rank's thread."""
        if self.is_multihost:
            raise RemoteRowsError(remote_rows_message(
                what, self.mesh.process_count))

    def _rel_ms(self, now_ms: int) -> int:
        return int((now_ms - self.epoch_ms + 2 ** 31) % 2 ** 32 - 2 ** 31)

    def _time_scalars(self, now_ms: int) -> Tuple[int, int, int, int]:
        """(idx_s, idx_m, rel_ms, in_win_ms) — host ints, int32 range."""
        s = self.spec
        return (s.second.index_of(now_ms),
                s.minute.index_of(now_ms) if s.minute else 0,
                self._rel_ms(now_ms), now_ms % s.second.win_ms)

    def _restamp_if_stale_locked(self, at_ms: Optional[int], now: int,
                                 times):
        """An event-time (``at_ms``) dispatch whose window index is a full
        ring older than one already dispatched would re-own a bucket a
        newer write holds (its refresh would zero live counts): it is
        re-stamped to now instead → ``(now, times)``. Callers hold
        ``self._lock``, so the check and the dispatch are atomic."""
        if (at_ms is not None
                and self._seen_idx - self.spec.second.index_of(now)
                >= self.spec.second.buckets):
            now = self.clock.now_ms()
            times = self._time_scalars(now)
        return now, times

    def _note_dispatch_locked(self, now: int, any_prio: bool) -> bool:
        """Record a dispatch at ``now`` → whether its step is occupy-aware:
        this batch is prioritized, or a booking of an earlier one can
        still be live (bookings last at most B+1 windows)."""
        sec = self.spec.second
        self._seen_idx = max(self._seen_idx, sec.index_of(now))
        if any_prio:
            self._occupy_live_until_ms = now + (sec.buckets + 1) * sec.win_ms
        return any_prio or now < self._occupy_live_until_ms

    def _sys_scalars(self) -> Tuple[float, float]:
        load1, cpu = self._cpu.sample()
        return float(np.float32(load1)), float(np.float32(cpu))

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """Host column → device tensor. On CUDA the column is staged in
        pinned memory and copied with ``non_blocking`` (no stream sync)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _drain_evictions_locked(self) -> None:
        """Recycled param key rows are reset and pending per-item
        overrides written (both padded with PK, as the reference pads
        them); rows recycled by registry pressure lose their history (and
        that of the alt rows they hashed to) before they serve a new
        resource — with tiering on, after the tier manager has gathered
        it for the cold tier, and then cold keys interned again are
        restored into their new rows."""
        ev_keys, overrides = self.param_key_registry.drain_updates()
        pk = self.spec.param_keys
        if ev_keys:
            rows = pad_to(np.asarray(ev_keys, np.int32),
                          pad_pow2(len(ev_keys)), pk, np.int32)
            self._state = self._state._replace(
                param_dyn=pf_mod.invalidate_param_keys(
                    self._state.param_dyn, self._dev(rows)))
        if overrides:
            m = pad_pow2(len(overrides))
            rows = pad_to(np.asarray([r for r, _ in overrides], np.int32), m,
                          pk, np.int32)
            vals = pad_to(np.asarray([v for _, v in overrides], np.float32),
                          m, -1.0, np.float32)
            self._state = self._state._replace(
                param_dyn=pf_mod.apply_overrides(
                    self._state.param_dyn, self._dev(rows),
                    self._dev(vals)))
        evicted = self.resources.drain_evicted()
        if evicted:
            if self.obs.enabled:
                # recycled rows lose their stats and any live bookings
                self.obs.counters.add(obs_keys.OCCUPY_EVICTED, len(evicted))
            # tiering demote: snapshot the recycled rows' state before the
            # invalidate below destroys it (stream order keeps the gather
            # reading the old values); it needs the alt edges' host
            # identities, so it runs before they are popped
            self.tiering.pre_invalidate_locked(evicted, self.clock.now_ms())
            alt: List[int] = []
            for row in evicted:
                alt.extend(self._alt_rows_by_row.pop(row, ()))
            rows = pad_to(np.asarray(evicted, np.int32),
                          pad_pow2(len(evicted)), self.spec.rows, np.int32)
            alt_arr = pad_to(np.asarray(alt, np.int32), pad_pow2(len(alt)),
                             self.spec.alt_rows, np.int32)
            self._state = invalidate_resource_rows(
                self.spec, self._state, self._dev(rows), self._dev(alt_arr))
        # tiering promote: restore re-interned cold keys into their fresh
        # rows — after the invalidate, before the decide that interned
        # them. Unconditional: a promoted row may come from the free list
        # with no eviction in this drain.
        self.tiering.post_invalidate_locked(self.clock.now_ms())

    def _alt_row(self, row: int, kind: int, key_id: int) -> int:
        """Hash (row, origin/context id) to its alt row and record the
        edge for eviction."""
        r = _alt_hash(row, kind, key_id, self.spec.alt_rows)
        self._alt_rows_by_row.setdefault(row, {})[r] = (kind, key_id)
        return r

    def _alt_rows_for(self, row: int, origin: str,
                      context_name: str) -> Tuple[int, int]:
        """(origin row, chain row) of one call; ``alt_rows`` = none."""
        ra = self.spec.alt_rows
        o_row = c_row = ra
        if origin:
            o_row = self._alt_row(row, 0, self.origins.get_or_create(origin))
        if context_name and context_name != DEFAULT_CONTEXT_NAME:
            c_row = self._alt_row(row, 1,
                                  self.contexts.get_or_create(context_name))
        return o_row, c_row

    def _no_alt(self, origin_rows, chain_rows) -> bool:
        """Every origin/chain row is padding (>= alt_rows)."""
        pad_a = self.spec.alt_rows
        return bool(np.min(origin_rows, initial=pad_a) >= pad_a
                    and np.min(chain_rows, initial=pad_a) >= pad_a)

    def _key_fits(self) -> bool:
        """The fast path's composite key ``rule · (RA+1) + subrow`` fits
        int32 for the loaded rule capacity."""
        nf1 = self._ruleset.flow_table.active.shape[0]  # graftlint: disable=LOCK002 -- single atomic reference read; rule swaps publish a complete RuleSet under the lock
        return nf1 * (self.spec.alt_rows + 1) < 2 ** 31

    @staticmethod
    def _batch_facts(acquire, origin_ids, vfull) -> Tuple[bool, bool]:
        """(acquire uniform >= 1 over valid lanes, no origin id on a valid
        lane)."""
        acq_v = np.asarray(acquire)[vfull]
        acq_uniform = (acq_v.size > 0
                       and int(acq_v.min()) == int(acq_v.max()) >= 1)
        no_origin_ids = int(np.max(np.asarray(origin_ids)[vfull],
                                   initial=0)) == 0
        return acq_uniform, no_origin_ids

    def _route(self, acq_uniform: bool, pure_scalar: bool,
               any_prio: bool) -> str:
        """The whole batch's route: scalar (``pure_scalar``: no origin
        ids, alt rows or cluster-fallback bits), fast or general."""
        if pure_scalar and acq_uniform and not any_prio:
            return "scalar"
        if acq_uniform and self._key_fits():
            return "fast"
        return "general"

    def _flags(self, route: str, record_alt: bool, use_occ: bool,
               any_prio: bool = False) -> dict:
        """The engine step's flags for ``route``; ``use_occ`` runs the
        occupy-aware step, ``any_prio`` its occupy attempt. Callers hold
        ``_lock``: the flags name the device slots the dispatch under it
        runs, and ``register_slot`` swaps that tuple under the same
        lock."""
        flags = dict(skip_auth=self._skip_auth, skip_sys=self._skip_sys,
                     skip_threads=self._skip_threads,
                     sortfree=self._sortfree, record_alt=record_alt,
                     scalar_has_rl=self._scalar_has_rl,
                     enable_occupy=use_occ, any_prio=any_prio,
                     custom_slots=self._device_slots)
        if route == "scalar":
            flags["scalar_flow"] = True
        elif route == "fast":
            flags["fast_flow"] = True
        return flags

    def _pairs(self, arr, b: int, fill: int):
        """An [n, PV] pair column padded to [b, PV] with ``fill`` and copied
        over (None passes through)."""
        if arr is None:
            return None
        out = np.full((b, self.spec.param_pairs), fill, np.int32)
        out[:arr.shape[0]] = arr
        return self._dev(out)

    def _entry_batch(self, rows, origin_ids, origin_rows, context_ids,
                     chain_rows, acquire, is_in, prioritized, vfull,
                     count_thread=None, record_block=None, param_rules=None,
                     param_keys=None, cluster_fallback=None,
                     staged=None) -> EntryBatch:
        """Pad the raw columns to a power of two and copy them over (the
        pairs padded with the NP and PK sentinels).

        A serving-sized batch (``b >= _STAGING_MIN_B``) whose caller
        passes a ``staged`` list fills a slot of the size's
        :class:`_StagingRing` in place; the slot is appended to
        ``staged`` as ``(ring, slot)`` and the caller releases it once the
        dispatch has settled. Without a list the columns are fresh (a
        slot nobody will release is never acquired); the rare optional
        columns are always fresh."""
        b = pad_pow2(rows.shape[0])
        r, ra = self.spec.rows, self.spec.alt_rows
        cols = ((rows, r), (origin_ids, 0), (origin_rows, ra),
                (context_ids, 0), (chain_rows, ra), (acquire, 0),
                (is_in, False), (prioritized, False), (vfull, False))
        names = _StagingRing._INT_COLS + _StagingRing._BOOL_COLS
        if (self._staging_on and b >= self._STAGING_MIN_B
                and staged is not None):
            ring = self._staging.get(b)
            if ring is None:
                ring = self._staging.setdefault(b, _StagingRing(
                    b, self._staging_depth, self.device.type == "cuda"))
            slot = ring.acquire()
            staged.append((ring, slot))
            dev = {}
            for name, (arr, fill) in zip(names, cols):
                t = slot[name]
                pad_into(t.numpy(), arr, fill)
                # CPU: a copy, so the batch never aliases a reused slot
                dev[name] = (t.to(self.device, non_blocking=True)
                             if ring.pinned else t.clone())
        else:
            dev = {name: self._dev(pad_to(
                       arr, b, fill,
                       np.int32 if name in _StagingRing._INT_COLS
                       else np.bool_))
                   for name, (arr, fill) in zip(names, cols)}
        return EntryBatch(
            **dev,
            param_rules=self._pairs(param_rules, b, self.cfg.max_param_rules),
            param_keys=self._pairs(param_keys, b, self.spec.param_keys),
            cluster_fallback=(None if cluster_fallback is None else self._dev(
                pad_to(cluster_fallback, b, 0, np.int32))),
            count_thread=(None if count_thread is None else self._dev(
                pad_to(count_thread, b, False, np.bool_))),
            record_block=(None if record_block is None else self._dev(
                pad_to(record_block, b, False, np.bool_))))

    def _exit_batch(self, rows, origin_rows, chain_rows, acquire, rt_ms,
                    error, is_in, valid, count_thread=None, param_rules=None,
                    param_keys=None) -> ExitBatch:
        b = pad_pow2(rows.shape[0])
        r, ra = self.spec.rows, self.spec.alt_rows
        col = self._dev
        return ExitBatch(
            rows=col(pad_to(rows, b, r, np.int32)),
            origin_rows=col(pad_to(origin_rows, b, ra, np.int32)),
            chain_rows=col(pad_to(chain_rows, b, ra, np.int32)),
            acquire=col(pad_to(acquire, b, 0, np.int32)),
            rt_ms=col(pad_to(rt_ms, b, 0, np.int32)),
            error=col(pad_to(error, b, False, np.bool_)),
            is_in=col(pad_to(is_in, b, False, np.bool_)),
            valid=col(pad_to(valid, b, False, np.bool_)),
            param_rules=self._pairs(param_rules, b, self.cfg.max_param_rules),
            param_keys=self._pairs(param_keys, b, self.spec.param_keys),
            count_thread=(None if count_thread is None else
                          col(pad_to(count_thread, b, False, np.bool_))))

    @staticmethod
    def _valid_full(n: int, valid) -> np.ndarray:
        vfull = np.ones(n, np.bool_)
        if valid is not None:
            vsrc = np.asarray(valid, bool)
            m = min(n, vsrc.shape[0])
            vfull[:] = False
            vfull[:m] = vsrc[:m]
        return vfull

    # below this padded size staging buys nothing: the per-call tier pads
    # to b=8..256, and a ring would be shared mutable state for every
    # concurrent entry() thread
    _STAGING_MIN_B = 512

    def _pending(self, parts, n: int, *, staged=(), brk=None,
                 on_read=None) -> PendingVerdicts:
        """Start the verdict copies of one dispatch → a leak-guarded
        handle. ``parts`` is ``[(verdicts, event indices or None for
        0..n-1)]`` (a split dispatch has two). Each part's
        ``sf_overflow`` and the breaker snapshot ``brk`` (seq, rules,
        state column) ride the same copy; the reader releases the
        ``staged`` slots (the device has consumed them once the copies
        are done), adds the overflow to ``sortfree_overflow``, runs
        ``on_read(verdicts, overflow)`` and diffs the breakers. Callers
        hold ``self._lock``: the copies are enqueued before any later
        step."""
        cols = []
        for v, idx in parts:
            m = n if idx is None else idx.shape[0]
            cols += [v.allow[:m], v.reason[:m], v.wait_ms[:m]]
        cols += [v.sf_overflow for v, _ in parts
                 if v.sf_overflow is not None]
        if brk is not None:
            cols.append(brk[2])
        host, event = start_host_copy(cols)

        def _read() -> Verdicts:
            got = wait_host_copy(host, event)
            out = Verdicts(allow=np.empty(n, np.bool_),
                           reason=np.empty(n, np.int8),
                           wait_ms=np.empty(n, np.int32))
            k = 0
            for _v, idx in parts:
                sel = slice(None) if idx is None else idx
                out.allow[sel] = got[k]
                out.reason[sel] = got[k + 1]
                out.wait_ms[sel] = got[k + 2]
                k += 3
            states = got.pop()[:-1].tolist() if brk is not None else None
            overflow = sum(int(x) for x in got[k:])
            while staged:
                ring, slot = staged.pop()
                ring.release(slot)
            if overflow:
                with self._lock:
                    self.sortfree_overflow += overflow
            if on_read is not None:
                on_read(out, overflow)
            if brk is not None:
                self._diff_and_fire_breakers(brk[0], brk[1], states)
            return out

        return self._pending_verdicts(_read)

    def _on_leaked_handle(self) -> None:
        if self.obs.enabled:
            self.obs.counters.add(obs_keys.PIPE_LEAKED)
        _log.warning("PendingVerdicts dropped without .result(); "
                     "settled by the GC finalizer")

    def _pending_verdicts(self, fn) -> PendingVerdicts:
        """A leak-guarded handle for a deferred settle (every nowait path
        returns through here)."""
        h = PendingVerdicts(fn)
        h.attach_leak_guard(self._on_leaked_handle)
        return h

    def _breaker_snapshot_locked(self):
        """(seq, rules, state column) for the breaker observers, or None
        without any. On the CPU the column is copied: a later step may
        update the live state in place before the deferred read."""
        if not self._breaker_observers:
            return None
        self._breaker_seq += 1
        col = self._state.breakers.state
        return (self._breaker_seq, self._deg.rules,
                col if col.is_cuda else col.clone())

    # ------------------------------------------------------------------
    # Per-call API
    # ------------------------------------------------------------------

    def entry(self, resource: str, *, origin: Optional[str] = None,
              acquire: int = 1, entry_type: int = ENTRY_TYPE_IN,
              prioritized: bool = False, args: Sequence = (),
              resource_type: int = 0, sleep: bool = True) -> Entry:
        """Guard a call. Raises a BlockException subclass when denied;
        sleeps (via the clock) on pass-with-wait verdicts, or with
        ``sleep=False`` reports the wait on ``Entry.wait_ms``. The origin
        is ``origin``, else the current context's
        (:class:`~sentinel_tpu_torch.core.context.ContextScope`); the
        context's name keys CHAIN rules. ``prioritized``
        (``SphU.entryWithPriority``): a call a DEFAULT QPS rule would deny
        may book the next window and pass after waiting for its edge.
        ``args`` are the call's parameters for hot-param rules
        (``SphU.entry(name, args)``). The host gates run first. With the
        host fast path on, calls on rule-free and leased resources are
        decided on the host (``Entry.fast``). ``resource_type``
        (``ResourceTypeConstants``) classifies the resource's metric
        lines. With the global switch off every call passes unchecked."""
        if not self._global_on:
            return Entry(self, resource, -1, -1, -1, acquire,
                         entry_type == ENTRY_TYPE_IN, self.clock.now_ms())
        ctx = current_context()
        use_origin = ctx.origin if origin is None else origin
        # rows resolved ONCE: the same rows feed the verdict and the Entry
        row = self.resources.get_or_create(resource)
        if self.tiering.enabled:
            # classify + queue a promotion if this key's state is cold
            self.tiering.note_interned((resource,), (row,))
        if resource_type:
            self.resource_types[resource] = resource_type
        origin_id = self.origins.get_or_create(use_origin) if use_origin \
            else 0
        o_row, c_row = self._alt_rows_for(row, use_origin, ctx.name)
        context_id = (self.contexts.get_or_create(ctx.name)
                      if c_row < self.spec.alt_rows else 0)
        is_in = entry_type == ENTRY_TYPE_IN
        if self._host_gates:  # graftlint: disable=LOCK002 -- hot-path feature gate: a stale read routes one call through the exact device path, never unsafely
            self._run_host_gates_one(resource, use_origin or "", acquire,
                                     args, row, o_row, c_row, is_in)
        if self._fast_enabled and not prioritized:  # graftlint: disable=LOCK002 -- hot-path feature gate: a stale read routes one call through the exact device path, never unsafely
            fe = self._fast_entry(resource, row, o_row, c_row, origin_id,
                                  use_origin or "", acquire, is_in, args)
            if fe is not None:
                return fe
        if self._fast_enabled and self._fast.due(self.clock.now_ms()):  # graftlint: disable=LOCK002 -- hot-path feature gate: a stale read routes one call through the exact device path, never unsafely
            # buffered stats reach the device before this decide
            self._flush_fast()
        # cluster-mode rules: token-server delegation BEFORE the local
        # pipeline (FlowRuleChecker.passClusterCheck); failed requests
        # with fallbackToLocalWhenFail re-enable exactly those rules
        # locally (the per-rule slot bitmask)
        cluster_fb = 0
        cluster_wait = 0
        crules = self._cluster_rules_by_row.get(row)
        if crules:
            cluster_fb, cluster_wait = self._cluster_check(
                resource, use_origin or "", row, o_row, c_row, acquire,
                is_in, prioritized, crules, sleep)
        cprules = self._cluster_param_rules_by_row.get(row)
        if cprules and args:
            cluster_wait += self._cluster_param_check(
                resource, use_origin or "", row, o_row, c_row, acquire,
                is_in, args, cprules, sleep)
        pairs = self._resolve_param_pairs_one(row, args)
        try:
            verdict = self.decide_raw(
                np.array([row], np.int32), np.array([origin_id], np.int32),
                np.array([o_row], np.int32),
                np.array([context_id], np.int32),
                np.array([c_row], np.int32), np.array([acquire], np.int32),
                np.array([is_in], np.bool_),
                np.array([prioritized], np.bool_),
                param_rules=None if pairs is None else pairs[0][None, :],
                param_keys=None if pairs is None else pairs[1][None, :],
                param_gen=-1 if pairs is None else pairs[2],
                cluster_fallback=(np.array([cluster_fb], np.int32)
                                  if cluster_fb else None))
            if not bool(verdict.allow[0]):
                rcode = int(verdict.reason[0])
                exc = self._exception_for(rcode, resource, use_origin or "")
                # LogSlot: block events roll into sentinel-block.log
                self.block_log.log(resource, type(exc).__name__,
                                   origin=use_origin or "")
                if self.obs.enabled:
                    self._obs_block(resource, rcode, use_origin or "", 1)
                if not self.callbacks.empty:   # StatisticSlot onBlocked
                    self.callbacks.fire_blocked(resource, use_origin or "",
                                                acquire, exc)
                raise exc
        except BaseException:
            if pairs is not None:   # a blocked entry never exits: unpin
                pairs[3].unpin_rows(pairs[4])
            raise
        if not self.callbacks.empty:           # StatisticSlot onPass
            self.callbacks.fire_pass(resource, use_origin or "", acquire,
                                     args)
        wait = int(verdict.wait_ms[0])
        if wait > 0 and sleep:
            self.clock.sleep_ms(wait)
        if not sleep:
            wait += cluster_wait     # a cluster SHOULD_WAIT surfaces here too
        now = self.clock.now_ms()
        # sleep=False: project create_ms past the wait the caller will
        # await, so rt excludes the pacing delay as with sleep=True
        e = Entry(self, resource, row, o_row, c_row, acquire, is_in,
                  now if sleep else now + wait, param_pairs=pairs)
        if not sleep:
            e.wait_ms = wait
        return e

    def _resolve_param_pairs_one(self, row: int, args: Sequence):
        """→ (rules [PV], keys [PV], generation, registry, pinned rows), or
        None when the resource has no param rule or the call no args.
        Table, registry and generation are read together under the lock;
        the THREAD-grade key rows come back pinned against recycling, and
        the caller unpins them (on a denial, or after the exit's
        decrement)."""
        with self._lock:
            compiled = self._param
            registry = self.param_key_registry
            gen = self._param_gen
        if not compiled.num_active or not args or row not in compiled.by_row:
            return None
        pr, pk = pf_mod.resolve_pairs(compiled, registry, row, args,
                                      self.spec.param_pairs)
        pins = pf_mod.thread_key_rows(compiled, pr, pk)
        registry.pin_rows(pins)
        return (pr, pk, gen, registry, pins)

    def _fast_entry(self, resource: str, row: int, o_row: int, c_row: int,
                    origin_id: int, origin: str, acquire: int,
                    is_in: bool, args: Sequence = ()) -> Optional[Entry]:
        """Try the host fast path → an admitted :class:`Entry`, or None to
        take the exact device path (it never decides a denial)."""
        fast = self._fast
        if fast.sys_active and is_in:
            return None          # SystemSlot gates inbound traffic globally
        kind = fast.classify(row)
        if kind == fp_mod.INELIGIBLE:
            return None
        now = self.clock.now_ms()
        if kind == fp_mod.FREE:
            fast.buffer_pass(row, o_row, c_row, acquire, is_in, now)
            mode = "free"
        else:
            # a lease pre-charges no alt rows: it serves origin-less,
            # default-context calls only
            if origin_id != 0 or c_row < self.spec.alt_rows:
                return None
            verdict = fast.lease_state(row, acquire, is_in, now)
            if verdict == fp_mod.DEVICE:
                return None
            if verdict == fp_mod.RENEW:
                if fast.is_hot(row, now):
                    return None    # a chunk was denied this bucket
                # one renewal in flight per row: a concurrent pre-charge
                # would spend the window budget twice
                if not fast.begin_renewal(row):
                    return None
                try:
                    # re-check under the claim: another thread may have
                    # installed a lease meanwhile
                    recheck = fast.lease_state(row, acquire, is_in, now)
                    if recheck == fp_mod.DEVICE:
                        return None
                    if recheck != fp_mod.ADMIT:
                        chunk = fast.lease_chunk(row, acquire)
                        gen0 = fast.table_gen
                        ra = self.spec.alt_rows
                        # at_ms=now: the chunk's PASS lands in the bucket
                        # the lease is stamped with, which its expiry
                        # uncount then targets
                        v = self.decide_raw(
                            np.array([row], np.int32), np.zeros(1, np.int32),
                            np.array([ra], np.int32), np.zeros(1, np.int32),
                            np.array([ra], np.int32),
                            np.array([chunk], np.int32),
                            np.array([is_in], np.bool_),
                            np.zeros(1, np.bool_),
                            count_thread=np.zeros(1, np.bool_),
                            record_block=np.zeros(1, np.bool_),
                            at_ms=now)
                        if not bool(v.allow[0]):
                            fast.mark_hot(row, now)
                            return None
                        fast.install_lease(row, chunk, acquire, is_in, now,
                                           gen=gen0)
                finally:
                    fast.end_renewal(row)
            mode = "leased"
        if not self.callbacks.empty:   # StatisticSlot onPass
            self.callbacks.fire_pass(resource, origin, acquire, args)
        e = Entry(self, resource, row, o_row, c_row, acquire, is_in, now)
        e.fast = mode
        if fast.due(now):
            self._flush_fast(now)
        return e

    def _flush_fast(self, now_ms: Optional[int] = None) -> None:
        """Land the fast path's buffered statistics on the device with
        their event-time window stamps: passes and exits grouped by
        second-window index, each group dispatched at its own time (a
        group a full ring older than any dispatch is re-stamped to now);
        passes through the decide step (rule-free events cannot block),
        expired leases' unused tokens through :func:`uncount_reserved`,
        exits through :meth:`exit_batch`."""
        now = self.clock.now_ms() if now_ms is None else now_ms
        with self._flush_lock:
            self._flush_fast_locked(now)

    def _flush_fast_locked(self, now: int) -> None:
        passes, exits, expired = self._fast.drain(now)
        if not passes and not exits and not expired:
            return
        sec = self.spec.second

        def grouped(events, ms_pos):
            by: Dict[int, list] = {}
            for e in events:
                by.setdefault(sec.index_of(e[ms_pos]), []).append(e)
            return sorted(by.items())

        def column(grp, pos, dtype):
            return np.fromiter((x[pos] for x in grp), dtype, len(grp))

        for g_idx, grp in grouped(passes, 5):
            at = grp[0][5] if self._seen_idx - g_idx < sec.buckets else None
            n = len(grp)
            self.decide_raw_nowait(
                column(grp, 0, np.int32), np.zeros(n, np.int32),
                column(grp, 1, np.int32), np.zeros(n, np.int32),
                column(grp, 2, np.int32), column(grp, 3, np.int32),
                column(grp, 4, np.bool_), np.zeros(n, np.bool_),
                at_ms=at)           # verdicts unused: all rule-free
        if expired:
            # unused lease tokens go back to their window buckets (the
            # ENTRY row's too for inbound pre-charges)
            rows, secs, mins, amts = [], [], [], []
            minute = self.spec.minute
            for row, created, remaining, was_in in expired:
                for r in ((row, ENTRY_NODE_ROW) if was_in else (row,)):
                    rows.append(r)
                    secs.append(sec.index_of(created))
                    mins.append(minute.index_of(created) if minute else 0)
                    amts.append(remaining)
            b = pad_pow2(len(rows))
            cols = [self._dev(pad_to(np.asarray(a, np.int32), b, fill,
                                     np.int32))
                    for a, fill in ((rows, self.spec.rows), (secs, 0),
                                    (mins, 0), (amts, 0))]
            with self._lock:
                self._state = uncount_reserved(self.spec, self._state,
                                               *cols)
        for g_idx, grp in grouped(exits, 8):
            at = grp[0][8] if self._seen_idx - g_idx < sec.buckets else None
            self.exit_batch(
                rows=column(grp, 0, np.int32),
                origin_rows=column(grp, 1, np.int32),
                chain_rows=column(grp, 2, np.int32),
                acquire=column(grp, 3, np.int32),
                rt_ms=column(grp, 4, np.int32),
                error=column(grp, 5, np.bool_),
                is_in=column(grp, 6, np.bool_),
                count_thread=column(grp, 7, np.bool_), at_ms=at)

    def _exit_one(self, e: Entry) -> None:
        if e.row < 0:       # the global switch was off at entry
            return
        now = self.clock.now_ms()
        rt = max(0, now - e.create_ms)
        if e.fast is not None:
            # fast-path entries exit through the host buffer (leased ones
            # opted out of the thread gauge on entry: symmetric here)
            self._fast.buffer_exit(
                e.row, e.origin_row, e.chain_row, e.acquire,
                min(rt, self.cfg.statistic_max_rt), e.error is not None,
                e.is_in, e.fast == "free", now)
            if not self.callbacks.empty:
                self.callbacks.fire_exit(e.resource, rt, e.error is not None,
                                         e.acquire)
            if self._fast.due(now):
                self._flush_fast(now)
            return
        pairs = e.param_pairs
        self.exit_batch(
            rows=np.array([e.row], np.int32),
            origin_rows=np.array([e.origin_row], np.int32),
            chain_rows=np.array([e.chain_row], np.int32),
            acquire=np.array([e.acquire], np.int32),
            rt_ms=np.array([min(rt, self.cfg.statistic_max_rt)], np.int32),
            error=np.array([e.error is not None], np.bool_),
            is_in=np.array([e.is_in], np.bool_),
            param_rules=None if pairs is None else pairs[0][None, :],
            param_keys=None if pairs is None else pairs[1][None, :],
            param_gen=-1 if pairs is None else pairs[2])
        if not self.callbacks.empty:           # MetricExitCallback
            self.callbacks.fire_exit(e.resource, rt, e.error is not None,
                                     e.acquire)

    # ------------------------------------------------------------------
    # Batch API (throughput tier)
    # ------------------------------------------------------------------

    def intern_resources(self, resources: Sequence[str]) -> np.ndarray:
        """Intern every DISTINCT name once → the int32 row array, for
        serving loops that pass it to :meth:`entry_batch` step after step
        (moving the intern cost out of the per-step path)."""
        names = list(dict.fromkeys(resources))
        drows = np.fromiter((self.resources.get_or_create(r) for r in names),
                            np.int32, count=len(names))
        self.tiering.note_interned(names, drows)
        if len(names) == len(resources):
            return drows
        by_name = dict(zip(names, drows))
        return np.fromiter((by_name[r] for r in resources), np.int32,
                           count=len(resources))

    def entry_batch(self, resources, **kwargs) -> Verdicts:
        return self.entry_batch_nowait(resources, **kwargs).result()

    def entry_batch_nowait(
            self, resources, *,
            origins: Optional[Sequence[str]] = None,
            contexts: Optional[Sequence[str]] = None,
            acquire: Optional[Sequence[int]] = None,
            entry_types: Optional[Sequence[int]] = None,
            prioritized: Optional[Sequence[bool]] = None,
            args_list=None, trace_id: int = 0) -> PendingVerdicts:
        """Dispatch-only batch tier: the decide is enqueued and the
        verdict copy started; ``.result()`` materializes, releases the
        param-key pins of the denied events and writes their block log
        (call it for every handle). ``resources`` may be names or a numpy
        INTEGER array of pre-interned rows (:meth:`intern_resources`);
        ``origins`` and ``contexts`` name each event's caller and entrance
        context (empty = none); ``args_list`` holds each event's
        parameters for hot-param rules — a 2-D numpy integer array is the
        fastest form (one rule per resource then resolves vectorized). The
        host gates run first; the events they deny are recorded in one
        batch and left out of the decide. ``trace_id`` (from a caller
        that minted one) keeps the batch's spans on that trace; else the
        span sampler decides."""
        n = len(resources)
        obs = self.obs
        obs_on = obs.enabled
        tr = (trace_id or obs.spans.maybe_trace()) if obs_on else 0
        t0 = obs.spans.now_ns() if obs_on else 0
        if isinstance(resources, np.ndarray) and resources.dtype.kind in "iu":
            rows = np.ascontiguousarray(resources, np.int32)
            # names are recovered where a gate, the cluster delegation or
            # the block log needs them
            resources = ([self.resources.name_of(int(r)) or ""
                          for r in rows]
                         if (self._host_gates  # graftlint: disable=LOCK002 -- hot-path feature gate: a stale read routes one batch through the exact device path, never unsafely
                             or self._cluster_rules_by_row
                             or self._cluster_param_rules_by_row) else None)
        else:
            batch_intern = getattr(self.resources, "get_or_create_batch",
                                   None)
            if batch_intern is not None:  # native table: one call, no GIL
                rows = batch_intern(resources)
            else:
                rows = np.fromiter(
                    (self.resources.get_or_create(r) for r in resources),
                    np.int32, count=n)
            # tiering: classify hot hits / cold misses and queue the
            # promotions (restored in this dispatch's eviction drain)
            self.tiering.note_interned(resources, rows)
        with self._lock:
            compiled = self._param
            registry = self.param_key_registry
            gen = self._param_gen
        ra = self.spec.alt_rows
        origin_ids = np.zeros(n, np.int32)
        origin_rows = np.full(n, ra, np.int32)
        context_ids = np.zeros(n, np.int32)
        chain_rows = np.full(n, ra, np.int32)
        if origins is not None:
            for i, o in enumerate(origins):
                if o:
                    oid = self.origins.get_or_create(o)
                    origin_ids[i] = oid
                    origin_rows[i] = self._alt_row(int(rows[i]), 0, oid)
        if contexts is not None:
            for i, c in enumerate(contexts):
                if c and c != DEFAULT_CONTEXT_NAME:
                    cid = self.contexts.get_or_create(c)
                    context_ids[i] = cid
                    chain_rows[i] = self._alt_row(int(rows[i]), 1, cid)
        acq = (np.asarray(acquire, np.int32) if acquire is not None
               else np.ones(n, np.int32))
        is_in = ((np.asarray(entry_types, np.int32) == ENTRY_TYPE_IN)
                 if entry_types is not None else np.ones(n, np.bool_))
        prio = (np.asarray(prioritized, np.bool_) if prioritized is not None
                else np.zeros(n, np.bool_))
        if tr:
            obs.spans.record(tr, "entry.prep", t0, obs.spans.now_ns(), n=n)
        # the gates run before any key is pinned: a gate that raises
        # leaks no pin
        gate_blocked = gate_reasons = None
        if self._host_gates:  # graftlint: disable=LOCK002 -- hot-path feature gate: a stale read routes one batch through the exact device path, never unsafely
            t_g = obs.spans.now_ns() if tr else 0
            gate_blocked, gate_reasons = self._run_host_gates_batch(
                resources, origins, acq, args_list, n)
            if tr:
                obs.spans.record(tr, "entry.host_gates", t_g,
                                 obs.spans.now_ns(), n=n)
            if not gate_blocked.any():
                gate_blocked = gate_reasons = None
        param_rules = param_keys = pin_arr = None
        if args_list is not None and compiled.num_active:
            param_rules, param_keys = pf_mod.resolve_pairs_many(
                compiled, registry, rows, args_list, self.spec.param_pairs)
            # THREAD-grade pairs stay pinned while in flight (the denied
            # events' pins are released at readback)
            pin_arr = pf_mod.thread_key_rows(
                compiled, param_rules, param_keys).reshape(param_keys.shape)
            registry.pin_rows(pin_arr)
        # cluster-mode rules: token delegation BEFORE the local decide,
        # one batched call when the service has one; the events it denies
        # leave the decide and come back as FLOW / PARAM_FLOW denials
        cluster_fb = pre_blocked = pre_reasons = pre_waits = valid = None
        if self._cluster_rules_by_row or self._cluster_param_rules_by_row:
            t_c = obs.spans.now_ns() if tr else 0
            cluster_fb, pre_blocked, pre_waits, pre_reasons, valid = \
                self._cluster_precheck_batch(
                    resources, origins, rows, acq, prio, args_list, n,
                    skip=gate_blocked)
            if tr:
                obs.spans.record(tr, "entry.cluster_precheck", t_c,
                                 obs.spans.now_ns(), n=n)
        if gate_blocked is not None:
            # the gates ran first: their denials take precedence and never
            # overlap a cluster denial
            if pre_blocked is None:
                pre_blocked, pre_reasons = gate_blocked, gate_reasons
                pre_waits = np.zeros(n, np.int32)
                valid = ~gate_blocked
            else:
                pre_blocked = pre_blocked | gate_blocked
                pre_reasons = np.where(gate_blocked, gate_reasons,
                                       pre_reasons)
                valid = valid & ~gate_blocked
        if pre_blocked is not None and pre_blocked.any():
            # one batched device record for every event denied on the host
            idxs = np.nonzero(pre_blocked)[0]
            times = self._time_scalars(self.clock.now_ms())
            with self._lock:
                self._record_blocks_locked(
                    rows[idxs], origin_rows[idxs], chain_rows[idxs],
                    acq[idxs], is_in[idxs], times)
        pending = self.decide_raw_nowait(
            rows, origin_ids, origin_rows, context_ids, chain_rows, acq,
            is_in, prio, valid=valid, param_rules=param_rules,
            param_keys=param_keys, param_gen=gen,
            cluster_fallback=cluster_fb, trace_id=tr)

        def _finalize() -> Verdicts:
            t_s = obs.spans.now_ns() if tr else 0
            verdicts = pending.result()
            if pre_blocked is not None:
                verdicts = verdicts._replace(
                    allow=np.where(pre_blocked, False, verdicts.allow),
                    reason=np.where(pre_blocked, pre_reasons,
                                    verdicts.reason).astype(np.int8),
                    wait_ms=np.maximum(verdicts.wait_ms, pre_waits))
            if pin_arr is not None:
                # denied events never exit: release their pins now
                denied = ~np.asarray(verdicts.allow)
                if denied.any():
                    registry.unpin_rows(pin_arr[denied])
            # LogSlot: the denials roll into sentinel-block.log, grouped
            # so a mostly denied batch is a handful of log calls (the
            # gates and the cluster precheck logged theirs already)
            denied = np.nonzero(~np.asarray(verdicts.allow))[0]
            if denied.size:
                reasons = np.asarray(verdicts.reason)
                grouped: Dict[tuple, int] = {}
                # one name lookup a distinct row (a C++ table's name_of
                # is a foreign call with a buffer of its own)
                names: Dict[int, str] = {}
                for i in denied.tolist():
                    if pre_blocked is not None and pre_blocked[i]:
                        continue
                    if resources is not None:
                        res_i = resources[i]
                    else:
                        row = int(rows[i])
                        res_i = names.get(row)
                        if res_i is None:
                            res_i = names[row] = (
                                self.resources.name_of(row) or "")
                    key = (res_i, int(reasons[i]),
                           (origins[i] if origins is not None
                            and origins[i] else ""))
                    grouped[key] = grouped.get(key, 0) + 1
                for (res, rcode, origin), cnt in grouped.items():
                    self.block_log.log(res, exception_name_for(rcode),
                                       origin=origin, count=cnt)
                    if obs_on:
                        self._obs_block(res, rcode, origin, cnt)
            if obs_on:
                t_end = obs.spans.now_ns()
                obs.hist_entry.record(t_end - t0)
                if tr:
                    obs.spans.record(tr, "entry.settle", t_s, t_end, n=n)
                    obs.spans.record(tr, "entry.total", t0, t_end, n=n)
            return verdicts

        return self._pending_verdicts(_finalize)

    def _cluster_precheck_batch(self, resources, origins, rows, acq, prio,
                                args_list, n: int, skip=None):
        """Cluster token delegation for a whole batch → ``(fallback bits
        or None, blocked, waits, reasons, valid)``.

        A service with ``request_tokens_batch`` (the embedded engine and
        the socket client both have it) gets ALL the batch's flow token
        requests in one call (``ClusterFlowChecker.java:55-112`` per
        request, applied in rule order per event; a BLOCKED verdict
        short-circuits the event's remaining results as the exception
        would), and the param requests in one
        ``request_param_tokens_batch`` call where the service has that
        too. Tokens for an event's later rules may be consumed even when
        an earlier rule blocks — bounded over-consumption of the class
        the reference's check-then-act races tolerate. A plain per-call
        service is asked event by event. Denials are logged here and
        recorded on the device by the caller; ``skip`` marks events a
        host gate already denied."""
        svc = self._token_service
        fallback = np.zeros(n, np.int32)      # per-rule slot bitmask
        cl_blocked = np.zeros(n, np.bool_)
        cl_waits = np.zeros(n, np.int32)
        cl_reasons = np.full(n, int(BlockReason.FLOW), np.int32)
        valid = np.ones(n, np.bool_)

        def origin_of(i):
            return origins[i] if origins is not None and origins[i] else ""

        def has_args(i):
            return (args_list is not None and args_list[i] is not None
                    and len(args_list[i]) > 0)

        if svc is None or not hasattr(svc, "request_tokens_batch"):
            for i in range(n):
                if skip is not None and skip[i]:
                    continue       # already denied by a host gate
                crules = self._cluster_rules_by_row.get(int(rows[i]))
                cprules = self._cluster_param_rules_by_row.get(int(rows[i]))
                if not crules and not cprules:
                    continue
                try:
                    if crules:
                        fallback[i], cl_waits[i] = self._cluster_check(
                            resources[i], origin_of(i), int(rows[i]), 0, 0,
                            int(acq[i]), True, bool(prio[i]), crules,
                            sleep=False, record=False)
                    if cprules and has_args(i):
                        cl_waits[i] += self._cluster_param_check(
                            resources[i], origin_of(i), int(rows[i]), 0, 0,
                            int(acq[i]), True, args_list[i], cprules,
                            sleep=False, record=False)
                except BlockException as exc:
                    cl_blocked[i] = True
                    if isinstance(exc, ParamFlowException):
                        cl_reasons[i] = int(BlockReason.PARAM_FLOW)
                    valid[i] = False        # out of the local decide
            return ((fallback if fallback.any() else None), cl_blocked,
                    cl_waits, cl_reasons, valid)

        # ---- batched: collect → one call per kind → apply in order ----
        flow_req: list = []    # (event i, slot k, rule)
        param_req: list = []   # (event i, rule, value)
        for i in range(n):
            if skip is not None and skip[i]:
                continue
            for slot_k, r in self._cluster_rules_by_row.get(int(rows[i]),
                                                           ()):
                flow_req.append((i, slot_k, r))
            cprules = self._cluster_param_rules_by_row.get(int(rows[i]))
            if cprules and has_args(i):
                a = args_list[i]
                for r in cprules:
                    idx = (r.param_idx if r.param_idx >= 0
                           else len(a) + r.param_idx)
                    if 0 <= idx < len(a):
                        param_req.append((i, r, a[idx]))
        flow_res: list = [None] * len(flow_req)
        param_res: list = [None] * len(param_req)
        try:
            if flow_req:
                flow_res = svc.request_tokens_batch(
                    [(r.cluster_flow_id, int(acq[i]), bool(prio[i]))
                     for i, _k, r in flow_req])
        except Exception as exc:
            record_log().warning("batched cluster token request failed: %r",
                                 exc)
        # the param batch call is gated on ITS OWN method: a service with
        # only the flow batch must not silently fail open for param rules
        try:
            if param_req and hasattr(svc, "request_param_tokens_batch"):
                param_res = svc.request_param_tokens_batch(
                    [(r.cluster_flow_id, int(acq[i]), [v])
                     for i, r, v in param_req])
            elif param_req:
                param_res = [svc.request_param_token(
                    r.cluster_flow_id, int(acq[i]), [v])
                    for i, r, v in param_req]
        except Exception as exc:
            record_log().warning("batched cluster param request failed: %r",
                                 exc)
        for kind, reqs, res_list in (("flow", flow_req, flow_res),
                                     ("param", param_req, param_res)):
            reason = int(BlockReason.FLOW if kind == "flow"
                         else BlockReason.PARAM_FLOW)
            for req, res in zip(reqs, res_list):
                i = req[0]
                if cl_blocked[i]:
                    continue    # the first BLOCK wins (the exception's
                    # short-circuit)
                status = int(res.status) if res is not None else -1
                if status == 0:
                    continue
                if status == 2:
                    cl_waits[i] += int(getattr(res, "wait_ms", 0))
                    continue
                if status == 1:
                    cl_blocked[i] = True
                    valid[i] = False
                    cl_reasons[i] = reason
                    self._log_cluster_block(reason, resources[i],
                                            origin_of(i), int(acq[i]))
                    continue
                # FAIL / NO_RULE / BAD_REQUEST / TOO_MANY: a flow rule's
                # fallback; a param rule passes through
                if kind == "flow" and req[2].cluster_fallback_to_local:
                    fallback[i] |= 1 << req[1]
        return ((fallback if fallback.any() else None), cl_blocked,
                cl_waits, cl_reasons, valid)

    def decide_raw(self, rows, origin_ids, origin_rows, context_ids,
                   chain_rows, acquire, is_in, prioritized, *,
                   valid=None, count_thread=None, record_block=None,
                   param_rules=None, param_keys=None, param_gen: int = -1,
                   cluster_fallback=None,
                   at_ms: Optional[int] = None) -> Verdicts:
        """Lowest-level host entry point: pre-resolved numpy arrays.
        ``param_gen`` is the generation the pairs were resolved against:
        pairs of an older one (a reload came in between) are dropped."""
        return self.decide_raw_nowait(
            rows, origin_ids, origin_rows, context_ids, chain_rows, acquire,
            is_in, prioritized, valid=valid, count_thread=count_thread,
            record_block=record_block, param_rules=param_rules,
            param_keys=param_keys, param_gen=param_gen,
            cluster_fallback=cluster_fallback, at_ms=at_ms).result()

    def decide_raw_nowait(self, rows, origin_ids, origin_rows, context_ids,
                          chain_rows, acquire, is_in, prioritized, *,
                          valid=None, count_thread=None, record_block=None,
                          param_rules=None, param_keys=None,
                          param_gen: int = -1, cluster_fallback=None,
                          at_ms: Optional[int] = None,
                          trace_id: int = 0) -> PendingVerdicts:
        """:meth:`decide_raw` with the verdict readback deferred: the step
        is enqueued (state advanced in order under the lock) and the
        device→host verdict copy started; ``.result()`` materializes. The
        route is the JAX runtime's (see the module docstring).
        ``count_thread`` / ``record_block`` (False = leave the event out
        of the thread gauges / record no BLOCK for its denial) and
        ``at_ms`` (event time, re-stamped to now when a full ring stale)
        serve the host fast path. ``cluster_fallback`` (int32 per event:
        bit k = check the cluster-mode rule of slot k locally) keeps its
        events off the scalar route. ``trace_id`` threads a sampled batch's
        spans through from :meth:`entry_batch_nowait`; direct callers get
        their own sampling decision. Every dispatch lands one
        ``split_route.*`` counter."""
        n = rows.shape[0]
        obs = self.obs
        obs_on = obs.enabled
        tr = trace_id if trace_id else (obs.spans.maybe_trace()
                                        if obs_on else 0)
        t_d0 = obs.spans.now_ns() if obs_on else 0
        vfull = self._valid_full(n, valid)
        acq_uniform, no_origin_ids = self._batch_facts(acquire, origin_ids,
                                                       vfull)
        no_alt = self._no_alt(origin_rows, chain_rows)
        prio_np = np.asarray(prioritized, np.bool_)
        any_prio = bool(prio_np.any())
        now = self.clock.now_ms() if at_ms is None else at_ms
        pure_scalar = no_origin_ids and no_alt and cluster_fallback is None
        if (not pure_scalar or any_prio) and acq_uniform \
                and self._key_fits():
            # per-event scalar eligibility (prioritized events only on
            # the fast side, the one that may book; no cluster-fallback
            # bits); invalid lanes are scalar-safe
            pad_a = self.spec.alt_rows
            ev_scalar = ((np.asarray(origin_ids) == 0)
                         & (np.asarray(origin_rows) >= pad_a)
                         & (np.asarray(chain_rows) >= pad_a) & ~prio_np)
            if cluster_fallback is not None:
                ev_scalar &= np.asarray(cluster_fallback) == 0
            ev_scalar |= ~vfull
            n_general = int(np.count_nonzero(~ev_scalar & vfull))
            n_scalar = int(np.count_nonzero(ev_scalar & vfull))
            if n_general > 0 and n_scalar >= SPLIT_MIN_SCALAR:
                if obs_on:
                    obs.counters.add(obs_keys.ROUTE_SPLIT)
                    if self.mesh is not None:
                        obs.counters.add(obs_keys.ROUTE_MESHED)
                    if tr:
                        obs.spans.record(
                            tr, "decide.split_decision", t_d0,
                            obs.spans.now_ns(), n=n,
                            note=f"scalar={n_scalar} general={n_general}")
                return self._decide_split_nowait(
                    rows, origin_ids, origin_rows, context_ids, chain_rows,
                    acquire, is_in, ev_scalar, vfull, prio_np, any_prio,
                    count_thread, record_block, param_rules, param_keys,
                    param_gen, cluster_fallback, now, tr)
        route = self._route(acq_uniform, pure_scalar, any_prio)
        staged: list = []
        batch = self._entry_batch(rows, origin_ids, origin_rows, context_ids,
                                  chain_rows, acquire, is_in, prio_np,
                                  vfull, count_thread, record_block,
                                  param_rules, param_keys, cluster_fallback,
                                  staged=staged)
        times = self._time_scalars(now)
        sys_scalars = self._sys_scalars()
        with self._lock:
            # under the lock that guards reloads: stale pairs never meet
            # the new table
            if batch.param_rules is not None and param_gen != self._param_gen:
                batch = batch._replace(param_rules=None, param_keys=None)
            now, times = self._restamp_if_stale_locked(at_ms, now, times)
            self._drain_evictions_locked()
            # hot-set sketch (tiering): single dispatch updates it inside
            # this decide call; off, it is an update call of its own
            sd_sketch = self._sd_sketch_locked()
            observed = (sd_sketch is None
                        and self.tiering.observe_locked(batch.rows,
                                                        batch.valid))
            use_occ = self._note_dispatch_locked(now, any_prio)
            flags = self._flags(route, not no_alt, use_occ, any_prio)
            self._first_dispatch_locked(
                "decide" if sd_sketch is None else "decide_sd",
                (2 if no_alt else 0) + int(use_occ), route, (batch,),
                times, sys_scalars, flags, tr)
            with obs.annotate("sentinel_tpu.decide"):
                self._state, verdicts = decide_entries(
                    self.spec, self._ruleset, self._state, batch, times,
                    sys_scalars, **flags)
                if sd_sketch is not None:
                    self.tiering.set_sketch_locked(sk_mod.update_sketch(
                        sd_sketch, batch.rows, batch.valid)[0])
            routed = "fast_occupy" if route == "fast" and use_occ else route
            self.routes[routed] += 1
            t_disp = self._obs_dispatched(
                tr, t_d0, n, "decide.dispatch", _ROUTE_KEYS[routed],
                dispatches=2 if observed else 1,
                single=sd_sketch is not None,
                note=_ROUTE_KEYS[routed].split(".", 1)[1])
            return self._pending(
                [(verdicts, None)], n, staged=staged,
                brk=self._breaker_snapshot_locked(),
                on_read=(self._obs_settled(tr, t_disp, n, "decide.device",
                                           prio_np if any_prio else None)
                         if obs_on else None))

    def _renew_programs_locked(self) -> None:
        """A new step generation for the program keys, wherever the
        reference rebuilds its jitted steps: shared by geometry without
        device slots (its steps are cached per ``EngineSpec``), fresh
        with them (its slot steps are built anew)."""
        self._program_gen = (self.spec if not self._device_slots
                             else next(self._program_gens))

    def _program_statics(self, route: str) -> dict:
        """The step flags the reference specializes a jitted step on for
        ``route`` (the statics of its program key)."""
        st = {"skip_auth": self._skip_auth, "skip_sys": self._skip_sys,
              "skip_threads": self._skip_threads}
        if self._sortfree:
            st["sortfree"] = True
        if route in ("scalar", "fast"):
            st[route + "_flow"] = True
            st["scalar_has_rl"] = self._scalar_has_rl
        return st

    def _first_dispatch_locked(self, kind: str, variant: int, route: str,
                               batches, times, sys_scalars, flags,
                               trace_id: int) -> None:
        """First-dispatch accounting of one step (the reference's
        ``_warm_first_fetch_key_locked``): ``compile_cache.hit`` /
        ``.miss`` count first against repeat dispatches of its program
        key — ``kind``, the step generation and ``variant`` (the
        reference's ``(2 if no alt rows) + (1 if occupy-aware)`` step
        index), the padded geometry of ``batches`` and the route's
        statics. With ``SENTINEL_FIRST_LOAD_TIMEOUT_S`` set, a key's first
        dispatch is preceded by a throwaway execution of the same step
        (fresh state, all-invalid copies of ``batches``) under
        :func:`~sentinel_tpu_torch.core.compile_cache.guarded_first_fetch`,
        each retry counting ``compile_cache.first_fetch_retry`` and a
        traced batch recording a ``decide.first_fetch`` span."""
        from sentinel_tpu_torch.core import compile_cache as cc
        key = cc.program_key(kind, (self._program_gen, variant),
                             tuple(int(b.rows.shape[0]) for b in batches),
                             self._program_statics(route))
        obs = self.obs
        hit = key in self._fetched_programs
        if obs.enabled:
            obs.counters.add(obs_keys.CACHE_HIT if hit
                             else obs_keys.CACHE_MISS)
        if hit:
            return
        timeout_s, retries = cc.first_fetch_policy()
        if timeout_s > 0:
            def attempt():
                state = init_state(self.spec, self.cfg.max_flow_rules,
                                   self.cfg.max_degrade_rules,
                                   device=self.device)
                state = state._replace(custom=self._custom_init_states())
                if self.mesh is not None:
                    # the throwaway runs on row blocks like the real step
                    state = local_shard.pin_state(
                        state, self._mesh_shardings[0])
                warm = [b._replace(valid=torch.zeros_like(b.valid))
                        for b in batches]
                step = (decide_entries if len(warm) == 1
                        else decide_and_record_exits)
                out = step(self.spec, self._ruleset, state, *warm, times,
                           sys_scalars, **flags)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                return out

            t0 = obs.spans.now_ns() if trace_id else 0
            cc.guarded_first_fetch(
                attempt, f"{kind} step (B={key[2]})", timeout_s, retries,
                on_retry=((lambda: obs.counters.add(obs_keys.CACHE_RETRY))
                          if obs.enabled else None))
            if trace_id:
                obs.spans.record(trace_id, "decide.first_fetch", t0,
                                 obs.spans.now_ns(), n=key[2][0])
        self._fetched_programs.add(key)

    def _sd_sketch_locked(self):
        """The sketch a single-dispatch decide call updates itself, or
        None (single dispatch off, or no sketch): then the caller takes
        the standalone ``tiering.observe_locked`` update."""
        if not self._single_dispatch:
            return None
        return self.tiering.sketch_for_fuse_locked()

    def _obs_dispatched(self, tr: int, t_d0: int, n: int, span: str,
                        route_key: Optional[str], dispatches: int = 1,
                        single: bool = False, note: str = "") -> int:
        """The counters and span of a dispatch just enqueued → its end
        time (0 with obs off): the route's counter (``route_key``), the
        sort-free one beside it, ``dispatches`` device steps (a standalone
        sketch update counts as one), and ``split_route.single_dispatch``
        when the call updated the sketch itself (``single``)."""
        obs = self.obs
        if not obs.enabled:
            return 0
        if route_key is not None:
            obs.counters.add(route_key)
        if self._sortfree:
            obs.counters.add(obs_keys.ROUTE_SORTFREE)
        if route_key is not None and self.mesh is not None:
            # a decide or a fused dispatch on row blocks (a split counts
            # at its decision)
            obs.counters.add(obs_keys.ROUTE_MESHED)
        obs.counters.add(obs_keys.PIPE_DISPATCH, dispatches)
        if single:
            obs.counters.add(obs_keys.ROUTE_SINGLE_DISPATCH)
        t_disp = obs.spans.now_ns()
        if tr:
            obs.spans.record(tr, span, t_d0, t_disp, n=n, note=note)
        return t_disp

    def _obs_settled(self, tr: int, t_disp: int, n: int, span: str,
                     prio_mask):
        """→ ``on_read(verdicts, overflow)`` for :meth:`_pending`: the
        dispatch→verdict histogram, the device span, the claim overflow
        and the occupy grants (prioritized events admitted with a wait;
        ``prio_mask`` is None when the batch had none)."""
        obs = self.obs

        def on_read(out: Verdicts, overflow: int) -> None:
            t_end = obs.spans.now_ns()
            obs.hist_dispatch.record(t_end - t_disp)
            if tr:
                obs.spans.record(tr, span, t_disp, t_end, n=n)
            if overflow:
                obs.counters.add(obs_keys.SORTFREE_OVERFLOW, overflow)
            if prio_mask is not None:
                granted = int(np.count_nonzero(
                    out.allow & (out.wait_ms > 0) & prio_mask[:n]))
                if granted:
                    obs.counters.add(obs_keys.OCCUPY_GRANTED, granted)

        return on_read

    def _decide_split_nowait(self, rows, origin_ids, origin_rows,
                             context_ids, chain_rows, acquire, is_in,
                             ev_scalar, vfull, prio_np, any_prio,
                             count_thread, record_block, param_rules,
                             param_keys, param_gen, cluster_fallback,
                             now: int, trace_id: int = 0) -> PendingVerdicts:
        """Mixed batch: the scalar-eligible events take the scalar step,
        the others (prioritized ones included) the fast step, scalar
        first, under one lock hold (a legitimate serialization of the
        batch: each sub-step is exact over its own events, as the JAX
        package's split dispatch). While occupy is live both take their
        occupy-aware steps: the scalar side reads bookings, the fast side
        may book."""
        n = rows.shape[0]
        obs = self.obs
        tr = trace_id
        t_d0 = obs.spans.now_ns() if obs.enabled else 0
        idx_s = np.nonzero(ev_scalar)[0]
        idx_g = np.nonzero(~ev_scalar)[0]
        staged: list = []

        def batch_of(idx, prio):
            cols = [np.asarray(a)[idx] for a in (
                rows, origin_ids, origin_rows, context_ids, chain_rows,
                acquire, is_in)]
            opt = [None if a is None else np.asarray(a)[idx]
                   for a in (count_thread, record_block, param_rules,
                             param_keys, cluster_fallback)]
            return self._entry_batch(*cols, prio, vfull[idx], *opt,
                                     staged=staged)

        prio_g = prio_np[idx_g]
        bs = batch_of(idx_s, np.zeros(idx_s.shape[0], np.bool_))
        bg = batch_of(idx_g, prio_g)
        no_alt_g = self._no_alt(np.asarray(origin_rows)[idx_g],
                                np.asarray(chain_rows)[idx_g])
        times = self._time_scalars(now)
        sys_scalars = self._sys_scalars()
        with self._lock:
            if bs.param_rules is not None and param_gen != self._param_gen:
                bs = bs._replace(param_rules=None, param_keys=None)
                bg = bg._replace(param_rules=None, param_keys=None)
            self._drain_evictions_locked()
            # hot-set sketch: both halves carry traffic rows; with single
            # dispatch each half's call updates it (scalar half first)
            sd_sketch = self._sd_sketch_locked()
            observed = 0
            if sd_sketch is None:
                observed += int(self.tiering.observe_locked(bs.rows,
                                                            bs.valid))
                observed += int(self.tiering.observe_locked(bg.rows,
                                                            bg.valid))
            use_occ = self._note_dispatch_locked(now, any_prio)
            fl_s = self._flags("scalar", False, use_occ)
            fl_g = self._flags("fast", not no_alt_g, use_occ,
                               bool(prio_g.any()))
            kind = "decide" if sd_sketch is None else "decide_sd"
            self._first_dispatch_locked(kind, 2 + int(use_occ), "scalar",
                                        (bs,), times, sys_scalars, fl_s, tr)
            self._first_dispatch_locked(
                kind, (2 if no_alt_g else 0) + int(use_occ), "fast", (bg,),
                times, sys_scalars, fl_g, tr)
            with obs.annotate("sentinel_tpu.decide_split"):
                state, v1 = decide_entries(
                    self.spec, self._ruleset, self._state, bs, times,
                    sys_scalars, **fl_s)
                self._state, v2 = decide_entries(
                    self.spec, self._ruleset, state, bg, times, sys_scalars,
                    **fl_g)
                if sd_sketch is not None:
                    sk1, _ = sk_mod.update_sketch(sd_sketch, bs.rows,
                                                  bs.valid)
                    self.tiering.set_sketch_locked(sk_mod.update_sketch(
                        sk1, bg.rows, bg.valid)[0])
            self.routes["split"] += 1
            # two calls plus any standalone sketch updates; a split never
            # counts split_route.single_dispatch (it is two calls)
            t_disp = self._obs_dispatched(
                tr, t_d0, n, "split.dispatch", None,
                dispatches=2 + observed,
                note=f"scalar={idx_s.shape[0]} general={idx_g.shape[0]} "
                     f"occ={int(use_occ)}")
            prio_mask = None
            if any_prio:
                prio_mask = np.zeros(n, np.bool_)
                prio_mask[idx_g] = prio_g
            return self._pending(
                [(v1, idx_s), (v2, idx_g)], n, staged=staged,
                brk=self._breaker_snapshot_locked(),
                on_read=(self._obs_settled(tr, t_disp, n, "split.device",
                                           prio_mask)
                         if obs.enabled else None))

    def decide_and_exit_raw_nowait(
            self, rows, origin_ids, origin_rows, context_ids, chain_rows,
            acquire, is_in, prioritized, *, exit_rows,
            exit_origin_rows=None, exit_chain_rows=None, exit_acquire=None,
            exit_rt_ms=None, exit_error=None, exit_is_in=None,
            exit_valid=None, valid=None, at_ms: Optional[int] = None,
            trace_id: int = 0) -> PendingVerdicts:
        """Fused decide+exit: this step's entry decisions and the previous
        step's completions in one engine step (exits land after decides,
        identical to the decide-then-exit pair). Exit columns default to
        padding-free trivia (no origins, acquire=1, rt=0, no errors). The
        whole batch takes one route (no split); the alt records run when
        either half carries an origin or chain row."""
        n = rows.shape[0]
        n_x = exit_rows.shape[0]
        obs = self.obs
        obs_on = obs.enabled
        tr = trace_id if trace_id else (obs.spans.maybe_trace()
                                        if obs_on else 0)
        t_d0 = obs.spans.now_ns() if obs_on else 0
        ra = self.spec.alt_rows
        vfull = self._valid_full(n, valid)
        acq_uniform, no_origin_ids = self._batch_facts(acquire, origin_ids,
                                                       vfull)
        prio_np = np.asarray(prioritized, np.bool_)
        any_prio = bool(prio_np.any())
        now = self.clock.now_ms() if at_ms is None else at_ms
        x_orows = (exit_origin_rows if exit_origin_rows is not None
                   else np.full(n_x, ra, np.int32))
        x_crows = (exit_chain_rows if exit_chain_rows is not None
                   else np.full(n_x, ra, np.int32))
        no_alt = (self._no_alt(origin_rows, chain_rows)
                  and self._no_alt(x_orows, x_crows))
        route = self._route(acq_uniform, no_origin_ids and no_alt, any_prio)
        staged: list = []
        batch = self._entry_batch(rows, origin_ids, origin_rows, context_ids,
                                  chain_rows, acquire, is_in, prio_np,
                                  vfull, staged=staged)
        xbatch = self._exit_batch(
            exit_rows, x_orows, x_crows,
            exit_acquire if exit_acquire is not None
            else np.ones(n_x, np.int32),
            exit_rt_ms if exit_rt_ms is not None else np.zeros(n_x, np.int32),
            exit_error if exit_error is not None
            else np.zeros(n_x, np.bool_),
            exit_is_in if exit_is_in is not None
            else np.ones(n_x, np.bool_),
            exit_valid if exit_valid is not None
            else np.ones(n_x, np.bool_))
        times = self._time_scalars(now)
        sys_scalars = self._sys_scalars()
        with self._lock:
            now, times = self._restamp_if_stale_locked(at_ms, now, times)
            self._drain_evictions_locked()
            # single dispatch: the sketch update and any due telemetry /
            # tiering tick ride this call (see _fused_epilogue_locked)
            sd_sketch = self._sd_sketch_locked()
            observed = (sd_sketch is None
                        and self.tiering.observe_locked(batch.rows,
                                                        batch.valid))
            use_occ = self._note_dispatch_locked(now, any_prio)
            flags = self._flags(route, not no_alt, use_occ, any_prio)
            # the carries due on this call are claimed before it, as the
            # reference claims them for its epilogue program
            tel_prep = tier_due = None
            kind = "fused"
            if sd_sketch is not None:
                tel_prep = self.telemetry.carry_due_locked(now)
                tier_due = self.tiering.carry_due_locked(now)
                kind = ("fused_sd_epi" if tel_prep is not None or tier_due
                        else "fused_sd")
            self._first_dispatch_locked(
                kind, (2 if no_alt else 0) + int(use_occ), route,
                (batch, xbatch), times, sys_scalars, flags, tr)
            with obs.annotate("sentinel_tpu.fused"):
                self._state, verdicts = decide_and_record_exits(
                    self.spec, self._ruleset, self._state, batch, xbatch,
                    times, sys_scalars, **flags)
                if sd_sketch is not None:
                    self._fused_epilogue_locked(sd_sketch, batch, tel_prep,
                                                tier_due)
            self.routes["fused"] += 1
            routed = "fast_occupy" if route == "fast" and use_occ else route
            t_disp = self._obs_dispatched(
                tr, t_d0, n, "fused.dispatch", obs_keys.ROUTE_FUSED,
                dispatches=2 if observed else 1,
                single=sd_sketch is not None,
                note=f"{_ROUTE_KEYS[routed].split('.', 1)[1]} exits={n_x}")
            return self._pending(
                [(verdicts, None)], n, staged=staged,
                brk=self._breaker_snapshot_locked(),
                on_read=(self._obs_settled(tr, t_disp, n, "fused.device",
                                           prio_np if any_prio else None)
                         if obs_on else None))

    def _fused_epilogue_locked(self, sketch, batch: EntryBatch, tel_prep,
                               tier_due: bool) -> None:
        """The single-dispatch tail of a fused decide+exit call, in the
        reference's order: the sketch update over the batch's rows, then
        — when a carry cadence claimed this call's slot (``tel_prep``,
        ``tier_due``) — the telemetry tick over the post-step windows and
        the sketch decay + estimate of every row, their readbacks queued
        with the services. Which parts run is known on the host (the
        claims), so each is a Python branch."""
        tel = self.telemetry
        sketch, _overflow = sk_mod.update_sketch(sketch, batch.rows,
                                                 batch.valid)
        if tel_prep is not None or tier_due:
            ring = tel.ring_for_fuse_locked()
            if tel_prep is not None:
                _now, _sec, append, idx_s, sec_idx_m = tel_prep
                st, spec = self._state, self.spec
                outs, ring = telemetry_tick(
                    spec.second, spec.minute, tel.k, st.second, st.minute,
                    st.rt_hist, ring, idx_s, sec_idx_m, append)
                tel.queue_carry(tel_prep, outs, ring)
            else:
                tel.set_ring_locked(ring)
            if tier_due:
                sketch, est = sk_mod.tick_read(sketch, self.spec.rows)
                self.tiering.queue_estimates(est)
        self.tiering.set_sketch_locked(sketch)

    def exit_batch(self, *, rows, origin_rows, chain_rows, acquire, rt_ms,
                   error, is_in, param_rules=None, param_keys=None,
                   param_gen: int = -1, count_thread=None,
                   at_ms: Optional[int] = None) -> None:
        """Record a batch of completions (``StatisticSlot.exit`` +
        ``DegradeSlot.exit``), on the origin and chain rows too where the
        batch has any. ``param_rules``/``param_keys`` are the entries'
        pairs (resolved at generation ``param_gen``): their THREAD-grade
        keys are decremented and then unpinned — unless a reload came in
        between, when neither happens (the pins lived on the discarded
        registry). ``count_thread`` False leaves an exit out of the
        thread gauges; ``at_ms`` is its event time (see
        :meth:`decide_raw_nowait`). With breaker observers registered the
        call reads the breaker states back (one small read), so an arc an
        exit causes fires within it."""
        n = rows.shape[0]
        obs = self.obs
        tr = obs.spans.maybe_trace() if obs.enabled else 0
        t0 = obs.spans.now_ns() if tr else 0
        batch = self._exit_batch(rows, origin_rows, chain_rows, acquire,
                                 rt_ms, error, is_in, np.ones(n, np.bool_),
                                 count_thread, param_rules, param_keys)
        now = self.clock.now_ms() if at_ms is None else at_ms
        times = self._time_scalars(now)
        unpin = None
        brk = None
        with self._lock:
            now, times = self._restamp_if_stale_locked(at_ms, now, times)
            if self.tiering.enabled:
                # a key demoted between entry and exit promotes back
                # before this decrement (else it lands on a recycled or
                # invalidated row); tiering off keeps the no-drain exit
                self._drain_evictions_locked()
            self._seen_idx = max(self._seen_idx,
                                 self.spec.second.index_of(now))
            if batch.param_rules is not None:
                if param_gen != self._param_gen:
                    batch = batch._replace(param_rules=None, param_keys=None)
                else:
                    unpin = (self.param_key_registry,
                             pf_mod.thread_key_rows(self._param, param_rules,
                                                    param_keys))
            with obs.annotate("sentinel_tpu.exit"):
                self._state = record_exits(
                    self.spec, self._ruleset, self._state, batch, times,
                    record_alt=not self._no_alt(origin_rows, chain_rows),
                    skip_threads=self._skip_threads)
            if self._breaker_observers:
                self._breaker_seq += 1
                brk = (self._breaker_seq, self._deg.rules,
                       self._state.breakers.state[:-1].tolist())
        # unpin only after the decrement is enqueued
        if unpin is not None:
            unpin[0].unpin_rows(unpin[1])
        if obs.enabled:
            obs.counters.add(obs_keys.PIPE_DISPATCH)
        if tr:
            obs.spans.record(tr, "exit.dispatch", t0, obs.spans.now_ns(),
                             n=n)
        if brk is not None:
            self._diff_and_fire_breakers(*brk)

    # ------------------------------------------------------------------
    # Live window geometry, switches and lifecycle
    # ------------------------------------------------------------------

    def update_window_geometry(self, sample_count: Optional[int] = None,
                               interval_ms: Optional[int] = None) -> None:
        """Live second-window geometry change (the reference's
        ``SampleCountProperty``/``IntervalProperty``: fresh windows for
        every node). The second windows and the flow shaping state
        cold-reset at the new geometry; the minute ring, the gauges, the
        breakers and the param state carry over; the host fast path's
        leases are dropped. No step or plan of the port is cached by
        geometry; the program keys take the new geometry's generation."""
        sc = int(sample_count if sample_count is not None
                 else self.cfg.second_sample_count)
        iv = int(interval_ms if interval_ms is not None
                 else self.cfg.second_interval_ms)
        if sc <= 0 or iv <= 0 or iv % sc:
            raise ValueError(
                "interval_ms must be a positive multiple of sample_count")
        self._flush_fast()      # land buffered stats on the OLD geometry
        with self._lock:
            if (sc == self.cfg.second_sample_count
                    and iv == self.cfg.second_interval_ms):
                return
            self.cfg = dataclasses.replace(self.cfg, second_sample_count=sc,
                                           second_interval_ms=iv)
            new_second = WindowSpec(sc, iv // sc)
            self.spec = dataclasses.replace(self.spec, second=new_second)
            dev = self.device
            self._state = self._state._replace(
                second=init_window(new_second, self.spec.rows, device=dev),
                alt_second=init_window(new_second, self.spec.alt_rows,
                                       device=dev),
                flow_dyn=flow_mod.init_flow_dyn(
                    self.cfg.max_flow_rules, new_second.buckets,
                    self.spec.rows, device=dev))
            self._refresh_shardings_locked()
            self._renew_programs_locked()
            self._occupy_live_until_ms = -1
            self._seen_idx = -(2 ** 62)
            self._fast.win_ms = max(1, new_second.win_ms)
            self._rebuild_fastpath()     # drops leases on the old buckets
            # cold entries and in-flight demote payloads hold OLD-geometry
            # windows and rings: land the in-flight ones, then cold-reset
            # every entry to the new bucket count (what resident rows got)
            self.tiering.on_geometry_changed_locked()

    def set_global_switch(self, on: bool) -> None:
        """The reference's setSwitch command: off, every call passes
        unchecked."""
        self._global_on = bool(on)

    @property
    def threads_elided(self) -> bool:
        """True while the thread gauges are not maintained (no loaded
        rule reads live concurrency): gauges read 0 whatever the
        traffic."""
        return bool(self._skip_threads)

    def register_shutdown(self, service) -> None:
        """Register a service for :meth:`close` — anything with a
        ``stop()`` or ``close()`` method (``MetricTimerListener``
        registers itself). Stopped LIFO, each at most once."""
        if not any(service is s for s in self._shutdown_hooks):
            self._shutdown_hooks.append(service)

    def close(self) -> None:
        """Idempotent teardown: land buffered fast-path stats, stop every
        registered service (their daemon threads joined), close the
        self-telemetry and the block log (its appender's thread joined).
        The engine stays readable but should not dispatch after."""
        if self._closed:
            return
        self._closed = True
        try:
            self._flush_fast()
        except Exception:       # closing must not depend on device health
            _log.debug("fast-path flush at close failed", exc_info=True)
        hooks, self._shutdown_hooks = self._shutdown_hooks, []
        for svc in reversed(hooks):
            fn = getattr(svc, "stop", None) or getattr(svc, "close", None)
            if fn is None:
                continue
            try:
                fn()
            except Exception:   # one bad service must not leak the rest
                _log.debug("shutdown hook failed", exc_info=True)
        self.obs.close()
        self.block_log.close()

    def frontend(self, **kwargs):
        """A new :class:`~sentinel_tpu_torch.frontend.AdaptiveBatcher`
        ingest tier over this runtime (kwargs pass through: batch_max,
        deadline_ms, budget_ms, idle_ms, queue_max, depth,
        record_flushes). The batcher registers with
        :meth:`register_shutdown`, so :meth:`close` tears it down. One
        batcher per event loop. An unset kwarg takes its
        ``SENTINEL_FRONTEND_*`` (or ``SENTINEL_PIPELINE_DEPTH``) knob when
        that is set, else the ``SENTINEL_TUNED_CONFIG`` artifact's value
        resolved at construction, else the batcher's default (explicit
        kwarg > explicit env > artifact > default)."""
        from sentinel_tpu_torch.frontend import AdaptiveBatcher
        from sentinel_tpu_torch.tune.knobs import FRONTEND_KWARG_ENVS
        for kw, env in FRONTEND_KWARG_ENVS:
            if kw not in kwargs and env in self._tuned:
                kwargs[kw] = self._tuned[env]
        return AdaptiveBatcher(self, **kwargs)

    def __enter__(self) -> "Sentinel":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def metrics_snapshot(self, time_ms: int) -> list:
        """Per-resource :class:`~sentinel_tpu_torch.metrics.node.MetricNode`
        list for the completed second containing ``time_ms`` (the
        ``MetricTimerListener`` pull; the ENTRY row as the inbound total).
        Needs the minute ring; [] without it. One masked read of the
        second's bucket ``[R, E]`` and one copy to the host."""
        if self.spec.minute is None:
            return []
        self._refuse_remote_rows("metrics_snapshot")
        self._flush_fast()      # buffered fast-path stats land first
        idx = self.spec.minute.index_of(time_ms)
        with self._lock:
            counters, rt = bucket_snapshot(self.spec.minute,
                                           self._state.minute, idx)
            copy = start_host_read(
                (counters, rt, self._state.threads.clone()))
            items = self.resources.items()
            rtypes = dict(self.resource_types)
        counters, rt, threads = wait_host_read(copy)
        sec_ms = (time_ms // 1000) * 1000
        nodes = []
        for name, row in items:
            c = counters[row]
            if not (c[ev.PASS] or c[ev.BLOCK] or c[ev.SUCCESS]
                    or c[ev.EXCEPTION] or c[ev.OCCUPIED_PASS]):
                continue
            succ = int(c[ev.SUCCESS])
            nodes.append(MetricNode(
                timestamp=sec_ms,
                resource=(TOTAL_IN_RESOURCE_NAME if row == ENTRY_NODE_ROW
                          else name),
                pass_qps=int(c[ev.PASS]), block_qps=int(c[ev.BLOCK]),
                success_qps=succ, exception_qps=int(c[ev.EXCEPTION]),
                rt=int(rt[row] / succ) if succ else 0,
                occupied_pass_qps=int(c[ev.OCCUPIED_PASS]),
                concurrency=int(threads[row]),
                classification=rtypes.get(name, 0)))
        nodes.sort(key=lambda n: n.resource)
        return nodes

    def node_totals(self, resource: str) -> dict:
        """Current rolling-second totals for a resource (ClusterNode view):
        pass, block, success, exception, threads."""
        row = self.resources.lookup(resource)
        if row is None:
            return {}
        t = self.node_totals_by_row(row)
        t.pop("avg_rt", None)
        return t

    def _totals_snapshot(self, rows: Optional[List[int]] = None):
        """Rolling-second (counters[n, E], rt[n], threads[n]) of ``rows``
        (all rows when None), one device read."""
        self._refuse_remote_rows("a node totals read")
        self._flush_fast()      # buffered fast-path stats land first
        idx_s = self.spec.second.index_of(self.clock.now_ms())
        with self._lock:
            w = self._state.second
            threads = self._state.threads
            if rows is not None:
                sel = torch.as_tensor(rows, dtype=torch.long,
                                      device=self.device)
                w = w._replace(counters=w.counters[sel],
                               stamps=w.stamps[sel], rt_sum=w.rt_sum[sel],
                               min_rt=w.min_rt[sel])
                threads = threads[sel]
            # one wait for all three copies, off the engine lock
            copy = start_host_read((
                rolling_totals(self.spec.second, w, idx_s),
                rt_totals(self.spec.second, w, idx_s), threads.clone()))
        tot, rt, threads = wait_host_read(copy)
        return tot, rt, threads

    @staticmethod
    def _totals_dict(tot_row, rt_row: float, threads_row: int) -> dict:
        succ = int(tot_row[ev.SUCCESS])
        return {
            "pass": int(tot_row[ev.PASS]), "block": int(tot_row[ev.BLOCK]),
            "success": succ, "exception": int(tot_row[ev.EXCEPTION]),
            "threads": int(threads_row),
            "avg_rt": (float(rt_row) / succ) if succ else 0.0,
        }

    def node_totals_by_row(self, row: int) -> dict:
        tot, rt, threads = self._totals_snapshot([row])
        return self._totals_dict(tot[0], rt[0], threads[0])

    def all_node_totals(self) -> List[Tuple[str, int, dict]]:
        """(name, row, totals) for every registered resource — one device
        read whatever the resource count."""
        items = self.resources.items()
        tot, rt, threads = self._totals_snapshot()
        return [(name, row,
                 self._totals_dict(tot[row], rt[row], threads[row]))
                for name, row in items]

    def origin_totals(self, resource: str) -> List[dict]:
        """Per-origin rolling-second stats of one resource (the ``origin``
        command). Origins are hashed alt rows, so attribution is per
        (resource × origin) hash cell; collisions merge."""
        row = self.resources.lookup(resource)
        if row is None:
            return []
        self._refuse_remote_rows("origin_totals")
        self._flush_fast()      # buffered fast-path stats land first
        idx_s = self.spec.second.index_of(self.clock.now_ms())
        with self._lock:
            touched = set(self._alt_rows_by_row.get(row, ()))
            origins = self.origins.items()
            copy = start_host_read((
                rolling_totals(self.spec.second, self._state.alt_second,
                               idx_s), self._state.alt_threads.clone()))
        tot, threads = wait_host_read(copy)
        out = []
        for name, oid in origins:
            if not name:
                continue
            r = _alt_hash(row, 0, oid, self.spec.alt_rows)
            if r not in touched:
                continue
            t = tot[r]
            out.append({
                "origin": name, "passQps": int(t[ev.PASS]),
                "blockQps": int(t[ev.BLOCK]),
                "successQps": int(t[ev.SUCCESS]),
                "exceptionQps": int(t[ev.EXCEPTION]),
                "threadNum": int(threads[r]),
            })
        return out

    def system_status(self) -> dict:
        """The ``systemStatus`` command payload (SystemStatusListener)."""
        load, cpu = self._cpu.sample()
        entry = self.node_totals_by_row(ENTRY_NODE_ROW)
        return {
            "rqps": entry.get("pass", 0), "qps": entry.get("pass", 0),
            "thread": entry.get("threads", 0), "rt": entry.get("avg_rt", 0),
            "load": load, "cpuUsage": cpu,
        }

    def get_flow_rules(self) -> List[flow_mod.FlowRule]:
        return list(self._flow.rules)

    def get_degrade_rules(self) -> List[deg_mod.DegradeRule]:
        return list(self._deg.rules)

    def get_authority_rules(self) -> List[auth_mod.AuthorityRule]:
        return list(self._auth.rules)

    def get_system_rules(self) -> List[sys_mod.SystemRule]:
        return list(self._sys_rules)

    def get_param_flow_rules(self) -> List[pf_mod.ParamFlowRule]:
        return list(self._user_param_rules)

    # ------------------------------------------------------------------
    # Circuit breakers: states, observers, forcing
    # ------------------------------------------------------------------

    def breaker_states(self) -> List[int]:
        with self._lock:
            return self._state.breakers.state[:-1].tolist()

    def breaker_resources(self) -> List[Tuple[str, int]]:
        """(resource, state) per loaded degrade rule, rule-slot order;
        rules and states read under one lock."""
        with self._lock:
            states = self._state.breakers.state[:-1].tolist()
            rules = list(self._deg.rules)
        return [(r.resource, states[j]) for j, r in enumerate(rules)
                if j < len(states)]

    def add_breaker_observer(self, fn) -> None:
        """Register ``fn(resource, prev_state, new_state)`` for breaker
        transitions (the reference's ``EventObserverRegistry``). It fires
        on the thread that reads the verdicts of the batch that caused
        the arc (the states ride that readback); an exit batch reads them
        itself. :meth:`check_breaker_transitions` is the poll fallback,
        on the same baseline, so no transition fires twice."""
        with self._lock:
            self._breaker_observers = self._breaker_observers + [fn]

    def _diff_and_fire_breakers(self, seq: int, rules_snap: tuple,
                                states: List[int]) -> int:
        """Diff ``states`` (rule-slot order) against the shared baseline
        and notify the observers → transitions fired. A snapshot older
        (``seq``) than the last one landed is skipped: the newer diff saw
        its transitions already."""
        observers = self._breaker_observers
        to_fire = []
        with self._breaker_event_lock:
            prev = self._breaker_live
            if prev is not None and seq <= prev[0]:
                return 0
            self._breaker_live = (seq, rules_snap, states)
            # a rules reload re-pairs slots with new rules: new baseline
            if prev is None or prev[1] is not rules_snap:
                return 0
            if observers:
                for j, r in enumerate(rules_snap):
                    if j < len(prev[2]) and j < len(states) \
                            and prev[2][j] != states[j]:
                        to_fire.append((r.resource, prev[2][j], states[j],
                                        observers))
            fired = len(to_fire)
            # queued under the event lock: queue order is seq order
            self._breaker_fire_q.extend(to_fire)
        if to_fire:
            self._drain_breaker_fires()
        return fired

    def _drain_breaker_fires(self) -> None:
        """Deliver queued transitions in seq order. One thread drains at
        a time; the others (an observer that re-enters the engine among
        them) enqueue and return, and the active drainer delivers their
        items. Observers run with no lock of the engine held."""
        with self._breaker_event_lock:
            if self._breaker_firing:
                return
            self._breaker_firing = True
        try:
            while True:
                with self._breaker_event_lock:
                    if not self._breaker_fire_q:
                        # reset atomically with the empty check, or a
                        # concurrent enqueuer's items would strand
                        self._breaker_firing = False
                        return
                    res, old, new, observers = \
                        self._breaker_fire_q.popleft()
                for fn in observers:
                    try:
                        fn(res, old, new)
                    except Exception as exc:
                        record_log().warning(
                            "breaker observer failed: %r", exc)
        except BaseException:
            # an interrupt in an observer must not leave the flag stuck
            with self._breaker_event_lock:
                self._breaker_firing = False
            raise

    def check_breaker_transitions(self) -> int:
        """Poll fallback: read the breaker states now and run them through
        the shared diff → transitions seen (arcs whose verdicts nobody
        read; rule reloads reset the baseline)."""
        with self._lock:
            observers = self._breaker_observers
            if not observers:
                return 0
            self._breaker_seq += 1
            seq = self._breaker_seq
            rules_snap = self._deg.rules
            states = self._state.breakers.state[:-1].tolist()
        return self._diff_and_fire_breakers(seq, rules_snap, states)

    def force_breaker(self, resource: str, state: int) -> bool:
        """Force every degrade-rule slot on ``resource`` into ``state``
        (``STATE_CLOSED``/``STATE_OPEN``/``STATE_HALF_OPEN``), the overload
        controller's degrade actuator. A forced-OPEN slot half-opens after
        its rule's ``time_window`` (``next_retry_ms`` stamped as a trip
        would); a forced-CLOSED or HALF_OPEN one starts a fresh stat
        window. Observers see the arc. → True when the resource has a
        loaded degrade rule."""
        state = int(state)
        if state not in (deg_mod.STATE_CLOSED, deg_mod.STATE_OPEN,
                         deg_mod.STATE_HALF_OPEN):
            raise ValueError(f"invalid breaker state {state}")
        # buffered fast-path passes were admitted under the old state
        self._flush_fast()
        never = -(2 ** 30)
        with self._lock:
            slots = [j for j, r in enumerate(self._deg.rules)
                     if r.resource == resource]
            if not slots:
                return False
            idx = torch.as_tensor(slots, dtype=torch.long,
                                  device=self.device)
            st = self._state.breakers

            def set_at(col, value):
                out = col.clone()
                out[idx] = value
                return out

            if state == deg_mod.STATE_OPEN:
                now_rel = self._rel_ms(self.clock.now_ms())
                retry = set_at(st.next_retry_ms,
                               (self._deg.table.retry_timeout_ms[idx]
                                + now_rel).to(torch.int32))
            else:
                retry = set_at(st.next_retry_ms, never)
            self._state = self._state._replace(breakers=st._replace(
                state=set_at(st.state, state), next_retry_ms=retry,
                win_stamp=set_at(st.win_stamp, never),
                bad=set_at(st.bad, 0), total=set_at(st.total, 0)))
        self.check_breaker_transitions()
        return True
