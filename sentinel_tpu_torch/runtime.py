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
(:class:`~sentinel_tpu_torch.rules.param_flow.ParamKeyRegistry`) and the
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

What is not ported raises :class:`NotImplementedError` naming the ROADMAP
item that will port it — cluster mode (param rules' too), meshes — and never
quietly takes another path. A decide step reads nothing back from the
device: the verdicts (and the sort-free steps' claim overflow count) come
home through :class:`PendingVerdicts` (pinned memory, ``non_blocking``
copies, one CUDA event). A lease renewal of the host fast path reads its
one verdict back: one pre-charge serves a chunk of calls.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"`` (as
the tests do); with no CUDA device and no ``device`` given, construction
raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core.batching import pad_pow2, pad_to
from sentinel_tpu_torch.core.clock import Clock, global_clock
from sentinel_tpu_torch.core.config import SentinelConfig, load_config
from sentinel_tpu_torch.core.context import (
    DEFAULT_CONTEXT_NAME, current_context,
)
from sentinel_tpu_torch.core.errors import (
    BlockException, BlockReason, ErrorEntryFreeError, block_exception_for,
    is_block_exception,
)
from sentinel_tpu_torch.core.pending import (
    PendingResult, start_host_copy, wait_host_copy,
)
from sentinel_tpu_torch.core.registry import (
    ENTRY_NODE_ROW, OriginRegistry, Registry, ResourceRegistry,
)
from sentinel_tpu_torch.engine import fastpath as fp_mod
from sentinel_tpu_torch.engine import slots as slots_mod
from sentinel_tpu_torch.engine.pipeline import (
    EngineSpec, EntryBatch, ExitBatch, RuleSet, Verdicts,
    decide_and_record_exits, decide_entries, init_state,
    invalidate_resource_rows, record_blocks, record_exits, uncount_reserved,
)
from sentinel_tpu_torch.obs.resource_hist import engine_hist_buckets
from sentinel_tpu_torch.rules import authority as auth_mod
from sentinel_tpu_torch.rules import degrade as deg_mod
from sentinel_tpu_torch.rules import flow as flow_mod
from sentinel_tpu_torch.rules import param_flow as pf_mod
from sentinel_tpu_torch.rules import system as sys_mod
from sentinel_tpu_torch.stats import events as ev
from sentinel_tpu_torch.stats.window import (
    MINUTE_SPEC, WindowSpec, rolling_totals, settle_occupied,
)

ENTRY_TYPE_OUT = 0
ENTRY_TYPE_IN = 1

# what the port rejects, and where ROADMAP.md queues it
_NOT_PORTED = {
    "cluster": "cluster-mode flow and param rules are not ported yet: "
               "ROADMAP A12",
    "mesh": "meshes (row-sharded multi-GPU engines) are not ported yet: "
            "ROADMAP A11",
}


#: a mixed batch splits when it has at least this many scalar events
SPLIT_MIN_SCALAR = 4096

_H1 = 0x9E3779B1
_H2 = 0x85EBCA6B
_MASK = 0xFFFFFFFF


def _alt_hash(row: int, kind: int, key_id: int, ra: int) -> int:
    """Stable (resource row, origin (kind 0) / context (kind 1) id) →
    alt-table row: the JAX package's hash, so both packages share rows."""
    h = ((row * _H1) ^ ((key_id * 2 + kind) * _H2)) & _MASK
    return h % ra


def sortfree_enabled() -> bool:
    """``SENTINEL_SORTFREE``: the fast and general paths group segments
    through the claim cascade (ops/sortfree.py). On unless the variable
    says ``0``/``off``/``false``/``disable``/``disabled``."""
    v = os.environ.get("SENTINEL_SORTFREE", "")
    return not v or v.lower() not in ("0", "off", "false", "disable",
                                      "disabled")


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


class PendingVerdicts(PendingResult):
    """Handle for an in-flight batch decide: ``result()`` waits for the
    verdict copies (one CUDA event) and returns numpy
    :class:`~sentinel_tpu_torch.engine.pipeline.Verdicts`."""

    __slots__ = ()


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
        self.device = resolve_device(device)
        self.cfg = cfg = config or load_config()
        if mesh is not None:
            raise NotImplementedError(_NOT_PORTED["mesh"])
        self.clock = clock or global_clock()

        self.resources = ResourceRegistry(cfg.max_resources)
        self.origins = OriginRegistry(cfg.max_origins)
        self.contexts = Registry(2048, reserved=(DEFAULT_CONTEXT_NAME,))
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
        self.param_key_registry = pf_mod.ParamKeyRegistry(
            cfg.param_table_slots)
        self._user_param_rules: List[pf_mod.ParamFlowRule] = []
        self._gateway_param_rules: List[pf_mod.ParamFlowRule] = []
        # bumped at every param-rule reload: pairs resolved against an
        # older (table, registry) carry their generation and are dropped
        self._param_gen = 0
        self._host_gates: Tuple[slots_mod.HostGate, ...] = ()
        self._device_slots: Tuple[slots_mod.DeviceSlot, ...] = ()
        # process epoch: wraparound-safe int32 relative time base
        self.epoch_ms = self.clock.now_ms()
        self._lock = threading.RLock()
        self._state = init_state(self.spec, cfg.max_flow_rules,
                                 cfg.max_degrade_rules, device=self.device)
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
        self._sortfree = sortfree_enabled()
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
        if any(r.cluster_mode for r in rules if r.is_valid()):
            raise NotImplementedError(_NOT_PORTED["cluster"])
        # buffered fast-path passes were admitted under the OLD tables:
        # land them before the swap, or the flush would re-decide them
        self._flush_fast()
        compiled = self._compile_flow(rules)
        with self._lock:
            self._flow = compiled
            self._ruleset = self._build_ruleset()
            # fresh shaping state for the new tables (the reference
            # rebuilds its raters); occupy bookings are row-keyed promises
            # already granted, so they survive: landed ones settle into
            # the second window as PASS, pending ones carry into the ring
            old = self._state.flow_dyn
            _, pend_cnt, pend_win = settle_occupied(
                self.spec.second, self._state.second, old.occupied_count,
                old.occupied_window,
                self.spec.second.index_of(self.clock.now_ms()), ev.PASS)
            fresh = flow_mod.init_flow_dyn(
                self.cfg.max_flow_rules, self.spec.second.buckets,
                self.spec.rows, device=self.device)
            self._state = self._state._replace(flow_dyn=fresh._replace(
                occupied_count=pend_cnt, occupied_window=pend_win))
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

    def load_degrade_rules(self, rules: Sequence[deg_mod.DegradeRule]) -> None:
        self._flush_fast()          # see load_flow_rules
        compiled = self._compile_degrade(rules)
        with self._lock:
            self._deg = compiled
            self._ruleset = self._build_ruleset()
            self._state = self._state._replace(
                breakers=deg_mod.init_breaker_state(
                    self.cfg.max_degrade_rules, device=self.device))
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
        unpin), fresh key state and its rule pins."""
        all_rules = ((self._user_param_rules if user is None else user)
                     + (self._gateway_param_rules if gateway is None
                        else gateway))
        if any(r.cluster_mode for r in all_rules if r.is_valid()):
            raise NotImplementedError(_NOT_PORTED["cluster"])
        self._flush_fast()          # see load_flow_rules
        compiled = self._compile_param(all_rules)
        with self._lock:
            if user is not None:
                self._user_param_rules = user
            if gateway is not None:
                self._gateway_param_rules = gateway
            self._param = compiled
            self._ruleset = self._build_ruleset()
            # rule slots changed meaning: fresh interning, cold key state
            self.param_key_registry = pf_mod.ParamKeyRegistry(
                self.cfg.param_table_slots)
            self._param_gen += 1
            self._state = self._state._replace(
                param_dyn=pf_mod.init_param_dyn(self.spec.param_keys,
                                                device=self.device))
            self._rebuild_fastpath()
            self._update_rule_pins_locked(
                "param", {r.resource for r in compiled.rules}, set(), set())

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

    def _reset_custom_states_locked(self) -> None:
        """Every registered device slot's initial state, on the engine's
        device (a (un)registration resets them all, as the reference's
        re-jit does)."""
        def place(x):
            if isinstance(x, tuple):
                return tuple(place(v) for v in x)
            return torch.as_tensor(x).to(self.device)
        self._state = self._state._replace(custom=tuple(
            place(s.init_state(self.spec)) for s in self._device_slots))

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
            return (self._host_gates[i].name if i < len(self._host_gates)
                    else "unknown-slot")
        i = code - int(BlockReason.CUSTOM_BASE)
        return (self._device_slots[i].name if i < len(self._device_slots)
                else "unknown-slot")

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
        for gi, gate in enumerate(self._host_gates):
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
        """→ (blocked bool[n], reasons int32[n]); the caller records the
        denials on the device in one batch."""
        blocked = np.zeros(n, np.bool_)
        reasons = np.zeros(n, np.int32)
        for gi, gate in enumerate(self._host_gates):
            oks = np.asarray(gate.check_batch(resources, origins, acq,
                                              args_list), np.bool_)
            newly = ~oks & ~blocked
            if newly.any():
                reasons[newly] = self._slot_code("gate", gi)
                blocked |= newly
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
        return self._log_cluster_block(reason, resource, origin, exc=exc,
                                       slot_name=slot_name)

    @staticmethod
    def _log_cluster_block(reason: int, resource: str, origin: str,
                           exc=None, slot_name: str = "") -> BlockException:
        """The exception of a denial decided off the device (``exc`` when
        the gate raised its own). The block log and the callbacks are not
        ported yet (ROADMAP A5)."""
        if exc is not None:
            return exc
        return block_exception_for(reason, resource, origin=origin,
                                   slot_name=slot_name)

    # ------------------------------------------------------------------
    # Time and device helpers
    # ------------------------------------------------------------------

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
        resource."""
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
            alt: List[int] = []
            for row in evicted:
                alt.extend(self._alt_rows_by_row.pop(row, ()))
            rows = pad_to(np.asarray(evicted, np.int32),
                          pad_pow2(len(evicted)), self.spec.rows, np.int32)
            alt_arr = pad_to(np.asarray(alt, np.int32), pad_pow2(len(alt)),
                             self.spec.alt_rows, np.int32)
            self._state = invalidate_resource_rows(
                self.spec, self._state, self._dev(rows), self._dev(alt_arr))

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
        nf1 = self._ruleset.flow_table.active.shape[0]
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

    def _route(self, acq_uniform: bool, no_origin_ids: bool,
               no_alt: bool, any_prio: bool) -> str:
        """The whole batch's route: scalar, fast or general."""
        if no_alt and no_origin_ids and acq_uniform and not any_prio:
            return "scalar"
        if acq_uniform and self._key_fits():
            return "fast"
        return "general"

    def _flags(self, route: str, record_alt: bool, use_occ: bool,
               any_prio: bool = False) -> dict:
        """The engine step's flags for ``route``; ``use_occ`` runs the
        occupy-aware step, ``any_prio`` its occupy attempt."""
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
                     param_keys=None) -> EntryBatch:
        """Pad the raw columns to a power of two and copy them over (the
        pairs padded with the NP and PK sentinels)."""
        b = pad_pow2(rows.shape[0])
        r, ra = self.spec.rows, self.spec.alt_rows
        col = self._dev
        return EntryBatch(
            rows=col(pad_to(rows, b, r, np.int32)),
            origin_ids=col(pad_to(origin_ids, b, 0, np.int32)),
            origin_rows=col(pad_to(origin_rows, b, ra, np.int32)),
            context_ids=col(pad_to(context_ids, b, 0, np.int32)),
            chain_rows=col(pad_to(chain_rows, b, ra, np.int32)),
            acquire=col(pad_to(acquire, b, 0, np.int32)),
            is_in=col(pad_to(is_in, b, False, np.bool_)),
            prioritized=col(pad_to(prioritized, b, False, np.bool_)),
            valid=col(pad_to(vfull, b, False, np.bool_)),
            param_rules=self._pairs(param_rules, b, self.cfg.max_param_rules),
            param_keys=self._pairs(param_keys, b, self.spec.param_keys),
            count_thread=(None if count_thread is None else
                          col(pad_to(count_thread, b, False, np.bool_))),
            record_block=(None if record_block is None else
                          col(pad_to(record_block, b, False, np.bool_))))

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

    def _pending(self, parts, n: int) -> PendingVerdicts:
        """Start the verdict copies of one dispatch → a handle. ``parts``
        is ``[(verdicts, event indices or None for 0..n-1)]`` (a split
        dispatch has two); each part's ``sf_overflow`` rides the same
        copy and is added to ``sortfree_overflow`` at readback."""
        cols = []
        for v, idx in parts:
            m = n if idx is None else idx.shape[0]
            cols += [v.allow[:m], v.reason[:m], v.wait_ms[:m]]
        cols += [v.sf_overflow for v, _ in parts
                 if v.sf_overflow is not None]
        host, event = start_host_copy(cols)

        def _read() -> Verdicts:
            got = iter(wait_host_copy(host, event))
            out = Verdicts(allow=np.empty(n, np.bool_),
                           reason=np.empty(n, np.int8),
                           wait_ms=np.empty(n, np.int32))
            for _v, idx in parts:
                sel = slice(None) if idx is None else idx
                out.allow[sel] = next(got)
                out.reason[sel] = next(got)
                out.wait_ms[sel] = next(got)
            overflow = sum(int(x) for x in got)
            if overflow:
                with self._lock:
                    self.sortfree_overflow += overflow
            return out

        return PendingVerdicts(_read)

    # ------------------------------------------------------------------
    # Per-call API
    # ------------------------------------------------------------------

    def entry(self, resource: str, *, origin: Optional[str] = None,
              acquire: int = 1, entry_type: int = ENTRY_TYPE_IN,
              prioritized: bool = False, args: Sequence = (),
              sleep: bool = True) -> Entry:
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
        decided on the host (``Entry.fast``)."""
        ctx = current_context()
        use_origin = ctx.origin if origin is None else origin
        # rows resolved ONCE: the same rows feed the verdict and the Entry
        row = self.resources.get_or_create(resource)
        origin_id = self.origins.get_or_create(use_origin) if use_origin \
            else 0
        o_row, c_row = self._alt_rows_for(row, use_origin, ctx.name)
        context_id = (self.contexts.get_or_create(ctx.name)
                      if c_row < self.spec.alt_rows else 0)
        is_in = entry_type == ENTRY_TYPE_IN
        if self._host_gates:
            self._run_host_gates_one(resource, use_origin or "", acquire,
                                     args, row, o_row, c_row, is_in)
        if self._fast_enabled and not prioritized:
            fe = self._fast_entry(resource, row, o_row, c_row, origin_id,
                                  acquire, is_in)
            if fe is not None:
                return fe
        if self._fast_enabled and self._fast.due(self.clock.now_ms()):
            # buffered stats reach the device before this decide
            self._flush_fast()
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
                param_gen=-1 if pairs is None else pairs[2])
            if not bool(verdict.allow[0]):
                raise self._exception_for(int(verdict.reason[0]), resource,
                                          use_origin or "")
        except BaseException:
            if pairs is not None:   # a blocked entry never exits: unpin
                pairs[3].unpin_rows(pairs[4])
            raise
        wait = int(verdict.wait_ms[0])
        if wait > 0 and sleep:
            self.clock.sleep_ms(wait)
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
                    origin_id: int, acquire: int,
                    is_in: bool) -> Optional[Entry]:
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
        now = self.clock.now_ms()
        rt = max(0, now - e.create_ms)
        if e.fast is not None:
            # fast-path entries exit through the host buffer (leased ones
            # opted out of the thread gauge on entry: symmetric here)
            self._fast.buffer_exit(
                e.row, e.origin_row, e.chain_row, e.acquire,
                min(rt, self.cfg.statistic_max_rt), e.error is not None,
                e.is_in, e.fast == "free", now)
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
            args_list=None) -> PendingVerdicts:
        """Dispatch-only batch tier: the decide is enqueued and the
        verdict copy started; ``.result()`` materializes (and releases the
        param-key pins of the denied events: call it for every handle).
        ``resources`` may be names or a numpy INTEGER array of pre-interned
        rows (:meth:`intern_resources`); ``origins`` and ``contexts`` name
        each event's caller and entrance context (empty = none);
        ``args_list`` holds each event's parameters for hot-param rules —
        a 2-D numpy integer array is the fastest form (one rule per
        resource then resolves vectorized). The host gates run first; the
        events they deny are recorded in one batch and left out of the
        decide."""
        n = len(resources)
        if isinstance(resources, np.ndarray) and resources.dtype.kind in "iu":
            rows = np.ascontiguousarray(resources, np.int32)
            if self._host_gates:
                # the gates are keyed by name
                resources = [self.resources.name_of(int(r)) or ""
                             for r in rows]
        else:
            rows = np.fromiter(
                (self.resources.get_or_create(r) for r in resources),
                np.int32, count=n)
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
        # the gates run before any key is pinned: a gate that raises
        # leaks no pin
        gate_blocked = gate_reasons = None
        if self._host_gates:
            gate_blocked, gate_reasons = self._run_host_gates_batch(
                resources, origins, acq, args_list, n)
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
        valid = None
        if gate_blocked is not None:
            idxs = np.nonzero(gate_blocked)[0]
            times = self._time_scalars(self.clock.now_ms())
            with self._lock:
                self._record_blocks_locked(
                    rows[idxs], origin_rows[idxs], chain_rows[idxs],
                    acq[idxs], is_in[idxs], times)
            valid = ~gate_blocked
        pending = self.decide_raw_nowait(
            rows, origin_ids, origin_rows, context_ids, chain_rows, acq,
            is_in, prio, valid=valid, param_rules=param_rules,
            param_keys=param_keys, param_gen=gen)

        def _finalize() -> Verdicts:
            verdicts = pending.result()
            if gate_blocked is not None:
                verdicts = verdicts._replace(
                    allow=np.where(gate_blocked, False, verdicts.allow),
                    reason=np.where(gate_blocked, gate_reasons,
                                    verdicts.reason).astype(np.int8))
            if pin_arr is not None:
                # denied events never exit: release their pins now
                denied = ~np.asarray(verdicts.allow)
                if denied.any():
                    registry.unpin_rows(pin_arr[denied])
            return verdicts

        return PendingVerdicts(_finalize)

    def decide_raw(self, rows, origin_ids, origin_rows, context_ids,
                   chain_rows, acquire, is_in, prioritized, *,
                   valid=None, count_thread=None, record_block=None,
                   param_rules=None, param_keys=None, param_gen: int = -1,
                   at_ms: Optional[int] = None) -> Verdicts:
        """Lowest-level host entry point: pre-resolved numpy arrays.
        ``param_gen`` is the generation the pairs were resolved against:
        pairs of an older one (a reload came in between) are dropped."""
        return self.decide_raw_nowait(
            rows, origin_ids, origin_rows, context_ids, chain_rows, acquire,
            is_in, prioritized, valid=valid, count_thread=count_thread,
            record_block=record_block, param_rules=param_rules,
            param_keys=param_keys, param_gen=param_gen, at_ms=at_ms).result()

    def decide_raw_nowait(self, rows, origin_ids, origin_rows, context_ids,
                          chain_rows, acquire, is_in, prioritized, *,
                          valid=None, count_thread=None, record_block=None,
                          param_rules=None, param_keys=None,
                          param_gen: int = -1,
                          at_ms: Optional[int] = None) -> PendingVerdicts:
        """:meth:`decide_raw` with the verdict readback deferred: the step
        is enqueued (state advanced in order under the lock) and the
        device→host verdict copy started; ``.result()`` materializes. The
        route is the JAX runtime's (see the module docstring).
        ``count_thread`` / ``record_block`` (False = leave the event out
        of the thread gauges / record no BLOCK for its denial) and
        ``at_ms`` (event time, re-stamped to now when a full ring stale)
        serve the host fast path."""
        n = rows.shape[0]
        vfull = self._valid_full(n, valid)
        acq_uniform, no_origin_ids = self._batch_facts(acquire, origin_ids,
                                                       vfull)
        no_alt = self._no_alt(origin_rows, chain_rows)
        prio_np = np.asarray(prioritized, np.bool_)
        any_prio = bool(prio_np.any())
        now = self.clock.now_ms() if at_ms is None else at_ms
        if (not (no_origin_ids and no_alt) or any_prio) and acq_uniform \
                and self._key_fits():
            # per-event scalar eligibility (prioritized events only on
            # the fast side, the one that may book); invalid lanes are
            # scalar-safe
            pad_a = self.spec.alt_rows
            ev_scalar = (((np.asarray(origin_ids) == 0)
                          & (np.asarray(origin_rows) >= pad_a)
                          & (np.asarray(chain_rows) >= pad_a) & ~prio_np)
                         | ~vfull)
            n_general = int(np.count_nonzero(~ev_scalar & vfull))
            n_scalar = int(np.count_nonzero(ev_scalar & vfull))
            if n_general > 0 and n_scalar >= SPLIT_MIN_SCALAR:
                return self._decide_split_nowait(
                    rows, origin_ids, origin_rows, context_ids, chain_rows,
                    acquire, is_in, ev_scalar, vfull, prio_np, any_prio,
                    count_thread, record_block, param_rules, param_keys,
                    param_gen, now)
        route = self._route(acq_uniform, no_origin_ids, no_alt, any_prio)
        batch = self._entry_batch(rows, origin_ids, origin_rows, context_ids,
                                  chain_rows, acquire, is_in, prio_np,
                                  vfull, count_thread, record_block,
                                  param_rules, param_keys)
        times = self._time_scalars(now)
        sys_scalars = self._sys_scalars()
        with self._lock:
            # under the lock that guards reloads: stale pairs never meet
            # the new table
            if batch.param_rules is not None and param_gen != self._param_gen:
                batch = batch._replace(param_rules=None, param_keys=None)
            now, times = self._restamp_if_stale_locked(at_ms, now, times)
            self._drain_evictions_locked()
            use_occ = self._note_dispatch_locked(now, any_prio)
            self._state, verdicts = decide_entries(
                self.spec, self._ruleset, self._state, batch, times,
                sys_scalars, **self._flags(route, not no_alt, use_occ,
                                           any_prio))
            self.routes["fast_occupy" if route == "fast" and use_occ
                        else route] += 1
            return self._pending([(verdicts, None)], n)

    def _decide_split_nowait(self, rows, origin_ids, origin_rows,
                             context_ids, chain_rows, acquire, is_in,
                             ev_scalar, vfull, prio_np, any_prio,
                             count_thread, record_block, param_rules,
                             param_keys, param_gen,
                             now: int) -> PendingVerdicts:
        """Mixed batch: the scalar-eligible events take the scalar step,
        the others (prioritized ones included) the fast step, scalar
        first, under one lock hold (a legitimate serialization of the
        batch: each sub-step is exact over its own events, as the JAX
        package's split dispatch). While occupy is live both take their
        occupy-aware steps: the scalar side reads bookings, the fast side
        may book."""
        n = rows.shape[0]
        idx_s = np.nonzero(ev_scalar)[0]
        idx_g = np.nonzero(~ev_scalar)[0]

        def batch_of(idx, prio):
            cols = [np.asarray(a)[idx] for a in (
                rows, origin_ids, origin_rows, context_ids, chain_rows,
                acquire, is_in)]
            opt = [None if a is None else np.asarray(a)[idx]
                   for a in (count_thread, record_block, param_rules,
                             param_keys)]
            return self._entry_batch(*cols, prio, vfull[idx], *opt)

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
            use_occ = self._note_dispatch_locked(now, any_prio)
            state, v1 = decide_entries(
                self.spec, self._ruleset, self._state, bs, times,
                sys_scalars, **self._flags("scalar", False, use_occ))
            self._state, v2 = decide_entries(
                self.spec, self._ruleset, state, bg, times, sys_scalars,
                **self._flags("fast", not no_alt_g, use_occ,
                              bool(prio_g.any())))
            self.routes["split"] += 1
            return self._pending([(v1, idx_s), (v2, idx_g)], n)

    def decide_and_exit_raw_nowait(
            self, rows, origin_ids, origin_rows, context_ids, chain_rows,
            acquire, is_in, prioritized, *, exit_rows,
            exit_origin_rows=None, exit_chain_rows=None, exit_acquire=None,
            exit_rt_ms=None, exit_error=None, exit_is_in=None,
            exit_valid=None, valid=None,
            at_ms: Optional[int] = None) -> PendingVerdicts:
        """Fused decide+exit: this step's entry decisions and the previous
        step's completions in one engine step (exits land after decides,
        identical to the decide-then-exit pair). Exit columns default to
        padding-free trivia (no origins, acquire=1, rt=0, no errors). The
        whole batch takes one route (no split); the alt records run when
        either half carries an origin or chain row."""
        n = rows.shape[0]
        n_x = exit_rows.shape[0]
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
        route = self._route(acq_uniform, no_origin_ids, no_alt, any_prio)
        batch = self._entry_batch(rows, origin_ids, origin_rows, context_ids,
                                  chain_rows, acquire, is_in, prio_np,
                                  vfull)
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
            use_occ = self._note_dispatch_locked(now, any_prio)
            self._state, verdicts = decide_and_record_exits(
                self.spec, self._ruleset, self._state, batch, xbatch, times,
                sys_scalars, **self._flags(route, not no_alt, use_occ,
                                           any_prio))
            self.routes["fused"] += 1
            return self._pending([(verdicts, None)], n)

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
        :meth:`decide_raw_nowait`)."""
        n = rows.shape[0]
        batch = self._exit_batch(rows, origin_rows, chain_rows, acquire,
                                 rt_ms, error, is_in, np.ones(n, np.bool_),
                                 count_thread, param_rules, param_keys)
        now = self.clock.now_ms() if at_ms is None else at_ms
        times = self._time_scalars(now)
        unpin = None
        with self._lock:
            now, times = self._restamp_if_stale_locked(at_ms, now, times)
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
            self._state = record_exits(
                self.spec, self._ruleset, self._state, batch, times,
                record_alt=not self._no_alt(origin_rows, chain_rows),
                skip_threads=self._skip_threads)
        # unpin only after the decrement is enqueued
        if unpin is not None:
            unpin[0].unpin_rows(unpin[1])

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def node_totals(self, resource: str) -> dict:
        """Current rolling-second totals for a resource (ClusterNode view):
        pass, block, success, exception, threads."""
        row = self.resources.lookup(resource)
        if row is None:
            return {}
        self._flush_fast()      # buffered fast-path stats land first
        idx_s = self.spec.second.index_of(self.clock.now_ms())
        with self._lock:
            tot = rolling_totals(self.spec.second, self._state.second,
                                 idx_s)[row].cpu().numpy()
            threads = int(self._state.threads[row])
        return {"pass": int(tot[ev.PASS]), "block": int(tot[ev.BLOCK]),
                "success": int(tot[ev.SUCCESS]),
                "exception": int(tot[ev.EXCEPTION]), "threads": threads}
