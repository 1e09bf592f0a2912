"""Hot-parameter flow control: ParamFlowSlot / ParamFlowChecker.

Port of ``sentinel_tpu/rules/param_flow.py`` (reference semantics:
``sentinel-extension/sentinel-parameter-flow-control``):

* ``ParamFlowChecker.passDefaultLocalCheck`` — a token bucket per (rule,
  param value), refilled only once ``durationInSec`` has passed, capped at
  ``count + burstCount``; an acquire above the cap, or a zero threshold,
  blocks;
* ``passThrottleLocalCheck`` — RATE_LIMITER: a paced queue per key with
  ``costTime = round(1000 · acquire · durationInSec / count)``, the wait
  strictly under ``maxQueueingTimeMs``;
* ``passSingleValueCheck`` — THREAD grade: live concurrency per key;
* ``ParamFlowSlot.applyRealParamIdx`` — a negative ``paramIdx`` counts from
  the tail, an index past the args passes.

Param values are interned on the host into *key rows* of a fixed device
table (:class:`ParamKeyRegistry`, an LRU like the reference's
``ParameterMetric`` caches); the per-key state is five dense vectors
indexed by key row (:class:`ParamDynState`); the device check runs over
the batch's (event × pair) applications: :func:`param_check` in key-sorted
segments, :func:`param_check_scalar` with arrival ranks under a uniform
acquire. Per-item overrides live in a per-key-row ``override`` vector
written at intern time, so the device never sees a value.

Parity notes (bit for bit with the JAX package):

* ``.at[...].set(..., mode="drop")`` scatters become
  :func:`scatter_set_drop` (dropped lanes spread over spare slots past the
  end, which are sliced off) and ``.at[...].max`` becomes
  :func:`ops.segments.scatter_reduce_drop`; the token consumption of the
  scalar form and the THREAD gauges' ±1 go through the scatter-add kernel
  seam (:func:`ops.scatter_add.scatter_add`).
* float32 → int32 casts saturate as XLA's do (``rules.flow._f32_to_i32``);
  ``//`` on int32 floors; int32 arithmetic wraps alike in both libraries.
* Every float sum here adds integer-valued acquires to a per-key bucket:
  exact in any order while the bucket stays below 2^24.
* The reference's XLA build rewrites the pacing cost's ``/ 1000.0`` into a
  multiply by the float32 constant 0.001 (the reciprocal, rounded): a cost
  of exactly ``x.5`` then rounds up. The port multiplies by that constant
  (:data:`_INV_1000`), as the compiled reference does.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.ops import scatter_add as sa
from sentinel_tpu_torch.ops import segments as seg
from sentinel_tpu_torch.rules.flow import _f32_to_i32

GRADE_THREAD = 0
GRADE_QPS = 1
BEHAVIOR_DEFAULT = 0
BEHAVIOR_RATE_LIMITER = 2

_NEVER = -(2 ** 30)
#: float32(1/1000), exactly: what XLA turns ``/ 1000.0`` into
_INV_1000 = float(np.float32(0.001))


@dataclasses.dataclass
class ParamFlowItem:
    """Per-value threshold override (reference ``ParamFlowItem``)."""

    object: Any
    count: int
    class_type: str = ""   # informational; values are compared by key form


@dataclasses.dataclass
class ParamFlowRule:
    """Host-facing rule (reference ``ParamFlowRule.java`` field parity)."""

    resource: str
    param_idx: int = 0
    count: float = 0.0
    grade: int = GRADE_QPS
    duration_in_sec: int = 1
    burst_count: int = 0
    control_behavior: int = BEHAVIOR_DEFAULT
    max_queueing_time_ms: int = 0
    param_flow_item_list: List[ParamFlowItem] = dataclasses.field(
        default_factory=list)
    cluster_mode: bool = False
    cluster_flow_id: int = 0

    def is_valid(self) -> bool:
        """``ParamFlowRuleUtil.isValidRule``: a resource, count >= 0, a
        known grade, duration > 0 and a param index."""
        if not self.resource or self.count < 0 or self.duration_in_sec <= 0:
            return False
        if self.grade not in (GRADE_THREAD, GRADE_QPS):
            return False
        return self.param_idx is not None

    def hot_items(self) -> Dict[Any, int]:
        """Parsed per-value overrides (``ParamFlowRuleUtil.parseHotItems``)."""
        out: Dict[Any, int] = {}
        for it in self.param_flow_item_list:
            if it.object is not None and it.count >= 0:
                out[_key_form(it.object)] = int(it.count)
        return out


def _key_form(value: Any) -> Any:
    """Canonical hashable form of a param value: ``param_flow_key()`` when
    the value has one (the ``ParamFlowArgument`` protocol), and ``repr``
    for an unhashable value."""
    pk = getattr(value, "param_flow_key", None)
    if callable(pk):
        value = pk()
    try:
        hash(value)
        return value
    except TypeError:
        return repr(value)


class ParamRuleTable(NamedTuple):
    """Static per-rule columns, NP+1 rows (the last an inactive sentinel)."""

    active: torch.Tensor        # bool[NP+1]
    grade: torch.Tensor         # int32
    count: torch.Tensor         # float32
    duration_ms: torch.Tensor   # int32
    burst: torch.Tensor         # float32
    behavior: torch.Tensor      # int32
    max_queue_ms: torch.Tensor  # int32


class ParamDynState(NamedTuple):
    """Mutable per-key-row state, PK+1 rows (the last a sentinel that
    padding pairs point at)."""

    tokens: torch.Tensor            # float32[PK+1]
    last_fill_ms: torch.Tensor      # int32[PK+1] rel-ms; _NEVER = never
    latest_passed_ms: torch.Tensor  # int32[PK+1] rate-limiter pacing clock
    threads: torch.Tensor           # int32[PK+1] live concurrency per key
    override: torch.Tensor          # float32[PK+1]; < 0 = the rule's count


class CompiledParamRules(NamedTuple):
    table: ParamRuleTable
    rules: Tuple[ParamFlowRule, ...]       # index-aligned with the table
    # main row → ((table slot, param idx, hot items), ...): pairs are
    # resolved on the host at entry time
    by_row: Dict[int, Tuple[Tuple[int, int, Dict[Any, int]], ...]]
    num_active: int
    # bool[len(rules)]: THREAD grade per slot (the batch tier's pin mask)
    thread_slot_mask: Any = None
    # the vectorized batch resolution's tables (:class:`VectorMeta`) when
    # every rule has a non-negative index; else None
    vector_meta: Any = None


class VectorMeta(NamedTuple):
    """What the vector resolution tier (:func:`_resolve_pairs_vector`)
    reads: a resource's rules as table columns, and the integer hot items
    of every rule as packed keys."""

    slot: np.ndarray        # int32[max_row+1, K]: rule slot, -1 = none
    idx: np.ndarray         # int32[max_row+1, K]: its param index (>= 0)
    hot_keys: np.ndarray    # int64, sorted: slot · 2^32 + (value + 2^31)
    hot_counts: np.ndarray  # float64, aligned: each hot item's threshold
    # distinct keys are interned in sorted order (one rule a resource, no
    # hot items: the JAX package's tier, whose twin this is); otherwise in
    # first-seen order, the general loop's, so that the rows, the LRU
    # order and the queued overrides are the general loop's exactly
    sorted_order: bool


def _int32_key(k) -> Optional[int]:
    """The int a hot item's key equals as a dict key (``True == 1``,
    ``2.0 == 2``) when that int lies in the vector tier's value range
    (-2^31, 2^31); else None: no value the tier takes can equal it."""
    if isinstance(k, (bool, np.bool_, int, np.integer)):
        v = int(k)
    elif (isinstance(k, (float, np.floating)) and np.isfinite(k)
          and float(k).is_integer()):
        v = int(k)
    else:
        return None
    return v if -(2 ** 31) < v < 2 ** 31 else None


def _vector_meta(by_row) -> Optional[VectorMeta]:
    """:class:`VectorMeta` of the compiled rules, or None where a rule
    counts its index from the tail (the general loop then resolves)."""
    if not by_row or any(idx < 0 for entries in by_row.values()
                         for _j, idx, _hot in entries):
        return None
    k = max(len(entries) for entries in by_row.values())
    max_row = max(by_row)
    slot = np.full((max_row + 1, k), -1, np.int32)
    idx = np.zeros((max_row + 1, k), np.int32)
    hot: Dict[int, float] = {}
    for row, entries in by_row.items():
        for c, (j, i, items) in enumerate(entries):
            slot[row, c] = j
            idx[row, c] = i
            for key, count in items.items():
                v = _int32_key(key)
                if v is not None:
                    hot[j * 2 ** 32 + v + 2 ** 31] = float(count)
    keys = np.array(sorted(hot), np.int64)
    return VectorMeta(
        slot=slot, idx=idx, hot_keys=keys,
        hot_counts=np.array([hot[int(x)] for x in keys], np.float64),
        sorted_order=all(len(e) == 1 and not e[0][2]
                         for e in by_row.values()))


def init_param_dyn(pk: int, device="cpu") -> ParamDynState:
    def full(v, dtype):
        return torch.full((pk + 1,), v, dtype=dtype, device=device)
    return ParamDynState(
        tokens=full(0.0, torch.float32),
        last_fill_ms=full(_NEVER, torch.int32),
        latest_passed_ms=full(_NEVER, torch.int32),
        threads=full(0, torch.int32),
        override=full(-1.0, torch.float32))


def compile_param_rules(rules: Sequence[ParamFlowRule], *, resource_registry,
                        capacity: int, k_per_resource: int,
                        device="cpu") -> CompiledParamRules:
    """Validate and vectorize (``ParamFlowRuleUtil``); more rules than
    ``capacity``, or than ``k_per_resource`` on one resource, raise."""
    valid = [r for r in rules if r.is_valid()]
    if len(valid) > capacity:
        raise ValueError(f"too many param flow rules: {len(valid)} > {capacity}")

    np_ = capacity
    active = np.zeros(np_ + 1, np.bool_)
    grade = np.zeros(np_ + 1, np.int32)
    count = np.zeros(np_ + 1, np.float32)
    duration_ms = np.full(np_ + 1, 1000, np.int32)
    burst = np.zeros(np_ + 1, np.float32)
    behavior = np.zeros(np_ + 1, np.int32)
    max_queue_ms = np.zeros(np_ + 1, np.int32)
    by_row: Dict[int, List[Tuple[int, int, Dict[Any, int]]]] = {}
    slots_used: Dict[int, int] = {}

    for j, r in enumerate(valid):
        row = resource_registry.pin(r.resource)
        k = slots_used.get(row, 0)
        if k >= k_per_resource:
            raise ValueError(
                f"more than {k_per_resource} param rules for {r.resource!r}")
        slots_used[row] = k + 1
        by_row.setdefault(row, []).append((j, int(r.param_idx), r.hot_items()))
        active[j] = True
        grade[j] = r.grade
        count[j] = r.count
        duration_ms[j] = int(r.duration_in_sec) * 1000
        burst[j] = r.burst_count
        behavior[j] = r.control_behavior
        max_queue_ms[j] = r.max_queueing_time_ms

    def dev(a):
        return torch.from_numpy(a).to(device)
    table = ParamRuleTable(
        active=dev(active), grade=dev(grade), count=dev(count),
        duration_ms=dev(duration_ms), burst=dev(burst),
        behavior=dev(behavior), max_queue_ms=dev(max_queue_ms))
    by_row_t = {k: tuple(v) for k, v in by_row.items()}
    return CompiledParamRules(
        table=table, rules=tuple(valid), by_row=by_row_t,
        num_active=len(valid),
        thread_slot_mask=np.array([r.grade == GRADE_THREAD for r in valid],
                                  np.bool_),
        vector_meta=_vector_meta(by_row_t))


# ---------------------------------------------------------------------------
# Host-side key interning (the ParameterMetric caches)
# ---------------------------------------------------------------------------

class ParamKeyRegistry:
    """LRU intern table: (rule slot, value) → device key row.

    Exact and LRU-bounded like ``ParameterMetric``'s caches. Evicted rows
    are drained by the runtime and reset on the device, so a recycled row
    starts cold; a row created for a value with a per-item override queues
    a (row, threshold) write that the runtime flushes into
    ``ParamDynState.override`` before the next decide. Rows pinned by
    in-flight THREAD-grade entries are never recycled. ``created`` and
    ``evicted`` count the rows handed to new keys and those taken from
    old ones."""

    def __init__(self, capacity: int):
        self._cap = capacity
        self._map: "OrderedDict[Tuple[int, Any], int]" = OrderedDict()
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._evicted: List[int] = []
        self._pending_override: List[Tuple[int, float]] = []
        self._pins: Dict[int, int] = {}   # row → live-entry refcount
        self._lock = threading.Lock()
        self.created = 0
        self.evicted = 0

    @property
    def capacity(self) -> int:
        return self._cap

    def items(self) -> List[Tuple[Tuple[int, Any], int]]:
        """``((rule slot, key), row)`` of every live key, least recently
        used first (read only)."""
        with self._lock:
            return list(self._map.items())

    def get_or_create(self, rule_slot: int, value: Any,
                      override: Optional[int] = None) -> int:
        key = (rule_slot, _key_form(value))
        with self._lock:
            row = self._map.get(key)
            if row is not None:
                self._map.move_to_end(key)
                return row
            row = self._free.pop() if self._free else self._evict_lru_locked()
            self._map[key] = row
            self.created += 1
            if override is not None:
                self._pending_override.append((row, float(override)))
            return row

    def _evict_lru_locked(self) -> int:
        # a pinned row's in-flight entry would decrement its NEW occupant's
        # thread count at exit: skip it
        for key, row in self._map.items():
            if not self._pins.get(row):
                del self._map[key]
                self._evicted.append(row)
                self.evicted += 1
                # a queued override of the evicted occupant must not land
                # on the row's next occupant
                self._pending_override = [
                    (r, v) for r, v in self._pending_override if r != row]
                return row
        raise RuntimeError(
            "all hot-param key rows are pinned by live entries; "
            "raise param_table_slots")

    def _real_pin_counts(self, rows):
        """(unique rows below capacity, multiplicities): the no-op rows
        (>= capacity) drop out in one numpy filter."""
        arr = np.asarray(rows)
        if arr.size == 0:
            return (), ()
        arr = arr[arr < self._cap]
        if arr.size == 0:
            return (), ()
        uniq, cnt = np.unique(arr, return_counts=True)
        return uniq.tolist(), cnt.tolist()

    def pin_rows(self, rows) -> None:
        """Hold rows against recycling while an entry is in flight."""
        uniq, cnt = self._real_pin_counts(rows)
        if not uniq:
            return
        with self._lock:
            for r, c in zip(uniq, cnt):
                self._pins[r] = self._pins.get(r, 0) + c

    def unpin_rows(self, rows) -> None:
        uniq, cnt = self._real_pin_counts(rows)
        if not uniq:
            return
        with self._lock:
            for r, c in zip(uniq, cnt):
                n = self._pins.get(r, 0) - c
                if n <= 0:
                    self._pins.pop(r, None)
                else:
                    self._pins[r] = n

    def get_or_create_batch(self, items) -> List[int]:
        """Intern many ``(rule_slot, key_form, override_or_None)`` triples
        under ONE lock hold → the aligned rows."""
        out: List[int] = []
        with self._lock:
            for rule_slot, kf, override in items:
                key = (rule_slot, kf)
                row = self._map.get(key)
                if row is not None:
                    self._map.move_to_end(key)
                else:
                    row = (self._free.pop() if self._free
                           else self._evict_lru_locked())
                    self._map[key] = row
                    self.created += 1
                    if override is not None:
                        self._pending_override.append((row, float(override)))
                out.append(row)
        return out

    def drain_updates(self) -> Tuple[List[int], List[Tuple[int, float]]]:
        """→ (evicted rows to reset, pending override writes)."""
        with self._lock:
            ev_, ov = self._evicted, self._pending_override
            self._evicted, self._pending_override = [], []
            return ev_, ov

    def live_pin_count(self) -> int:
        """Pins held by in-flight entries, counted."""
        with self._lock:
            return sum(self._pins.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)


class NativeParamKeyRegistry:
    """:class:`ParamKeyRegistry` backed by the C++ table
    (:mod:`sentinel_tpu_torch.native`). Same observable behavior: row
    assignment order, LRU eviction skipping counted-pinned rows,
    evicted-row drain, override-on-create with cancel-on-evict (held row
    for row against both packages in ``tests/test_torch_native.py``).

    Key canonicalization mirrors the Python dict's equality semantics for
    the dominant types: ``bool``/integral ``float`` collapse onto ``int``
    (``True == 1``, ``1.0 == 1`` in a dict), int64-range ints take the
    13-byte binary form the C++ ``i64_get_or_create_batch`` fast path
    writes, strings are utf-8; anything else canonicalizes via ``repr``
    (exotic equal-but-different-repr keys may stay distinct — bounded
    divergence, same class as the reference's Object.equals vs our repr).
    """

    def __init__(self, capacity: int):
        import ctypes

        from sentinel_tpu_torch.native import load_native
        lib = load_native()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._ct = ctypes
        self._lib = lib
        self._cap = capacity
        self._h = ctypes.c_void_p(lib.str_new(capacity))
        if not self._h:
            raise MemoryError("str_new failed")
        self._lock = threading.Lock()    # guards _evicted/_pending lists
        self._evicted: List[int] = []
        self._pending_override: List[Tuple[int, float]] = []
        self._drain_buf = np.empty(512, np.int32)
        self.created = 0
        self.evicted = 0

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.str_free(h)

    @property
    def capacity(self) -> int:
        return self._cap

    # -- encoding ----------------------------------------------------------
    @staticmethod
    def _canon(kf):
        # numpy scalars hash/compare equal to their Python counterparts in
        # the dict-backed registry (np.int64(5) == 5), so they must
        # collapse to the same canonical form here too
        if isinstance(kf, (bool, np.bool_)):
            return int(kf)
        if isinstance(kf, np.integer):
            kf = int(kf)
        elif isinstance(kf, np.floating):
            kf = float(kf)
        if isinstance(kf, float) and kf.is_integer() \
                and -(2 ** 63) <= kf < 2 ** 63:
            return int(kf)
        if isinstance(kf, int) and not (-(2 ** 63) <= kf < 2 ** 63):
            return repr(kf)              # bigint → repr form
        return kf

    def _encode(self, slot: int, kf) -> bytes:
        import struct
        kf = self._canon(kf)
        if isinstance(kf, int):
            return struct.pack("<i", slot) + b"i" + struct.pack("<q", kf)
        if isinstance(kf, str):
            return struct.pack("<i", slot) + b"s" + kf.encode("utf-8")
        if isinstance(kf, float):
            return struct.pack("<i", slot) + b"f" + struct.pack("<d", kf)
        return struct.pack("<i", slot) + b"r" + repr(kf).encode("utf-8")

    # -- native plumbing ---------------------------------------------------
    def _ptr(self, arr, typ):
        return arr.ctypes.data_as(self._ct.POINTER(typ))

    def _drain_native_locked(self) -> None:
        """Pull freshly evicted rows out of the C++ queue and cancel any
        queued override targeting them — the Python registry cancels AT
        eviction; draining immediately after every intern call restores
        that ordering exactly (batches are chunked at override
        boundaries)."""
        buf = self._drain_buf
        while True:
            n = self._lib.str_drain(self._h, self._ptr(buf, self._ct.c_int32),
                                    buf.shape[0])
            if n <= 0:
                break
            rows = buf[:n].tolist()
            self._evicted.extend(rows)
            self.evicted += n
            if self._pending_override:
                rs = set(rows)
                self._pending_override = [
                    (r, v) for r, v in self._pending_override
                    if r not in rs]
            if n < buf.shape[0]:
                break

    def _raise_if_full(self, rows: np.ndarray) -> None:
        if (rows == -2).any():
            raise RuntimeError(
                "all hot-param key rows are pinned by live entries; "
                "raise param_table_slots")

    def _intern_encoded_locked(self, encoded: List[bytes],
                               overrides) -> np.ndarray:
        n = len(encoded)
        offsets = np.zeros(n + 1, np.int32)
        np.cumsum([len(b) for b in encoded], out=offsets[1:])
        data = b"".join(encoded)
        out = np.empty(n, np.int32)
        created = np.empty(n, np.uint8)
        self._lib.str_get_or_create_batch2(
            self._h, data, self._ptr(offsets, self._ct.c_int32), n,
            self._ptr(out, self._ct.c_int32),
            self._ptr(created, self._ct.c_uint8))
        self._drain_native_locked()
        self._raise_if_full(out)
        self.created += int(np.count_nonzero(created))
        if overrides is not None:
            for i, ov in overrides:
                if ov is not None and created[i]:
                    self._pending_override.append((int(out[i]), float(ov)))
        return out

    # -- ParamKeyRegistry interface ---------------------------------------
    def get_or_create(self, rule_slot: int, value, override=None) -> int:
        with self._lock:
            out = self._intern_encoded_locked(
                [self._encode(rule_slot, value)],
                [(0, override)] if override is not None else None)
            return int(out[0])

    def get_or_create_batch(self, items) -> List[int]:
        out: List[int] = []
        chunk: List[bytes] = []
        with self._lock:
            for rule_slot, kf, override in items:
                if override is None:
                    chunk.append(self._encode(rule_slot, kf))
                    continue
                # override items chunk-flush so cancel-on-evict ordering
                # matches the Python registry call-for-call
                if chunk:
                    out.extend(self._intern_encoded_locked(chunk, None)
                               .tolist())
                    chunk = []
                one = self._intern_encoded_locked(
                    [self._encode(rule_slot, kf)], [(0, override)])
                out.append(int(one[0]))
            if chunk:
                out.extend(self._intern_encoded_locked(chunk, None)
                           .tolist())
        return out

    def get_or_create_int_batch(self, packed: np.ndarray,
                                overrides: Optional[np.ndarray] = None
                                ) -> np.ndarray:
        """Fast path for the vector resolution tier: ``packed`` is the
        int64 combine-key ``slot * 2**32 + (value + 2**31)`` — key bytes
        are produced in C++, one FFI call for the whole distinct set.
        ``overrides`` (float64, aligned; NaN = none) queues the threshold
        of each key this call creates, as :meth:`get_or_create_batch`
        does item by item: a row the call takes from a key it created
        earlier cancels that key's override, so of the keys created on
        one row the last alone keeps its own (the drain has cancelled
        the older queued overrides of the rows it recycled)."""
        packed = np.ascontiguousarray(packed, np.int64)
        n = packed.shape[0]
        out = np.empty(n, np.int32)
        created = np.empty(n, np.uint8)
        with self._lock:
            self._lib.i64_get_or_create_batch(
                self._h, self._ptr(packed, self._ct.c_int64), n,
                self._ptr(out, self._ct.c_int32),
                self._ptr(created, self._ct.c_uint8))
            self._drain_native_locked()
            self._raise_if_full(out)
            made = np.flatnonzero(created)
            self.created += int(made.size)
            if overrides is not None and made.size:
                # the last key created on each row
                _, back = np.unique(out[made][::-1], return_index=True)
                last = np.sort(made[made.size - 1 - back])
                ov = np.asarray(overrides, np.float64)[last]
                keep = ~np.isnan(ov)
                self._pending_override.extend(
                    zip(out[last][keep].tolist(), ov[keep].tolist()))
        return out

    def items(self) -> List[Tuple[Tuple[int, Any], int]]:
        """``((rule slot, key), row)`` of every live key, least recently
        used first (read only): each key decoded from the bytes
        :meth:`_encode` made (integers as ints, floats as floats, strings
        and other values' ``repr`` as strings)."""
        import struct

        from sentinel_tpu_torch.native import snapshot
        out = []
        for key, row in snapshot(self._lib, self._h, self._cap):
            slot, tag = struct.unpack_from("<ic", key)
            body = key[5:]
            value = (struct.unpack("<q", body)[0] if tag == b"i" else
                     struct.unpack("<d", body)[0] if tag == b"f" else
                     body.decode("utf-8"))
            out.append(((slot, value), row))
        return out

    def pin_rows(self, rows) -> None:
        arr = np.ascontiguousarray(np.asarray(rows, np.int32).ravel())
        arr = arr[(arr >= 0) & (arr < self._cap)]
        if arr.size:
            arr = np.ascontiguousarray(arr)
            self._lib.str_pin_rows(self._h,
                                   self._ptr(arr, self._ct.c_int32),
                                   arr.shape[0])

    def unpin_rows(self, rows) -> None:
        arr = np.ascontiguousarray(np.asarray(rows, np.int32).ravel())
        arr = arr[(arr >= 0) & (arr < self._cap)]
        if arr.size:
            arr = np.ascontiguousarray(arr)
            self._lib.str_unpin_rows(self._h,
                                     self._ptr(arr, self._ct.c_int32),
                                     arr.shape[0])

    def drain_updates(self) -> Tuple[List[int], List[Tuple[int, float]]]:
        with self._lock:
            self._drain_native_locked()
            ev_, ov = self._evicted, self._pending_override
            self._evicted, self._pending_override = [], []
            return ev_, ov

    def live_pin_count(self) -> int:
        """Total counted pins held by in-flight entries (observability)."""
        return int(self._lib.str_pin_total(self._h))

    def __len__(self) -> int:
        return int(self._lib.str_len(self._h))


def make_param_key_registry(capacity: int):
    """The native table when it builds, else the Python registry —
    identical semantics either way (``SENTINEL_TPU_NATIVE=0`` forces
    Python, same switch as the resource registry)."""
    from sentinel_tpu_torch.native import native_available
    if native_available():
        return NativeParamKeyRegistry(capacity)
    return ParamKeyRegistry(capacity)


_PIN_NOOP = 2 ** 31 - 1       # >= any registry capacity: pin/unpin no-op


def thread_key_rows(compiled: CompiledParamRules, pair_rules: np.ndarray,
                    pair_keys: np.ndarray) -> np.ndarray:
    """Key rows of THREAD-grade pairs, the no-op row elsewhere: only their
    exit-side decrement must find the same occupant."""
    keys_flat = np.asarray(pair_keys).reshape(-1)
    mask = compiled.thread_slot_mask
    nrules = len(compiled.rules)
    if nrules == 0 or mask is None or not mask.any():
        return np.full(keys_flat.shape, _PIN_NOOP, keys_flat.dtype)
    rj = np.asarray(pair_rules).reshape(-1)
    valid = (rj >= 0) & (rj < nrules)
    is_thread = valid & mask[np.where(valid, rj, 0)]
    return np.where(is_thread, keys_flat, keys_flat.dtype.type(_PIN_NOOP))


def resolve_pairs(compiled: CompiledParamRules, keys: ParamKeyRegistry,
                  row: int, args: Sequence[Any],
                  pairs_per_event: int) -> Tuple[np.ndarray, np.ndarray]:
    """One event's positional args → (rule slots, key rows), each int32
    [PV]: ``applyRealParamIdx`` (negative from the tail, past the end
    passes), ``paramFlowKey``, None passes, a collection checks every
    element. More than ``pairs_per_event`` pairs raise."""
    np_sentinel = compiled.table.active.shape[0] - 1
    pk_sentinel = keys.capacity
    pr = np.full(pairs_per_event, np_sentinel, np.int32)
    pk = np.full(pairs_per_event, pk_sentinel, np.int32)
    fills = 0
    entries = compiled.by_row.get(row)
    if not entries:
        return pr, pk
    n = len(args)
    for slot_j, idx, hot in entries:
        if idx < 0:
            idx = n + idx if -idx <= n else -idx
        if idx >= n:
            continue
        value = args[idx]
        if value is None:
            continue
        values = (list(value) if isinstance(value, (list, tuple, set, frozenset))
                  else [value])
        for v in values:
            if v is None:
                continue
            if fills >= pairs_per_event:
                raise ValueError(
                    f"event needs more than {pairs_per_event} param checks; "
                    f"raise param_pairs_per_event")
            kf = _key_form(v)
            pr[fills] = slot_j
            pk[fills] = keys.get_or_create(slot_j, kf, override=hot.get(kf))
            fills += 1
    return pr, pk


def _resolve_pairs_vector(compiled: CompiledParamRules,
                          keys: ParamKeyRegistry, rows, args_list,
                          pr: np.ndarray, pk: np.ndarray,
                          stats: Optional[dict] = None):
    """Vectorized resolution (``vector_meta``) of integer args of one
    arity: each event's pairs in its resource's rule order (a rule whose
    index lies past the arity adds none), (slot, value) packed into one
    int64 and deduplicated with ``np.unique``, the distinct keys interned
    in one call with their hot items' thresholds → (pr, pk) filled, as
    the general loop fills them, or None where the shape is not provably
    safe (the caller then takes the general loop): not a 2-D integer
    array, a value outside (-2^31, 2^31), more pairs an event than
    ``pr`` has columns."""
    try:
        arr = np.asarray(args_list)
    except (ValueError, TypeError):
        return None
    if arr.ndim != 2 or arr.dtype.kind not in "iu" or arr.shape[1] == 0:
        return None
    if arr.dtype.kind == "u" and arr.dtype.itemsize == 8:
        return None                      # uint64 may wrap in the int64 cast
    meta: VectorMeta = compiled.vector_meta
    rows_arr = np.asarray(rows, np.int64)
    in_range = rows_arr < meta.slot.shape[0]
    r = np.where(in_range, rows_arr, 0)
    slots = np.where(in_range[:, None], meta.slot[r], -1)       # [n, K]
    idxs = meta.idx[r]
    live = (slots >= 0) & (idxs < arr.shape[1])
    if stats is not None:
        stats["pairs"] = stats["distinct"] = 0
    if not live.any():
        return pr, pk
    fills = np.cumsum(live, axis=1, dtype=np.int32)
    if int(fills[:, -1].max()) > pr.shape[1]:
        return None                      # the general loop raises
    ev, k = np.nonzero(live)             # event-major: the loop's order
    vals = arr[ev, idxs[ev, k]].astype(np.int64)
    # direct comparisons: abs(int64.min) overflows
    if (vals >= 2 ** 31).any() or (vals <= -(2 ** 31)).any():
        return None
    s = slots[ev, k].astype(np.int64)
    comb = s * (2 ** 32) + (vals + 2 ** 31)
    if meta.sorted_order:
        uniq, inv = np.unique(comb, return_inverse=True)
        order = None
    else:
        uniq, first, inv = np.unique(comb, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind="stable")
        uniq = uniq[order]
    over = None
    if meta.hot_keys.size:
        at = np.minimum(np.searchsorted(meta.hot_keys, uniq),
                        meta.hot_keys.size - 1)
        over = np.where(meta.hot_keys[at] == uniq, meta.hot_counts[at],
                        np.nan)
    goc_int = getattr(keys, "get_or_create_int_batch", None)
    if goc_int is not None:
        # the native table: the packed keys go through one call, the key
        # bytes made in C++
        rows_out = goc_int(uniq, over)
    else:
        u_slot = (uniq // (2 ** 32)).tolist()
        u_val = (uniq % (2 ** 32) - 2 ** 31).tolist()
        u_ov = ([None] * len(u_slot) if over is None else
                [None if np.isnan(x) else x for x in over.tolist()])
        rows_out = np.asarray(keys.get_or_create_batch(
            list(zip(u_slot, u_val, u_ov))), np.int32)
    if order is not None:
        back = np.empty_like(rows_out)
        back[order] = rows_out
        rows_out = back
    col = fills[ev, k] - 1
    pr[ev, col] = s.astype(np.int32)
    pk[ev, col] = rows_out[inv.reshape(-1)]
    if stats is not None:
        stats["pairs"], stats["distinct"] = int(ev.size), int(uniq.size)
    return pr, pk


def resolve_pairs_many(compiled: CompiledParamRules, keys: ParamKeyRegistry,
                       rows: Sequence[int], args_list: Sequence[Sequence[Any]],
                       pairs_per_event: int, stats: Optional[dict] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Batch form of :func:`resolve_pairs` with one registry lock hold and
    one intern per distinct (slot, key) → ``(param_rules [n, PV],
    param_keys [n, PV])``. A ``stats`` dict receives the batch's pair
    applications (``pairs``) and distinct keys (``distinct``)."""
    n_events = len(rows)
    np_sentinel = compiled.table.active.shape[0] - 1
    pk_sentinel = keys.capacity
    pr = np.full((n_events, pairs_per_event), np_sentinel, np.int32)
    pk = np.full((n_events, pairs_per_event), pk_sentinel, np.int32)
    if compiled.vector_meta is not None:
        out = _resolve_pairs_vector(compiled, keys, rows, args_list, pr, pk,
                                    stats)
        if out is not None:
            return out
    if stats is not None:
        stats["pairs"] = stats["distinct"] = 0
    by_row_get = compiled.by_row.get
    uniq_pos: Dict[Tuple[int, Any], int] = {}
    uniq_items: List[Tuple[int, Any, Optional[int]]] = []
    want_i: List[int] = []
    want_f: List[int] = []
    want_slot: List[int] = []
    want_u: List[int] = []
    rows_list = (rows.tolist() if isinstance(rows, np.ndarray)
                 else [int(r) for r in rows])
    for i, (row, args) in enumerate(zip(rows_list, args_list)):
        if args is None or len(args) == 0:   # len(): ndarray rows are valid
            continue
        entries = by_row_get(row)
        if not entries:
            continue
        n = len(args)
        fills = 0
        for slot_j, idx, hot in entries:
            if idx < 0:
                idx = n + idx if -idx <= n else -idx
            if idx >= n:
                continue
            value = args[idx]
            if value is None:
                continue
            tv = type(value)
            if tv is int or tv is str:
                values = (value,)
            elif isinstance(value, (list, tuple, set, frozenset)):
                values = value
            else:
                values = (value,)
            for v in values:
                if v is None:
                    continue
                if fills >= pairs_per_event:
                    raise ValueError(
                        f"event needs more than {pairs_per_event} param "
                        f"checks; raise param_pairs_per_event")
                tv2 = type(v)
                kf = v if (tv2 is int or tv2 is str) else _key_form(v)
                ukey = (slot_j, kf)
                u = uniq_pos.get(ukey)
                if u is None:
                    u = uniq_pos[ukey] = len(uniq_items)
                    uniq_items.append(
                        (slot_j, kf, hot.get(kf) if hot else None))
                want_i.append(i)
                want_f.append(fills)
                want_slot.append(slot_j)
                want_u.append(u)
                fills += 1
    if stats is not None:
        stats["pairs"], stats["distinct"] = len(want_i), len(uniq_items)
    if not uniq_items:
        return pr, pk
    rows_out = np.asarray(keys.get_or_create_batch(uniq_items), np.int32)
    ii = np.asarray(want_i, np.int64)
    ff = np.asarray(want_f, np.int64)
    pr[ii, ff] = np.asarray(want_slot, np.int32)
    pk[ii, ff] = rows_out[np.asarray(want_u, np.int64)]
    return pr, pk


# ---------------------------------------------------------------------------
# Device-side checks
# ---------------------------------------------------------------------------

def scatter_set_drop(dest: torch.Tensor, idx: torch.Tensor,
                     values, keep: torch.Tensor) -> torch.Tensor:
    """``dest.at[idx].set(values, mode="drop")`` for the lanes where
    ``keep`` holds → a new tensor (``dest`` untouched). The other lanes
    write to spare slots past the end, spread by lane index, that are
    sliced off: no live slot and no single address takes them. Lanes that
    share a kept index must carry one value (every caller's do)."""
    n = dest.shape[0]
    ext = torch.cat([dest, dest.new_zeros((seg.SPARE_SLOTS,))])
    lane = torch.arange(idx.shape[0], device=idx.device)
    tgt = torch.where(keep, idx.long(), n + lane % seg.SPARE_SLOTS)
    if not isinstance(values, torch.Tensor):
        values = torch.full(idx.shape, values, dtype=dest.dtype,
                            device=dest.device)
    return ext.scatter_(0, tgt, values.to(dest.dtype))[:n]


def scatter_set_last(dest: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """:func:`scatter_set_drop` where lanes sharing an index may carry
    different values: the LAST such lane (batch order) wins, as in the
    reference's scatter on the CPU. One ``amax`` of lane numbers per
    index picks the winner, which then writes alone."""
    n = dest.shape[0]
    lane = torch.arange(idx.shape[0], device=idx.device)
    last = seg.scatter_reduce_drop(
        torch.full((n,), -1, dtype=torch.long, device=dest.device), idx,
        lane, keep, "amax")
    win = keep & (_gather(last, idx) == lane)
    return scatter_set_drop(dest, idx, values, win)


def _gather(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[idx]`` with a JAX gather's clamping (indices are in range on
    every path; the clamp keeps a stray one from faulting)."""
    return col[torch.clamp(idx, 0, col.shape[0] - 1).long()]


def _pairs(table: ParamRuleTable, dyn: ParamDynState,
           pair_rules: torch.Tensor, pair_keys: torch.Tensor,
           valid: torch.Tensor):
    """Flatten the [B, PV] pairs → (rj, kj, valid_p): inapplicable pairs
    (a dead event, the NP or PK sentinel, an inactive rule) point at the
    sentinels."""
    pv = pair_rules.shape[1]
    np_ = table.active.shape[0] - 1
    pk = dyn.tokens.shape[0] - 1
    rj = pair_rules.reshape(-1)
    kj = pair_keys.reshape(-1)
    valid_p = (seg.repeat_each(valid, pv) & (rj != np_) & (kj < pk)
               & _gather(table.active, rj))
    return (torch.where(valid_p, rj, np_), torch.where(valid_p, kj, pk),
            valid_p)


def param_check(
    table: ParamRuleTable,
    dyn: ParamDynState,
    pair_rules: torch.Tensor,     # int32[B, PV] table slot, NP = none
    pair_keys: torch.Tensor,      # int32[B, PV] key row, PK = none
    acquire: torch.Tensor,        # int32[B]
    valid: torch.Tensor,          # bool[B]: events still live in the chain
    rel_now_ms: int,
) -> Tuple[ParamDynState, torch.Tensor, torch.Tensor]:
    """→ (dyn', allow bool[B], wait_ms int32[B]): one segmented pass over
    the (event, pair) applications, a segment per key row, so in-batch
    requests on one hot key consume in batch order."""
    B, PV = pair_rules.shape
    PK = dyn.tokens.shape[0] - 1
    rj, kj, valid_p = _pairs(table, dyn, pair_rules, pair_keys, valid)
    acq_p = torch.where(valid_p, seg.repeat_each(acquire, PV), 0).float()

    # threshold: a per-item override beats the rule's count
    ov = _gather(dyn.override, kj)
    threshold = torch.where(ov >= 0.0, ov, _gather(table.count, rj))
    max_count = threshold + _gather(table.burst, rj)
    duration = torch.clamp(_gather(table.duration_ms, rj), min=1).float()

    # --- segments: one per key row ---
    order = seg.sort_by_keys(kj)
    rj_s = rj[order]
    kj_s = kj[order]
    acq_s = acq_p[order]
    valid_s = valid_p[order]
    starts = seg.segment_starts(kj_s, torch.zeros_like(kj_s))
    leader = seg.segment_leader_index(starts)

    thr_s = threshold[order]
    maxc_s = max_count[order]
    dur_s = duration[order]
    grade_s = _gather(table.grade, rj_s)
    behavior_s = _gather(table.behavior, rj_s)

    # --- QPS default: the leader refills, then greedy consumption ---
    last_fill = _gather(dyn.last_fill_ms, kj_s)
    never = last_fill == _NEVER
    pass_time = (rel_now_ms - last_fill).float()
    refill = pass_time > dur_s
    to_add = torch.floor(pass_time * thr_s / dur_s)
    tok_s = _gather(dyn.tokens, kj_s)
    t0 = torch.where(never, maxc_s,
                     torch.where(refill, torch.minimum(tok_s + to_add, maxc_s),
                                 tok_s))
    t0 = seg.segment_broadcast_first(t0, leader)
    qps_pass = seg.greedy_admit(torch.zeros_like(acq_s), acq_s, t0, starts,
                                leader)
    qps_pass = qps_pass & (thr_s > 0.0) & (acq_s <= maxc_s)

    # --- QPS rate limiter: a paced queue per key ---
    # the compiled reference's operation order, in float32
    cost_s = _f32_to_i32(torch.round(
        1000.0 * acq_s * dur_s * _INV_1000 / torch.clamp(thr_s, min=1e-9)))
    c_first = seg.segment_broadcast_first(cost_s, leader)
    l0 = _gather(dyn.latest_passed_ms, kj_s)
    due = (l0 == _NEVER) | ((l0 + c_first - rel_now_ms) <= 0)
    base_time = torch.where(due, rel_now_ms - c_first, l0)
    # a rejected request consumes no pacing budget: exactly three rounds
    # of the fixed point, as the reference runs them
    rl_pass = torch.ones_like(starts)
    maxq_s = _gather(table.max_queue_ms, rj_s)
    for _ in range(3):
        excl_cost, _ = seg.segment_prefix_sum(
            torch.where(rl_pass, cost_s, 0), starts, leader)
        latest_s = base_time + excl_cost + cost_s
        wait_s = torch.clamp(latest_s - rel_now_ms, min=0)
        rl_pass = ((wait_s <= 0) | (wait_s < maxq_s)) & (thr_s > 0.0)

    # --- THREAD grade: +1 a request whatever its acquire ---
    ones = torch.where(valid_s, 1.0, 0.0)
    thread_pass = seg.greedy_admit(_gather(dyn.threads, kj_s).float(), ones,
                                   thr_s, starts, leader)

    is_rl = (grade_s == GRADE_QPS) & (behavior_s == BEHAVIOR_RATE_LIMITER)
    is_qps = (grade_s == GRADE_QPS) & ~is_rl
    pair_pass_s = torch.where(is_qps, qps_pass,
                              torch.where(is_rl, rl_pass, thread_pass))
    pair_pass_s = pair_pass_s | ~valid_s
    pair_wait_s = torch.where(is_rl & pair_pass_s & valid_s, wait_s, 0)

    # --- back to events: every pair must pass ---
    pair_pass = seg.unsort(order, pair_pass_s.to(torch.int32)).bool()
    pair_wait = seg.unsort(order, pair_wait_s.to(torch.int32))
    allow = pair_pass.reshape(B, PV).all(dim=1)
    wait_ms = pair_wait.reshape(B, PV).amax(dim=1).to(torch.int32)
    allow = allow | ~valid

    # --- writeback at segment granularity; a pair whose event a sibling
    # pair blocked consumes nothing ---
    event_ok_pair_s = seg.repeat_each(allow & valid, PV)[order]
    live_qps = valid_s & is_qps
    consumed = torch.where(live_qps & pair_pass_s & event_ok_pair_s, acq_s,
                           0.0)
    _, incl_consumed = seg.segment_prefix_sum(consumed, starts, leader)
    new_tokens = t0 - incl_consumed
    # the last element of each key segment carries the final value
    is_last = torch.cat([starts[1:], torch.ones_like(starts[:1])])
    tokens = scatter_set_drop(dyn.tokens, kj_s, new_tokens,
                              is_last & live_qps)
    last_fill_new = scatter_set_drop(
        dyn.last_fill_ms, kj_s, rel_now_ms,
        is_last & live_qps & (never | refill))
    rl_latest = torch.where(is_rl & pair_pass_s & valid_s & event_ok_pair_s,
                            latest_s, _NEVER)
    latest_passed = seg.scatter_reduce_drop(
        dyn.latest_passed_ms, kj_s, rl_latest, is_rl & valid_s, "amax")
    return (dyn._replace(tokens=tokens, last_fill_ms=last_fill_new,
                         latest_passed_ms=latest_passed), allow, wait_ms)


def param_check_scalar(
    table: ParamRuleTable,
    dyn: ParamDynState,
    pair_rules: torch.Tensor,     # int32[B, PV] table slot, NP = none
    pair_keys: torch.Tensor,      # int32[B, PV] key row, PK = none
    acquire: torch.Tensor,        # int32[B]: HOST-VERIFIED uniform (>= 1)
    valid: torch.Tensor,          # bool[B]
    rel_now_ms: int,
) -> Tuple[ParamDynState, torch.Tensor, torch.Tensor]:
    """The rank form of :func:`param_check` (the scalar and fast routes),
    bit-exact with it under a uniform acquire: every admission quantity of
    a key segment (the refilled bucket, the threshold, the pacing cost) is
    a function of the key alone, so the greedy consumption, the rate
    limiter's fixed point and the THREAD check become compares against
    each pair's arrival rank among the pairs of its key. The writebacks
    scatter by key row; the token consumption goes through the
    scatter-add kernel seam."""
    B, PV = pair_rules.shape
    PK = dyn.tokens.shape[0] - 1
    rj, kj, valid_p = _pairs(table, dyn, pair_rules, pair_keys, valid)
    # the uniform acquire as a device scalar (no readback)
    a_int = torch.where(valid, acquire, 0).max()
    a = a_int.float()

    rank = seg.ranks_by_key(kj)
    rankf = rank.float()

    ov = _gather(dyn.override, kj)
    threshold = torch.where(ov >= 0.0, ov, _gather(table.count, rj))
    maxc = threshold + _gather(table.burst, rj)
    duration = torch.clamp(_gather(table.duration_ms, rj), min=1).float()
    grade = _gather(table.grade, rj)
    behavior = _gather(table.behavior, rj)

    # --- QPS default: refill per key, then the rank-prefix consumption ---
    last_fill = _gather(dyn.last_fill_ms, kj)
    never = last_fill == _NEVER
    pass_time = (rel_now_ms - last_fill).float()
    refill = pass_time > duration
    to_add = torch.floor(pass_time * threshold / duration)
    tok = _gather(dyn.tokens, kj)
    t0 = torch.where(never, maxc,
                     torch.where(refill, torch.minimum(tok + to_add, maxc),
                                 tok))
    # every term an integer below 2^24: exact, contracted or not
    qps_pass = (rankf * a) + a <= t0
    qps_pass = qps_pass & (threshold > 0.0) & (a <= maxc)

    # --- QPS rate limiter: the closed form per key (a rank budget) ---
    cost = _f32_to_i32(torch.round(
        1000.0 * a * duration * _INV_1000
        / torch.clamp(threshold, min=1e-9)))
    l0 = _gather(dyn.latest_passed_ms, kj)
    due = (l0 == _NEVER) | ((l0 + cost - rel_now_ms) <= 0)
    base_time = torch.where(due, rel_now_ms - cost, l0)
    maxq = _gather(table.max_queue_ms, rj)
    # pass ⇔ wait <= 0 or wait < maxq ⇔ wait < max(maxq, 1)
    maxq_eff = torch.clamp(maxq, min=1)
    rl_numer = rel_now_ms + maxq_eff - base_time
    # (k+1)·cost < numer ⇔ k < (numer-1) // cost (floor division)
    max_k = torch.clamp(torch.div(rl_numer - 1, torch.clamp(cost, min=1),
                                  rounding_mode="floor"), min=0)
    wait0_ok = torch.clamp(base_time - rel_now_ms, min=0) < maxq_eff
    max_k = torch.where(cost > 0, max_k,
                        torch.where(wait0_ok, 2 ** 30, 0)).to(torch.int32)
    rl_pass = (rank < max_k) & (threshold > 0.0)
    safe_rank = torch.minimum(rank, max_k)
    wait_pair = torch.clamp(base_time + (safe_rank + 1) * cost - rel_now_ms,
                            min=0)

    # --- THREAD grade: +1 a request whatever its acquire ---
    thread_pass = (_gather(dyn.threads, kj).float() + rankf) + 1.0 \
        <= threshold

    is_rl = (grade == GRADE_QPS) & (behavior == BEHAVIOR_RATE_LIMITER)
    is_qps = (grade == GRADE_QPS) & ~is_rl
    pair_pass = torch.where(is_qps, qps_pass,
                            torch.where(is_rl, rl_pass, thread_pass))
    pair_pass = pair_pass | ~valid_p
    pair_wait = torch.where(is_rl & pair_pass & valid_p, wait_pair, 0)

    allow = pair_pass.reshape(B, PV).all(dim=1)
    wait_ms = pair_wait.reshape(B, PV).amax(dim=1).to(torch.int32)
    allow = allow | ~valid

    # --- writeback, keyed by key row ---
    event_ok_pair = seg.repeat_each(allow & valid, PV)
    live_qps = valid_p & is_qps
    # the refreshed bucket, then what this batch consumed. Many lanes may
    # write one key. They carry that key's t0 (t0 depends on the key row
    # and its rule) — unless the registry recycled the row within this
    # batch (a batch with more distinct keys than rows), when two rules
    # share it: then the last lane wins, as in the reference
    tokens = scatter_set_last(dyn.tokens, kj, t0, live_qps)
    consumed = torch.where(live_qps & pair_pass & event_ok_pair, -a_int, 0)
    # integer amounts into the float32 bucket: exact in any order while
    # the bucket stays below 2^24; a lane that consumes nothing drops
    sa.scatter_add(tokens[:, None], torch.where(live_qps, kj, PK + 1),
                   None, consumed.to(torch.int32)[:, None])
    last_fill_new = scatter_set_drop(dyn.last_fill_ms, kj, rel_now_ms,
                                     live_qps & (never | refill))
    latest_pair = torch.where(is_rl & rl_pass & valid_p & event_ok_pair,
                              base_time + (safe_rank + 1) * cost, _NEVER)
    latest_passed = seg.scatter_reduce_drop(
        dyn.latest_passed_ms, kj, latest_pair.to(torch.int32),
        is_rl & valid_p, "amax")
    return (dyn._replace(tokens=tokens, last_fill_ms=last_fill_new,
                         latest_passed_ms=latest_passed), allow, wait_ms)


def param_thread_update(
    table: ParamRuleTable,
    dyn: ParamDynState,
    pair_rules: torch.Tensor,     # int32[B, PV]
    pair_keys: torch.Tensor,      # int32[B, PV]
    counted: torch.Tensor,        # bool[B]: events whose pairs count
    delta: int,
) -> ParamDynState:
    """±1 live concurrency per key for THREAD-grade pairs (the reference's
    ``ParamFlowStatisticEntryCallback`` / ``ExitCallback``), through the
    scatter-add kernel seam, IN PLACE; a lane that does not count targets
    the sentinel row PK with amount 0 (skipped), as the reference's does."""
    NP = table.active.shape[0] - 1
    PK = dyn.tokens.shape[0] - 1
    PV = pair_rules.shape[1]
    rj = pair_rules.reshape(-1)
    kj = pair_keys.reshape(-1)
    live = seg.repeat_each(counted, PV) & (rj != NP) & (kj < PK)
    live = live & (_gather(table.grade, rj) == GRADE_THREAD)
    target = torch.where(live, kj, PK)
    sa.scatter_add(dyn.threads[:, None], target, None,
                   torch.where(live, delta, 0).to(torch.int32)[:, None])
    if delta < 0:
        dyn.threads.clamp_(min=0)
    return dyn


def invalidate_param_keys(dyn: ParamDynState,
                          rows: torch.Tensor) -> ParamDynState:
    """Reset recycled key rows (rows padded with PK, which stays at its
    initial values)."""
    keep = (rows >= 0) & (rows < dyn.tokens.shape[0])
    return ParamDynState(
        tokens=scatter_set_drop(dyn.tokens, rows, 0.0, keep),
        last_fill_ms=scatter_set_drop(dyn.last_fill_ms, rows, _NEVER, keep),
        latest_passed_ms=scatter_set_drop(dyn.latest_passed_ms, rows, _NEVER,
                                          keep),
        threads=scatter_set_drop(dyn.threads, rows, 0, keep),
        override=scatter_set_drop(dyn.override, rows, -1.0, keep))


def apply_overrides(dyn: ParamDynState, rows: torch.Tensor,
                    values: torch.Tensor) -> ParamDynState:
    """Flush pending per-item thresholds (rows padded with PK, values with
    -1.0: the sentinel row's own value)."""
    keep = (rows >= 0) & (rows < dyn.tokens.shape[0])
    return dyn._replace(override=scatter_set_drop(dyn.override, rows, values,
                                                  keep))
