"""Resource / origin registries: string name → dense row id.

The reference keys everything by string resource name inside copy-on-write
maps (``CtSph.lookProcessChain``, ``ClusterBuilderSlot`` resource→ClusterNode)
and hard-caps at 6,000 chains / 2,000 contexts (``Constants.java:37-38``),
silently skipping checks beyond the cap. Here the registry maps names to rows
of the dense counter tensors. Capacity is pre-allocated (the state tensors
are sized once); on overflow we evict the least-recently-entered unpinned
row instead of silently disabling checks — strictly better than the
reference's behavior.

Evicted row ids are queued; the runtime drains them via :meth:`drain_evicted`
and invalidates those rows' window state on the next device step (see
``stats.window.invalidate_rows`` in the JAX package) so a recycled row never inherits the evicted
resource's live counters.

Row 0 is reserved for the global inbound aggregate (reference
``Constants.ENTRY_NODE``), used by the system-adaptive slot.

The PyTorch port's own copy of ``sentinel_tpu/core/registry.py``: the
pure-Python registries and the factories that pick the native C++ table
(:mod:`sentinel_tpu_torch.native`) when it builds. Allocation order is
identical in all four tables, so the same name sequence interned into
either package, native or not, yields the same rows.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Iterable, List, Optional, Tuple

ENTRY_NODE_ROW = 0
ENTRY_NODE_NAME = "__entry_node__"


class Registry:
    """Thread-safe name→id allocator, O(1) LRU eviction on overflow."""

    def __init__(self, capacity: int, reserved: Iterable[str] = ()):  # rows [0, capacity)
        reserved = tuple(reserved)
        if capacity < 1 + len(reserved):
            raise ValueError("capacity too small")
        self._capacity = capacity
        self._lock = threading.Lock()
        # OrderedDict in LRU order: oldest first; move_to_end on touch.
        self._name_to_id: "collections.OrderedDict[str, int]" = collections.OrderedDict()
        self._id_to_name: List[Optional[str]] = [None] * capacity
        self._next = 0
        self._free: List[int] = []
        self._pinned: set = set()
        self._evicted_pending: List[int] = []
        for name in reserved:
            rid = self._alloc_locked(name)
            self._pinned.add(rid)

    @property
    def capacity(self) -> int:
        return self._capacity

    def _alloc_locked(self, name: str) -> int:
        if self._free:
            rid = self._free.pop()
        elif self._next < self._capacity:
            rid = self._next
            self._next += 1
        else:
            rid = self._evict_locked()
        self._name_to_id[name] = rid
        self._id_to_name[rid] = name
        return rid

    def _evict_locked(self) -> int:
        for victim, rid in self._name_to_id.items():
            if rid not in self._pinned:
                del self._name_to_id[victim]
                self._id_to_name[rid] = None
                self._evicted_pending.append(rid)
                return rid
        raise RuntimeError("registry full and all rows pinned")

    def get_or_create(self, name: str) -> int:
        with self._lock:
            rid = self._name_to_id.get(name)
            if rid is None:
                rid = self._alloc_locked(name)
            else:
                self._name_to_id.move_to_end(name)
            return rid

    def lookup(self, name: str) -> Optional[int]:
        with self._lock:
            return self._name_to_id.get(name)

    def name_of(self, rid: int) -> Optional[str]:
        with self._lock:
            if 0 <= rid < self._capacity:
                return self._id_to_name[rid]
            return None

    def pin(self, name: str) -> int:
        """Allocate and protect from eviction (rule-referenced resources)."""
        with self._lock:
            rid = self._name_to_id.get(name)
            if rid is None:
                rid = self._alloc_locked(name)
            self._pinned.add(rid)
            return rid

    def unpin(self, name: str) -> None:
        with self._lock:
            rid = self._name_to_id.get(name)
            if rid is not None:
                self._pinned.discard(rid)

    def evict_name(self, name: str) -> bool:
        """Targeted eviction (the tiering ticker's proactive demotion):
        drop ``name``'s row to the free list and queue it for the next
        invalidation drain, exactly as an LRU overflow would. Refuses
        pinned or unknown names."""
        with self._lock:
            rid = self._name_to_id.get(name)
            if rid is None or rid in self._pinned:
                return False
            del self._name_to_id[name]
            self._id_to_name[rid] = None
            self._evicted_pending.append(rid)
            self._free.append(rid)
            return True

    def drain_evicted(self) -> List[int]:
        """Row ids recycled since the last drain; caller must invalidate their
        window state before the rows serve a new resource's decisions."""
        with self._lock:
            out = self._evicted_pending
            self._evicted_pending = []
            return out

    def items(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._name_to_id.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._name_to_id)


class ResourceRegistry(Registry):
    def __init__(self, capacity: int):
        super().__init__(capacity, reserved=(ENTRY_NODE_NAME,))


class OriginRegistry(Registry):
    """Origin "" (unknown caller) is id 0, parity with empty-origin checks."""

    DEFAULT_ORIGIN_ID = 0

    def __init__(self, capacity: int):
        super().__init__(capacity, reserved=("",))


def make_registry(capacity: int, reserved: Iterable[str] = ()):
    """Registry factory: the C++ table when it builds (``g++``, cached in
    ``_build/``), else the pure-Python implementation — identical
    semantics either way. ``SENTINEL_TPU_NATIVE=0`` forces Python; a
    failed build is logged once in the record log."""
    from sentinel_tpu_torch.native import NativeRegistry, native_available
    if native_available():
        return NativeRegistry(capacity, reserved)
    return Registry(capacity, reserved)


def make_resource_registry(capacity: int):
    return make_registry(capacity, reserved=(ENTRY_NODE_NAME,))


def make_origin_registry(capacity: int):
    return make_registry(capacity, reserved=("",))
