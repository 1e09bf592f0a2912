"""The global mesh: every process's logical shards in one ordered table.

Port of ``sentinel_tpu/multihost/mesh.py``. The JAX package's mesh is an
array of ``jax.devices()``, ordered by (process, local id); the port's
is the same order over the runtime's device table
(:meth:`MultihostRuntime.global_devices`): entry ``i`` is logical shard
``i`` — ``(process, local shard, torch.device)`` — so process *p* owns one
contiguous slab of the axis, matching the ``row // rows_per_shard``
ownership math in ``shard_math``. It pins the conventions in one place:

* the cluster token engine's axis is ``"shard"``
  (:mod:`sentinel_tpu_torch.parallel.cluster`), and
* the product engine's axis is ``"rows"``
  (``parallel/local_shard.py``'s ``MESH_AXIS`` in the JAX package).

The mesh also carries the collectives the engines run across it (the
namespace sum, the verdict gather, a row's broadcast, the row-sharded
engine's bit-view reads), on the backend the runtime chose, and counts
what they cost this process (:class:`CollectiveStats`). Geometry checks
route through :mod:`sentinel_tpu_torch.parallel.shard_math`.

:func:`row_sharding`, :func:`replicated` and :func:`repin_rows` place a
row-leading tensor tree's local slab on this process's device; as in the
reference, nothing consumes them. The row-sharded product engine takes
a ``GlobalMesh`` over the ``"rows"`` axis as its row blocks
(:func:`sentinel_tpu_torch.parallel.local_shard.as_row_mesh`): all of
them with one process, this process's entries with several.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence

import torch

from sentinel_tpu_torch.multihost import bootstrap
from sentinel_tpu_torch.multihost.bootstrap import ShardDevice
from sentinel_tpu_torch.parallel import shard_math

CLUSTER_AXIS = "shard"   # parallel/cluster.py mesh axis
LOCAL_AXIS = "rows"      # the row-sharded product engine's axis


class GlobalMesh:
    """1-D mesh over every logical shard of every participating process.

    ``devices[i]`` is shard ``i``; ``process_index`` is this process;
    ``backend`` the process group's (``None`` with one process)."""

    def __init__(self, devices: Sequence[ShardDevice], axis: str,
                 process_index: int = 0, backend: Optional[str] = None):
        self.devices = tuple(ShardDevice(*d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.axis_names = (axis,)
        self.process_index = process_index
        self.backend = backend
        self.process_count = len({d.process_index for d in self.devices})
        local = [d.device for d in self.devices
                 if d.process_index == process_index]
        if len(set(local)) > 1:
            raise ValueError(
                f"process {process_index}'s shards sit on several devices "
                f"{sorted(set(local))}: a process holds its shards on one")
        self.local_device = torch.device(local[0]) if local else None

        self.stats = CollectiveStats()

    @property
    def size(self) -> int:
        return len(self.devices)

    # -- collectives (every process calls each, in the same order) --------
    def _timed(self, fn, t: torch.Tensor, *args) -> torch.Tensor:
        if self.process_count == 1:
            return fn(t, *args, self.backend, self.local_device, 1)
        t0 = time.perf_counter()
        out = fn(t, *args, self.backend, self.local_device,
                 self.process_count)
        self.stats.add(t.numel() * t.element_size(),
                       time.perf_counter() - t0)
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the processes, on ``t``'s device."""
        return self._timed(bootstrap.all_reduce_sum, t)

    def all_reduce_bits(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the processes of ``t``'s integer bit view
        (:func:`~.bootstrap.all_reduce_bits`: exact where one process
        holds each element and the rest hold zero bits)."""
        return self._timed(bootstrap.all_reduce_bits, t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[P, *t.shape]`` in process order (the host under gloo)."""
        return self._timed(bootstrap.all_gather, t)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Process ``src``'s ``t``, on ``t``'s device."""
        return self._timed(bootstrap.broadcast, t, src)


class CollectiveStats:
    """What a mesh's collectives cost this process: calls, the bytes of
    its own contribution, and the host seconds inside them (a gloo
    collective on a card includes the copies to and from the host).
    One process issues none."""

    __slots__ = ("calls", "bytes", "seconds")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def add(self, nbytes: int, seconds: float) -> None:
        self.calls += 1
        self.bytes += int(nbytes)
        self.seconds += seconds

    def snapshot(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "ms": self.seconds * 1e3}


def global_mesh(axis: str = CLUSTER_AXIS,
                devices: Optional[Sequence[ShardDevice]] = None
                ) -> GlobalMesh:
    """1-D mesh over every shard of every participating process.

    ``devices`` defaults to the table of the runtime
    :func:`~.bootstrap.initialize` brought up; without one, a one-process
    mesh of one shard on the default device (the card)."""
    rt = bootstrap.active_runtime()
    if devices is None:
        if rt is not None:
            devices = rt.global_devices()
        else:
            from sentinel_tpu_torch.runtime import resolve_device
            devices = [ShardDevice(0, 0, str(resolve_device(None)))]
    pid = rt.process_index if rt is not None else 0
    backend = rt.backend if rt is not None and rt.process_count > 1 else None
    return GlobalMesh(devices, axis, pid, backend)


def spans_processes(mesh: GlobalMesh) -> bool:
    """True when the mesh crosses process boundaries (real multihost)."""
    return mesh.process_count > 1


def local_shard_indices(mesh: GlobalMesh) -> List[int]:
    """Positions along the (1-D) mesh axis owned by THIS process."""
    return [i for i, d in enumerate(mesh.devices)
            if d.process_index == mesh.process_index]


def validate_global_rows(name: str, dim: int, mesh: GlobalMesh) -> None:
    """Row dimension must divide over the global shard count."""
    shard_math.validate_divisible(name, dim, mesh.size)


class RowSharding(NamedTuple):
    """Axis 0 (rows) split into contiguous slabs over ``axis``."""

    mesh: GlobalMesh
    axis: str


class Replicated(NamedTuple):
    """Every process holds the whole value."""

    mesh: GlobalMesh


def row_sharding(mesh: GlobalMesh, axis: Optional[str] = None
                 ) -> RowSharding:
    """Shard axis 0 (rows) over the mesh axis."""
    return RowSharding(mesh, axis or mesh.axis_names[0])


def replicated(mesh: GlobalMesh) -> Replicated:
    return Replicated(mesh)


def repin_rows(tree, mesh: GlobalMesh, axis: Optional[str] = None):
    """Re-place every leaf of a row-leading tree (tensors or numpy arrays,
    in tuples, lists, NamedTuples or dicts) as this process's slab of the
    row sharding over the mesh's one axis, on its device: rows
    ``[lo·R/S, hi·R/S)`` for its shards ``[lo, hi)``. Works from any
    process; no collective."""
    shards = local_shard_indices(mesh)
    lo, hi = shards[0], shards[-1] + 1

    def place(x):
        t = torch.as_tensor(x)
        validate_global_rows("rows", t.shape[0], mesh)
        per = t.shape[0] // mesh.size
        return t[lo * per:hi * per].to(mesh.local_device)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        return None if x is None else place(x)

    return walk(tree)
