"""Row-sharding of the LOCAL engine over N row blocks (product mode).

Port of ``sentinel_tpu/parallel/local_shard.py``: the ``[R, B, E]``
window tensors, the thread gauges, the occupy ring and the RT histogram
split on the RESOURCE axis into N contiguous row blocks, each on its own
device; rules, batches, verdicts and the per-rule state are replicated
on the home device (``devices[0]``), where the step's replicated work
runs. Usage::

    mesh = local_mesh(devices=[torch.device("cuda:0")] * 8)  # 8 blocks
    sph = Sentinel(config, mesh=mesh)      # everything else is unchanged

The JAX package annotates its state with shardings and lets GSPMD
partition the fused step; PyTorch has no partitioner, so the port holds
each row-split field as a
:class:`~sentinel_tpu_torch.parallel.row_blocks.RowBlocks` and its
readers and writers work by owner (``stats/window.py``,
``engine/pipeline.py``): a per-lane read gathers from the lane's owner, a
write goes only to the owner's block (every other block sees the index
one past its end), a whole-table pass runs block by block. Verdicts and
state equal the one-block engine's bit for bit.

The port's mesh is a :class:`RowMesh`: ``axis_names == ("rows",)``,
``shape["rows"] == N`` and a tuple of ``torch.device`` s, which may
repeat — N blocks may share one card (or the CPU). A one-process
:class:`~sentinel_tpu_torch.multihost.mesh.GlobalMesh` over the
``"rows"`` axis is accepted as such a mesh.

A ``GlobalMesh`` over ``"rows"`` that spans processes (``global_mesh(
axis="rows")`` after ``multihost.initialize()``) gives each process the
blocks its entries name, all on its own device, in the rank-local form
of :class:`RowBlocks` (per-lane reads join the ranks with one
``all_reduce``; writes stay local). That mode is SPMD, as the JAX
runtime's: every process constructs the engine identically and replays
the same rule loads and batches at the same times (a ``ManualClock`` or
an explicit ``at_ms``), because every row read is a collective. Host
reads of a whole row-split table raise
:class:`~sentinel_tpu_torch.parallel.row_blocks.RemoteRowsError`, as the
reference's do.

Field map (state field → placement), the single source of truth:

==================  ==========================  =====================
state field          shape                       placement
==================  ==========================  =====================
second/minute        WindowState [R, B, ...]     row blocks
alt_second           WindowState [RA, B, ...]    row blocks
threads              int32[R]                    row blocks
alt_threads          int32[RA]                   row blocks
flow_dyn.occupied_*  [R, B+1]                    row blocks
flow_dyn (pacing)    [NF+1]                      replicated
breakers             [ND+1]                      replicated
param_dyn            [PK+1]                      replicated
custom               user DeviceSlot states      replicated
rt_hist              int32[R, HB] (or absent)    row blocks
==================  ==========================  =====================

A disabled minute window is a 1-row stub and stays replicated.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.parallel import shard_math
from sentinel_tpu_torch.parallel.row_blocks import RowBlocks

MESH_AXIS = "rows"

#: what a mesh over several processes raises without a process group
NO_PROCESS_GROUP = (
    "a \"rows\" mesh that spans processes needs the process group: call "
    "sentinel_tpu_torch.multihost.initialize() on every process first "
    "(and build the mesh with multihost.mesh.global_mesh(axis=\"rows\"))")


def as_device(device) -> torch.device:
    """``cuda`` without an index names the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class RowMesh:
    """A 1-D mesh of row blocks: block ``first + i`` lives on
    ``devices[i]`` (devices may repeat); the home device is
    ``devices[0]``. By default the blocks are all of the mesh's; over
    processes (``comm``, the spanning ``GlobalMesh``) ``devices`` are
    this process's blocks, ``first`` the global index of its first and
    ``total`` the global count."""

    axis_names = (MESH_AXIS,)

    def __init__(self, devices: Sequence, *, first: int = 0,
                 total: Optional[int] = None, comm=None):
        self.devices = tuple(as_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.first = int(first)
        self.total = len(self.devices) if total is None else int(total)
        self.comm = comm

    @property
    def shape(self):
        return {MESH_AXIS: self.total}

    @property
    def size(self) -> int:
        return self.total

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @property
    def process_count(self) -> int:
        return 1 if self.comm is None else self.comm.process_count

    @property
    def process_index(self) -> int:
        return 0 if self.comm is None else self.comm.process_index

    def blocks_of(self, t: torch.Tensor) -> RowBlocks:
        """``t``'s row blocks held here (a copy each)."""
        return RowBlocks.split(t, self.devices, self.home, first=self.first,
                               total=self.total, comm=self.comm)

    def _key(self):
        return (self.devices, self.first, self.total, id(self.comm))

    def __eq__(self, other) -> bool:
        return isinstance(other, RowMesh) and other._key() == self._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        if self.comm is None:
            return f"RowMesh({[str(d) for d in self.devices]})"
        return (f"RowMesh(process {self.process_index} of "
                f"{self.process_count}: blocks {self.first}.."
                f"{self.first + len(self.devices) - 1} of {self.total} on "
                f"{self.home})")


def visible_devices() -> Tuple[torch.device, ...]:
    """Every card, in index order, or the CPU without one."""
    if torch.cuda.is_available():
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device("cpu"),)


def local_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None) -> RowMesh:
    """The one way to build a local row-sharding mesh, so the axis name
    and device order can never drift apart. ``n_devices`` takes the first
    n visible devices (all when None); ``devices`` pins the blocks'
    devices explicitly, repeats allowed."""
    if devices is None:
        devices = visible_devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"local_mesh(n_devices={n_devices}) but only "
                    f"{len(devices)} devices visible — to hold several row "
                    f"blocks on one device, pass devices=[device] * "
                    f"{n_devices}")
            devices = devices[:n_devices]
    return RowMesh(devices)


def as_row_mesh(mesh) -> RowMesh:
    """``mesh`` as a :class:`RowMesh`: a RowMesh as it is; a one-process
    ``multihost.mesh.GlobalMesh`` over the ``"rows"`` axis by its
    devices; one that spans processes by this process's entries, on its
    device, with the mesh as the collective (a process without the
    process group raises RuntimeError, rather than hang or fall back to
    one process; processes must hold equal block counts). A mesh without
    the axis raises ValueError."""
    names = tuple(getattr(mesh, "axis_names", ()))
    if MESH_AXIS not in names:
        raise ValueError(
            f"local-engine mesh needs a {MESH_AXIS!r} axis; got {names} — "
            f"build it with local_mesh(...)")
    if isinstance(mesh, RowMesh):
        return mesh
    if getattr(mesh, "process_count", 1) == 1:
        return RowMesh([getattr(d, "device", d) for d in mesh.devices])
    import torch.distributed as dist
    if mesh.backend is None or not (dist.is_available()
                                    and dist.is_initialized()):
        raise RuntimeError(NO_PROCESS_GROUP)
    counts = collections.Counter(d.process_index for d in mesh.devices)
    if len(set(counts.values())) > 1:
        raise ValueError(
            f"every process must hold the same number of row blocks; got "
            f"{dict(sorted(counts.items()))}")
    from sentinel_tpu_torch.multihost.mesh import local_shard_indices
    mine = local_shard_indices(mesh)
    return RowMesh([mesh.local_device] * len(mine), first=mine[0],
                   total=mesh.size, comm=mesh)


def validate_mesh(spec, mesh) -> None:
    """Fail fast (with a fix) when the geometry can't split over the mesh."""
    m = as_row_mesh(mesh)
    n = m.shape[MESH_AXIS]
    shard_math.validate_divisible(
        "max_resources", spec.rows, n,
        f"round max_resources up to a multiple of {n}")
    shard_math.validate_divisible(
        "alt_rows", spec.alt_rows, n,
        f"round max_resources up to a multiple of {n} (alt_rows follows it)")


def shard_of_rows(n_rows: int, mesh, rows) -> np.ndarray:
    """Owner block per row id (int32, the shape of ``rows``) under the
    contiguous split; an unmeshed engine is one block. The tiering ticker
    spreads proactive demotions across blocks with it."""
    rows = np.asarray(rows)
    if mesh is None:
        return np.zeros(rows.shape, np.int32)
    per = n_rows // as_row_mesh(mesh).shape[MESH_AXIS]
    return (rows // per).astype(np.int32)


class Placement(NamedTuple):
    """Where a leaf lives: ``spec == (MESH_AXIS,)`` splits axis 0 into
    the mesh's row blocks, ``spec == ()`` keeps one copy on the home
    device (the JAX package's ``NamedSharding(mesh, P(...))``)."""

    mesh: RowMesh
    spec: Tuple[str, ...]


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested (Named)tuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, Placement):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, *xs)
                            for xs in zip(tree, *rest)))
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _leaves(tree) -> list:
    out = []
    _tree_map(lambda x: out.append(x), tree)
    return out


def state_shardings(spec, mesh, state):
    """A ``SentinelState``-shaped tree of :class:`Placement` per the field
    map above; ``state`` supplies the structure of the variable parts
    (custom slot states, an absent RT histogram)."""
    from sentinel_tpu_torch.engine.pipeline import SentinelState
    m = as_row_mesh(mesh)
    row = Placement(m, (MESH_AXIS,))
    rep = Placement(m, ())

    def rows_first(sub):
        return _tree_map(lambda _: row, sub)

    def replicated(sub):
        return _tree_map(lambda _: rep, sub)

    return SentinelState(
        second=rows_first(state.second),
        # minute is [R]-rowed when enabled, a 1-row stub when disabled
        minute=(rows_first(state.minute) if spec.minute
                else replicated(state.minute)),
        alt_second=rows_first(state.alt_second),
        threads=row,
        alt_threads=row,
        flow_dyn=state.flow_dyn._replace(
            latest_passed_ms=rep, stored_tokens=rep, last_filled_sec=rep,
            occupied_count=row, occupied_window=row),
        breakers=replicated(state.breakers),
        param_dyn=replicated(state.param_dyn),
        custom=replicated(state.custom),
        rt_hist=(row if state.rt_hist is not None else None),
    )


def verdict_shardings(mesh):
    from sentinel_tpu_torch.engine.pipeline import Verdicts
    rep = Placement(as_row_mesh(mesh), ())
    return Verdicts(allow=rep, reason=rep, wait_ms=rep, sf_overflow=rep)


def _place(x, p: Placement):
    m = p.mesh
    if p.spec == (MESH_AXIS,):
        if isinstance(x, RowBlocks):
            if (x.devices() != m.devices or x.first != m.first
                    or x.total != m.total):
                raise ValueError(f"{x} is not on the mesh's blocks")
            return x
        return m.blocks_of(torch.as_tensor(x))
    if isinstance(x, RowBlocks):
        raise ValueError("a replicated leaf arrived as row blocks")
    return torch.as_tensor(x).to(m.home)


def pin_state(state, shardings):
    """Place (or re-place) every state leaf on its placement — at init and
    whenever host code rebuilt a leaf (a rule reload's fresh tables, a
    window-geometry change, a snapshot restore), so a fresh whole tensor
    never drops the engine back to one block. Leaves already in place
    stay as they are."""
    return _tree_map(_place, state, shardings)


def shardings_for(spec, mesh, state):
    """→ ``(state_shardings, verdict_shardings)``, or ``(None, None)``
    without a mesh; the one call the runtime makes."""
    if mesh is None:
        return None, None
    validate_mesh(spec, mesh)
    return state_shardings(spec, mesh, state), verdict_shardings(mesh)


@functools.lru_cache(maxsize=8)
def batch_shardings(mesh) -> Tuple[Placement, Placement]:
    """→ the (batch-axis, replicated) placement pair of event columns."""
    m = as_row_mesh(mesh)
    return Placement(m, (MESH_AXIS,)), Placement(m, ())


def batch_sharding(mesh, x) -> Placement:
    """The reference's placement rule for ONE event column: the leading
    (event) axis partitions when it divides over the mesh, else the
    column is replicated; trailing (param-lane) axes stay whole. The
    port's step reads every column on the home device, so this is the
    layout the reference would pick, recorded for artifacts."""
    sharded, rep = batch_shardings(mesh)
    n = sharded.mesh.shape[MESH_AXIS]
    return sharded if (x.ndim >= 1 and x.shape[0] % n == 0) else rep


def place_batch(batch, mesh):
    """Every present column of an ``EntryBatch`` / ``ExitBatch`` on the
    mesh's home device, where the step reads it (values unchanged; a
    column already there is not copied)."""
    home = as_row_mesh(mesh).home
    return type(batch)(*(None if x is None else torch.as_tensor(x).to(home)
                         for x in batch))


def topk_layout(spec, mesh=None) -> Tuple[int, int]:
    """→ ``(n_blocks, rows_per_block)`` for the telemetry top-K merge
    (obs/telemetry.py): block ``i`` owns the global rows
    ``[i*rows_per_block, (i+1)*rows_per_block)``, so a local top-k index
    maps to its global row as ``local + i * rows_per_block``."""
    if mesh is None:
        return 1, spec.rows
    n = int(as_row_mesh(mesh).shape[MESH_AXIS])
    return n, spec.rows // n


def mesh_topology(spec, mesh, state_sh=None) -> dict:
    """Artifact-ready description of the serving layout: device count,
    axis name, rows per block and — when the placement tree is given —
    how many state leaves split and how many are replicated."""
    if mesh is None:
        return {"n_devices": 1, "axis": None,
                "rows_per_device": spec.rows, "sharded": False}
    m = as_row_mesh(mesh)
    n = m.shape[MESH_AXIS]
    out = {"n_devices": int(n), "axis": MESH_AXIS,
           "rows_per_device": spec.rows // int(n), "sharded": True,
           "multihost": m.process_count > 1}
    if m.process_count > 1:
        out["process_count"] = m.process_count
        out["local_blocks"] = len(m.devices)
    if state_sh is not None:
        leaves = _leaves(state_sh)
        n_rows = sum(1 for p in leaves if p.spec == (MESH_AXIS,))
        out["state_leaves_sharded"] = n_rows
        out["state_leaves_replicated"] = len(leaves) - n_rows
    return out
