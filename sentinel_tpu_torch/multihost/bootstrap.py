"""Multi-process bring-up: ``torch.distributed.init_process_group`` with
guardrails.

Port of ``sentinel_tpu/multihost/bootstrap.py``. One process a rank, one
of them doubling as the coordinator (rank 0, whose TCP store the others
join). Config comes from the environment (the ``SENTINEL_*`` variables
:func:`MultihostConfig.from_env` reads — what
:mod:`~sentinel_tpu_torch.multihost.launch` exports into workers) or is
built programmatically; :func:`initialize` picks the backend and the
device by one rule (:func:`select_backend`), joins the process group and
hands back a :class:`MultihostRuntime` that tears it down on
``close()``/``with``-exit.

The backend rule: ``gloo`` on the CPU platform and whenever the ranks on
a host outnumber its cards (NCCL refuses two ranks on one GPU); ``nccl``
when each rank has a card of its own. The device is
``cuda:(process_id % device_count)``, or ``cpu`` on the CPU platform.
The rule is applied before the group exists: no backend is tried and
then swapped for another after a failure.

``local_devices`` keeps the reference's meaning — the logical shards
this process holds (all on its one device; the JAX package's virtual CPU
devices) — and every process learns every other's count and device once,
at bring-up (:meth:`MultihostRuntime.global_devices`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Mapping, NamedTuple, Optional, Tuple

import torch

_ENV_COORDINATOR = "SENTINEL_COORDINATOR"
_ENV_NUM_PROCESSES = "SENTINEL_NUM_PROCESSES"
_ENV_PROCESS_ID = "SENTINEL_PROCESS_ID"
_ENV_LOCAL_DEVICES = "SENTINEL_LOCAL_DEVICES"
_ENV_PLATFORM = "SENTINEL_MH_PLATFORM"
#: ranks on this host (torchrun's name); :func:`~.launch.launch` sets it,
#: and without it every rank is taken to share one host
_ENV_LOCAL_WORLD = "LOCAL_WORLD_SIZE"

#: the platform when the config names none: the card, as
#: ``runtime.resolve_device`` makes it
DEFAULT_PLATFORM = "cuda"

_active: Optional["MultihostRuntime"] = None


@dataclasses.dataclass(frozen=True)
class MultihostConfig:
    """Static multi-process topology for one participating process."""

    coordinator: str               # "host:port" every process can reach
    num_processes: int
    process_id: int
    local_devices: Optional[int] = None   # logical shards this process holds
    platform: Optional[str] = DEFAULT_PLATFORM   # "cuda" | "cpu"

    def __post_init__(self):
        if self.num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if not (0 <= self.process_id < self.num_processes):
            raise ValueError(
                f"process_id {self.process_id} outside "
                f"[0, {self.num_processes})")
        if ":" not in self.coordinator:
            raise ValueError(
                f"coordinator must be host:port, got {self.coordinator!r}")

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None,
                 ) -> "MultihostConfig":
        """Build from ``SENTINEL_COORDINATOR`` / ``SENTINEL_NUM_PROCESSES``
        / ``SENTINEL_PROCESS_ID`` (+ optional ``SENTINEL_LOCAL_DEVICES``,
        ``SENTINEL_MH_PLATFORM``) — the contract
        :func:`sentinel_tpu_torch.multihost.launch.launch` exports to
        workers."""
        env = os.environ if env is None else env
        missing = [k for k in
                   (_ENV_COORDINATOR, _ENV_NUM_PROCESSES, _ENV_PROCESS_ID)
                   if not env.get(k)]
        if missing:
            raise KeyError(
                "multihost bootstrap env incomplete; missing "
                + ", ".join(missing))
        local = env.get(_ENV_LOCAL_DEVICES)
        return cls(
            coordinator=env[_ENV_COORDINATOR],
            num_processes=int(env[_ENV_NUM_PROCESSES]),
            process_id=int(env[_ENV_PROCESS_ID]),
            local_devices=int(local) if local else None,
            platform=env.get(_ENV_PLATFORM, DEFAULT_PLATFORM) or None)


class ShardDevice(NamedTuple):
    """One entry of the global device table: logical shard
    ``local_index`` of process ``process_index``, held on ``device``."""

    process_index: int
    local_index: int
    device: str


def select_backend(platform: Optional[str], process_id: int,
                   local_processes: int, device_count: int
                   ) -> Tuple[str, str]:
    """The one backend and device rule → ``(backend, device)``.

    ``gloo`` and ``cpu`` on the CPU platform; on the card the device is
    ``cuda:(process_id % device_count)`` and the backend ``nccl`` only
    when each of the host's ``local_processes`` ranks has a card of its
    own, else ``gloo`` (NCCL refuses two ranks on one GPU). No card on
    the card platform raises: the CPU is used only when asked for."""
    platform = platform or DEFAULT_PLATFORM
    if platform == "cpu":
        return "gloo", "cpu"
    if platform != "cuda":
        raise ValueError(
            f"platform must be 'cuda' or 'cpu', got {platform!r}")
    if device_count < 1:
        raise RuntimeError(
            "no CUDA device available: the multihost runtime runs on the "
            "GPU; set SENTINEL_MH_PLATFORM=cpu to run on the CPU explicitly")
    device = f"cuda:{process_id % device_count}"
    backend = "nccl" if local_processes <= device_count else "gloo"
    return backend, device


class MultihostRuntime:
    """Live handle for an initialized multi-process runtime."""

    def __init__(self, config: MultihostConfig, backend: str, device: str,
                 topology: List[Tuple[int, str]]):
        self.config = config
        self.backend = backend
        self.device = torch.device(device)
        #: per process: (logical shards held, device)
        self._topology = topology
        self._closed = False

    @property
    def process_index(self) -> int:
        return self.config.process_id

    @property
    def process_count(self) -> int:
        return self.config.num_processes

    @property
    def is_coordinator(self) -> bool:
        return self.config.is_coordinator

    def local_devices(self) -> List[ShardDevice]:
        """The logical shards this process holds."""
        return [d for d in self.global_devices()
                if d.process_index == self.process_index]

    def global_devices(self) -> List[ShardDevice]:
        """Every process's shards, ordered by (process, local index)."""
        return [ShardDevice(p, i, dev)
                for p, (n, dev) in enumerate(self._topology)
                for i in range(n)]

    def barrier(self, name: str = "sentinel-mh") -> None:
        """Block until every process reaches the same point (``name`` is
        for the reader: a process group's barrier has no tag)."""
        if self.process_count > 1:
            barrier(self.backend, self.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's ``t`` stacked in process order (collective)."""
        return all_gather(t, self.backend, self.device, self.process_count)

    def close(self) -> None:
        """Leave the process group (idempotent)."""
        global _active
        if self._closed:
            return
        self._closed = True
        if _active is self:
            _active = None
        if self.process_count > 1:
            import torch.distributed as dist
            dist.destroy_process_group()

    def __enter__(self) -> "MultihostRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def active_runtime() -> Optional[MultihostRuntime]:
    """The live runtime from a prior :func:`initialize`, if any."""
    return _active


# ---------------------------------------------------------------------------
# Collectives. gloo moves host memory and NCCL device memory: a tensor is
# put where the backend reads it before the call — by the backend the rule
# chose, never after a failed attempt. Under gloo a CUDA tensor is copied
# to the host first (a synchronous copy: it waits for the work that wrote
# the tensor). gloo would take the CUDA tensor itself (it stages through
# the host internally), but its result would then land back on the card,
# and the verdict readback wants it on the host.
# ---------------------------------------------------------------------------

def _wire(t: torch.Tensor, backend: str, device: torch.device
          ) -> torch.Tensor:
    if backend == "nccl":
        return t.to(device).contiguous()
    return t.cpu().contiguous()


def all_gather(t: torch.Tensor, backend: str, device: torch.device,
               world: int) -> torch.Tensor:
    """``[world, *t.shape]``: every process's ``t`` in process order, on
    the wire's device (the host for gloo). One process: ``t[None]``."""
    if world == 1:
        return t[None]
    import torch.distributed as dist
    w = _wire(t, backend, device)
    out = [torch.empty_like(w) for _ in range(world)]
    dist.all_gather(out, w)
    return torch.stack(out)


def all_reduce_sum(t: torch.Tensor, backend: str, device: torch.device,
                   world: int) -> torch.Tensor:
    """Elementwise sum of every process's ``t``, on ``t``'s device."""
    if world == 1:
        return t
    import torch.distributed as dist
    w = _wire(t, backend, device)
    dist.all_reduce(w)
    return w.to(t.device)


#: the integer view each dtype is summed through by :func:`all_reduce_bits`
_BIT_VIEWS = {torch.float32: torch.int32, torch.float64: torch.int64,
              torch.int32: torch.int32, torch.int64: torch.int64}


def all_reduce_bits(t: torch.Tensor, backend: str, device: torch.device,
                    world: int) -> torch.Tensor:
    """Elementwise sum of every process's ``t`` taken over its integer
    bit view, on ``t``'s device: exact where at most one process holds a
    non-zero element at each position (the others all zero bits). A
    float sum would turn the one holder's ``-0.0`` into ``+0.0`` and
    need not keep a NaN's payload; the bit sum returns the holder's
    bits. A bool travels as int32."""
    if t.dtype == torch.bool:
        return all_reduce_sum(t.to(torch.int32), backend, device,
                              world) != 0
    view = _BIT_VIEWS.get(t.dtype)
    if view is None:
        raise TypeError(f"no integer bit view for {t.dtype}")
    bits = t.contiguous().view(view)
    return all_reduce_sum(bits, backend, device, world).view(t.dtype)


def broadcast(t: torch.Tensor, src: int, backend: str,
              device: torch.device, world: int) -> torch.Tensor:
    """Process ``src``'s ``t`` on every process, on ``t``'s device."""
    if world == 1:
        return t
    import torch.distributed as dist
    w = _wire(t, backend, device)
    dist.broadcast(w, src)
    return w.to(t.device)


def barrier(backend: str, device: torch.device) -> None:
    import torch.distributed as dist
    if backend == "nccl":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()


def initialize(config: Optional[MultihostConfig] = None) -> MultihostRuntime:
    """Bring this process into the multi-process group.

    ``config=None`` reads :func:`MultihostConfig.from_env`. The backend and
    device come from :func:`select_backend` (the host's rank count from
    ``LOCAL_WORLD_SIZE``, else every rank on one host), the card is made
    current before the group forms, and the group is joined with
    ``init_method="tcp://<coordinator>"``. Then one ``all_gather_object``
    tells every process every other's shard count and device.

    Single-process configs (``num_processes == 1``) skip the handshake
    entirely, so the same worker code runs 1-process reference jobs and
    N-process jobs unchanged.
    """
    global _active
    if _active is not None:
        raise RuntimeError(
            "multihost runtime already initialized; close() it first "
            "(one process group per process)")
    if config is None:
        config = MultihostConfig.from_env()
    local_world = int(os.environ.get(_ENV_LOCAL_WORLD)
                      or config.num_processes)
    backend, device = select_backend(
        config.platform, config.process_id, local_world,
        torch.cuda.device_count() if config.platform != "cpu" else 0)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    shards = config.local_devices or 1
    topology = [(shards, device)]
    if config.num_processes > 1:
        import torch.distributed as dist
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{config.coordinator}",
            rank=config.process_id, world_size=config.num_processes)
        topology = [None] * config.num_processes
        dist.all_gather_object(topology, (shards, device))
        topology = [tuple(t) for t in topology]
    runtime = MultihostRuntime(config, backend, device, topology)
    _active = runtime
    return runtime
