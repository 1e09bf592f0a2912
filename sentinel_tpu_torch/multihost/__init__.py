"""Multi-process runtime: real multi-process operation for the cluster
token engine on ``torch.distributed``.

Port of ``sentinel_tpu/multihost``. Takes the cluster token engine
(:mod:`sentinel_tpu_torch.parallel.cluster`) from one process to N
coordinated processes, each holding a contiguous block of its shards —
the reference system's own deployment shape (N processes speaking to
shared state) — and the row-sharded product engine
(:mod:`sentinel_tpu_torch.parallel.local_shard`) from N row blocks in
one process to a ``"rows"`` mesh over N processes, each holding its own
blocks (``Sentinel(mesh=mesh.global_mesh(axis="rows"))``, SPMD).

Pieces:

* :mod:`~sentinel_tpu_torch.multihost.bootstrap` — process-group
  bring-up/teardown from env vars or programmatic config, the backend
  and device rule, and the collectives on the chosen backend;
* :mod:`~sentinel_tpu_torch.multihost.mesh` — the global mesh over every
  process's logical shards and its collectives (counted in
  ``GlobalMesh.stats``), plus row-layout re-pinning helpers;
* :mod:`~sentinel_tpu_torch.multihost.ingest` — host-local batch
  ingestion driving :meth:`ClusterEngine.step_routed` collectively;
* :mod:`~sentinel_tpu_torch.multihost.launch` — N-process spawner on one
  machine (the card by default, the CPU when asked), so all of the above
  is testable in CI without a card;
* :mod:`~sentinel_tpu_torch.multihost.obs_agg` — collective gather + sum
  of each process's telemetry counters (obs/) at the coordinator.
"""

from sentinel_tpu_torch.multihost.bootstrap import (
    MultihostConfig, MultihostRuntime, active_runtime, initialize,
)
from sentinel_tpu_torch.multihost.ingest import MultihostIngest
from sentinel_tpu_torch.multihost.launch import LaunchError, free_port, launch
from sentinel_tpu_torch.multihost import mesh
from sentinel_tpu_torch.multihost.obs_agg import (
    aggregate_counters, coordinator_report,
)

__all__ = [
    "MultihostConfig", "MultihostRuntime", "MultihostIngest",
    "LaunchError", "active_runtime", "aggregate_counters",
    "coordinator_report", "free_port", "initialize", "launch", "mesh",
]
