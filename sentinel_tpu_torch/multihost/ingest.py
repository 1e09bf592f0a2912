"""Host-local batch ingestion over the multi-process cluster engine.

Port of ``sentinel_tpu/multihost/ingest.py``. Every process calls
:meth:`MultihostIngest.request_tokens` with the SAME request *metadata*
(flow ids, acquire counts, priorities — the cheap, shared part of the
stream) for the same step; each process keeps request *payload lanes*
only for the shards it holds (``shard_math.mask_to_local_lanes``; the
engine copies only its own block to its device). The step then runs on
every process's block: per-flow admission stays shard-local, the
namespace request-limiter combines with one ``all_reduce``, and the
verdicts come back through one ``all_gather`` — identical to the
single-process result over the same stream (held by
``tests/test_torch_multihost.py``).

SPMD rules the caller must keep (the engine can't check them for you):

* every process participates in every ``request_tokens`` call, in the
  same order, with the same ``now_ms``;
* rule loads / connected counts / namespace limits are replayed
  identically on every process BEFORE the step that should see them;
* the param-flow path is not wired for multihost —
  :meth:`MultihostIngest.request_params` raises ``NotImplementedError``
  at the call site, as the reference's does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from sentinel_tpu_torch.multihost import mesh as mh_mesh
from sentinel_tpu_torch.parallel import shard_math
from sentinel_tpu_torch.parallel.cluster import (
    STATUS_BAD_REQUEST, STATUS_FAIL, STATUS_NO_RULE_EXISTS, ClusterEngine,
)


class MultihostIngest:
    """Drives :meth:`ClusterEngine.step_routed` collectively across
    processes."""

    def __init__(self, engine: ClusterEngine):
        self.engine = engine
        self.local_shards = mh_mesh.local_shard_indices(engine.mesh)
        self.multiprocess = mh_mesh.spans_processes(engine.mesh)

    def request_tokens(self, flow_ids: Sequence[int],
                       acquire: Sequence[int],
                       prioritized: Optional[Sequence[bool]] = None,
                       *, now_ms: int) -> List[Tuple[int, int, int]]:
        """Collective ``requestToken`` step → aligned
        ``(status, wait_ms, remaining)`` per request on every process."""
        eng = self.engine
        ids = np.asarray(flow_ids)
        if ids.dtype.kind not in "iu":
            ids = np.asarray([int(f) for f in flow_ids], np.int64)
        with eng._lock:
            rowg = eng.rows_for_flows(ids)
            if rowg is None:
                # no dense lookup (sparse ids) — resolve through the dict;
                # identical on every process because rule loads are replayed
                rowg = np.asarray(
                    [eng._flow_to_row.get(int(f), -1) for f in ids],
                    np.int64)
            lanes, plan = shard_math.route_requests(
                rowg, acquire, prioritized,
                eng.spec.n_shards, eng.spec.flows_per_shard,
                status_fail=STATUS_FAIL, status_bad=STATUS_BAD_REQUEST,
                status_no_rule=STATUS_NO_RULE_EXISTS)
            if lanes is None:
                return [(int(s), 0, 0) for s in plan.status0]
            if self.multiprocess:
                lanes = shard_math.mask_to_local_lanes(
                    lanes, plan, self.local_shards)
            verdicts = eng.step_routed(
                lanes.rows, lanes.acquire, lanes.prioritized, lanes.valid,
                lanes.lanes, now_ms=now_ms)
            return eng._gather_results_vec(verdicts, plan, lanes.lanes)

    def request_params(self, *args, **kwargs):
        """NOT wired for multihost, as in the reference. The param-flow
        step keys its table by host-hashed param values and tracks hot
        values in process-local tables; routing them through the sharded
        step without a cross-process agreement would diverge per
        process. Single-process callers use
        ``ClusterEngine.request_param_tokens`` directly."""
        raise NotImplementedError(
            "param-flow (request_params) is not wired for multihost: "
            "param intern tables are process-local and would diverge "
            "across hosts (as in the reference)")
