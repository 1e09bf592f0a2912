"""Row-ownership layout of the device state.

Port of the parts of ``sentinel_tpu/parallel/local_shard.py`` the
telemetry tick and the tiering ticker need. The port runs one engine on one GPU: its state is one shard
that owns every row. Row-sharded engines over several GPUs are not ported
yet (ROADMAP A11's second half; the cluster token engine's multi-process
leg is :mod:`sentinel_tpu_torch.multihost`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

MESH_NOT_PORTED = ("meshes (row-sharded multi-GPU engines) are not ported "
                   "yet: ROADMAP A11, second half")


def topk_layout(spec, mesh=None) -> Tuple[int, int]:
    """→ ``(n_shards, rows_per_shard)`` for the telemetry top-K: shard
    ``i`` owns the global rows ``[i*rows_per_shard, (i+1)*rows_per_shard)``.
    One device: ``(1, spec.rows)``; a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    return 1, spec.rows


def shard_of_rows(n_rows: int, mesh, rows) -> np.ndarray:
    """Owner shard per row id (int32, the shape of ``rows``): the tiering
    ticker spreads proactive demotions across shards with it. One
    device: every row is in shard 0; a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    return np.zeros(np.asarray(rows).shape, np.int32)
