"""Serving front end: the async ingest tier above the dispatch pipeline.

Port of ``sentinel_tpu/frontend/``:

* frontend/batcher.py — :class:`AdaptiveBatcher`, the deadline-driven
  adaptive batching loop (flush at ``min(B_max, oldest-deadline)``) with
  per-request future fan-out over the
  :class:`~sentinel_tpu_torch.serving.DispatchPipeline`;
* frontend/server.py — the aiohttp HTTP endpoint and app factory (POST an
  entry, get a verdict); it imports aiohttp, so nothing here imports it;
* frontend/workloads.py — the deterministic seeded workload zoo (steady,
  diurnal, flash crowd, Zipf hot keys, priority mix, slow consumer).
"""

from sentinel_tpu_torch.frontend.batcher import (
    FLUSH_DEADLINE, FLUSH_FULL, FLUSH_IDLE, FRONTEND_BATCH_ENV,
    FRONTEND_BUDGET_ENV, FRONTEND_DEADLINE_ENV, FRONTEND_IDLE_ENV,
    FRONTEND_QUEUE_ENV, AdaptiveBatcher, FrontendClosed, IngestOverload,
    IngestQueue, RequestVerdict, frontend_batch_max, frontend_budget_ms,
    frontend_deadline_ms, frontend_idle_ms, frontend_queue_max,
)

__all__ = [
    "AdaptiveBatcher", "IngestQueue", "RequestVerdict",
    "IngestOverload", "FrontendClosed",
    "FLUSH_FULL", "FLUSH_DEADLINE", "FLUSH_IDLE",
    "FRONTEND_BATCH_ENV", "FRONTEND_DEADLINE_ENV", "FRONTEND_BUDGET_ENV",
    "FRONTEND_IDLE_ENV", "FRONTEND_QUEUE_ENV",
    "frontend_batch_max", "frontend_deadline_ms", "frontend_budget_ms",
    "frontend_idle_ms", "frontend_queue_max",
]
