"""Metric file pipeline: per-second aggregation → rolling files + search
(the port's copy of ``sentinel_tpu/metrics/``; the on-disk format is the
reference's byte for byte)."""

from sentinel_tpu_torch.metrics.node import (
    TOTAL_IN_RESOURCE_NAME,
    TYPE_CACHE,
    TYPE_COMMON,
    TYPE_DB,
    TYPE_GATEWAY,
    TYPE_RPC,
    TYPE_WEB,
    MetricNode,
)
from sentinel_tpu_torch.metrics.searcher import MetricSearcher
from sentinel_tpu_torch.metrics.timer import MetricTimerListener
from sentinel_tpu_torch.metrics.writer import (
    MetricWriter, form_metric_file_name,
)

__all__ = [
    "MetricNode", "MetricWriter", "MetricSearcher", "MetricTimerListener",
    "form_metric_file_name", "TOTAL_IN_RESOURCE_NAME",
    "TYPE_COMMON", "TYPE_WEB", "TYPE_RPC", "TYPE_GATEWAY", "TYPE_DB",
    "TYPE_CACHE",
]
