"""Control-plane dashboard (reference ``sentinel-dashboard``, SURVEY §2.5).

A standalone web app that discovers agents via heartbeats
(``/registry/machine``), polls their ``/metric`` command every few seconds
into an in-memory 5-minute ring, and offers rule CRUD that writes through to
every machine of an app over the agent command plane — the same
heartbeat → discovery → fetch → aggregate → chart and controller →
``SentinelApiClient`` → ``setRules`` flows as the reference
(``MachineRegistryController.java:36-45``, ``MetricFetcher.java:72-183``,
``client/SentinelApiClient.java:397-593``), rebuilt on the Python stdlib
HTTP stack with a single-file JS UI instead of Spring Boot + AngularJS.

The PyTorch port's own copy of ``sentinel_tpu/dashboard/__init__.py``.
"""

from sentinel_tpu_torch.dashboard.discovery import AppManagement, MachineInfo
from sentinel_tpu_torch.dashboard.repository import (
    InMemoryMetricsRepository, MetricEntity, RuleEntity, RuleRepository,
)
from sentinel_tpu_torch.dashboard.client import SentinelApiClient
from sentinel_tpu_torch.dashboard.fetcher import MetricFetcher
from sentinel_tpu_torch.dashboard.server import Dashboard, DashboardServer

__all__ = [
    "AppManagement", "MachineInfo",
    "InMemoryMetricsRepository", "MetricEntity",
    "RuleEntity", "RuleRepository",
    "SentinelApiClient", "MetricFetcher", "Dashboard", "DashboardServer",
]
