"""Machine discovery from heartbeats (reference
``sentinel-dashboard/.../discovery/{AppManagement,SimpleMachineDiscovery}.java``).

Apps are keyed by name; each machine is keyed by ``(ip, port)`` and carries
the timestamp of its last heartbeat. Health = heartbeat age below a cutoff
(the reference UI greys machines out after 60s and the metric fetcher skips
them — ``AppInfo.isHealthy`` analog).

The PyTorch port's own copy of ``sentinel_tpu/dashboard/discovery.py``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

HEALTH_TIMEOUT_MS = 60_000


@dataclasses.dataclass
class MachineInfo:
    app: str = ""
    hostname: str = ""
    ip: str = ""
    port: int = 8719
    app_type: int = 0
    version: str = ""               # agent framework version
    heartbeat_version: int = 0      # agent-side timestamp from the beat
    last_heartbeat_ms: int = 0      # dashboard-side receive time
    exporter_port: int = 0          # Prometheus scrape port; 0 = none

    def key(self) -> str:
        return f"{self.ip}:{self.port}"

    def healthy(self, now_ms: Optional[int] = None,
                timeout_ms: int = HEALTH_TIMEOUT_MS) -> bool:
        now = int(time.time() * 1000) if now_ms is None else now_ms
        return now - self.last_heartbeat_ms < timeout_ms

    def to_dict(self, now_ms: Optional[int] = None) -> dict:
        return {
            "app": self.app, "hostname": self.hostname, "ip": self.ip,
            "port": self.port, "appType": self.app_type,
            "version": self.version,
            "heartbeatVersion": self.heartbeat_version,
            "lastHeartbeat": self.last_heartbeat_ms,
            "exporterPort": self.exporter_port,
            "healthy": self.healthy(now_ms),
        }


class AppManagement:
    """app name → {machine key → MachineInfo}; thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._apps: Dict[str, Dict[str, MachineInfo]] = {}

    def register(self, machine: MachineInfo) -> None:
        with self._lock:
            self._apps.setdefault(machine.app, {})[machine.key()] = machine

    def app_names(self) -> List[str]:
        with self._lock:
            return sorted(self._apps)

    def machines(self, app: str) -> List[MachineInfo]:
        with self._lock:
            return list(self._apps.get(app, {}).values())

    def healthy_machines(self, app: str,
                         now_ms: Optional[int] = None) -> List[MachineInfo]:
        return [m for m in self.machines(app) if m.healthy(now_ms)]

    def first_healthy(self, app: str,
                      now_ms: Optional[int] = None) -> Optional[MachineInfo]:
        ms = self.healthy_machines(app, now_ms)
        return ms[0] if ms else None

    def get_machine(self, app: str, ip: str, port: int) -> Optional[MachineInfo]:
        with self._lock:
            return self._apps.get(app, {}).get(f"{ip}:{port}")

    def remove_machine(self, app: str, ip: str, port: int) -> bool:
        """``AppManagement.removeMachine`` (AppController machine/remove
        flow); drops the app entirely when its last machine goes."""
        with self._lock:
            machines = self._apps.get(app)
            if machines is None or machines.pop(f"{ip}:{port}", None) is None:
                return False
            if not machines:
                self._apps.pop(app, None)
            return True

    def remove_app(self, app: str) -> None:
        with self._lock:
            self._apps.pop(app, None)
