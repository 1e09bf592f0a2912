"""Heartbeat sender (reference
``sentinel-transport-simple-http/.../SimpleHttpHeartbeatSender.java`` +
``HeartbeatMessage.java``).

Periodically POSTs the agent's identity to the dashboard's
``/registry/machine`` endpoint so it discovers live machines. Message fields
mirror ``HeartbeatMessage.java:1-30``: hostname, ip, transport port, app
name/type, framework + spec version, current time.

The PyTorch port's own copy of ``sentinel_tpu/transport/heartbeat.py``.
"""

from __future__ import annotations

import socket
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from sentinel_tpu_torch import __version__

HEARTBEAT_PATH = "/registry/machine"   # TransportConfig.java:41
DEFAULT_INTERVAL_MS = 10_000


def _local_ip() -> str:
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.254.254.254", 1))   # no packets actually sent
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"


class HeartbeatSender:
    def __init__(self, dashboard_addr: str, *, app_name: str,
                 app_type: int = 0, api_port: int = 8719,
                 interval_ms: int = DEFAULT_INTERVAL_MS,
                 clock=None, exporter_port: Optional[int] = None):
        """``dashboard_addr`` is ``host:port`` (csp.sentinel.dashboard.server).
        ``exporter_port`` — when the app serves Prometheus ``/metrics``
        (metrics/exporter.py), advertise that port too so scrape targets
        can be discovered from dashboard machine discovery."""
        self.dashboard_addr = dashboard_addr
        self.app_name = app_name
        self.app_type = app_type
        self.api_port = api_port
        self.exporter_port = exporter_port
        self.interval_ms = interval_ms
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_ok: bool = False
        self.sent_count = 0

    def message(self) -> dict:
        import time
        now = (self._clock.now_ms() if self._clock is not None
               else int(time.time() * 1000))
        msg = {
            "hostname": socket.gethostname(),
            "ip": _local_ip(),
            "port": str(self.api_port),
            "app": self.app_name,
            "app_type": str(self.app_type),
            "v": __version__,                    # heartbeat client version
            "version": str(now),
        }
        if self.exporter_port:
            msg["exporterPort"] = str(self.exporter_port)
        return msg

    def send_once(self, timeout: float = 3.0) -> bool:
        url = f"http://{self.dashboard_addr}{HEARTBEAT_PATH}"
        data = urllib.parse.urlencode(self.message()).encode("utf-8")
        try:
            with urllib.request.urlopen(url, data=data, timeout=timeout) as r:
                self.last_ok = 200 <= r.status < 300
        except (urllib.error.URLError, OSError):
            self.last_ok = False
        self.sent_count += 1
        return self.last_ok

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            # first beat inside the thread: start() must not block app
            # startup on an unreachable dashboard (connect can hang ~3 s)
            self.send_once()
            while not self._stop.wait(self.interval_ms / 1000.0):
                self.send_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="sentinel-heartbeat")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None
