"""Cluster mode coordinator: turn the dashboard's mode flips into real
client/server lifecycles (reference ``ClusterStateManager`` +
``SentinelDefaultTokenServer`` embedded mode + ``DefaultClusterTokenClient``
wiring, SURVEY §2.3/§2.8.4: "any instance can become the token server").

Wire into the command plane::

    coord = ClusterCoordinator(sentinel)
    rt = start_transport(sentinel, ...)
    rt.cluster_state.add_observer(coord.on_mode_change)

Mode transitions:

- ``CLIENT`` (0): connect a :class:`ClusterTokenClient` to the configured
  server address and install it as the Sentinel's token service.
- ``SERVER`` (1): start an embedded :class:`ClusterTokenServer` (own
  engine) and install a loopback token service that talks to the local
  engine directly (the reference's ``EmbeddedClusterTokenServerProvider`` —
  the server instance serves its own requests in-process, no socket hop).
- ``NOT_STARTED`` (-1): stop whichever is running, uninstall.

The PyTorch port of ``sentinel_tpu/cluster/coordinator.py``: the embedded
server's engine lives on the Sentinel's device.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from sentinel_tpu_torch.core.logs import record_log

CLUSTER_NOT_STARTED = -1
CLUSTER_CLIENT = 0
CLUSTER_SERVER = 1


@dataclasses.dataclass
class EmbeddedTokenResult:
    status: int
    wait_ms: int = 0
    remaining: int = 0


class _EmbeddedTokenService:
    """Loopback TokenService over a local engine (no socket round-trip)."""

    def __init__(self, engine, clock=None):
        self.engine = engine
        self._clock = clock

    def _now(self) -> int:
        if self._clock is not None:
            return self._clock.now_ms()
        import time
        return int(time.time() * 1000)

    def request_token(self, flow_id: int, count: int = 1,
                      prioritized: bool = False):
        status, wait, remaining = self.engine.request_tokens(
            [flow_id], [count], [prioritized], now_ms=self._now())[0]
        return EmbeddedTokenResult(status=status, wait_ms=wait,
                                   remaining=remaining)

    def request_param_token(self, flow_id: int, count: int, params):
        status, wait, remaining = self.engine.request_param_tokens(
            [flow_id], [count], [list(params)], now_ms=self._now())[0]
        return EmbeddedTokenResult(status=status, wait_ms=wait,
                                   remaining=remaining)

    # batched surface: the runtime's batch tier funnels a whole entry_batch
    # worth of token requests into ONE engine step instead of a device
    # round-trip per event (the reference has no analog — its token RPCs
    # are per-call — but the engine is batched end-to-end here)
    def request_tokens_batch(self, items):
        """items: [(flow_id, count, prioritized)] → aligned results."""
        res = self.engine.request_tokens(
            [i[0] for i in items], [i[1] for i in items],
            [bool(i[2]) for i in items], now_ms=self._now())
        return [EmbeddedTokenResult(status=s, wait_ms=w, remaining=r)
                for (s, w, r) in res]

    def request_param_tokens_batch(self, items):
        """items: [(flow_id, count, params)] → aligned results."""
        res = self.engine.request_param_tokens(
            [i[0] for i in items], [i[1] for i in items],
            [list(i[2]) for i in items], now_ms=self._now())
        return [EmbeddedTokenResult(status=s, wait_ms=w, remaining=r)
                for (s, w, r) in res]


class ClusterCoordinator:
    def __init__(self, sentinel, *, namespace: Optional[str] = None,
                 server_port: int = 0, n_shards: int = 1,
                 flows_per_shard: int = 64,
                 param_keys_per_shard: int = 1024, clock=None):
        self.sentinel = sentinel
        self.namespace = namespace or sentinel.cfg.app_name
        self.server_port = server_port
        self.n_shards = n_shards
        self.flows_per_shard = flows_per_shard
        # >0 so an assigned/embedded token server can serve cluster
        # hot-param rules too (reference embedded server always can)
        self.param_keys_per_shard = param_keys_per_shard
        self.clock = clock if clock is not None else sentinel.clock
        self._lock = threading.Lock()
        self.mode = CLUSTER_NOT_STARTED
        self.client = None
        self.server = None
        # client connection config (ClusterClientConfigManager)
        self.server_host = "127.0.0.1"
        self.server_port_client = 18730
        self.request_timeout_ms = 20

    # ---------------------------------------------------------------- wiring
    def bind(self, cluster_state, command_center=None) -> None:
        """Attach to a transport :class:`ClusterModeState`: mode flips and
        client-config pushes from the dashboard drive this coordinator, and
        ``getClusterMode`` reports the live token-server port. Passing the
        transport's ``CommandCenter`` also registers the ten
        ``cluster/server/*`` management commands (rules/config/metrics —
        reference ``sentinel-cluster-server-default`` handlers), resolved
        live against whichever engine/server this coordinator is running."""
        cluster_state.add_observer(self.on_mode_change)
        cluster_state.add_config_observer(
            lambda cfg: self.configure_client(
                cfg["serverHost"], int(cfg["serverPort"]),
                int(cfg["requestTimeout"])
                if "requestTimeout" in cfg else None))
        cluster_state.info_provider = self.info
        if command_center is not None:
            from sentinel_tpu_torch.cluster.commands import (
                register_cluster_server_handlers,
            )
            register_cluster_server_handlers(command_center,
                                             coordinator=self)

    def info(self) -> dict:
        # lock-free snapshot: a mode change can hold the lock for seconds
        # (engine compile) and getClusterMode must not block behind it
        out = {"effectiveMode": self.mode}  # graftlint: disable=LOCK002 -- lock-free snapshot by design; a mode swap holds the lock for seconds and info() must not block
        server, client = self.server, self.client
        if server is not None:
            out["serverPort"] = server.port
        if client is not None:
            out["serverHost"] = self.server_host
            out["clientServerPort"] = self.server_port_client
        return out

    # ---------------------------------------------------------------- config
    def configure_client(self, host: str, port: int,
                         request_timeout_ms: Optional[int] = None) -> None:
        """``modifyClusterClientConfig``: on change, a running client
        reconnects to the new server (ServerChangeObserver)."""
        with self._lock:
            self.server_host = host
            self.server_port_client = port
            if request_timeout_ms is not None:
                self.request_timeout_ms = request_timeout_ms
            if self.mode == CLUSTER_CLIENT:
                self._stop_client_locked()
                try:
                    self._start_client_locked()
                except Exception as exc:
                    # same contract as on_mode_change: a failed restart
                    # leaves a retryable NOT_STARTED, never a phantom CLIENT
                    self.mode = CLUSTER_NOT_STARTED
                    record_log().warning(
                        "cluster client reconfigure failed: %r", exc)

    # ---------------------------------------------------------------- modes
    def on_mode_change(self, mode: int) -> None:
        with self._lock:
            if mode == self.mode:
                return
            self._stop_client_locked()
            self._stop_server_locked()
            # the old service is already gone: from here the effective mode
            # is NOT_STARTED until the new one starts, so a failed start
            # leaves a retryable state (not a stale mode that no-ops)
            self.mode = CLUSTER_NOT_STARTED
            try:
                if mode == CLUSTER_CLIENT:
                    self._start_client_locked()
                elif mode == CLUSTER_SERVER:
                    self._start_server_locked()
                else:
                    self.sentinel.set_token_service(None)
                self.mode = mode
            except Exception as exc:
                record_log().warning("cluster mode change failed: %r", exc)

    # ---------------------------------------------------------------- impl
    def _start_client_locked(self) -> None:
        from sentinel_tpu_torch.cluster.client import ClusterTokenClient
        client = ClusterTokenClient(
            host=self.server_host, port=self.server_port_client,
            namespace=self.namespace,
            request_timeout_ms=self.request_timeout_ms)
        client.start()
        self.client = client
        self.sentinel.set_token_service(client)

    def _stop_client_locked(self) -> None:
        if self.client is not None:
            self.sentinel.set_token_service(None)
            try:
                self.client.stop()
            finally:
                self.client = None

    def _start_server_locked(self) -> None:
        from sentinel_tpu_torch.cluster.server import ClusterTokenServer
        from sentinel_tpu_torch.parallel.cluster import ClusterEngine, ClusterSpec
        engine = ClusterEngine(ClusterSpec(
            n_shards=self.n_shards, flows_per_shard=self.flows_per_shard,
            namespaces=4,
            param_keys_per_shard=self.param_keys_per_shard),
            device=self.sentinel.device)
        server = ClusterTokenServer(engine, port=self.server_port,
                                    clock=self.clock)
        server.start()
        self.server = server
        # embedded mode: this instance's own cluster rules are served by
        # the in-process engine, no loopback socket
        self.sentinel.set_token_service(
            _EmbeddedTokenService(engine, clock=self.clock))

    def _stop_server_locked(self) -> None:
        if self.server is not None:
            self.sentinel.set_token_service(None)
            try:
                self.server.stop()
            finally:
                self.server = None

    def stop(self) -> None:
        with self._lock:
            self._stop_client_locked()
            self._stop_server_locked()
            self.mode = CLUSTER_NOT_STARTED
