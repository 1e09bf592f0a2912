"""One-call agent transport bootstrap.

The reference binds its command server first and then stores the *actual*
port back into ``TransportConfig`` so heartbeats advertise the right address
after port auto-increment (``SimpleHttpCommandCenter.java:48-80`` +
``TransportConfig.setRuntimePort``). This helper reproduces that ordering:
start command center → learn bound port → advertise it in both the
heartbeat message and the ``basicInfo`` command.

The PyTorch port's own copy of ``sentinel_tpu/transport/bootstrap.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from sentinel_tpu_torch.transport.command import CommandCenter
from sentinel_tpu_torch.transport.handlers import (
    ClusterModeState, register_default_handlers,
)
from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender
from sentinel_tpu_torch.transport.http_server import SimpleHttpCommandCenter


@dataclasses.dataclass
class TransportRuntime:
    center: CommandCenter
    http: object            # SimpleHttpCommandCenter | AsyncHttpCommandCenter
    heartbeat: Optional[HeartbeatSender]
    cluster_state: ClusterModeState
    port: int
    metric_timer: Optional[object] = None
    cadence: Optional[object] = None    # serving.CadenceScheduler (r16)

    def stop(self) -> None:
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self.metric_timer is not None:
            self.metric_timer.stop()
        if self.cadence is not None:
            # join the cadence daemon here, not just at Sentinel.close():
            # embedders that stop the transport without closing the
            # engine must not leave a device-dispatching thread running
            # into interpreter teardown
            self.cadence.stop()
        self.http.stop()


def start_transport(sentinel, *, host: str = "0.0.0.0", port: int = 8719,
                    dashboard_addr: Optional[str] = None,
                    metric_searcher=None, writable_registry=None,
                    heartbeat_interval_ms: int = 10_000,
                    metric_log: bool = True,
                    gateway_manager=None, api_definition_manager=None,
                    clock=None, async_server: bool = False,
                    exporter_port: Optional[int] = None) -> TransportRuntime:
    """Start the HTTP command center (with port auto-increment) and, when a
    dashboard address is given, a heartbeat loop advertising the port that
    was actually bound.

    ``metric_log=True`` (the default, matching the reference where the
    metric-file timer always runs — ``MetricTimerListener`` is started by
    FlowRuleManager's static init) also wires the metric pipeline: a 1 s
    writer flushing window snapshots to the app's metric log plus a searcher
    serving the ``metric`` command, which is what the dashboard's fetcher
    polls for the realtime charts. Pass an explicit ``metric_searcher`` (or
    ``metric_log=False``) to manage the pipeline yourself.

    ``gateway_manager`` / ``api_definition_manager`` add the four
    ``gateway/*`` commands. ``exporter_port`` is advertised as
    ``exporterPort`` in ``basicInfo`` and the heartbeat; the exporter's
    own HTTP server is the caller's (``PrometheusExporter.serve``), as in
    the JAX package."""
    center = CommandCenter()
    extra: dict = {}
    metric_timer = None
    cadence = None
    if metric_searcher is None and metric_log:
        from sentinel_tpu_torch.metrics.searcher import MetricSearcher
        from sentinel_tpu_torch.metrics.timer import MetricTimerListener
        from sentinel_tpu_torch.metrics.writer import form_metric_file_name
        metric_timer = MetricTimerListener(
            sentinel, flush_interval_sec=sentinel.cfg.metric_flush_interval_sec)
        metric_timer.start()
        metric_searcher = MetricSearcher(
            sentinel.cfg.metric_dir(),
            form_metric_file_name(sentinel.cfg.app_name))
        # attach the sampled block-event log (obs/eventlog.py) and the
        # SLO flight recorder's <app>-trace log (obs/flight.py) to the
        # same metric directory — both 1 s drains ride metric_timer.tick()
        obs = getattr(sentinel, "obs", None)
        if obs is not None:
            obs.block_events.configure(sentinel.cfg.metric_dir(),
                                       sentinel.cfg.app_name)
            obs.flight.configure(sentinel.cfg.metric_dir(),
                                 sentinel.cfg.app_name)
        # hot-resource telemetry (obs/telemetry.py): top-K second lines
        # ride the same rotation as <app>-metric. Since round 16 the
        # telemetry + tiering cadences share ONE CadenceScheduler thread
        # (serving.py): it arms both services' epilogue carries so
        # steady serving traffic runs the ticks inside the fused
        # dispatch, and only self-dispatches on idle gaps. Its drains
        # still overlap the dispatch pipeline rather than serializing
        # behind metric_timer.tick(). Stops via register_shutdown.
        telemetry = getattr(sentinel, "telemetry", None)
        if telemetry is not None and telemetry.enabled:
            telemetry.configure(sentinel.cfg.metric_dir(),
                                sentinel.cfg.app_name)
            from sentinel_tpu_torch.serving import CadenceScheduler
            cadence = CadenceScheduler(sentinel)
            cadence.start()
    cstate = register_default_handlers(
        center, sentinel, metric_searcher=metric_searcher,
        extra_info=extra, writable_registry=writable_registry,
        gateway_manager=gateway_manager,
        api_definition_manager=api_definition_manager)
    if async_server:
        # nonblocking variant (NettyHttpCommandCenter analog): one event
        # loop, slow-loris-bounded — transport/async_http_server.py
        from sentinel_tpu_torch.transport.async_http_server import (
            AsyncHttpCommandCenter,
        )
        http = AsyncHttpCommandCenter(center, host=host, port=port)
    else:
        http = SimpleHttpCommandCenter(center, host=host, port=port)
    bound = http.start()
    extra["apiPort"] = bound          # basicInfo reflects the bound port
    if exporter_port:
        extra["exporterPort"] = exporter_port

    hb = None
    if dashboard_addr:
        hb = HeartbeatSender(
            dashboard_addr, app_name=sentinel.cfg.app_name,
            app_type=sentinel.cfg.app_type, api_port=bound,
            interval_ms=heartbeat_interval_ms,
            clock=clock if clock is not None else sentinel.clock,
            exporter_port=exporter_port)
        hb.start()
    return TransportRuntime(center=center, http=http, heartbeat=hb,
                            cluster_state=cstate, port=bound,
                            metric_timer=metric_timer, cadence=cadence)
