"""Prometheus metric exporter — the PyTorch port's copy of
``sentinel_tpu/metrics/exporter.py`` (reference
``sentinel-extension/sentinel-metric-exporter``: ``MetricExporterInit`` →
``JMXMetricExporter`` exposing per-resource ``MetricBean`` MXBeans —
rebuilt as the Python ecosystem's idiom, a prometheus_client collector).

One custom collector snapshots every resource's rolling-second totals in a
single device fetch (``all_node_totals``) at scrape time — no background
thread, no per-resource device round-trips. Exposes::

    sentinel_pass_qps{resource=...}        rolling-second pass count
    sentinel_block_qps{resource=...}
    sentinel_success_qps{resource=...}
    sentinel_exception_qps{resource=...}
    sentinel_avg_rt_ms{resource=...}
    sentinel_concurrency{resource=...}     live thread/inflight count
    sentinel_breaker_state{resource=...}   0 closed / 1 open / 2 half-open

Self-telemetry families (from ``Sentinel.obs`` — obs/; absent while
``SENTINEL_OBS_DISABLE`` is set)::

    sentinel_rt_p99_ms                     entry→verdict p99 (batch tier)
    sentinel_rt_quantile_ms{quantile=...}  p50 / p95 / p99 of the same
    sentinel_request_quantile_ms{quantile=...} per-REQUEST ingest→verdict
                                           through the serving front end
    sentinel_split_route_total{route=...}  dispatch-path decisions
    sentinel_compile_cache_hits_total      program-fetch cache hits
    sentinel_compile_cache_misses_total
    sentinel_compile_cache_first_fetch_retries_total
    sentinel_block_reason_total{reason=...} denials by verdict code name
    sentinel_occupy_bookings_total{event=...} granted/carried/settled/evicted
    sentinel_pipeline_total{event=...}     depth/stall/leaked_handles/
                                           meshed_dispatch/dispatches
    sentinel_frontend_total{event=...}     enqueue/queue_depth/shed
    sentinel_frontend_flush_total{reason=...} full/deadline/idle batch cuts
    sentinel_span_ring_wraps_total         spans/links lost to ring wrap
    sentinel_flight_pinned_total           SLO-pinned trace chains
    sentinel_flight_trigger_total{kind=...} deadline_miss/shed/p99/block_burst
    sentinel_sortfree_bucket_overflow_total claim-cascade sorted fallbacks
    sentinel_tune_total{event=...}         autotuner lifecycle: config_loaded/
                                           fingerprint_fallback/knob_rejected/
                                           trial/parity_fail
    sentinel_resource_qps{resource=...}    hot-resource rolling QPS — top-K
                                           labels ONLY (obs/telemetry.py)
    sentinel_resource_rt_ms{resource=...,quantile=...}
                                           per-resource RT quantiles (p50/
                                           p95/p99) from the device-resident
                                           cumulative histogram table — top-K
                                           labels only; absent when
                                           SENTINEL_RESOURCE_HIST_DISABLE set
    sentinel_telemetry_total{event=...}    telemetry health: tick/readback_drop
                                           /hist_tick
    sentinel_exporter_label_overflow_total samples dropped at the label cap

Label-cardinality guard: the per-resource gauge families cap the number
of distinct ``resource`` label values per scrape
(:data:`LABEL_CARDINALITY_CAP`, constructor-overridable). Beyond the cap
the hottest rows (by pass+block) win, the rest are dropped and counted
(``exporter.label_overflow``) — per-resource labels can never explode
the scrape, no matter how many resources register. The telemetry family
is bounded by construction (top-K ≤ 128 labels).

Every key in the fixed counter CATALOG (obs/counters.py) has a family
here — tests/test_obs.py walks the catalog against the rendered scrape
so a key added without an export shows up as a test failure, not a
silent observability gap. ``compile_cache.*`` counts first against
repeat dispatches of each program key (core/compile_cache.py) and
``tune.*`` the autotuner's startup events (tune/), as in the
reference.

``prometheus_client`` is optional: without it, constructing the
collector or the exporter raises an ImportError naming the package.
"""

from __future__ import annotations

from typing import Optional

try:                    # optional: nothing else in the port needs it
    from prometheus_client import start_http_server
    from prometheus_client.core import CounterMetricFamily, GaugeMetricFamily
    from prometheus_client.registry import REGISTRY
except ImportError:     # the collector and the exporter then raise
    start_http_server = CounterMetricFamily = GaugeMetricFamily = None
    REGISTRY = None


def _require_client() -> None:
    if GaugeMetricFamily is None:
        raise ImportError(
            "the Prometheus exporter needs the prometheus_client package, "
            "which is not installed")

#: Default per-family cap on distinct ``resource`` label values per
#: scrape. Prometheus guidance keeps label cardinality in the hundreds;
#: at 1M registered resources an uncapped scrape would be megabytes.
LABEL_CARDINALITY_CAP = 512


class SentinelCollector:
    """Register with ``prometheus_client``'s registry; each scrape pulls one
    consistent snapshot of all resources."""

    _GAUGES = (
        ("pass", "pass_qps", "Rolling-second pass count"),
        ("block", "block_qps", "Rolling-second block count"),
        ("success", "success_qps", "Rolling-second success count"),
        ("exception", "exception_qps", "Rolling-second exception count"),
        ("avg_rt", "avg_rt_ms", "Rolling-second average RT (ms)"),
        ("threads", "concurrency", "Live in-flight count"),
    )

    def __init__(self, sentinel, namespace: str = "sentinel",
                 label_cap: int = LABEL_CARDINALITY_CAP):
        _require_client()
        self.sentinel = sentinel
        self.namespace = namespace
        self.label_cap = max(1, int(label_cap))

    def describe(self):
        """Static family list so Registry.register doesn't trigger a full
        collect (device snapshot + first-compile) at construction time."""
        ns = self.namespace
        for _key, suffix, doc in self._GAUGES:
            yield GaugeMetricFamily(f"{ns}_{suffix}", doc,
                                    labels=["resource"])
        yield GaugeMetricFamily(
            f"{ns}_breaker_state",
            "Circuit state: 0 closed, 1 open, 2 half-open",
            labels=["resource"])
        yield from self._obs_families(describe_only=True)

    def _obs_families(self, describe_only: bool = False):
        """Self-telemetry families (host-side reads only — no device
        work, so scrapes stay cheap even under SENTINEL_OBS_DISABLE)."""
        ns = self.namespace
        obs = getattr(self.sentinel, "obs", None)
        p99 = GaugeMetricFamily(
            f"{ns}_rt_p99_ms",
            "p99 entry→verdict latency over the batch tier (ms)")
        quant = GaugeMetricFamily(
            f"{ns}_rt_quantile_ms",
            "entry→verdict latency quantiles (ms)", labels=["quantile"])
        req_quant = GaugeMetricFamily(
            f"{ns}_request_quantile_ms",
            "per-request ingest→verdict latency quantiles through the "
            "serving front end (ms)", labels=["quantile"])
        route = CounterMetricFamily(
            f"{ns}_split_route",
            "Dispatch-path decisions by route", labels=["route"])
        hits = CounterMetricFamily(
            f"{ns}_compile_cache_hits",
            "Decide-program fetch cache hits")
        misses = CounterMetricFamily(
            f"{ns}_compile_cache_misses",
            "Decide-program fetch cache misses (first dispatches)")
        retries = CounterMetricFamily(
            f"{ns}_compile_cache_first_fetch_retries",
            "Guarded first-fetch stall retries")
        blocks = CounterMetricFamily(
            f"{ns}_block_reason",
            "Denials by verdict reason name", labels=["reason"])
        occupy = CounterMetricFamily(
            f"{ns}_occupy_bookings",
            "Priority occupy booking lifecycle events", labels=["event"])
        pipeline = CounterMetricFamily(
            f"{ns}_pipeline",
            "Dispatch-pipeline health: depth (sum of in-flight at each "
            "enqueue), stall, leaked_handles", labels=["event"])
        frontend = CounterMetricFamily(
            f"{ns}_frontend",
            "Serving front-end ingest events: enqueue, queue_depth "
            "(sum of pending depth at each enqueue), shed",
            labels=["event"])
        fe_flush = CounterMetricFamily(
            f"{ns}_frontend_flush",
            "Why each device batch was cut", labels=["reason"])
        wraps = CounterMetricFamily(
            f"{ns}_span_ring_wraps",
            "Spans/links lost to per-thread ring wrap (capacity too "
            "small for the sustained span rate)")
        flight_pinned = CounterMetricFamily(
            f"{ns}_flight_pinned",
            "Trace chains pinned by an SLO flight-recorder trigger")
        flight_trig = CounterMetricFamily(
            f"{ns}_flight_trigger",
            "Flight-recorder SLO triggers fired (post rate limiting)",
            labels=["kind"])
        sf_ovf = CounterMetricFamily(
            f"{ns}_sortfree_bucket_overflow",
            "Sort-free claim-cascade overflows (elements that fell back "
            "to the sorted branch; sustained growth = bucket table "
            "undersized for the key distribution)")
        tune = CounterMetricFamily(
            f"{ns}_tune",
            "Autotuner lifecycle: config_loaded / fingerprint_fallback "
            "/ knob_rejected at startup, trial / parity_fail during a "
            "sweep", labels=["event"])
        res_qps = GaugeMetricFamily(
            f"{ns}_resource_qps",
            "Hot-resource rolling pass+block QPS — top-K labels only "
            "(the device-merged hot set, obs/telemetry.py)",
            labels=["resource"])
        res_rt = GaugeMetricFamily(
            f"{ns}_resource_rt_ms",
            "Per-resource RT quantiles (ms) from the device-resident "
            "cumulative log-bucket histogram — top-K labels only "
            "(obs/resource_hist.py; absent when "
            "SENTINEL_RESOURCE_HIST_DISABLE is set)",
            labels=["resource", "quantile"])
        telem = CounterMetricFamily(
            f"{ns}_telemetry",
            "Hot-resource telemetry health: tick (device reads "
            "dispatched) / readback_drop (async readback fell behind) / "
            "hist_tick (hot sets landed with histogram quantiles)",
            labels=["event"])
        label_ovf = CounterMetricFamily(
            f"{ns}_exporter_label_overflow",
            "Resource-labeled scrape samples dropped at the "
            "label-cardinality cap")
        tier = CounterMetricFamily(
            f"{ns}_tier_total",
            "Tiered-state lifecycle: hot_hit / cold_miss intern "
            "classifications, promoted / demoted row migrations, "
            "sketch_overflow halvings (tiering/manager.py)",
            labels=["event"])
        control = CounterMetricFamily(
            f"{ns}_control_total",
            "Overload-controller activity: tick (control cycles), "
            "shed_rate / retune_batcher / degrade (actions applied), "
            "admission_dropped (requests shed at the admission gate), "
            "tail_signal (ticks where per-resource p99 deltas fed the "
            "degrade policy) (control/loop.py)",
            labels=["action"])
        if not describe_only and obs is not None and obs.enabled:
            from sentinel_tpu_torch.obs import counters as ck
            counts = obs.counters.snapshot()
            v99 = obs.hist_entry.percentile_ms(0.99)
            if v99 is not None:
                p99.add_metric([], v99)
            for q in (0.50, 0.95, 0.99):
                v = obs.hist_entry.percentile_ms(q)
                if v is not None:
                    quant.add_metric([f"{q:g}"], v)
                rv = obs.hist_request.percentile_ms(q)
                if rv is not None:
                    req_quant.add_metric([f"{q:g}"], rv)
            for key, fam_key in ((ck.ROUTE_SCALAR, "scalar"),
                                 (ck.ROUTE_FAST, "fast"),
                                 (ck.ROUTE_FAST_OCCUPY, "fast_occupy"),
                                 (ck.ROUTE_GENERAL, "general_sorted"),
                                 (ck.ROUTE_SPLIT, "split_fired"),
                                 (ck.ROUTE_FUSED, "fused_exit"),
                                 (ck.ROUTE_MESHED, "meshed"),
                                 (ck.ROUTE_SORTFREE, "sortfree"),
                                 (ck.ROUTE_SINGLE_DISPATCH,
                                  "single_dispatch")):
                route.add_metric([fam_key], counts.get(key, 0))
            sf_ovf.add_metric([], counts.get(ck.SORTFREE_OVERFLOW, 0))
            hits.add_metric([], counts.get(ck.CACHE_HIT, 0))
            misses.add_metric([], counts.get(ck.CACHE_MISS, 0))
            retries.add_metric([], counts.get(ck.CACHE_RETRY, 0))
            for key, v in sorted(counts.items()):
                if key.startswith(ck.BLOCK_PREFIX):
                    blocks.add_metric([key[len(ck.BLOCK_PREFIX):]], v)
            for key, ev in ((ck.OCCUPY_GRANTED, "granted"),
                            (ck.OCCUPY_CARRIED, "carried"),
                            (ck.OCCUPY_SETTLED, "settled"),
                            (ck.OCCUPY_EVICTED, "evicted")):
                occupy.add_metric([ev], counts.get(key, 0))
            for key, ev in ((ck.PIPE_DEPTH, "depth"),
                            (ck.PIPE_STALL, "stall"),
                            (ck.PIPE_LEAKED, "leaked_handles"),
                            (ck.PIPE_MESHED, "meshed_dispatch"),
                            (ck.PIPE_DISPATCH, "dispatches")):
                pipeline.add_metric([ev], counts.get(key, 0))
            for key, ev in ((ck.FE_ENQUEUE, "enqueue"),
                            (ck.FE_QUEUE_DEPTH, "queue_depth"),
                            (ck.FE_SHED, "shed")):
                frontend.add_metric([ev], counts.get(key, 0))
            for key, reason in ((ck.FE_FLUSH_FULL, "full"),
                                (ck.FE_FLUSH_DEADLINE, "deadline"),
                                (ck.FE_FLUSH_IDLE, "idle")):
                fe_flush.add_metric([reason], counts.get(key, 0))
            wraps.add_metric([], counts.get(ck.SPAN_RING_WRAP, 0))
            flight_pinned.add_metric([], counts.get(ck.FLIGHT_PINNED, 0))
            for key, v in sorted(counts.items()):
                if key.startswith(ck.FLIGHT_TRIGGER_PREFIX):
                    flight_trig.add_metric(
                        [key[len(ck.FLIGHT_TRIGGER_PREFIX):]], v)
            for key, ev in ((ck.TUNE_LOADED, "config_loaded"),
                            (ck.TUNE_FALLBACK, "fingerprint_fallback"),
                            (ck.TUNE_KNOB_REJECTED, "knob_rejected"),
                            (ck.TUNE_TRIAL, "trial"),
                            (ck.TUNE_PARITY_FAIL, "parity_fail")):
                tune.add_metric([ev], counts.get(key, 0))
            for key, ev in ((ck.TELEMETRY_TICK, "tick"),
                            (ck.TELEMETRY_DROP, "readback_drop"),
                            (ck.TELEMETRY_HIST_TICK, "hist_tick")):
                telem.add_metric([ev], counts.get(key, 0))
            label_ovf.add_metric(
                [], counts.get(ck.EXPORTER_LABEL_OVERFLOW, 0))
            for key, ev in ((ck.TIER_HOT_HIT, "hot_hit"),
                            (ck.TIER_COLD_MISS, "cold_miss"),
                            (ck.TIER_PROMOTED, "promoted"),
                            (ck.TIER_DEMOTED, "demoted"),
                            (ck.TIER_SKETCH_OVERFLOW, "sketch_overflow")):
                tier.add_metric([ev], counts.get(key, 0))
            for key, ev in ((ck.CONTROL_TICK, "tick"),
                            (ck.CONTROL_SHED_ACTION, "shed_rate"),
                            (ck.CONTROL_RETUNE_ACTION, "retune_batcher"),
                            (ck.CONTROL_DEGRADE_ACTION, "degrade"),
                            (ck.CONTROL_DROPPED, "admission_dropped"),
                            (ck.CONTROL_TAIL_SIGNAL, "tail_signal")):
                control.add_metric([ev], counts.get(key, 0))
            # bounded by construction: at most telemetry.k ≤ MAX_K labels
            # (×3 quantile labels for res_rt — still top-K-bounded)
            telemetry = getattr(self.sentinel, "telemetry", None)
            if telemetry is not None and telemetry.enabled:
                for h in telemetry.hot_entries():
                    res_qps.add_metric([h["resource"]], float(h["qps"]))
                    for q, fld in (("0.5", "rt_p50_ms"),
                                   ("0.95", "rt_p95_ms"),
                                   ("0.99", "rt_p99_ms")):
                        if fld in h:
                            res_rt.add_metric([h["resource"], q],
                                              float(h[fld]))
        yield from (p99, quant, req_quant, route, hits, misses, retries,
                    blocks, occupy, pipeline, frontend, fe_flush, wraps,
                    flight_pinned, flight_trig, sf_ovf, tune,
                    res_qps, res_rt, telem, label_ovf, tier, control)

    def collect(self):
        ns = self.namespace
        gauges = {key: GaugeMetricFamily(f"{ns}_{suffix}", doc,
                                         labels=["resource"])
                  for key, suffix, doc in self._GAUGES}
        breaker = GaugeMetricFamily(
            f"{ns}_breaker_state",
            "Circuit state: 0 closed, 1 open, 2 half-open",
            labels=["resource"])

        totals = self.sentinel.all_node_totals()
        # label-cardinality guard: never more than label_cap distinct
        # resource labels per family — keep the hottest rows (pass+block,
        # name-tiebroken for a deterministic scrape), drop and COUNT the
        # cold tail (exporter.label_overflow)
        dropped = len(totals) - self.label_cap
        if dropped > 0:
            totals = sorted(
                totals,
                key=lambda it: (-(it[2].get("pass", 0)
                                  + it[2].get("block", 0)), it[0]),
            )[:self.label_cap]
            obs = getattr(self.sentinel, "obs", None)
            if obs is not None:
                from sentinel_tpu_torch.obs import counters as ck
                obs.counters.add(ck.EXPORTER_LABEL_OVERFLOW, dropped)
        for name, _row, t in totals:
            for key, fam in gauges.items():
                fam.add_metric([name], float(t.get(key, 0) or 0))
        # several rules may guard one resource; one sample per label set
        # (duplicates make Prometheus reject the whole scrape) — report the
        # most-degraded state (OPEN > HALF_OPEN > CLOSED)
        by_res: dict = {}
        for res, state in self.sentinel.breaker_resources():
            rank = {0: 0, 2: 1, 1: 2}.get(state, 0)
            cur = by_res.get(res)
            if cur is None or rank > cur[0]:
                by_res[res] = (rank, state)
        for res, (_rank, state) in by_res.items():
            breaker.add_metric([res], float(state))
        yield from gauges.values()
        yield breaker
        yield from self._obs_families()


class PrometheusExporter:
    """Convenience wrapper: register the collector and (optionally) serve
    ``/metrics`` on its own port (``MetricExporterInit`` analog)."""

    def __init__(self, sentinel, *, registry=None,
                 namespace: str = "sentinel",
                 label_cap: int = LABEL_CARDINALITY_CAP):
        self.collector = SentinelCollector(sentinel, namespace,
                                           label_cap=label_cap)
        # (None: prometheus_client's global registry)
        self.registry = registry if registry is not None else REGISTRY
        self._server = None
        registry.register(self.collector)
        # Sentinel.close() then unregisters the collector and releases
        # the listener — no leaked registration across open/close cycles
        reg = getattr(sentinel, "register_shutdown", None)
        if reg is not None:
            reg(self)

    def serve(self, port: int = 9464, addr: str = "0.0.0.0") -> None:
        self._server, _ = start_http_server(
            port, addr=addr, registry=self.registry)

    def close(self) -> None:
        try:
            self.registry.unregister(self.collector)
        except KeyError:
            pass
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()   # release the listening socket now
            self._server = None
