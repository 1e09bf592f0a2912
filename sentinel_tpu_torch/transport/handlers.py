"""The built-in command handlers (reference
``sentinel-transport-common/.../command/handler/*.java`` — the 18 commands
the dashboard drives agents with, SURVEY §2.4).

Each handler closes over a :class:`~sentinel_tpu_torch.runtime.Sentinel` instance
(plus optional metric searcher / cluster hooks) and is registered into a
:class:`~sentinel_tpu_torch.transport.command.CommandCenter`.

The PyTorch port's own copy of ``sentinel_tpu/transport/handlers.py``.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Optional

from sentinel_tpu_torch import __version__
from sentinel_tpu_torch.core.logs import record_log
from sentinel_tpu_torch.core.registry import ENTRY_NODE_ROW
from sentinel_tpu_torch.metrics.node import TOTAL_IN_RESOURCE_NAME
from sentinel_tpu_torch.metrics.searcher import MetricSearcher
from sentinel_tpu_torch.rules import codec
from sentinel_tpu_torch.transport.command import (
    CommandCenter, CommandRequest, CommandResponse,
)

# ClusterStateManager.java: CLUSTER_NOT_STARTED=-1, CLIENT=0, SERVER=1
CLUSTER_NOT_STARTED = -1
CLUSTER_CLIENT = 0
CLUSTER_SERVER = 1

_MAX_METRIC_LINES = 12000  # SendMetricCommandHandler maxLines/FETCH cap


class ClusterModeState:
    """Per-process cluster mode cell (``ClusterStateManager`` analog).

    ``on_change(mode)`` hooks let the embedding app start/stop its token
    client/server when the dashboard flips the mode; client-config
    observers mirror ``ClusterClientConfigManager``'s ServerChangeObserver;
    ``info_provider`` lets the running server/client report live details
    (e.g. the bound token-server port) through ``getClusterMode``.
    """

    def __init__(self) -> None:
        self.mode = CLUSTER_NOT_STARTED
        self.last_modified_ms = 0
        self.client_config: Dict[str, Any] = {}
        self.info_provider: Optional[Callable[[], Dict[str, Any]]] = None
        self._observers: list = []
        self._config_observers: list = []

    def add_observer(self, fn: Callable[[int], None]) -> None:
        self._observers.append(fn)

    def add_config_observer(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        self._config_observers.append(fn)

    def set_mode(self, mode: int, now_ms: int = 0) -> None:
        self.mode = mode
        self.last_modified_ms = now_ms
        for fn in list(self._observers):
            fn(mode)

    def set_client_config(self, config: Dict[str, Any]) -> None:
        self.client_config = dict(config)
        for fn in list(self._config_observers):
            fn(self.client_config)


def register_default_handlers(
    center: CommandCenter,
    sentinel,
    *,
    metric_searcher: Optional[MetricSearcher] = None,
    cluster_state: Optional[ClusterModeState] = None,
    extra_info: Optional[Dict[str, Any]] = None,
    writable_registry=None,
    gateway_manager=None,
    api_definition_manager=None,
) -> ClusterModeState:
    """Bind the full default command surface for one Sentinel instance
    (the gateway commands too when ``gateway_manager`` /
    ``api_definition_manager`` are given)."""
    from sentinel_tpu_torch.datasource.registry import default_registry

    s = sentinel
    cstate = cluster_state or ClusterModeState()
    wreg = writable_registry if writable_registry is not None else default_registry

    # ---- meta ------------------------------------------------------------

    def cmd_version(req: CommandRequest) -> CommandResponse:
        return CommandResponse.of_success(__version__)

    def cmd_api(req: CommandRequest) -> CommandResponse:
        return CommandResponse.of_success(json.dumps(
            [{"url": f"/{name}", "desc": desc}
             for name, desc in sorted(center.names().items())]))

    def cmd_basic_info(req: CommandRequest) -> CommandResponse:
        info = {
            "appName": s.cfg.app_name, "appType": s.cfg.app_type,
            "version": __version__, "apiPort": s.cfg.api_port,
            "maxResources": s.cfg.max_resources,
            # thread gauges currently compiled away → their 0s are elision,
            # not idleness (flips live with THREAD-rule loads)
            "threadsElided": bool(getattr(s, "threads_elided", False)),
        }
        info.update(extra_info or {})
        return CommandResponse.of_success(json.dumps(info))

    # ---- rules -----------------------------------------------------------

    _GET = {"flow": s.get_flow_rules, "degrade": s.get_degrade_rules,
            "system": s.get_system_rules, "authority": s.get_authority_rules,
            "paramFlow": s.get_param_flow_rules}
    _LOAD = {"flow": s.load_flow_rules, "degrade": s.load_degrade_rules,
             "system": s.load_system_rules,
             "authority": s.load_authority_rules,
             "paramFlow": s.load_param_flow_rules}

    def cmd_get_rules(req: CommandRequest) -> CommandResponse:
        rtype = req.param("type")
        getter = _GET.get(rtype)
        if getter is None:
            return CommandResponse.of_failure("invalid type", 400)
        return CommandResponse.of_success(codec.rules_to_json(rtype, getter()))

    def cmd_set_rules(req: CommandRequest) -> CommandResponse:
        rtype = req.param("type")
        loader = _LOAD.get(rtype)
        if loader is None:
            return CommandResponse.of_failure("invalid type", 400)
        try:
            data = req.param("data")
            if not data and req.body:
                data = req.body.decode("utf-8")   # UnicodeDecodeError ⊂ ValueError
            rules = codec.rules_from_json(rtype, data or "[]")
        except (ValueError, KeyError, TypeError) as exc:
            return CommandResponse.of_failure(f"decode rules error: {exc}", 400)
        loader(rules)
        # ModifyRulesCommandHandler persists through the registered writable
        # datasource after a successful in-memory load; a failed write does
        # not undo the live rules, so still report success
        try:
            wreg.write_if_registered(rtype, rules)
        except OSError as exc:
            record_log().warning("setRules: datasource write failed: %s", exc)
        return CommandResponse.of_success("success")

    def cmd_get_param_rules(req: CommandRequest) -> CommandResponse:
        """Dedicated ``getParamFlowRules`` path — the reference DASHBOARD
        fetches param rules through this name, not ``getRules?type=``
        (``SentinelApiClient.java:105``)."""
        return CommandResponse.of_success(
            codec.rules_to_json("paramFlow", s.get_param_flow_rules()))

    def cmd_set_param_rules(req: CommandRequest) -> CommandResponse:
        req.parameters["type"] = "paramFlow"
        return cmd_set_rules(req)

    # ---- switch ----------------------------------------------------------

    def cmd_get_switch(req: CommandRequest) -> CommandResponse:
        return CommandResponse.of_success(
            f"Sentinel switch value: {'true' if s._global_on else 'false'}")

    def cmd_set_switch(req: CommandRequest) -> CommandResponse:
        value = req.param("value").lower()
        if value not in ("true", "false"):
            return CommandResponse.of_failure("invalid parameter", 400)
        s.set_global_switch(value == "true")
        return CommandResponse.of_success("success")

    # ---- metrics ---------------------------------------------------------

    def cmd_metric(req: CommandRequest) -> CommandResponse:
        if metric_searcher is None:
            return CommandResponse.of_success("")
        try:
            begin = int(req.param("startTime", "0") or 0)
        except ValueError:
            begin = 0
        end_raw = req.param("endTime", "")
        end = int(end_raw) if end_raw.isdigit() else None
        identity = req.param("identity", "")
        nodes = metric_searcher.find(begin, end, identity=identity or None,
                                     max_lines=_MAX_METRIC_LINES)
        if not identity:
            # SendMetricCommandHandler hides the global inbound node unless
            # asked for by name
            nodes = [n for n in nodes if n.resource != TOTAL_IN_RESOURCE_NAME]
        body = "".join(n.to_thin_string() + "\n" for n in nodes)
        if getattr(s, "threads_elided", False) and body:
            # marker line, not a metric line: dashboard clients skip lines
            # that don't parse as MetricNode (dashboard/client.py), and
            # elision-aware readers learn the 0 thread columns are elided
            body = "# threadsElided=true\n" + body
        return CommandResponse.of_success(body)

    # ---- node tree -------------------------------------------------------

    def _node_dicts():
        out = []
        rtypes = dict(getattr(s, "resource_types", {}) or {})
        elided = bool(getattr(s, "threads_elided", False))
        for name, row, t in s.all_node_totals():
            if not (t["pass"] or t["block"] or t["success"] or t["threads"]):
                continue
            out.append({
                "threadsElided": elided,
                "id": row,
                "resource": TOTAL_IN_RESOURCE_NAME if row == ENTRY_NODE_ROW
                else name,
                # ResourceTypeConstants classification (0 common, 1 web,
                # 2 rpc, 3 gateway) — the SPA's gateway tree grouping keys
                # off this the way the reference gateway identity page does
                "classification": int(rtypes.get(name, 0)),
                "threadNum": t["threads"], "passQps": t["pass"],
                "blockQps": t["block"], "totalQps": t["pass"] + t["block"],
                "successQps": t["success"], "exceptionQps": t["exception"],
                "averageRt": round(t["avg_rt"], 2),
            })
        return out

    def cmd_cluster_node(req: CommandRequest) -> CommandResponse:
        return CommandResponse.of_success(json.dumps(_node_dicts()))

    def cmd_cluster_node_by_id(req: CommandRequest) -> CommandResponse:
        rid = req.param("id")
        nodes = [n for n in _node_dicts() if n["resource"] == rid]
        return CommandResponse.of_success(json.dumps(nodes))

    def cmd_origin(req: CommandRequest) -> CommandResponse:
        rid = req.param("id")
        if not rid:
            return CommandResponse.of_failure("invalid parameter: id", 400)
        return CommandResponse.of_success(json.dumps(s.origin_totals(rid)))

    def cmd_tree(req: CommandRequest) -> CommandResponse:
        lines = ["EntranceNode: machine-root"]
        for n in _node_dicts():
            lines.append(
                f"-{n['resource']}({n['threadNum']}/{n['totalQps']}/"
                f"{n['passQps']}/{n['blockQps']}/{n['successQps']}/"
                f"{n['averageRt']})")
        return CommandResponse.of_success("\n".join(lines) + "\n")

    def cmd_json_tree(req: CommandRequest) -> CommandResponse:
        return CommandResponse.of_success(json.dumps(_node_dicts()))

    # ---- system ----------------------------------------------------------

    def cmd_system_status(req: CommandRequest) -> CommandResponse:
        return CommandResponse.of_success(json.dumps(s.system_status()))

    # ---- self-telemetry (obs/ — docs/OBSERVABILITY.md) -------------------

    def cmd_obs(req: CommandRequest) -> CommandResponse:
        """Runtime self-telemetry snapshot: decision counters, latency
        histograms (p50/p95/p99), recent sampled spans and block events.
        Params: ``spans`` (max spans, default 128), ``events`` (max block
        events, default 64), ``trace`` (a trace id → that trace's full
        span chain under ``"trace"``)."""
        obs = getattr(s, "obs", None)
        if obs is None:
            return CommandResponse.of_failure("observability unavailable",
                                              404)
        try:
            span_limit = int(req.param("spans", "128") or 128)
            event_limit = int(req.param("events", "64") or 64)
        except ValueError:
            return CommandResponse.of_failure("invalid limit", 400)
        payload = obs.payload(span_limit=span_limit,
                              event_limit=event_limit)
        payload["threadsElided"] = s.threads_elided
        trace = req.param("trace", "")
        if trace:
            try:
                payload["trace"] = obs.spans.chain(int(trace))
            except ValueError:
                return CommandResponse.of_failure("invalid trace id", 400)
        return CommandResponse.of_success(json.dumps(payload))

    def cmd_topk(req: CommandRequest) -> CommandResponse:
        """Hot-resource telemetry snapshot (obs/telemetry.py): the last
        drained device top-K (per-resource rolling pass/block/qps, plus
        ``rt_p50_ms``/``rt_p95_ms``/``rt_p99_ms`` and the raw
        ``rt_hist`` bucket vector when the device-resident RT histogram
        table is enabled — obs/resource_hist.py) plus the engine-wide
        per-second timeline tail. Params: ``timeline`` (max timeline
        entries, default 60), ``tick`` (``1`` → run one poll inline
        first — the pull-only path for agents without the telemetry
        ticker running)."""
        telemetry = getattr(s, "telemetry", None)
        if telemetry is None:
            return CommandResponse.of_failure("telemetry unavailable", 404)
        try:
            timeline_limit = int(req.param("timeline", "60") or 60)
        except ValueError:
            return CommandResponse.of_failure("invalid limit", 400)
        if req.param("tick", "") in ("1", "true"):
            telemetry.poll()
        return CommandResponse.of_success(json.dumps(
            telemetry.snapshot(timeline_limit=timeline_limit)))

    def cmd_control(req: CommandRequest) -> CommandResponse:
        """Overload-controller snapshot (control/loop.py): policy state
        (admission fraction, estimator extrema, degrade trackers), the
        last observation, and the applied-action tail with per-action
        evidence. Params: ``actions`` (max actions, default 32),
        ``tick`` (``1`` → run one observe/decide/apply cycle inline
        first — the pull-only path without a scheduler)."""
        control = getattr(s, "control", None)
        if control is None:
            return CommandResponse.of_failure("controller unavailable", 404)
        try:
            limit = int(req.param("actions", "32") or 32)
        except ValueError:
            return CommandResponse.of_failure("invalid limit", 400)
        if req.param("tick", "") in ("1", "true"):
            control.poll()
        return CommandResponse.of_success(json.dumps(
            control.snapshot(limit=limit)))

    def cmd_trace(req: CommandRequest) -> CommandResponse:
        """Request-scoped trace export (docs/OBSERVABILITY.md "Request
        tracing"). Params: ``id`` (a trace id → that chain's causal
        closure as a Chrome-trace-event/Perfetto document; when the
        flight recorder pinned the id, the pinned — possibly
        richer-than-ring — record is exported); without ``id``, the
        pinned-record index (``{"pinned": [...metadata...]}``)."""
        obs = getattr(s, "obs", None)
        if obs is None:
            return CommandResponse.of_failure("observability unavailable",
                                              404)
        from sentinel_tpu_torch.obs import traceexport
        raw = req.param("id", "")
        if not raw:
            return CommandResponse.of_success(json.dumps({
                "pinned": obs.flight.snapshot(limit=32)}))
        try:
            trace_id = int(raw)
        except ValueError:
            return CommandResponse.of_failure("invalid trace id", 400)
        pinned = obs.flight.pinned(trace_id)
        doc = (traceexport.chrome_trace(pinned) if pinned is not None
               else traceexport.export_chain(obs.spans, trace_id))
        return CommandResponse.of_success(json.dumps(doc))

    # ---- cluster mode ----------------------------------------------------

    def cmd_get_cluster_mode(req: CommandRequest) -> CommandResponse:
        info = {
            "mode": cstate.mode,
            "lastModified": cstate.last_modified_ms,
            "clientAvailable": True, "serverAvailable": True,
        }
        if cstate.info_provider is not None:
            try:
                info.update(cstate.info_provider() or {})
            except Exception:
                pass
        return CommandResponse.of_success(json.dumps(info))

    def cmd_get_cluster_client_config(req: CommandRequest) -> CommandResponse:
        return CommandResponse.of_success(json.dumps(cstate.client_config))

    def cmd_set_cluster_client_config(req: CommandRequest) -> CommandResponse:
        """``cluster/client/modifyConfig`` analog: point the token client at
        a (new) server; a running client reconnects via the observers."""
        data = req.param("data")
        if not data and req.body:
            try:
                data = req.body.decode("utf-8")
            except UnicodeDecodeError:
                return CommandResponse.of_failure("invalid body", 400)
        try:
            cfg_in = json.loads(data or "{}")
            cfg_out = {"serverHost": str(cfg_in["serverHost"]),
                       "serverPort": int(cfg_in["serverPort"])}
            if "requestTimeout" in cfg_in:
                cfg_out["requestTimeout"] = int(cfg_in["requestTimeout"])
        except (ValueError, KeyError, TypeError) as exc:
            return CommandResponse.of_failure(f"invalid config: {exc}", 400)
        cstate.set_client_config(cfg_out)
        return CommandResponse.of_success("success")

    def cmd_set_cluster_mode(req: CommandRequest) -> CommandResponse:
        try:
            mode = int(req.param("mode"))
        except ValueError:
            return CommandResponse.of_failure("invalid mode", 400)
        if mode not in (CLUSTER_NOT_STARTED, CLUSTER_CLIENT, CLUSTER_SERVER):
            return CommandResponse.of_failure("invalid mode", 400)
        cstate.set_mode(mode, s.clock.now_ms())
        return CommandResponse.of_success("success")

    # ---- gateway (sentinel-api-gateway-adapter-common command handlers,
    # registered only when the app wired up the gateway managers) --------

    def _body_or_data(req: CommandRequest) -> str:
        data = req.param("data")
        if not data and req.body:
            data = req.body.decode("utf-8")    # UnicodeDecodeError ⊂ ValueError
        return data or "[]"

    def cmd_gateway_get_rules(req: CommandRequest) -> CommandResponse:
        from sentinel_tpu_torch.gateway.codec import gateway_rules_to_json
        return CommandResponse.of_success(
            gateway_rules_to_json(gateway_manager.all_rules()))

    def cmd_gateway_update_rules(req: CommandRequest) -> CommandResponse:
        from sentinel_tpu_torch.gateway.codec import gateway_rules_from_json
        try:
            rules = gateway_rules_from_json(_body_or_data(req))
        except (ValueError, KeyError, TypeError) as exc:
            return CommandResponse.of_failure(f"decode rules error: {exc}", 400)
        gateway_manager.load_rules(rules)
        return CommandResponse.of_success("success")

    def cmd_gateway_get_apis(req: CommandRequest) -> CommandResponse:
        from sentinel_tpu_torch.gateway.codec import api_definitions_to_json
        return CommandResponse.of_success(api_definitions_to_json(
            api_definition_manager.get_api_definitions()))

    def cmd_gateway_update_apis(req: CommandRequest) -> CommandResponse:
        from sentinel_tpu_torch.gateway.codec import api_definitions_from_json
        try:
            defs = api_definitions_from_json(_body_or_data(req))
        except (ValueError, KeyError, TypeError) as exc:
            return CommandResponse.of_failure(f"decode apis error: {exc}", 400)
        api_definition_manager.load_api_definitions(defs)
        return CommandResponse.of_success("success")

    if gateway_manager is not None:
        center.register(cmd_gateway_get_rules, "gateway/getRules",
                        "get gateway flow rules")
        center.register(cmd_gateway_update_rules, "gateway/updateRules",
                        "set gateway flow rules")
    if api_definition_manager is not None:
        center.register(cmd_gateway_get_apis, "gateway/getApiDefinitions",
                        "get gateway api groups")
        center.register(cmd_gateway_update_apis,
                        "gateway/updateApiDefinitions",
                        "set gateway api groups")

    for name, desc, fn in [
        ("version", "get sentinel version", cmd_version),
        ("api", "list available commands", cmd_api),
        ("basicInfo", "get app basic info", cmd_basic_info),
        ("getRules", "get rules by type", cmd_get_rules),
        ("setRules", "load rules by type", cmd_set_rules),
        ("getSwitch", "get global switch", cmd_get_switch),
        ("setSwitch", "set global switch", cmd_set_switch),
        ("metric", "search metric logs", cmd_metric),
        ("clusterNode", "all resource nodes", cmd_cluster_node),
        ("clusterNodeById", "resource node by name", cmd_cluster_node_by_id),
        ("cnode", "resource node by name", cmd_cluster_node_by_id),
        ("origin", "per-origin stats of a resource", cmd_origin),
        ("tree", "node tree (text)", cmd_tree),
        ("jsonTree", "node tree (json)", cmd_json_tree),
        ("systemStatus", "system adaptive status", cmd_system_status),
        ("obs", "runtime self-telemetry snapshot", cmd_obs),
        ("topk", "hot-resource top-K snapshot", cmd_topk),
        ("control", "overload controller snapshot", cmd_control),
        ("trace", "causal trace chain as chrome-trace JSON", cmd_trace),
        ("getClusterMode", "get cluster mode", cmd_get_cluster_mode),
        ("setClusterMode", "set cluster mode", cmd_set_cluster_mode),
        ("getClusterClientConfig", "get cluster client config",
         cmd_get_cluster_client_config),
        ("setClusterClientConfig", "point the token client at a server",
         cmd_set_cluster_client_config),
        # reference-dashboard exact paths (SentinelApiClient.java:105-111):
        # param rules use dedicated commands, client config the cluster/
        # client/* names — aliases so a REAL Sentinel dashboard can drive
        # this agent unchanged
        ("getParamFlowRules", "get param flow rules", cmd_get_param_rules),
        ("setParamFlowRules", "set param flow rules", cmd_set_param_rules),
        ("cluster/client/fetchConfig", "get cluster client config",
         cmd_get_cluster_client_config),
        ("cluster/client/modifyConfig", "modify cluster client config",
         cmd_set_cluster_client_config),
    ]:
        center.register(fn, name, desc)

    # SPI-discovered custom command handlers (CommandHandler SPI analog —
    # providers carry command_name/command_desc; see core/spi.py and
    # demos/command_handler_spi.py)
    from sentinel_tpu_torch.core.spi import SERVICE_COMMAND_HANDLER, SpiLoader
    for handler in SpiLoader.of(
            SERVICE_COMMAND_HANDLER).load_instance_list_sorted():
        center.register(handler)

    return cstate
