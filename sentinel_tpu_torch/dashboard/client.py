"""HTTP client to agent command planes (reference
``sentinel-dashboard/.../client/SentinelApiClient.java:397-593``).

Every operation maps to one agent command (SURVEY §2.4): ``getRules`` /
``setRules`` per type, ``metric`` with a time range, ``clusterNode`` /
``jsonTree`` for live node views, ``getClusterMode`` / ``setClusterMode``,
``version`` and ``systemStatus``.

The PyTorch port's own copy of ``sentinel_tpu/dashboard/client.py``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional

from sentinel_tpu_torch.metrics.node import MetricNode

DEFAULT_TIMEOUT_S = 3.0

# gateway rule families speak their own commands (reference
# ``SentinelApiClient.fetchApis/modifyApis`` + ``GatewayFlowRuleController``)
_GATEWAY_GET = {"gatewayFlow": "gateway/getRules",
                "gatewayApi": "gateway/getApiDefinitions"}
_GATEWAY_SET = {"gatewayFlow": "gateway/updateRules",
                "gatewayApi": "gateway/updateApiDefinitions"}


class AgentUnreachable(Exception):
    pass


class SentinelApiClient:
    def __init__(self, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.timeout_s = timeout_s

    # ------------------------------------------------------------- plumbing
    def _get(self, ip: str, port: int, command: str,
             params: Optional[Dict[str, str]] = None) -> str:
        qs = ("?" + urllib.parse.urlencode(params)) if params else ""
        url = f"http://{ip}:{port}/{command}{qs}"
        try:
            with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
                return r.read().decode("utf-8")
        except (urllib.error.URLError, OSError) as exc:
            raise AgentUnreachable(f"{url}: {exc}") from exc

    def _post(self, ip: str, port: int, command: str,
              params: Dict[str, str]) -> str:
        url = f"http://{ip}:{port}/{command}"
        data = urllib.parse.urlencode(params).encode("utf-8")
        try:
            with urllib.request.urlopen(url, data=data,
                                        timeout=self.timeout_s) as r:
                return r.read().decode("utf-8")
        except (urllib.error.URLError, OSError) as exc:
            raise AgentUnreachable(f"{url}: {exc}") from exc

    # ------------------------------------------------------------- commands
    def version(self, ip: str, port: int) -> str:
        return self._get(ip, port, "version").strip()

    def fetch_rules(self, ip: str, port: int,
                    rule_type: str) -> List[Dict[str, Any]]:
        if rule_type in _GATEWAY_GET:
            text = self._get(ip, port, _GATEWAY_GET[rule_type])
        else:
            text = self._get(ip, port, "getRules", {"type": rule_type})
        return json.loads(text or "[]")

    def set_rules(self, ip: str, port: int, rule_type: str,
                  rules: List[Dict[str, Any]]) -> bool:
        if rule_type in _GATEWAY_SET:
            resp = self._post(ip, port, _GATEWAY_SET[rule_type],
                              {"data": json.dumps(rules)})
        else:
            resp = self._post(ip, port, "setRules", {
                "type": rule_type, "data": json.dumps(rules)})
        return "success" in resp

    def fetch_metrics(self, ip: str, port: int, start_ms: int,
                      end_ms: int) -> List[MetricNode]:
        text = self._get(ip, port, "metric", {
            "startTime": str(start_ms), "endTime": str(end_ms)})
        nodes = []
        for line in text.splitlines():
            line = line.strip()
            if not line or line == "No metrics":
                continue
            try:
                # agents serve the thin line format (SendMetricCommandHandler
                # returns MetricNode.toThinString)
                nodes.append(MetricNode.from_thin_string(line))
            except (ValueError, IndexError):
                continue
        return nodes

    def fetch_cluster_nodes(self, ip: str, port: int) -> List[Dict[str, Any]]:
        return json.loads(self._get(ip, port, "clusterNode") or "[]")

    def fetch_json_tree(self, ip: str, port: int) -> List[Dict[str, Any]]:
        return json.loads(self._get(ip, port, "jsonTree") or "[]")

    def fetch_system_status(self, ip: str, port: int) -> Dict[str, Any]:
        return json.loads(self._get(ip, port, "systemStatus") or "{}")

    def fetch_obs(self, ip: str, port: int,
                  spans: int = 128, events: int = 64,
                  trace: str = "") -> Dict[str, Any]:
        """Runtime self-telemetry snapshot (``obs`` command): counters,
        latency histograms, recent spans/block events; optionally one
        trace's full span chain."""
        params = {"spans": str(spans), "events": str(events)}
        if trace:
            params["trace"] = trace
        return json.loads(self._get(ip, port, "obs", params) or "{}")

    def fetch_topk(self, ip: str, port: int,
                   timeline: int = 60, tick: bool = False) -> Dict[str, Any]:
        """Hot-resource telemetry snapshot (``topk`` command —
        obs/telemetry.py): current top-K by rolling pass+block QPS plus
        the per-second engine-wide timeline. ``tick=True`` forces one
        device tick + readback first (operator poke when the background
        ticker is off)."""
        params = {"timeline": str(timeline)}
        if tick:
            params["tick"] = "1"
        return json.loads(self._get(ip, port, "topk", params) or "{}")

    def fetch_control(self, ip: str, port: int,
                      actions: int = 32, tick: bool = False
                      ) -> Dict[str, Any]:
        """Overload-controller snapshot (``control`` command —
        control/loop.py): admission fraction, estimator extrema, degrade
        trackers, the last observation, and the applied-action tail.
        ``tick=True`` runs one observe/decide/apply cycle inline first."""
        params = {"actions": str(actions)}
        if tick:
            params["tick"] = "1"
        return json.loads(self._get(ip, port, "control", params) or "{}")

    def fetch_trace(self, ip: str, port: int,
                    trace_id: str = "") -> Dict[str, Any]:
        """Request-scoped trace export (``trace`` command): with an id, a
        Chrome-trace-event/Perfetto document of that causal chain; without,
        the flight recorder's pinned-record index."""
        params = {"id": trace_id} if trace_id else None
        return json.loads(self._get(ip, port, "trace", params) or "{}")

    def get_cluster_mode(self, ip: str, port: int) -> Dict[str, Any]:
        return json.loads(self._get(ip, port, "getClusterMode") or "{}")

    def set_cluster_mode(self, ip: str, port: int, mode: int) -> bool:
        resp = self._post(ip, port, "setClusterMode", {"mode": str(mode)})
        return "success" in resp

    def fetch_origin_stats(self, ip: str, port: int,
                           resource: str) -> List[Dict[str, Any]]:
        """Per-origin rolling stats of one resource (agent ``origin``
        command — ``FetchOriginCommandHandler``)."""
        return json.loads(self._get(ip, port, "origin",
                                    {"id": resource}) or "[]")

    def fetch_cluster_server_info(self, ip: str, port: int) -> Dict[str, Any]:
        """``cluster/server/info`` (FetchClusterServerInfoCommandHandler)."""
        return json.loads(self._get(ip, port, "cluster/server/info") or "{}")

    def fetch_cluster_server_metrics(self, ip: str, port: int,
                                     namespace: str) -> List[Dict[str, Any]]:
        """Token-server per-flow current-window metrics
        (``cluster/server/metricList`` — ClusterMetricNode shapes)."""
        return json.loads(self._get(ip, port, "cluster/server/metricList",
                                    {"namespace": namespace}) or "[]")

    def set_cluster_client_config(self, ip: str, port: int,
                                  server_host: str, server_port: int,
                                  request_timeout: int = 0) -> bool:
        cfg = {"serverHost": server_host, "serverPort": server_port}
        if request_timeout:
            cfg["requestTimeout"] = request_timeout
        resp = self._post(ip, port, "setClusterClientConfig",
                          {"data": json.dumps(cfg)})
        return "success" in resp

    def fetch_cluster_server_config(self, ip: str, port: int,
                                    namespace: str = "") -> Dict[str, Any]:
        """``cluster/server/fetchConfig`` — ``{flow, namespaceSet,
        transport}`` without a namespace, or the per-namespace
        ``ServerFlowConfig`` view (``maxAllowedQps``) with one (reference
        ``FetchClusterServerConfigHandler``)."""
        params = {"namespace": namespace} if namespace else None
        return json.loads(self._get(ip, port, "cluster/server/fetchConfig",
                                    params) or "{}")

    def set_cluster_server_flow_config(self, ip: str, port: int,
                                       namespace: str,
                                       max_allowed_qps: float) -> bool:
        """Per-namespace ``ServerFlowConfig.maxAllowedQps`` (reference
        ``ModifyClusterServerFlowConfigHandler`` →
        ``GlobalRequestLimiter``)."""
        resp = self._post(
            ip, port, "cluster/server/modifyFlowConfig",
            {"namespace": namespace,
             "data": json.dumps({"maxAllowedQps": max_allowed_qps})})
        return "success" in resp

    def set_cluster_server_namespace_set(self, ip: str, port: int,
                                         namespaces: List[str]) -> bool:
        """Replace the token server's served-namespace set (reference
        ``ModifyServerNamespaceSetHandler``)."""
        resp = self._post(ip, port, "cluster/server/modifyNamespaceSet",
                          {"data": json.dumps(list(namespaces))})
        return "success" in resp
