"""Cluster-server command-plane handlers (reference
``sentinel-cluster-server-default/.../command/handler/*`` — the 10
``cluster/server/*`` commands the dashboard uses to manage a token server
over HTTP).

Wire formats match the reference: modify/fetch flow rules speak standard
``FlowRule`` JSON (cluster fields in ``clusterConfig`` —
``ModifyClusterFlowRulesCommandHandler.java``), param rules speak
``ParamFlowRule`` JSON, ``fetchConfig`` returns the
``{transport, flow, namespaceSet}`` shape of
``FetchClusterServerConfigHandler.java``, and ``metricList`` returns
``ClusterMetricNode``-shaped dicts.

Register with :func:`register_cluster_server_handlers` — pass a
:class:`~sentinel_tpu_torch.cluster.coordinator.ClusterCoordinator` for live
resolution (the engine/server exist only while serving), or a fixed
engine/server pair for a standalone token-server process.

The PyTorch port's own copy of ``sentinel_tpu/cluster/commands.py``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from sentinel_tpu_torch.transport.command import (
    CommandCenter, CommandRequest, CommandResponse,
)

SUCCESS = "success"


class ClusterServerCommands:
    def __init__(self, *, engine=None, server=None, coordinator=None,
                 clock=None):
        self._engine = engine
        self._server = server
        self.coordinator = coordinator
        self._clock = clock
        # raw rule payloads per namespace: display-field enrichment for
        # fetch (resource names, grades) and verbatim round-trip of
        # non-cluster-mode beans; enforcement fields always come from the
        # engine (see _engine_rule_beans)
        self._raw_flow: Dict[str, List[dict]] = {}
        self._raw_param: Dict[str, List[dict]] = {}
        self._namespace_set: List[str] = []

    # ------------------------------------------------------------- plumbing
    def _resolve_server(self):
        if self._server is not None:
            return self._server
        if self.coordinator is not None:
            return self.coordinator.server
        return None

    def _resolve_engine(self):
        if self._engine is not None:
            return self._engine
        srv = self._resolve_server()
        return srv.engine if srv is not None else None

    def _now_ms(self) -> int:
        if self._clock is not None:
            return self._clock.now_ms()
        if self.coordinator is not None:
            return self.coordinator.clock.now_ms()
        import time
        return int(time.time() * 1000)

    @staticmethod
    def _need(req: CommandRequest, name: str) -> Optional[str]:
        v = req.param(name)
        return v if v else None

    def _engine_or_fail(self):
        eng = self._resolve_engine()
        if eng is None:
            return None, CommandResponse.of_failure(
                "token server not running", 400)
        return eng, None

    # ------------------------------------------------------------ rules
    def _engine_rule_beans(self, ns: str, *, param: bool) -> List[dict]:
        """Rule beans for a namespace derived from ENGINE state (the
        authoritative enforcement tables), enriched with the raw JSON pushed
        through the modify commands when available.  Rules loaded through any
        other path (direct ``engine.load_rules``, a standalone server's own
        config) are synthesized from the engine's rule structs so fetch and
        ``metricList`` never disagree with live enforcement."""
        eng = self._resolve_engine()
        if eng is None:
            return list((self._raw_param if param else
                         self._raw_flow).get(ns, []))
        raw_list = (self._raw_param if param else self._raw_flow).get(ns, [])
        raw = {}
        for d in raw_list:
            fid = (d.get("clusterConfig") or {}).get("flowId")
            if fid is not None and d.get("clusterMode"):
                raw[int(fid)] = d
        beans: List[dict] = []
        for fid, r in eng.namespace_rules(ns, param=param).items():
            if fid in raw:
                # raw bean supplies display fields (resource name, grade…)
                # but ENFORCEMENT fields come from the engine — a direct
                # engine.load_rules after the push must win in fetch too
                bean = dict(raw[fid])
                bean["count"] = float(r.count)
                cc = dict(bean.get("clusterConfig") or {})
                cc["flowId"] = int(fid)
                cc["thresholdType"] = int(r.threshold_type)
                bean["clusterConfig"] = cc
            else:
                bean = {"resource": str(fid), "count": float(r.count),
                        "clusterMode": True,
                        "clusterConfig": {
                            "flowId": int(fid),
                            "thresholdType": int(r.threshold_type)}}
                if param:
                    bean["grade"] = 1
            if param:
                # per-item thresholds are enforcement too: always rebuilt
                # from the engine rule, never served from the stale bean
                # (classType display strings are kept from the pushed bean
                # when the item survives)
                ctypes = {str(it.get("object")): it.get("classType")
                          for it in bean.get("paramFlowItemList", [])}
                items = getattr(r, "items", None)
                if items:
                    bean["paramFlowItemList"] = [
                        {"object": str(k), "count": float(v),
                         "classType": ctypes.get(str(k),
                                                 type(k).__name__)}
                        for k, v in items.items()]
                else:
                    bean.pop("paramFlowItemList", None)
            beans.append(bean)
        # non-cluster-mode beans pushed through modify are not enforced by
        # the cluster engine but must still round-trip verbatim (the
        # reference stores full FlowRule beans)
        for d in raw_list:
            fid = (d.get("clusterConfig") or {}).get("flowId")
            if fid is None or not d.get("clusterMode"):
                beans.append(d)
        return beans

    def cmd_fetch_flow_rules(self, req: CommandRequest) -> CommandResponse:
        ns = self._need(req, "namespace")
        if ns is None:
            return CommandResponse.of_failure("empty namespace", 400)
        return CommandResponse.of_success(
            json.dumps(self._engine_rule_beans(ns, param=False)))

    def cmd_modify_flow_rules(self, req: CommandRequest) -> CommandResponse:
        from sentinel_tpu_torch.parallel.cluster import ClusterFlowRule
        from sentinel_tpu_torch.rules import codec
        ns = self._need(req, "namespace")
        if ns is None:
            return CommandResponse.of_failure("empty namespace", 400)
        data = req.param("data") or (req.body.decode("utf-8")
                                     if req.body else "")
        if not data.strip():
            return CommandResponse.of_failure("empty data", 400)
        eng, fail = self._engine_or_fail()
        if fail:
            return fail
        try:
            flow_rules = codec.rules_from_json("flow", data)
        except (ValueError, KeyError, TypeError) as exc:
            return CommandResponse.of_failure(
                f"decode cluster flow rules error: {exc}", 400)
        crules = [ClusterFlowRule(
            flow_id=f.cluster_flow_id, count=f.count,
            threshold_type=f.cluster_threshold_type)
            for f in flow_rules if f.cluster_mode]
        eng.load_rules(ns, crules)
        self._raw_flow[ns] = json.loads(codec.rules_to_json(
            "flow", flow_rules))
        return CommandResponse.of_success(SUCCESS)

    def cmd_fetch_param_rules(self, req: CommandRequest) -> CommandResponse:
        ns = self._need(req, "namespace")
        if ns is None:
            return CommandResponse.of_failure("empty namespace", 400)
        return CommandResponse.of_success(
            json.dumps(self._engine_rule_beans(ns, param=True)))

    def cmd_modify_param_rules(self, req: CommandRequest) -> CommandResponse:
        from sentinel_tpu_torch.parallel.cluster import ClusterParamFlowRule
        from sentinel_tpu_torch.rules import codec
        ns = self._need(req, "namespace")
        if ns is None:
            return CommandResponse.of_failure("empty namespace", 400)
        data = req.param("data") or (req.body.decode("utf-8")
                                     if req.body else "")
        if not data.strip():
            return CommandResponse.of_failure("empty data", 400)
        eng, fail = self._engine_or_fail()
        if fail:
            return fail
        try:
            prules = codec.rules_from_json("paramFlow", data)
        except (ValueError, KeyError, TypeError) as exc:
            return CommandResponse.of_failure(
                f"decode cluster param rules error: {exc}", 400)
        crules = [ClusterParamFlowRule(
            flow_id=p.cluster_flow_id, count=p.count,
            items={it.object: float(it.count)
                   for it in p.param_flow_item_list} or None)
            for p in prules if p.cluster_mode]
        eng.load_param_rules(ns, crules)
        self._raw_param[ns] = json.loads(codec.rules_to_json(
            "paramFlow", prules))
        return CommandResponse.of_success(SUCCESS)

    # ------------------------------------------------------------ config
    def cmd_fetch_config(self, req: CommandRequest) -> CommandResponse:
        eng = self._resolve_engine()
        srv = self._resolve_server()
        flow_cfg = {"exceedCount": 1.0, "maxOccupyRatio": 1.0,
                    "intervalMs": 1000, "sampleCount": 10}
        if eng is not None:
            w = eng.spec.window
            flow_cfg["intervalMs"] = int(w.win_ms * w.buckets)
            flow_cfg["sampleCount"] = int(w.buckets)
        ns = req.param("namespace")
        if ns:
            if eng is not None:
                # read-only: must not allocate a namespace slot for typos
                flow_cfg["maxAllowedQps"] = eng.namespace_qps_limit(
                    ns, create=False)
            return CommandResponse.of_success(json.dumps({"flow": flow_cfg}))
        out = {"flow": flow_cfg, "namespaceSet": list(self._namespace_set)}
        if srv is not None:
            out["transport"] = {"port": srv.port,
                                "idleSeconds": srv.idle_seconds}
        return CommandResponse.of_success(json.dumps(out))

    def cmd_modify_transport_config(self,
                                    req: CommandRequest) -> CommandResponse:
        srv = self._resolve_server()
        if srv is None:
            return CommandResponse.of_failure("token server not running", 400)
        data = req.param("data") or (req.body.decode("utf-8")
                                     if req.body else "")
        try:
            cfg = json.loads(data or "{}")
            port = cfg.get("port")
            idle = cfg.get("idleSeconds")
            srv.update_transport_config(
                port=int(port) if port is not None else None,
                idle_seconds=float(idle) if idle is not None else None)
        except (ValueError, TypeError, RuntimeError) as exc:
            return CommandResponse.of_failure(
                f"modify transport config failed: {exc}", 400)
        return CommandResponse.of_success(SUCCESS)

    def cmd_modify_flow_config(self, req: CommandRequest) -> CommandResponse:
        """Per-namespace ``ServerFlowConfig`` — ``maxAllowedQps`` feeds the
        GlobalRequestLimiter analog; window geometry is fixed by the engine
        spec (a live geometry change would rebuild the sharded tables)."""
        ns = self._need(req, "namespace")
        if ns is None:
            return CommandResponse.of_failure("empty namespace", 400)
        eng, fail = self._engine_or_fail()
        if fail:
            return fail
        data = req.param("data") or (req.body.decode("utf-8")
                                     if req.body else "")
        try:
            cfg = json.loads(data or "{}")
            if "maxAllowedQps" in cfg:
                eng.set_namespace_qps_limit(ns, float(cfg["maxAllowedQps"]))
        except (ValueError, TypeError) as exc:
            return CommandResponse.of_failure(
                f"modify flow config failed: {exc}", 400)
        return CommandResponse.of_success(SUCCESS)

    def cmd_modify_namespace_set(self,
                                 req: CommandRequest) -> CommandResponse:
        eng, fail = self._engine_or_fail()
        if fail:
            return fail
        data = req.param("data") or (req.body.decode("utf-8")
                                     if req.body else "")
        try:
            namespaces = json.loads(data or "[]")
            if not isinstance(namespaces, list):
                raise ValueError("expected a JSON list of namespaces")
            for ns in namespaces:
                eng.namespace_id(str(ns))       # pre-register the slot
        except (ValueError, TypeError) as exc:
            return CommandResponse.of_failure(
                f"modify namespace set failed: {exc}", 400)
        self._namespace_set = [str(n) for n in namespaces]
        return CommandResponse.of_success(SUCCESS)

    # ------------------------------------------------------------ info
    def cmd_info(self, req: CommandRequest) -> CommandResponse:
        out: dict = {}
        if self.coordinator is not None:
            out.update(self.coordinator.info())
        srv = self._resolve_server()
        eng = self._resolve_engine()
        if srv is not None:
            out.update(port=srv.port, idleSeconds=srv.idle_seconds,
                       connectedCount=len(getattr(srv, "_conns", ())))
        if eng is not None:
            out["namespaceSet"] = self._namespace_set
        return CommandResponse.of_success(json.dumps(out))

    def cmd_metric_list(self, req: CommandRequest) -> CommandResponse:
        """Current-window metric per flow of the namespace
        (``ClusterMetricNodeGenerator.generateCurrentNodeMap``)."""
        ns = self._need(req, "namespace")
        if ns is None:
            return CommandResponse.of_failure("namespace cannot be empty",
                                              400)
        eng, fail = self._engine_or_fail()
        if fail:
            return fail
        now = self._now_ms()
        names = {}
        for d in (self._engine_rule_beans(ns, param=False)
                  + self._engine_rule_beans(ns, param=True)):
            fid = (d.get("clusterConfig") or {}).get("flowId")
            if fid is not None:
                names[int(fid)] = d.get("resource", "")
        nodes = []
        for fid in eng.namespace_flow_ids(ns):
            m = eng.flow_metrics(fid, now_ms=now)
            if not m:
                continue
            w = eng.spec.window
            secs = max(w.win_ms * w.buckets / 1000.0, 1e-9)
            nodes.append({
                "timestamp": now, "flowId": fid,
                "resourceName": names.get(fid, str(fid)),
                "passQps": round(m.get("pass", 0) / secs, 2),
                "blockQps": round(m.get("block", 0) / secs, 2),
                "rt": 0,
                "topParams": {str(k): v for k, v in
                              eng.top_params(fid, now_ms=now).items()},
            })
        return CommandResponse.of_success(json.dumps(nodes))


def register_cluster_server_handlers(
        center: CommandCenter, *, engine=None, server=None,
        coordinator=None, clock=None) -> ClusterServerCommands:
    cmds = ClusterServerCommands(engine=engine, server=server,
                                 coordinator=coordinator, clock=clock)
    for name, desc, fn in [
        ("cluster/server/flowRules", "get cluster flow rules",
         cmds.cmd_fetch_flow_rules),
        ("cluster/server/modifyFlowRules", "modify cluster flow rules",
         cmds.cmd_modify_flow_rules),
        ("cluster/server/paramRules", "get cluster server param flow rules",
         cmds.cmd_fetch_param_rules),
        ("cluster/server/modifyParamRules",
         "modify cluster param flow rules", cmds.cmd_modify_param_rules),
        ("cluster/server/fetchConfig", "get cluster server config",
         cmds.cmd_fetch_config),
        ("cluster/server/modifyTransportConfig",
         "modify cluster server transport config",
         cmds.cmd_modify_transport_config),
        ("cluster/server/modifyFlowConfig",
         "modify cluster server flow config", cmds.cmd_modify_flow_config),
        ("cluster/server/modifyNamespaceSet",
         "modify server namespace set", cmds.cmd_modify_namespace_set),
        ("cluster/server/info", "get cluster server info", cmds.cmd_info),
        ("cluster/server/metricList", "get cluster server metrics",
         cmds.cmd_metric_list),
    ]:
        center.register(fn, name, desc)
    return cmds
