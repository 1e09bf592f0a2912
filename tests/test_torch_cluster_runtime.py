"""Port parity: the runtime's cluster-mode rules and the cluster
coordinator against the JAX package's.

Twin runtimes under twin ManualClocks run the reference's scenarios of
``tests/test_cluster_integration.py`` (cluster-mode flow and param rules
asking a scripted token service: OK, BLOCKED, SHOULD_WAIT, FAIL and
TOO_MANY_REQUEST, per-rule local fallback, the batch tier's one batched
call) and the three of ``tests/test_cluster_coordinator.py`` that need no
dashboard (an embedded server serving its own rules, mode off, a client
talking to a server on loopback). Each side gets its own package's
service: the same scripted fake, or its package's coordinator, server and
engine. The observations (verdicts, exceptions, waits, node totals, the
service's calls), the block-log lines, the ``obs`` counters less
``compile_cache.*`` / ``tune.*`` and the engine state must agree — and
for the coordinator the embedded engines' windows too.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.cluster import coordinator as jcoord
from sentinel_tpu.core import logs as jlogs
from sentinel_tpu.parallel import cluster as jcl
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.cluster import coordinator as tcoord
from sentinel_tpu_torch.core import logs as tlogs
from sentinel_tpu_torch.parallel import cluster as tcl

torch.set_num_threads(2)

T0 = 1_785_000_000_000
PKGS = {"jax": stpu, "torch": stt}
LOGS = {"jax": jlogs, "torch": tlogs}
COORD = {"jax": jcoord, "torch": tcoord}
CLUSTER = {"jax": jcl, "torch": tcl}
#: counter families the comparison leaves out: the reference's compiled-
#: program accounting and its autotuner, which the port does not have
EXCLUDED = ("compile_cache.", "tune.")


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


def make(pkg, clk):
    cfg = pkg.load_config(max_resources=64, max_flow_rules=16,
                          max_degrade_rules=16, max_authority_rules=16,
                          minute_enabled=True)
    extra = {"device": "cpu"} if pkg is stt else {}
    sph = pkg.Sentinel(config=cfg, clock=clk, **extra)
    sph._cpu.sample = lambda: (0.5, 0.25)
    return sph


def twin(scenario, tmp_path):
    """``scenario(name, pkg, sph, clk) -> observations`` on twin runtimes
    whose block logs write under ``tmp_path/<package>`` → the port's
    observations; observations, counters, block-log lines and state must
    agree."""
    got, lines, snaps = {}, {}, {}
    for name, pkg in PKGS.items():
        clk = pkg.ManualClock(start_ms=T0)
        sph = make(pkg, clk)
        sph.block_log.close()
        sph.block_log = LOGS[name].BlockStatLogger(
            clk, base_dir=str(tmp_path / name))
        obs = scenario(name, pkg, sph, clk)
        counters = {k: v for k, v in sph.obs.counters.snapshot().items()
                    if not k.startswith(EXCLUDED)}
        sph.block_log.flush()
        path = tmp_path / name / sph.block_log.FILE_NAME
        lines[name] = path.read_text().splitlines() if path.exists() else []
        snaps[name] = convert.engine_to_numpy(sph)
        got[name] = (obs, counters)
        sph.close()
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
    assert lines["torch"] == lines["jax"]
    assert convert.leaf_diff(snaps["jax"], snaps["torch"]) == []
    return got["torch"][0]


@dataclasses.dataclass
class _Result:
    status: int
    wait_ms: int = 0


class FakeTokenService:
    def __init__(self, script=()):
        self.script = list(script)   # results popped per request
        self.calls = []

    def request_token(self, flow_id, count, prioritized=False):
        self.calls.append((flow_id, count, prioritized))
        return self.script.pop(0) if self.script else _Result(0)


class FakeParamTokenService(FakeTokenService):
    def request_param_token(self, flow_id, count, params):
        self.calls.append(("param", flow_id, count, tuple(params)))
        return self.script.pop(0) if self.script else _Result(0)


class PerFlowTokenService:
    """Scripts verdicts per flow id (mixed grant/failure scenarios)."""

    def __init__(self, by_flow):
        self.by_flow = dict(by_flow)
        self.calls = []

    def request_token(self, flow_id, count, prioritized=False):
        self.calls.append((flow_id, count, prioritized))
        return _Result(self.by_flow.get(flow_id, 0))


def cluster_rule(pkg, **over):
    kw = dict(resource="csvc", count=100.0, cluster_mode=True,
              cluster_flow_id=42, cluster_fallback_to_local=True)
    kw.update(over)
    return pkg.FlowRule(**kw)


def _entries(pkg, sph, n, resource="csvc", **kw):
    out = []
    for _ in range(n):
        try:
            with sph.entry(resource, **kw):
                out.append("pass")
        except pkg.BlockException as exc:
            out.append(type(exc).__name__)
    return out


def verdicts(v):
    return (np.asarray(v.allow).tolist(), np.asarray(v.reason).tolist(),
            np.asarray(v.wait_ms).tolist())


# ------------------------------------------- test_cluster_integration.py

def scn_ok_token_passes_and_skips_local_count(name, pkg, sph, clk):
    svc = FakeTokenService()
    sph.set_token_service(svc)
    sph.load_flow_rules([cluster_rule(pkg, count=0.0)])
    out = _entries(pkg, sph, 3)
    assert svc.calls == [(42, 1, False)] * 3
    assert sph.node_totals("csvc")["pass"] == 3
    return out, svc.calls, sph.node_totals("csvc")


def scn_blocked_token_raises_and_records(name, pkg, sph, clk):
    svc = FakeTokenService([_Result(1)])
    sph.set_token_service(svc)
    sph.load_flow_rules([cluster_rule(pkg)])
    out = _entries(pkg, sph, 1)
    assert out == ["FlowException"]
    t = sph.node_totals("csvc")
    assert t["block"] == 1 and t["pass"] == 0
    return out, t


def scn_should_wait_sleeps_then_passes(name, pkg, sph, clk):
    svc = FakeTokenService([_Result(2, wait_ms=120)])
    sph.set_token_service(svc)
    sph.load_flow_rules([cluster_rule(pkg)])
    before = clk.now_ms()
    out = _entries(pkg, sph, 1)
    assert clk.now_ms() - before == 120
    # with sleep=False the wait comes back on the entry instead
    svc.script = [_Result(2, wait_ms=70)]
    e = sph.entry("csvc", sleep=False)
    e.exit()
    return out, clk.now_ms() - before, e.wait_ms


def scn_fail_falls_back_to_local_check(name, pkg, sph, clk):
    svc = FakeTokenService([_Result(-1)] * 5)
    sph.set_token_service(svc)
    sph.load_flow_rules([cluster_rule(pkg, count=2.0)])
    out = _entries(pkg, sph, 5)
    assert out == ["pass", "pass"] + ["FlowException"] * 3
    return out


def scn_fail_without_fallback_passes_through(name, pkg, sph, clk):
    svc = FakeTokenService([_Result(-1)] * 4)
    sph.set_token_service(svc)
    sph.load_flow_rules([cluster_rule(pkg, count=0.0,
                                      cluster_fallback_to_local=False)])
    out = _entries(pkg, sph, 4)
    assert sph.node_totals("csvc")["pass"] == 4
    return out


def scn_no_service_installed_behaves_like_fail(name, pkg, sph, clk):
    sph.load_flow_rules([cluster_rule(pkg, count=1.0)])
    out = _entries(pkg, sph, 3)
    assert out == ["pass", "FlowException", "FlowException"]
    return out


def scn_cluster_rule_inactive_locally_when_tokens_granted(name, pkg, sph,
                                                          clk):
    sph.set_token_service(FakeTokenService())
    sph.load_flow_rules([cluster_rule(pkg, count=0.0),
                         pkg.FlowRule(resource="csvc", count=2.0)])
    out = _entries(pkg, sph, 4)
    assert out == ["pass", "pass", "FlowException", "FlowException"]
    return out


def scn_entry_batch_enforces_cluster_rules(name, pkg, sph, clk):
    svc = FakeTokenService([_Result(0), _Result(1), _Result(2, wait_ms=80),
                            _Result(-1)])
    sph.set_token_service(svc)
    sph.load_flow_rules([cluster_rule(pkg, count=0.0)])
    v = sph.entry_batch(["csvc"] * 4)
    assert list(map(bool, v.allow)) == [True, False, True, False]
    assert int(v.wait_ms[2]) == 80
    t = sph.node_totals("csvc")
    assert t["block"] == 2 and t["pass"] == 2
    # interned rows and origins take the same precheck
    svc.script = [_Result(1), _Result(0)]
    rows = sph.intern_resources(["csvc", "csvc"])
    v2 = sph.entry_batch(rows, origins=["app-a", ""])
    return verdicts(v), verdicts(v2), t, svc.calls


def scn_batch_cluster_block_leaves_no_stat_residue(name, pkg, sph, clk):
    svc = FakeTokenService([_Result(1)])
    sph.set_token_service(svc)
    sph.load_flow_rules([cluster_rule(pkg)])
    v = sph.entry_batch(["csvc"])
    assert not bool(v.allow[0])
    t = sph.node_totals("csvc")
    assert t["pass"] == 0 and t["block"] == 1 and t["threads"] == 0
    totals = {n: tot for n, _row, tot in sph.all_node_totals()}
    g = totals.get("__entry_node__") or totals.get(
        "__total_inbound_traffic__")
    assert g["pass"] == 0 and g["threads"] == 0 and g["block"] == 1
    return verdicts(v), t, g


def scn_cluster_param_rule_delegates(name, pkg, sph, clk):
    svc = FakeParamTokenService()
    sph.set_token_service(svc)
    sph.load_param_flow_rules([pkg.ParamFlowRule(
        resource="psvc", param_idx=0, count=100, cluster_mode=True,
        cluster_flow_id=77)])
    out = _entries(pkg, sph, 1, "psvc", args=("alice",))
    assert svc.calls == [("param", 77, 1, ("alice",))]
    svc.script = [_Result(1)]
    out += _entries(pkg, sph, 1, "psvc", args=("alice",))
    t = sph.node_totals("psvc")
    assert t["pass"] == 1 and t["block"] == 1
    svc.script = [_Result(2, wait_ms=90)]
    before = clk.now_ms()
    out += _entries(pkg, sph, 1, "psvc", args=("bob",))
    assert clk.now_ms() - before == 90
    n = len(svc.calls)
    out += _entries(pkg, sph, 1, "psvc")
    assert len(svc.calls) == n
    return out, svc.calls, t


def scn_too_many_request_falls_back_to_local(name, pkg, sph, clk):
    sph.set_token_service(FakeTokenService([_Result(-2)] * 5))
    sph.load_flow_rules([cluster_rule(pkg, count=2.0)])
    out = _entries(pkg, sph, 5)
    assert out == ["pass", "pass"] + ["FlowException"] * 3
    return out


def scn_too_many_request_param_passes_through(name, pkg, sph, clk):
    sph.set_token_service(FakeParamTokenService([_Result(-2)] * 3))
    sph.load_param_flow_rules([pkg.ParamFlowRule(
        resource="psvc", param_idx=0, count=100, cluster_mode=True,
        cluster_flow_id=77)])
    out = _entries(pkg, sph, 3, "psvc", args=("alice",))
    assert sph.node_totals("psvc")["pass"] == 3
    return out


def scn_mixed_grant_failure_enforces_failed_rule_locally(name, pkg, sph,
                                                         clk):
    sph.set_token_service(PerFlowTokenService({42: 0, 43: -1}))
    sph.load_flow_rules([cluster_rule(pkg, count=0.0, cluster_flow_id=42),
                         cluster_rule(pkg, count=2.0, cluster_flow_id=43)])
    out = _entries(pkg, sph, 5)
    assert out == ["pass", "pass"] + ["FlowException"] * 3
    return out


def scn_mixed_grant_failure_batch_tier(name, pkg, sph, clk):
    sph.set_token_service(PerFlowTokenService({42: 0, 43: -1}))
    sph.load_flow_rules([cluster_rule(pkg, count=0.0, cluster_flow_id=42),
                         cluster_rule(pkg, count=2.0, cluster_flow_id=43)])
    v = sph.entry_batch(["csvc"] * 5)
    assert list(map(bool, v.allow)) == [True, True, False, False, False]
    return verdicts(v)


def scn_batch_cluster_param_block_reason_and_single_count(name, pkg, sph,
                                                          clk):
    sph.set_token_service(FakeParamTokenService([_Result(1)]))
    sph.load_param_flow_rules([pkg.ParamFlowRule(
        resource="psvc", param_idx=0, count=100, cluster_mode=True,
        cluster_flow_id=77)])
    v = sph.entry_batch(["psvc"], args_list=[("alice",)])
    assert not bool(v.allow[0])
    assert int(v.reason[0]) == int(pkg.BlockReason.PARAM_FLOW)
    t = sph.node_totals("psvc")
    assert t["block"] == 1 and t["pass"] == 0
    return verdicts(v), t


def scn_batch_without_a_batch_call_and_a_split(name, pkg, sph, clk):
    """A per-call service in the batch tier (one request an event), and a
    batch of 4200 events whose fallback bits keep 200 off the scalar
    route (the split)."""
    svc = FakeTokenService([_Result(-1)] * 3 + [_Result(1)])
    sph.set_token_service(svc)
    sph.load_flow_rules([cluster_rule(pkg, count=1.0, resource="c2"),
                         pkg.FlowRule(resource="plain", count=5000.0)])
    v1 = sph.entry_batch(["c2"] * 4)
    names = ["plain"] * 4000 + ["c2"] * 200
    v2 = sph.entry_batch(names)
    return verdicts(v1), verdicts(v2), len(svc.calls)


INTEGRATION = [v for k, v in sorted(globals().items())
               if k.startswith("scn_")]


@pytest.mark.parametrize("scenario", INTEGRATION,
                         ids=lambda f: f.__name__[4:])
def test_integration_scenario_matches_reference(scenario, tmp_path):
    twin(scenario, tmp_path)


# -------------------------------------------- test_cluster_coordinator.py

def _engine_state(coord):
    return convert.cluster_to_numpy(coord.server.engine)


def coord_server_mode_serves_own_rules_embedded(name, pkg, sph, clk):
    cm, cl = COORD[name], CLUSTER[name]
    coord = cm.ClusterCoordinator(sph, clock=pkg.ManualClock(start_ms=T0))
    try:
        sph.load_flow_rules([pkg.FlowRule(
            resource="gsvc", count=1000, cluster_mode=True,
            cluster_flow_id=7, cluster_fallback_to_local=True)])
        coord.on_mode_change(cm.CLUSTER_SERVER)
        assert coord.server is not None and coord.server.port > 0
        if pkg is stt:
            assert coord.server.engine.device == sph.device
        coord.server.load_flow_rules(coord.namespace, [cl.ClusterFlowRule(
            flow_id=7, count=2, threshold_type=cl.THRESHOLD_GLOBAL)])
        out = _entries(pkg, sph, 4, "gsvc")
        assert out == ["pass", "pass", "FlowException", "FlowException"]
        v = sph.entry_batch(["gsvc"] * 3)
        return out, verdicts(v), _engine_state(coord), coord.info()["effectiveMode"]
    finally:
        coord.stop()


def coord_mode_off_uninstalls_service(name, pkg, sph, clk):
    cm = COORD[name]
    coord = cm.ClusterCoordinator(sph, clock=pkg.ManualClock(start_ms=T0))
    try:
        sph.load_flow_rules([pkg.FlowRule(
            resource="gsvc", count=1.0, cluster_mode=True,
            cluster_flow_id=7, cluster_fallback_to_local=True)])
        coord.on_mode_change(cm.CLUSTER_SERVER)
        coord.on_mode_change(cm.CLUSTER_NOT_STARTED)
        assert coord.server is None
        out = _entries(pkg, sph, 3, "gsvc")
        assert out == ["pass", "FlowException", "FlowException"]
        return out, coord.mode
    finally:
        coord.stop()


def coord_client_mode_talks_to_remote_server(name, pkg, sph, clk):
    cm, cl = COORD[name], CLUSTER[name]
    server_app = make(pkg, pkg.ManualClock(start_ms=T0))
    server_coord = cm.ClusterCoordinator(server_app,
                                         clock=pkg.ManualClock(start_ms=T0))
    client_coord = cm.ClusterCoordinator(
        sph, namespace=server_coord.namespace,
        clock=pkg.ManualClock(start_ms=T0))
    try:
        server_coord.on_mode_change(cm.CLUSTER_SERVER)
        server_coord.server.load_flow_rules(
            server_coord.namespace,
            [cl.ClusterFlowRule(flow_id=7, count=2,
                                threshold_type=cl.THRESHOLD_GLOBAL)])
        sph.load_flow_rules([pkg.FlowRule(
            resource="gsvc", count=1000, cluster_mode=True,
            cluster_flow_id=7, cluster_fallback_to_local=False)])
        client_coord.configure_client("127.0.0.1", server_coord.server.port,
                                      request_timeout_ms=60_000)
        client_coord.on_mode_change(cm.CLUSTER_CLIENT)
        assert client_coord.client is not None
        res = _entries(pkg, sph, 4, "gsvc")
        assert res.count("pass") == 2 and res.count("FlowException") == 2
        return res, _engine_state(server_coord)
    finally:
        client_coord.stop()
        server_coord.stop()
        server_app.close()


COORDINATOR = [coord_server_mode_serves_own_rules_embedded,
               coord_mode_off_uninstalls_service,
               coord_client_mode_talks_to_remote_server]


def _same(a, b):
    """Observations with cluster-state dicts compared leaf by leaf."""
    if isinstance(a, dict) and a and all(isinstance(v, np.ndarray)
                                         for v in a.values()):
        return convert.leaf_diff(a, b) == []
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("scenario", COORDINATOR,
                         ids=lambda f: f.__name__[6:])
def test_coordinator_scenario_matches_reference(scenario, tmp_path):
    got = {}

    def _observe(name, pkg, sph, clk):
        got[name] = scenario(name, pkg, sph, clk)
        return None

    twin(_observe, tmp_path)
    assert _same(got["jax"], got["torch"])


def test_bind_with_a_command_center_names_roadmap_a12():
    """ROADMAP A12's command half is ported: ``bind`` with a command
    center wires the mode and config observers and registers the ten
    ``cluster/server/*`` commands, as the reference's does."""
    from sentinel_tpu.cluster import commands as jcmd
    from sentinel_tpu_torch.transport import CommandCenter
    from sentinel_tpu_torch.transport.handlers import ClusterModeState

    sph = make(stt, stt.ManualClock(start_ms=T0))
    coord = tcoord.ClusterCoordinator(sph)
    state, center = ClusterModeState(), CommandCenter()
    coord.bind(state, command_center=center)
    assert state.info_provider == coord.info
    names = sorted(n for n in center.names()
                   if n.startswith("cluster/server/"))
    assert len(names) == 10
    from sentinel_tpu.transport import CommandCenter as JCenter
    jcenter = JCenter()
    jcmd.register_cluster_server_handlers(jcenter)
    assert names == sorted(jcenter.names())
    state.set_mode(tcoord.CLUSTER_SERVER)
    assert coord.mode == tcoord.CLUSTER_SERVER and coord.server is not None
    coord.stop()
    sph.close()
