"""Port parity: the multi-process fabric (``sentinel_tpu_torch.multihost``)
and the multi-process cluster token engine against
``sentinel_tpu.multihost`` and the JAX engine.

Twins of ``tests/test_multihost.py``: the shard math, the bootstrap
config and the launcher on both packages; then the acceptance gate —
the port's parity worker in 2 processes × 4 shards and in 1 process × 8
shards (gloo on the CPU, ``SENTINEL_MH_PLATFORM=cpu``) decides the
shared stream exactly as the JAX engine does over the conftest's 8
virtual CPU devices, computed here through the reference worker's own
``build_engine`` and ``run_parity``; the gathered flow window equals the
one-process engine's bit for bit. The top-K merge and the counter and
RT-histogram aggregates run in 2 processes (the JAX top-K worker too,
through the reference's launcher) and in this one against the JAX
functions on the same counts (quantiles below 2^24 a row, the range
ROADMAP C1 states). The file's launches run two at a time in a module
fixture, their workers on one thread each.
"""

import concurrent.futures
import importlib
import json
import socket

import numpy as np
import pytest
import torch

from sentinel_tpu.multihost import bootstrap as j_boot
from sentinel_tpu.parallel import shard_math as j_sm
from sentinel_tpu_torch.multihost import bootstrap as t_boot
from sentinel_tpu_torch.multihost import mesh as t_mesh
from sentinel_tpu_torch.parallel import shard_math as t_sm

# the packages export ``launch`` the function over ``launch`` the module
j_launch = importlib.import_module("sentinel_tpu.multihost.launch")
t_launch = importlib.import_module("sentinel_tpu_torch.multihost.launch")

torch.set_num_threads(2)

STATUS = dict(fail=-1, bad=-4, no_rule=3)
SM = {"jax": j_sm, "torch": t_sm}
PORT_PARITY = ["-m", "sentinel_tpu_torch.multihost._parity_worker"]
PORT_TOPK = ["-m", "sentinel_tpu_torch.multihost._topk_worker"]
JAX_TOPK = ["-m", "sentinel_tpu.multihost._topk_worker"]


def _route(m, rowg, acq, prio, S, L):
    return m.route_requests(rowg, acq, prio, S, L,
                            **{"status_" + k: v for k, v in STATUS.items()})


def _same_lanes(a, b):
    if a is None or b is None:
        return a is b
    return (a.lanes == b.lanes and all(
        np.array_equal(x, y) for x, y in zip(a[:4], b[:4])))


# ---------------------------------------------------------------------------
# shard_math: the port's copy against the reference's
# ---------------------------------------------------------------------------

def _route_loop_reference(rowg, acq, S, L):
    """Straight-line per-request reference for route_requests."""
    per_shard = [[] for _ in range(S)]
    status0 = []
    for i, (r, a) in enumerate(zip(rowg, acq)):
        if a <= 0:
            status0.append(STATUS["bad"])
        elif r < 0:
            status0.append(STATUS["no_rule"])
        else:
            status0.append(STATUS["fail"])
            per_shard[r // L].append(i)
    return per_shard, status0


def test_route_requests_matches_loop_reference():
    rng = np.random.RandomState(7)
    S, L = 8, 16
    rowg = rng.randint(-1, S * L, size=200)
    acq = rng.randint(-1, 5, size=200)
    prio = rng.rand(200) < 0.5
    lanes, plan = _route(t_sm, rowg, acq, prio, S, L)
    per_shard, status0 = _route_loop_reference(rowg, acq, S, L)
    assert plan.status0.tolist() == status0
    seen = set()
    for src, sh, lane in zip(plan.src, plan.shard, plan.lane):
        assert rowg[src] // L == sh
        assert lanes.valid[sh, lane]
        assert lanes.rows[sh, lane] == rowg[src] % L
        assert lanes.acquire[sh, lane] == acq[src]
        assert lanes.prioritized[sh, lane] == prio[src]
        assert src not in seen
        seen.add(src)
    assert sorted(seen) == sorted(i for p in per_shard for i in p)
    assert int(lanes.valid.sum()) == len(seen)
    assert lanes.lanes >= max(len(p) for p in per_shard)
    j_lanes, j_plan = _route(j_sm, rowg, acq, prio, S, L)
    assert _same_lanes(lanes, j_lanes)
    assert all(np.array_equal(x, y) for x, y in zip(plan, j_plan))


def test_route_requests_all_unroutable():
    for m in SM.values():
        lanes, plan = _route(m, np.array([-1, -1]), np.array([1, 0]), None,
                             4, 8)
        assert lanes is None
        assert plan.status0.tolist() == [STATUS["no_rule"], STATUS["bad"]]


def test_scatter_verdicts_roundtrip():
    rng = np.random.RandomState(11)
    S, L = 4, 8
    rowg = rng.randint(-1, S * L, size=64)
    acq = rng.randint(0, 3, size=64)
    outs = {}
    for name, m in SM.items():
        lanes, plan = _route(m, rowg, acq, None, S, L)
        st = np.arange(S * lanes.lanes).reshape(S, lanes.lanes)
        out = m.scatter_verdicts(plan, lanes.lanes, st, st * 10, st * 100, S)
        assert len(out) == 64
        for src, sh, lane in zip(plan.src, plan.shard, plan.lane):
            code = sh * lanes.lanes + lane
            assert out[src] == (code, code * 10, code * 100)
        routed = set(plan.src.tolist())
        for i, (s, w, r) in enumerate(out):
            if i not in routed:
                assert (s, w, r) == (plan.status0[i], 0, 0)
        outs[name] = out
    assert outs["torch"] == outs["jax"]


def test_mask_to_local_lanes_zeroes_only_remote():
    rng = np.random.RandomState(3)
    S, L = 8, 4
    rowg = rng.randint(0, S * L, size=40)
    locals_ = {}
    for name, m in SM.items():
        lanes, plan = _route(m, rowg, np.ones(40, np.int64), None, S, L)
        local = m.mask_to_local_lanes(lanes, plan, [2, 3])
        for s in range(S):
            if s in (2, 3):
                assert (local.rows[s] == lanes.rows[s]).all()
                assert (local.valid[s] == lanes.valid[s]).all()
            else:
                assert not local.valid[s].any()
                assert not local.acquire[s].any()
        locals_[name] = local
    assert _same_lanes(locals_["torch"], locals_["jax"])


@pytest.mark.parametrize("args,match", [
    (("rows", 64, 8), None),
    (("rows", 65, 8), "rows=65 does not divide over 8"),
    (("rows", 65, 8, "use a multiple"), "use a multiple"),
])
def test_validate_divisible(args, match):
    for m in SM.values():
        if match is None:
            m.validate_divisible(*args)
        else:
            with pytest.raises(ValueError, match=match):
                m.validate_divisible(*args)


def test_owner_and_local_row():
    rows = np.array([0, 15, 16, 127])
    for m in SM.values():
        assert m.owner_shard(rows, 16).tolist() == [0, 0, 1, 7]
        assert m.local_row(rows, 16).tolist() == [0, 15, 0, 15]


# ---------------------------------------------------------------------------
# bootstrap config, the backend rule, the launcher
# ---------------------------------------------------------------------------

_ENV = {"SENTINEL_COORDINATOR": "10.0.0.1:1234",
        "SENTINEL_NUM_PROCESSES": "4", "SENTINEL_PROCESS_ID": "2",
        "SENTINEL_LOCAL_DEVICES": "8"}


def test_config_from_env_roundtrip():
    cfg = t_boot.MultihostConfig.from_env(_ENV)
    ref = j_boot.MultihostConfig.from_env(_ENV)
    assert cfg.coordinator == ref.coordinator == "10.0.0.1:1234"
    assert cfg.num_processes == ref.num_processes == 4
    assert cfg.process_id == ref.process_id == 2
    assert cfg.local_devices == ref.local_devices == 8
    # the port's default platform is the card; the reference's its CPU
    assert cfg.platform == "cuda" and ref.platform == "cpu"
    assert not cfg.is_coordinator
    assert t_boot.MultihostConfig.from_env(
        dict(_ENV, SENTINEL_MH_PLATFORM="cpu")).platform == "cpu"
    assert t_boot.MultihostConfig.from_env({
        "SENTINEL_COORDINATOR": "h:1", "SENTINEL_NUM_PROCESSES": "1",
        "SENTINEL_PROCESS_ID": "0"}).is_coordinator


@pytest.mark.parametrize("missing", ["SENTINEL_COORDINATOR",
                                     "SENTINEL_NUM_PROCESSES",
                                     "SENTINEL_PROCESS_ID"])
def test_config_from_env_missing_vars(missing):
    env = {k: v for k, v in _ENV.items() if k != missing}
    for boot in (t_boot, j_boot):
        with pytest.raises(KeyError, match=missing):
            boot.MultihostConfig.from_env(env)


@pytest.mark.parametrize("kw,match", [
    (dict(num_processes=2, process_id=2), "process_id"),
    (dict(coordinator="nohostport", num_processes=1, process_id=0),
     "host:port"),
    (dict(num_processes=0, process_id=0), "num_processes"),
])
def test_config_validation(kw, match):
    kw = dict({"coordinator": "h:1"}, **kw)
    for boot in (t_boot, j_boot):
        with pytest.raises(ValueError, match=match):
            boot.MultihostConfig(**kw)


def test_free_port_is_bindable():
    p = t_launch.free_port()
    with socket.socket() as s:
        s.bind(("127.0.0.1", p))


@pytest.mark.parametrize("platform,pid,local,cards,want", [
    ("cpu", 1, 2, 0, ("gloo", "cpu")),
    ("cpu", 0, 2, 2, ("gloo", "cpu")),          # the CPU when asked
    ("cuda", 1, 2, 1, ("gloo", "cuda:0")),      # two ranks, one card
    ("cuda", 0, 2, 1, ("gloo", "cuda:0")),
    ("cuda", 1, 2, 2, ("nccl", "cuda:1")),      # a card a rank
    ("cuda", 0, 1, 1, ("nccl", "cuda:0")),
    (None, 3, 4, 2, ("gloo", "cuda:1")),        # default: the card
])
def test_select_backend(platform, pid, local, cards, want):
    assert t_boot.select_backend(platform, pid, local, cards) == want


def test_select_backend_refuses_a_missing_card():
    with pytest.raises(RuntimeError, match="SENTINEL_MH_PLATFORM=cpu"):
        t_boot.select_backend("cuda", 0, 1, 0)
    with pytest.raises(ValueError, match="platform"):
        t_boot.select_backend("tpu", 0, 1, 1)


def test_single_process_runtime_and_mesh():
    """One process: no process group, the runtime's tables and the mesh
    helpers (``repin_rows`` takes this process's whole slab)."""
    cfg = t_boot.MultihostConfig("h:1", 1, 0, local_devices=4,
                                 platform="cpu")
    with t_boot.initialize(cfg) as rt:
        assert t_boot.active_runtime() is rt
        assert (rt.backend, str(rt.device)) == ("gloo", "cpu")
        assert rt.global_devices() == rt.local_devices() == [
            (0, i, "cpu") for i in range(4)]
        rt.barrier()
        mesh = t_mesh.global_mesh()
        assert mesh.size == 4 and not t_mesh.spans_processes(mesh)
        assert t_mesh.local_shard_indices(mesh) == [0, 1, 2, 3]
        t_mesh.validate_global_rows("rows", 64, mesh)
        with pytest.raises(ValueError, match="does not divide over 4"):
            t_mesh.validate_global_rows("rows", 65, mesh)
        x = torch.arange(16).view(8, 2)
        out = t_mesh.repin_rows({"a": x, "b": (x.numpy(), None)}, mesh)
        assert torch.equal(out["a"], x) and out["b"][1] is None
    assert t_boot.active_runtime() is None


def test_two_process_mesh_tables():
    """A mesh over two processes' shards, seen from process 1: its block,
    ``repin_rows``'s slab, and an engine built on it holds that block."""
    from sentinel_tpu_torch.parallel import cluster as tc
    devs = [t_boot.ShardDevice(p, i, "cpu") for p in range(2)
            for i in range(4)]
    mesh = t_mesh.GlobalMesh(devs, t_mesh.CLUSTER_AXIS, process_index=1,
                             backend="gloo")
    assert t_mesh.spans_processes(mesh)
    assert t_mesh.local_shard_indices(mesh) == [4, 5, 6, 7]
    x = torch.arange(16)
    assert t_mesh.repin_rows(x, mesh).tolist() == list(range(8, 16))
    eng = tc.ClusterEngine(tc.ClusterSpec(8, 16, 4), mesh=mesh)
    assert eng._multiprocess and eng._block == (4, 8)
    assert eng.state.flows.counters.shape[0] == 4 * 16
    assert eng.state.ns.counters.shape[0] == 4 * 4
    with pytest.raises(ValueError, match="need 4 devices"):
        tc.ClusterEngine(tc.ClusterSpec(4, 16, 4), mesh=mesh)


def test_launch_surfaces_worker_failure():
    with pytest.raises(t_launch.LaunchError) as ei:
        t_launch.launch(["-c", "import sys; print('boom'); sys.exit(3)"], 1,
                        timeout_s=60, platform="cpu")
    assert "boom" in str(ei.value)
    assert ei.value.procs[0].returncode == 3


def test_launch_env_contract():
    """The children get the bootstrap env, the platform asked for, and no
    JAX setting (the parent here has ``XLA_FLAGS`` from the conftest)."""
    probe = ("import os, json; print('ENV:' + json.dumps({k: v for k, v in "
             "os.environ.items() if k.startswith(('SENTINEL_', 'JAX_', "
             "'XLA_', 'LOCAL_WORLD'))}))")
    res = t_launch.launch(["-c", probe], 2, devices_per_process=3,
                          timeout_s=60, platform="cpu")
    envs = [json.loads(r.stdout.split("ENV:", 1)[1]) for r in res]
    for pid, env in enumerate(envs):
        assert env["SENTINEL_PROCESS_ID"] == str(pid)
        assert env["SENTINEL_NUM_PROCESSES"] == "2"
        assert env["SENTINEL_LOCAL_DEVICES"] == "3"
        assert env["SENTINEL_MH_PLATFORM"] == "cpu"
        assert env["LOCAL_WORLD_SIZE"] == "2"
        assert not [k for k in env if k.startswith(("JAX_", "XLA_"))]
    assert envs[0]["SENTINEL_COORDINATOR"] == envs[1]["SENTINEL_COORDINATOR"]


# ---------------------------------------------------------------------------
# the launches: every one at once
# ---------------------------------------------------------------------------

def _lines(results, tag):
    return [json.loads(line.split(":", 1)[1]) for r in results
            for line in r.stdout.splitlines() if line.startswith(tag)]


def _one(results, tag):
    got = _lines(results, tag)
    assert len(got) == 1, "\n".join(r.stdout + r.stderr for r in results)
    return got[0]


#: the workers' thread pools kept to one thread: the suite runs beside
#: other test workers on the same cores
_QUIET = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def runs():
    jobs = {
        "port_1x8": lambda: t_launch.launch(
            PORT_PARITY, 1, devices_per_process=8, timeout_s=240,
            platform="cpu", env=_QUIET),
        "port_2x4": lambda: t_launch.launch(
            PORT_PARITY, 2, devices_per_process=4, timeout_s=240,
            platform="cpu", env=_QUIET),
        "port_topk": lambda: t_launch.launch(
            PORT_TOPK, 2, devices_per_process=4, timeout_s=240,
            platform="cpu", env=_QUIET),
        "jax_topk": lambda: j_launch.launch(
            JAX_TOPK, 2, devices_per_process=4, timeout_s=240, env=_QUIET),
    }
    # two launches at a time: at most four worker processes at once
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {k: pool.submit(f) for k, f in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


@pytest.fixture(scope="module")
def jax_parity():
    """The JAX engine over the conftest's 8 virtual CPU devices, driven by
    the reference worker's own functions in this process."""
    from sentinel_tpu.multihost import MultihostIngest
    from sentinel_tpu.multihost import _parity_worker as jw
    eng = jw.build_engine()
    assert eng.mesh.devices.size == 8
    out = jw.run_parity(MultihostIngest(eng))
    from sentinel_tpu_torch import convert
    state = convert.cluster_to_numpy(eng)
    out["flow_window"] = {"counters": state["state.flows.counters"],
                          "stamps": state["state.flows.stamps"]}
    from sentinel_tpu_torch.multihost._parity_worker import (
        METRIC_PROBES, NOW0,
    )
    out["flow_metrics"] = [eng.flow_metrics(f, now_ms=NOW0 + 2_000)
                           for f in METRIC_PROBES]
    return out


def test_two_process_parity_with_single_process_and_jax(runs, jax_parity):
    """THE acceptance gate: 2 processes × 4 shards decide a shared
    deterministic stream identically to 1 process × 8 shards and to the
    JAX engine on 8 devices — token grants, waits and remaining counts,
    element for element; the gathered flow window bit for bit."""
    one = _one(runs["port_1x8"], "PARITY_JSON:")
    two = _one(runs["port_2x4"], "PARITY_JSON:")
    assert one["n_devices"] == two["n_devices"] == 8
    assert one["process_count"] == 1 and two["process_count"] == 2
    assert two["local_shards"] == [0, 1, 2, 3]  # coordinator owns 0-3
    ranks = sorted(_lines(runs["port_2x4"], "RANK_JSON:"),
                   key=lambda r: r["process_index"])
    assert [r["local_shards"] for r in ranks] == [[0, 1, 2, 3],
                                                  [4, 5, 6, 7]]
    assert {(r["backend"], r["device"]) for r in ranks} == {("gloo", "cpu")}
    assert one["decisions"] == two["decisions"] == jax_parity["decisions"]
    statuses = {d[0] for d in one["decisions"]}
    assert {0, 1, STATUS["bad"], STATUS["no_rule"]} <= statuses
    for key in ("counters", "stamps"):
        a = np.asarray(one["flow_window"][key], np.int32)
        b = np.asarray(two["flow_window"][key], np.int32)
        assert a.shape[0] == 8 * 16
        assert np.array_equal(a, b)
        assert np.array_equal(a, jax_parity["flow_window"][key])
    assert one["flow_metrics"] == two["flow_metrics"] \
        == jax_parity["flow_metrics"]
    assert any(m.get("pass") for m in one["flow_metrics"])


def test_two_process_topk_merges_cluster_hot_view(runs):
    """obs_agg.aggregate_topk: each process's top-K gathers and merges by
    name — the reference test's every assertion, and the merged hot list
    equal to the JAX worker's."""
    from sentinel_tpu_torch.multihost import _topk_worker as w

    agg = _one(runs["port_topk"], "TOPK_JSON:")
    ref = _one(runs["jax_topk"], "TOPK_JSON:")
    assert agg["process_count"] == 2
    hot = {h["resource"]: h for h in agg["hot"]}
    assert agg["hot"][0]["resource"] == "shared-hot"
    assert hot["shared-hot"]["load"] == 2 * w.SHARED_N
    assert hot["shared-hot"]["hosts"] == 2
    for p in range(2):
        assert hot[f"hot-{p}"]["load"] == w.HOT_N
        assert hot[f"hot-{p}"]["hosts"] == 1
    names = [h["resource"] for h in agg["hot"]]
    assert names[:3] == ["shared-hot", "hot-0", "hot-1"]
    local = {h["resource"] for h in agg["local_hot"]}
    assert "hot-0" in local and "hot-1" not in local
    assert agg["hot"] == ref["hot"]
    assert (agg["k"], agg["process_count"]) == (ref["k"],
                                                 ref["process_count"])


def test_two_process_counter_and_hist_aggregates_sum(runs):
    """aggregate_counters / aggregate_resource_hist in 2 processes: each
    total is the host-side sum of the per-process vectors, and the fleet
    quantiles are those of the summed histogram."""
    from sentinel_tpu_torch.obs import counters as ck
    from sentinel_tpu_torch.obs import resource_hist as rh

    agg = _one(runs["port_topk"], "TOPK_JSON:")
    ranks = sorted(_lines(runs["port_topk"], "RANK_JSON:"),
                   key=lambda r: r["process_index"])
    assert len(ranks) == 2
    vecs = np.asarray([r["counters"] for r in ranks], np.int64)
    c = agg["counters"]
    assert c["process_count"] == 2 and c["process_index"] == 0
    assert c["total"] == ck.vector_counts(vecs.sum(0))
    assert c["per_process"] == [ck.vector_counts(v) for v in vecs]
    assert c["total"]  # the workers' traffic counted something
    h = agg["resource_hist"]
    assert h["hist_buckets"] == rh.DEFAULT_BUCKETS
    want = {}
    for r in ranks:
        for e in r["hot"]:
            want[e["resource"]] = want.get(e["resource"], 0) + np.asarray(
                e["rt_hist"], np.int64)
    got = {e["resource"]: e for e in h["hot"]}
    assert set(got) == set(want)
    for name, vec in want.items():
        assert got[name]["rt_hist"] == vec.tolist()
        assert vec.sum() < 2 ** 24
        q = rh.np_quantiles(vec)
        assert [got[name][f"rt_p{p}_ms"] for p in (50, 95, 99)] == [
            round(float(x), 3) for x in q]
    # the shared key's tail comes from process 1's slower exits
    assert got["shared-hot"]["hosts"] == 2
    assert got["shared-hot"]["rt_p99_ms"] > got["hot-0"]["rt_p99_ms"]


class _Obs:
    def __init__(self, counts):
        self.counters = type("C", (), {"snapshot": lambda _s: counts})()


class _Tel:
    def __init__(self, entries, k):
        self._e, self.k = entries, k

    def hot_entries(self, k=None):
        return self._e


def test_single_process_aggregates_equal_jax(tmp_path, monkeypatch):
    """One process, no runtime: the port's aggregates of a port
    ``Sentinel`` equal the JAX functions on the same counts."""
    from types import SimpleNamespace

    import sentinel_tpu_torch as stt
    from sentinel_tpu.multihost import obs_agg as j_agg
    from sentinel_tpu_torch.core.clock import ManualClock
    from sentinel_tpu_torch.multihost import obs_agg as t_agg

    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path))
    cfg = stt.load_config(max_resources=64, max_flow_rules=16,
                          max_degrade_rules=16, host_fast_path=False)
    s = stt.Sentinel(cfg, clock=ManualClock(start_ms=10_000_000),
                     device="cpu")
    try:
        for i, (name, n) in enumerate((("api", 40), ("db", 12),
                                       ("cache", 3))):
            for j in range(n):
                e = s.entry(name)
                s.clock.advance_ms((j % 7) * (i + 1))
                e.exit()
        s.clock.advance_ms(50)
        s.telemetry.poll()
        entries = s.telemetry.hot_entries(8)
        twin = SimpleNamespace(obs=_Obs(s.obs.counters.snapshot()),
                               telemetry=_Tel(entries, s.telemetry.k),
                               spec=SimpleNamespace(
                                   hist_buckets=s.spec.hist_buckets))
        assert t_agg.aggregate_counters(s) == j_agg.aggregate_counters(twin)
        assert t_agg.coordinator_report(s) == j_agg.coordinator_report(twin)
        assert t_agg.aggregate_topk(s, k=8) == j_agg.aggregate_topk(twin, k=8)
        got = t_agg.aggregate_resource_hist(s, k=8)
        assert got == j_agg.aggregate_resource_hist(twin, k=8)
        assert {h["resource"] for h in got["hot"]} == {"api", "db", "cache"}
        assert all(h["total"] < 2 ** 24 for h in got["hot"])
        off = SimpleNamespace(telemetry=None,
                              spec=SimpleNamespace(hist_buckets=0))
        assert t_agg.aggregate_resource_hist(off) == \
            j_agg.aggregate_resource_hist(off)
    finally:
        s.close()


# ---------------------------------------------------------------------------
# what the reference refuses, the port refuses
# ---------------------------------------------------------------------------

def test_token_server_refuses_a_multiprocess_engine():
    from sentinel_tpu.cluster import server as j_server
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.parallel import cluster as tc
    devs = [t_boot.ShardDevice(p, i, "cpu") for p in range(2)
            for i in range(2)]
    eng = tc.ClusterEngine(tc.ClusterSpec(4, 8, 2), mesh=t_mesh.GlobalMesh(
        devs, t_mesh.CLUSTER_AXIS, process_index=0, backend="gloo"))
    with pytest.raises(ValueError, match="several processes"):
        ClusterTokenServer(eng, port=0)
    # the reference's check reads the same attribute
    with pytest.raises(ValueError):
        j_server.ClusterTokenServer(eng, port=0)
    one = tc.ClusterEngine(tc.ClusterSpec(4, 8, 2), device="cpu")
    assert not one._multiprocess


def test_request_params_is_not_wired():
    from sentinel_tpu.multihost.ingest import MultihostIngest as JIngest
    from sentinel_tpu_torch.multihost.ingest import MultihostIngest
    for cls in (MultihostIngest, JIngest):
        with pytest.raises(NotImplementedError, match="not wired"):
            cls.request_params(None, [1], [1], [[1]], now_ms=0)
