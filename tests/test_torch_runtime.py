"""Port parity: ``sentinel_tpu_torch.Sentinel`` against
``sentinel_tpu.Sentinel`` on the scalar admission route.

Twin engines (both ``host_fast_path=False``) under twin ManualClocks get
the same rule loads and the same ``entry`` / ``entry_batch`` /
``decide_and_exit_raw_nowait`` / ``exit_batch`` stream; verdicts, raised
exceptions and the full engine state must agree exactly after every
stage. The JAX side must have taken its scalar route
(``split_route.scalar``) for every dispatch. The JAX side's default
tiering is left on: at these sizes nothing is evicted, so it does not
perturb the comparison.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.obs import counters as obs_keys
from sentinel_tpu_torch import convert
from sentinel_tpu_torch import runtime as trt

from test_scalar_flow import DEG_RULES, MIXED_RULES

torch.set_num_threads(2)

T0 = 1_785_000_000_000
CFG = dict(max_resources=64, max_origins=32, max_flow_rules=16,
           max_degrade_rules=16, max_authority_rules=16,
           minute_enabled=True, host_fast_path=False)


def _port_rules(rules):
    return [getattr(stt, type(r).__name__)(**dataclasses.asdict(r))
            for r in rules]


RULESETS = {
    # every flow behaviour family (bar cluster mode) + every breaker grade
    "mixed": ([r for r in MIXED_RULES if not r.cluster_mode], DEG_RULES,
              [], []),
    # the system slot (global QPS + thread gates, the BBR load check) and
    # the authority slot live
    "system_authority": (
        [stpu.FlowRule(resource="qps", count=5.0)], DEG_RULES[:1],
        [stpu.SystemRule(qps=30.0, max_thread=40.0,
                         highest_system_load=0.0)],
        [stpu.AuthorityRule(resource="brk", limit_app="app-a")]),
}


@pytest.fixture(params=sorted(RULESETS))
def twins(request):
    flow, deg, system, auth = RULESETS[request.param]
    jc, tc = stpu.ManualClock(start_ms=T0), stt.ManualClock(start_ms=T0)
    js = stpu.Sentinel(config=stpu.load_config(**CFG), clock=jc)
    ts = stt.Sentinel(config=stt.load_config(**CFG), clock=tc, device="cpu")
    for load, rules in (("load_flow_rules", flow),
                        ("load_degrade_rules", deg),
                        ("load_system_rules", system),
                        ("load_authority_rules", auth)):
        getattr(js, load)(rules)
        getattr(ts, load)(_port_rules(rules))
    # both engines sample the host's load once per virtual second: pin it
    # so the twins read the same value
    for sph in (js, ts):
        sph._cpu.sample = lambda: (0.5, 0.25)
    return js, ts, jc, tc


def _same_state(js, ts, tag):
    bad = convert.leaf_diff(convert.to_numpy(js._state),
                            convert.to_numpy(ts._state))
    assert bad == [], f"{tag}: {bad}"


def _same_verdicts(vj, vt, tag):
    for f in ("allow", "reason", "wait_ms"):
        np.testing.assert_array_equal(getattr(vt, f), getattr(vj, f),
                                      err_msg=f"{tag}: {f}")


def _entry_outcomes(sph, block_exc, names, clock, error_every=0):
    out = []
    for i, name in enumerate(names):
        try:
            with sph.entry(name) as e:
                clock.advance_ms(3)
                if error_every and i % error_every == 0:
                    e.trace(RuntimeError("business failure"))
                out.append("pass")
        except block_exc as exc:
            out.append(type(exc).__name__)
    return out


def test_twin_stream_matches(twins):
    js, ts, jc, tc = twins
    names = ["qps", "qps2", "thread", "warm", "paced", "wurl", "rel",
             "chain", "zero_rl", "free1", "brk", "slow"]
    rng = np.random.default_rng(0)
    scalar_before = js.obs.counters.get(obs_keys.ROUTE_SCALAR)
    dispatches = fused = 0
    prev_rows = np.empty(0, np.int32)
    for step in range(6):
        seq = [names[i] for i in rng.integers(0, len(names), 12)]
        got = [_entry_outcomes(sph, exc, seq, clk, error_every=3)
               for sph, exc, clk in ((js, stpu.BlockException, jc),
                                     (ts, stt.BlockException, tc))]
        assert got[0] == got[1], f"entry outcomes, step {step}"
        dispatches += len(seq)
        _same_state(js, ts, f"entries, step {step}")

        batch = [names[i] for i in rng.integers(0, len(names), 50)]
        vj, vt = js.entry_batch(batch), ts.entry_batch(batch)
        _same_verdicts(vj, vt, f"entry_batch, step {step}")
        dispatches += 1

        rows = ts.intern_resources(batch)
        np.testing.assert_array_equal(rows, js.intern_resources(batch))
        n = rows.shape[0]
        ra = ts.spec.alt_rows
        raw = (rows, np.zeros(n, np.int32), np.full(n, ra, np.int32),
               np.zeros(n, np.int32), np.full(n, ra, np.int32),
               np.ones(n, np.int32), np.ones(n, np.bool_),
               np.zeros(n, np.bool_))
        m = prev_rows.shape[0]
        xkw = dict(exit_rows=prev_rows,
                   exit_rt_ms=rng.integers(0, 80, m).astype(np.int32),
                   exit_error=rng.random(m) < 0.3)
        hj = js.decide_and_exit_raw_nowait(*raw, **xkw)
        ht = ts.decide_and_exit_raw_nowait(*raw, **xkw)
        vj2, vt2 = hj.result(), ht.result()
        _same_verdicts(vj2, vt2, f"fused, step {step}")
        fused += 1
        _same_state(js, ts, f"fused, step {step}")

        done = rows[vj.allow]
        k = done.shape[0]
        xb = dict(rows=done, origin_rows=np.full(k, ra, np.int32),
                  chain_rows=np.full(k, ra, np.int32),
                  acquire=np.ones(k, np.int32),
                  rt_ms=rng.integers(0, 60, k).astype(np.int32),
                  error=rng.random(k) < 0.5, is_in=np.ones(k, np.bool_))
        js.exit_batch(**xb)
        ts.exit_batch(**xb)
        _same_state(js, ts, f"exit_batch, step {step}")
        for name in ("qps", "brk", "__entry_node__"):
            want = js.node_totals(name)
            want.pop("avg_rt", None)
            assert ts.node_totals(name) == want
        prev_rows = rows[vj2.allow]
        jc.advance_ms(int(rng.integers(50, 700)))
        tc.advance_ms(int(jc.now_ms() - tc.now_ms()))
    # every JAX-side decide took the scalar route (a fused dispatch is
    # counted as fused; no dispatch went to the fast or general paths)
    c = js.obs.counters
    assert c.get(obs_keys.ROUTE_SCALAR) - scalar_before == dispatches
    assert c.get(obs_keys.ROUTE_FUSED) == fused
    for key in (obs_keys.ROUTE_FAST, obs_keys.ROUTE_FAST_OCCUPY,
                obs_keys.ROUTE_GENERAL, obs_keys.ROUTE_SPLIT):
        assert c.get(key) == 0


def test_hello_world_twenty_pass_then_flow_exception():
    clk = stt.ManualClock(start_ms=T0)
    sph = stt.Sentinel(config=stt.load_config(**CFG), clock=clk,
                       device="cpu")
    sph.load_flow_rules([stt.FlowRule(resource="HelloWorld", count=20)])
    got = _entry_outcomes(sph, stt.BlockException, ["HelloWorld"] * 25, clk)
    assert got == ["pass"] * 20 + ["FlowException"] * 5
    tot = sph.node_totals("HelloWorld")
    assert (tot["pass"], tot["block"], tot["success"]) == (20, 5, 20)


def test_rate_limiter_wait_reported_without_sleep():
    clk = stt.ManualClock(start_ms=T0)
    sph = stt.Sentinel(config=stt.load_config(**CFG), clock=clk,
                       device="cpu")
    sph.load_flow_rules([stt.FlowRule(
        resource="p", count=10.0, max_queueing_time_ms=500,
        control_behavior=stt.BEHAVIOR_RATE_LIMITER)])
    waits, ended = [], []
    for _ in range(3):
        e = sph.entry("p", sleep=False)
        e.when_terminate(ended.append)
        waits.append(e.wait_ms)
        e.exit()
    assert waits == [0, 100, 200]
    assert len(ended) == 3
    with pytest.raises(stt.ErrorEntryFreeError):
        e.exit()


def test_sentinel_without_cuda_needs_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stt.Sentinel(config=stt.load_config(**CFG))
    with pytest.raises(RuntimeError):
        trt.resolve_device(None)
    assert trt.resolve_device("cpu").type == "cpu"


def test_off_route_calls_raise_not_implemented():
    """A row-block mesh constructs (A11); a ``"rows"`` mesh over several
    processes in a process without the process group raises a
    RuntimeError that says to initialize it (the spanning mesh itself
    runs in ``tests/test_torch_rows_multiprocess.py``), and a
    mesh without a ``"rows"`` axis raises ValueError, as the reference's
    ``validate_mesh`` does. Cluster-mode flow and param rules load
    (their rows keyed by rule slot for the token delegation), as do
    param rules and call args (A8), the host fast path (A6, the default
    config) and prioritized events (A7b), as the reference does."""
    from sentinel_tpu_torch.multihost.bootstrap import ShardDevice
    from sentinel_tpu_torch.multihost.mesh import GlobalMesh
    from sentinel_tpu_torch.parallel import local_shard
    cfg = stt.load_config(**CFG)
    two = GlobalMesh([ShardDevice(p, 0, "cpu") for p in (0, 1)], "rows")
    with pytest.raises(RuntimeError, match="process group"):
        stt.Sentinel(config=cfg, mesh=two)
    with pytest.raises(ValueError, match="rows"):
        stt.Sentinel(config=cfg, device="cpu", mesh=object())
    meshed = stt.Sentinel(
        config=cfg, clock=stt.ManualClock(start_ms=T0),
        mesh=local_shard.local_mesh(devices=[torch.device("cpu")] * 8))
    assert meshed.device == torch.device("cpu")
    assert meshed._state.second.counters.n == 8
    with meshed.entry("m"):
        pass
    assert meshed.node_totals("m")["pass"] == 1
    meshed.close()
    sph = stt.Sentinel(config=cfg, clock=stt.ManualClock(start_ms=T0),
                       device="cpu")
    sph.load_flow_rules([stt.FlowRule(resource="c", count=1.0,
                                      cluster_mode=True)])
    row = sph.resources.lookup("c")
    assert [(k, r.resource) for k, r in sph._cluster_rules_by_row[row]] \
        == [(0, "c")]
    sph.load_param_flow_rules([stt.ParamFlowRule(
        resource="c", count=1.0, cluster_mode=True)])
    assert [r.resource for r in sph._cluster_param_rules_by_row[row]] \
        == ["c"]
    # nothing was decided, and a cluster param rule compiles into no
    # device table
    assert not sph.routes
    assert sph._param.num_active == 0

    # param rules and args (A8) run, as in the JAX package
    got = {}
    for name, pkg in (("jax", stpu), ("torch", stt)):
        extra = {"device": "cpu"} if pkg is stt else {}
        twin = pkg.Sentinel(config=pkg.load_config(**CFG),
                            clock=pkg.ManualClock(start_ms=T0), **extra)
        twin._cpu.sample = lambda: (0.5, 0.25)
        twin.load_param_flow_rules([])
        out = []
        with twin.entry("x", args=(1,)):
            out.append("pass")
        twin.load_param_flow_rules([pkg.ParamFlowRule(resource="a",
                                                      count=1.0)])
        out.append(twin.entry_batch(["a"] * 2,
                                    args_list=[(1,), (1,)]).allow.tolist())
        out.append(twin.entry_batch(["a"], args_list=[(2,)]).allow.tolist())
        got[name] = (out, twin)
    assert got["torch"][0] == got["jax"][0] == [
        "pass", [True, False], [True]]
    _same_state(got["jax"][1], got["torch"][1], "param rules and args")

    # the default config (host fast path on) and prioritized events
    dflt = {k: v for k, v in CFG.items() if k != "host_fast_path"}
    jc, tc = stpu.ManualClock(start_ms=T0), stt.ManualClock(start_ms=T0)
    js = stpu.Sentinel(config=stpu.load_config(**dflt), clock=jc)
    ts = stt.Sentinel(config=stt.load_config(**dflt), clock=tc, device="cpu")
    assert ts.cfg.host_fast_path and ts._fast_enabled
    got = {}
    for name, sph, pkg, clk in (("jax", js, stpu, jc), ("torch", ts, stt, tc)):
        sph._cpu.sample = lambda: (0.5, 0.25)
        sph.load_flow_rules([pkg.FlowRule(resource="x", count=1.0)])
        out = []
        with sph.entry("free") as e:
            out.append(e.fast)
        with sph.entry("x", prioritized=True) as e:
            out.append(e.wait_ms)
        clk.advance_ms(700)
        e = sph.entry("x", prioritized=True, sleep=False)
        out.append(e.wait_ms)
        e.exit()
        v = sph.entry_batch(["a", "b", "x"], prioritized=[False, True, True])
        out.append((v.allow.tolist(), v.wait_ms.tolist()))
        v = sph.entry_batch(["a", "x"], origins=["", "app"],
                            prioritized=[True, False])
        out.append((v.allow.tolist(), v.wait_ms.tolist()))
        ra = sph.spec.alt_rows
        row = sph.intern_resources(["x"])
        v = sph.decide_and_exit_raw_nowait(
            row, np.zeros(1, np.int32), np.array([ra], np.int32),
            np.zeros(1, np.int32), np.array([ra], np.int32),
            np.ones(1, np.int32), np.ones(1, np.bool_),
            np.ones(1, np.bool_), exit_rows=np.zeros(0, np.int32)).result()
        out.append((v.allow.tolist(), v.wait_ms.tolist()))
        t = sph.node_totals("x")
        t.pop("avg_rt", None)
        out.append(t)
        got[name] = out
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "free" and got["torch"][2] == 300
    _same_state(js, ts, "default config, prioritized")


def test_registry_eviction_invalidates_recycled_rows():
    """A full registry recycles its least-recently-used row; the recycled
    row starts from clean history, as in the JAX package."""
    cfg = {**CFG, "max_resources": 8}
    jc, tc = stpu.ManualClock(start_ms=T0), stt.ManualClock(start_ms=T0)
    js = stpu.Sentinel(config=stpu.load_config(**cfg), clock=jc)
    ts = stt.Sentinel(config=stt.load_config(**cfg), clock=tc, device="cpu")
    names = [f"k{i}" for i in range(20)]
    for sph in (js, ts):
        for name in names:
            sph.entry_batch([name, name, "k0"])
    _same_state(js, ts, "after churn")
    assert ts.resources.items() == js.resources.items()
