"""Port parity: warm-restart snapshots (``sentinel_tpu_torch.core.snapshot``)
against ``sentinel_tpu.core.snapshot``.

Twins of the 5 tests of ``tests/test_snapshot.py``: each scenario runs on
both packages (the port on the CPU) under twin ManualClocks, and its
observations (restore results, node totals, verdicts) and the restored
runtimes' engine state (``convert.engine_to_numpy``) must agree.

Then the file format across packages, both ways: a snapshot written by
one package restores ``"full"`` in the other, leaf for leaf equal to the
writer's own restore, and the same following traffic gives the same
verdicts and state; under changed rules it restores ``"partial"`` there
too. Both registries (the C++ tables and ``SENTINEL_TPU_NATIVE=0``) are
covered.
"""

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.core import snapshot as jsnap
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core import snapshot as tsnap

torch.set_num_threads(2)

T0 = 1_785_000_000_000
PKGS = {"jax": (stpu, jsnap), "torch": (stt, tsnap)}


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


def make(name, start_ms=T0, **over):
    pkg = PKGS[name][0]
    kw = dict(max_resources=64, max_flow_rules=16,
              max_degrade_rules=16, max_authority_rules=16)
    kw.update(over)
    extra = {"device": "cpu"} if name == "torch" else {}
    sph = pkg.Sentinel(config=pkg.load_config(**kw),
                       clock=pkg.ManualClock(start_ms=start_ms), **extra)
    sph._cpu.sample = lambda: (0.5, 0.25)
    return sph


def twin(scenario, tmp_path):
    """``scenario(name, pkg, snap, dir)`` on both packages → the port's
    (observations, state of the runtime it returns), equal to the
    reference's."""
    got = {}
    for name, (pkg, snap) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        obs, sph = scenario(name, pkg, snap, d)
        try:
            got[name] = (obs, convert.engine_to_numpy(sph))
        finally:
            sph.close()
    assert got["torch"][0] == got["jax"][0]
    assert convert.leaf_diff(got["torch"][1], got["jax"][1]) == []
    return got["torch"][0]


def _try(pkg, sph, res):
    try:
        with sph.entry(res):
            return "pass"
    except pkg.BlockException as e:
        return type(e).__name__


def test_counters_survive_restart(tmp_path):
    def scenario(name, pkg, snap, d):
        a = make(name)
        a.load_flow_rules([pkg.FlowRule(resource="svc", count=3)])
        for _ in range(3):
            with a.entry("svc"):
                pass
        snap.save_state(a, str(d / "snap"))
        a.close()
        b = make(name, T0 + 50)
        b.load_flow_rules([pkg.FlowRule(resource="svc", count=3)])
        obs = [snap.load_state(b, str(d / "snap")),
               b.node_totals("svc")["pass"], _try(pkg, b, "svc")]
        b.clock.advance_ms(1100)
        obs.append(_try(pkg, b, "svc"))
        return obs, b

    assert twin(scenario, tmp_path) == ["full", 3, "FlowException", "pass"]


def test_breaker_state_survives_restart(tmp_path):
    def scenario(name, pkg, snap, d):
        rule = dict(resource="svc", grade=pkg.GRADE_EXCEPTION_COUNT, count=1,
                    time_window=30, min_request_amount=1)
        a = make(name)
        a.load_degrade_rules([pkg.DegradeRule(**rule)])
        for _ in range(2):
            try:
                with a.entry("svc") as e:
                    e.trace(RuntimeError("x"))
            except pkg.BlockException:
                pass
        obs = [_try(pkg, a, "svc")]
        snap.save_state(a, str(d / "snap"))
        a.close()
        b = make(name, T0 + 100)
        b.load_degrade_rules([pkg.DegradeRule(**rule)])
        obs += [snap.load_state(b, str(d / "snap")), _try(pkg, b, "svc")]
        return obs, b

    assert twin(scenario, tmp_path) == ["DegradeException", "full",
                                        "DegradeException"]


def test_geometry_mismatch_restores_cold(tmp_path):
    def scenario(name, pkg, snap, d):
        a = make(name)
        with a.entry("svc"):
            pass
        snap.save_state(a, str(d / "snap"))
        a.close()
        b = make(name, max_resources=128)
        return [snap.load_state(b, str(d / "snap")),
                b.node_totals("svc").get("pass", 0)], b

    assert twin(scenario, tmp_path) == [False, 0]


def test_missing_snapshot_is_cold(tmp_path):
    def scenario(name, pkg, snap, d):
        b = make(name)
        obs = [snap.load_state(b, str(d / "nope"))]
        # a truncated file restores cold too
        (d / "bad.npz").write_bytes(b"PK\x03\x04 truncated")
        (d / "bad.meta.json").write_text("{")
        obs.append(snap.load_state(b, str(d / "bad")))
        return obs, b

    assert twin(scenario, tmp_path) == [False, False]


def test_rule_change_restores_windows_partially(tmp_path):
    def scenario(name, pkg, snap, d):
        a = make(name)
        a.load_flow_rules([pkg.FlowRule(resource="svc", count=100)])
        for _ in range(5):
            with a.entry("svc"):
                pass
        a._flush_fast()
        snap.save_state(a, str(d / "snap"))
        a.close()
        b = make(name, T0 + 50)
        b.load_flow_rules([pkg.FlowRule(resource="svc", count=5)])
        obs = [snap.load_state(b, str(d / "snap")),
               b.node_totals("svc")["pass"], _try(pkg, b, "svc")]
        c = make(name, T0 + 50)
        c.load_flow_rules([pkg.FlowRule(resource="svc", count=100)])
        obs.append(snap.load_state(c, str(d / "snap")))
        c.close()
        return obs, b

    assert twin(scenario, tmp_path) == ["partial", 5, "FlowException",
                                        "full"]


# ------------------------------------------------------- across packages

NAMES = [f"r{i}" for i in range(24)]


def _rules(pkg, tight: float):
    flow = [pkg.FlowRule(resource=n, count=tight) for n in NAMES[:12]]
    flow.append(pkg.FlowRule(resource="r0", count=2.0, limit_app="app-a"))
    deg = [pkg.DegradeRule(resource=n, grade=pkg.GRADE_EXCEPTION_COUNT,
                           count=1, time_window=30, min_request_amount=1)
           for n in NAMES[12:16]]
    return flow, deg


def _load(pkg, sph, tight):
    flow, deg = _rules(pkg, tight)
    sph.load_flow_rules(flow)
    sph.load_degrade_rules(deg)


def _drive(pkg, sph, seed: int, steps: int) -> list:
    """Seeded traffic: single entries with origins (some failing) and
    batches, the clock moving 130 ms a step → verdicts."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        for _ in range(6):
            res = NAMES[int(rng.integers(0, len(NAMES)))]
            origin = "app-a" if rng.random() < 0.4 else None
            try:
                fail = rng.random() < 0.5
                with sph.entry(res, origin=origin) as e:
                    if fail:
                        e.trace(RuntimeError("x"))
                out.append((res, "pass"))
            except pkg.BlockException as exc:
                out.append((res, type(exc).__name__))
        names = [NAMES[i] for i in rng.integers(0, len(NAMES), 64)]
        v = sph.entry_batch(names, acquire=rng.integers(1, 3, 64)
                            .astype(np.int32))
        out.append((np.asarray(v.allow).tolist(),
                    np.asarray(v.reason).tolist()))
        sph.clock.advance_ms(130)
    return out


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_snapshot_restores_across_packages(tmp_path, monkeypatch, native,
                                           writer, reader):
    monkeypatch.setenv("SENTINEL_TPU_NATIVE", native)
    wpkg, wsnap = PKGS[writer]
    a = make(writer)
    _load(wpkg, a, 20.0)
    _drive(wpkg, a, seed=7, steps=6)
    path = str(tmp_path / "snap")
    wsnap.save_state(a, path)
    a.close()
    after, states, restores = {}, {}, {}
    for name in (writer, reader):        # the writer's own restore first
        pkg, snap = PKGS[name]
        b = make(name, T0 + 6 * 130 + 40)
        _load(pkg, b, 20.0)
        restores[name] = snap.load_state(b, path)
        states[name] = {k: v for k, v in convert.engine_to_numpy(b).items()
                        if k != convert.SKETCH_LEAF}
        after[name] = (_drive(pkg, b, seed=8, steps=4),
                       convert.engine_to_numpy(b))
        b.close()
        c = make(name, T0 + 6 * 130 + 40)
        _load(pkg, c, 5.0)                # changed rules
        restores[name] = (restores[name], snap.load_state(c, path),
                          convert.engine_to_numpy(c)["second.counters"])
        c.close()
    assert restores[reader][:2] == restores[writer][:2] == ("full",
                                                            "partial")
    assert np.array_equal(restores[reader][2], restores[writer][2])
    assert convert.leaf_diff(states[reader], states[writer]) == []
    assert int(states[reader]["second.counters"].sum()) > 0
    assert after[reader][0] == after[writer][0]
    assert convert.leaf_diff(after[reader][1], after[writer][1]) == []


@pytest.mark.parametrize("outcome", ["full", "partial"])
def test_snapshot_between_row_blocks_and_one_block(tmp_path, outcome):
    """A snapshot of an 8-block engine restores into a one-block engine,
    and the one-block engine's back into 8 blocks (the blocks go to the
    host one by one at save; a restore re-places them through the
    engine's placements), with the reference's outcomes; the following
    traffic gives the same verdicts and state on both, and on the JAX
    meshed engine restored from the same file."""
    from sentinel_tpu.parallel import local_shard as jls
    from sentinel_tpu_torch.parallel import local_shard as tls
    from sentinel_tpu_torch.parallel.row_blocks import RowBlocks
    meshes = {"mesh": {"mesh": tls.local_mesh(
        devices=[torch.device("cpu")] * 8)}, "one": {"device": "cpu"}}

    def port(kind):
        s = stt.Sentinel(config=stt.load_config(
            max_resources=64, max_flow_rules=16, max_degrade_rules=16,
            max_authority_rules=16), clock=stt.ManualClock(start_ms=T0),
            **meshes[kind])
        s._cpu.sample = lambda: (0.5, 0.25)
        return s

    rules = [dict(resource=f"svc-{i}", count=4.0) for i in range(10)]
    later = rules if outcome == "full" else rules[:-1]
    traffic = [f"svc-{i % 10}" for i in range(70)]
    results = {}
    for src, dst in (("mesh", "one"), ("one", "mesh")):
        a = port(src)
        a.load_flow_rules([stt.FlowRule(**r) for r in rules])
        for name in traffic:
            _try(stt, a, name)
        path = str(tmp_path / f"{src}.snap")
        tsnap.save_state(a, path)
        a.close()
        b = port(dst)
        b.load_flow_rules([stt.FlowRule(**r) for r in later])
        got = tsnap.load_state(b, path)
        assert got == outcome
        assert isinstance(b._state.second.counters, RowBlocks) == (
            dst == "mesh")
        if dst == "mesh":
            assert b._state.second.counters.n == 8
        after = [_try(stt, b, name) for name in traffic[:30]]
        results[src] = (after, convert.engine_to_numpy(b))
        b.close()
    assert results["mesh"][0] == results["one"][0]
    assert convert.leaf_diff(results["mesh"][1], results["one"][1]) == []
    # the file restores into the JAX meshed engine alike
    j = stpu.Sentinel(config=stpu.load_config(
        max_resources=64, max_flow_rules=16, max_degrade_rules=16,
        max_authority_rules=16), clock=stpu.ManualClock(start_ms=T0),
        mesh=jls.local_mesh(8))
    j._cpu.sample = lambda: (0.5, 0.25)
    j.load_flow_rules([stpu.FlowRule(**r) for r in later])
    assert jsnap.load_state(j, str(tmp_path / "mesh.snap")) == outcome
    after = [_try(stpu, j, name) for name in traffic[:30]]
    assert after == results["mesh"][0]
    assert convert.leaf_diff(convert.engine_to_numpy(j),
                             results["mesh"][1]) == []
    j.close()
