"""Port parity: single-dispatch serving (``SENTINEL_SINGLE_DISPATCH``)
against ``sentinel_tpu``'s, with the reference's tiering ON.

Twins of the 8 tests of ``tests/test_single_dispatch.py``. The port has
no compiled programs: with the knob on, its decide call updates the
tiering sketch itself, and a fused decide+exit call also runs a due
telemetry tick and sketch decay+estimate in the reference's order; off,
the sketch update is a call of its own. What the twins hold equal to the
reference, bit for bit: verdicts, the count-min table, the engine state,
``pipeline.dispatches``, ``split_route.single_dispatch`` and every other
counter, the services' tick
counts and the carried estimates.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.tiering import sketch as jsk
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core.batching import pad_pow2
from sentinel_tpu_torch.obs import counters as ck
from sentinel_tpu_torch.tiering import sketch as tsk

torch.set_num_threads(2)

T0 = 1_785_000_000_000
PKGS = {"jax": stpu, "torch": stt}


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_NATIVE", "0")
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.delenv("SENTINEL_TIERING_DISABLE", raising=False)


def make(pkg, clk, **over):
    kw = dict(max_resources=64, max_flow_rules=16, max_degrade_rules=16,
              max_authority_rules=16, minute_enabled=True)
    kw.update(over)
    extra = {"device": "cpu"} if pkg is stt else {}
    sph = pkg.Sentinel(config=pkg.load_config(**kw), clock=clk, **extra)
    sph._cpu.sample = lambda: (0.5, 0.25)
    return sph


def _counters(sph) -> dict:
    return sph.obs.counters.snapshot()


def twin(scenario, **over):
    """``scenario(pkg, sph, clk)`` on twin runtimes → the port's
    observations; observations, counters and engine state with the
    sketch must agree."""
    got, views = {}, {}
    for name, pkg in PKGS.items():
        clk = pkg.ManualClock(start_ms=T0)
        sph = make(pkg, clk, **over)
        try:
            got[name] = scenario(pkg, sph, clk)
            views[name] = (_counters(sph), convert.engine_to_numpy(sph))
        finally:
            sph.close()
    assert got["torch"] == got["jax"]
    assert views["torch"][0] == views["jax"][0]
    assert convert.leaf_diff(views["jax"][1], views["torch"][1]) == []
    return got["torch"]


# ---------------------------------------------------------------------------
# parity fuzz: on vs off, tiered vs resident
# ---------------------------------------------------------------------------

def _run_engine(pkg, capacity, steps, batch, keys, rules, reload_rules,
                seed, origins=None):
    """The churn harness of test_torch_tiering.py plus the final sketch
    table → (verdict triples, tiering snapshot less wall-clock times,
    sketch, counters, engine leaves)."""
    clk = pkg.ManualClock(start_ms=T0)
    s = make(pkg, clk, max_resources=capacity, host_fast_path=False,
             minute_enabled=False)
    try:
        s.load_flow_rules([pkg.FlowRule(**r) for r in rules])
        rng = np.random.default_rng(seed)
        verdicts = []
        for step in range(steps):
            if step == steps // 2:
                s.load_flow_rules([pkg.FlowRule(**r) for r in reload_rules])
            names = list(rng.choice(keys, size=batch, replace=False))
            prio = list(rng.random(batch) < 0.25)
            kw = {}
            if origins is not None:
                kw["origins"] = list(rng.choice(origins, size=batch))
            v = s.entry_batch(names, acquire=[1] * batch,
                              prioritized=prio, **kw)
            verdicts.append((np.asarray(v.allow).tolist(),
                             np.asarray(v.reason).tolist(),
                             np.asarray(v.wait_ms).tolist()))
            clk.advance_ms(25)
        snap = dict(s.tiering.snapshot())
        for k in ("migrate_p50_ms", "migrate_p99_ms"):
            snap[k] = snap[k] is not None
        leaves = convert.engine_to_numpy(s)
        return (verdicts, snap, leaves.get(convert.SKETCH_LEAF),
                _counters(s), leaves)
    finally:
        s.close()


RULED = [f"zk{i}" for i in range(8)]
KEYS = [f"zk{i}" for i in range(48)]
RULES = [dict(resource=r, count=3.0) for r in RULED]
RELOAD = ([dict(resource=r, count=3.0) for r in RULED[:4]]
          + [dict(resource=f"zk{i}", count=2.0) for i in range(8, 12)])


@pytest.mark.parametrize("origins", [None, ("app-a", "app-b")],
                         ids=["plain", "origins"])
def test_parity_on_vs_off_bitwise(monkeypatch, origins):
    """Verdicts AND the count-min table are bit-identical between the
    update inside the decide call and the standalone composition
    (tiered 24-row engine, churn, mid-run reload, ~25% prioritized; the
    origins variant drives the split so the sketch threads through two
    calls) — and each knob setting equals the reference's, counters
    included."""
    runs = {}
    for sd in ("1", "0"):
        monkeypatch.setenv("SENTINEL_SINGLE_DISPATCH", sd)
        for name, pkg in PKGS.items():
            runs[name, sd] = _run_engine(pkg, 24, 32, 12, KEYS, RULES,
                                         RELOAD, 1601, origins=origins)
    for sd in ("1", "0"):
        j, t = runs["jax", sd], runs["torch", sd]
        assert t[0] == j[0]
        assert t[1] == j[1]
        np.testing.assert_array_equal(t[2], j[2])
        assert t[3] == j[3]
        assert convert.leaf_diff(j[4], t[4]) == []
    on, off = runs["torch", "1"], runs["torch", "0"]
    assert on[0] == off[0]
    np.testing.assert_array_equal(on[2], off[2])
    assert sum(a.count(False) for a, _r, _w in on[0]) > 0
    assert on[3].get(ck.ROUTE_SINGLE_DISPATCH, 0) > 0
    assert off[3].get(ck.ROUTE_SINGLE_DISPATCH, 0) == 0
    assert off[3][ck.PIPE_DISPATCH] > on[3][ck.PIPE_DISPATCH]


def test_parity_tiered_vs_resident_single_dispatch(monkeypatch):
    monkeypatch.setenv("SENTINEL_SINGLE_DISPATCH", "1")
    small = _run_engine(stt, 24, 32, 12, KEYS, RULES, RELOAD, 1602)
    small_j = _run_engine(stpu, 24, 32, 12, KEYS, RULES, RELOAD, 1602)
    big = _run_engine(stt, 512, 32, 12, KEYS, RULES, RELOAD, 1602)
    assert small[0] == small_j[0] == big[0]
    assert small[1] == small_j[1]
    assert small[1]["demoted"] > 0 and small[1]["promoted"] > 0
    assert big[1]["demoted"] == 0
    assert small[3].get(ck.ROUTE_SINGLE_DISPATCH, 0) > 0


# ---------------------------------------------------------------------------
# epilogue cadence
# ---------------------------------------------------------------------------

def _drive_fused(s, clk, steps, advance_ms, drain=True, last=None):
    """Steady fused serving loop (decide+exit in one call a step) → the
    dispatch times; ``last`` gets each step's padded (rows, valid)."""
    rows_all = s.intern_resources(["a", "b", "c"])
    pad_a = s.spec.alt_rows
    n = 4
    rng = np.random.default_rng(7)
    ones = np.ones(n, np.int32)
    is_in = np.ones(n, np.bool_)
    no_prio = np.zeros(n, np.bool_)
    ctx0 = np.zeros(n, np.int32)
    crow = np.full(n, pad_a, np.int32)
    orow = np.full(n, pad_a, np.int32)
    oid = np.zeros(n, np.int32)
    times = []
    prev = None
    for _ in range(steps):
        rows = np.asarray(rng.choice(rows_all, size=n), np.int32)
        times.append(int(clk.now_ms()))
        s.decide_and_exit_raw_nowait(
            rows, oid, orow, ctx0, crow, ones, is_in, no_prio,
            exit_rows=prev if prev is not None else rows,
            exit_valid=(np.ones(n, np.bool_) if prev is not None
                        else np.zeros(n, np.bool_))).result()
        if last is not None:
            b = pad_pow2(n)
            padded = np.full(b, s.spec.rows, np.int32)
            padded[:n] = rows
            last[:] = [padded, np.arange(b) < n]
        prev = rows
        if drain:       # what the CadenceScheduler thread does
            s.telemetry.drain()
            s.tiering.drain()
        clk.advance_ms(advance_ms)
    return times


def _expected_claims(t_start, times, interval):
    last, n = t_start, 0
    for t in times:
        if t - last >= interval:
            last, n = t, n + 1
    return n


def test_epilogue_once_per_due_tick(monkeypatch):
    """With both carries armed a fused step runs the telemetry tick and
    the sketch decay exactly when its slot is due — once a slot, whatever
    the batch rate — and every batch is one dispatch."""
    monkeypatch.setenv("SENTINEL_SINGLE_DISPATCH", "1")

    def scenario(pkg, s, clk):
        out = [s.telemetry.enabled, s.tiering.enabled]
        t_arm = int(clk.now_ms())
        s.telemetry.arm_carry(400)
        s.tiering.arm_carry(150)
        base = s.obs.counters.get(ck.PIPE_DISPATCH)
        tel0 = s.telemetry.snapshot()["ticks"]
        tier0 = s.tiering.snapshot()["ticks"]
        times = _drive_fused(s, clk, steps=30, advance_ms=50)
        tel_claims = _expected_claims(t_arm, times, 400)
        tier_claims = _expected_claims(t_arm, times, 150)
        out += [tel_claims, tier_claims,
                s.telemetry.snapshot()["ticks"] - tel0,
                s.tiering.snapshot()["ticks"] - tier0,
                s.telemetry.snapshot()["drops"],
                s.obs.counters.get(ck.PIPE_DISPATCH) - base, len(times),
                s.obs.counters.get(ck.ROUTE_SINGLE_DISPATCH),
                np.asarray(s.tiering._last_est).tolist(),
                [h["resource"] for h in s.telemetry.snapshot()["hot"]]]
        return out

    out = twin(scenario)
    tel_claims, tier_claims = out[2], out[3]
    assert out[:2] == [True, True]
    assert tel_claims >= 3 and tier_claims >= 8
    assert out[4] == tel_claims and out[5] == tier_claims
    assert out[6] == 0
    assert out[7] == out[8]                  # one dispatch a batch
    assert out[9] >= out[8]
    assert out[11]                           # carried telemetry: hot rows


def test_epilogue_estimates_match_standalone_tick(monkeypatch):
    """The carried tier tick is ``sketch.tick_read`` over the table this
    step's update left: replaying the update and the tick on the
    pre-step table reproduces the carried estimate and the new table
    bit for bit, with either package's functions."""
    monkeypatch.setenv("SENTINEL_SINGLE_DISPATCH", "1")
    clk = stt.ManualClock(start_ms=T0)
    s = make(stt, clk)
    try:
        _drive_fused(s, clk, steps=4, advance_ms=10)
        pre = s.tiering._sketch.clone()
        s.tiering.arm_carry(1)
        clk.advance_ms(5)
        last = [None, None]
        _drive_fused(s, clk, steps=1, advance_ms=0, last=last)
        est = np.asarray(s.tiering._last_est)
        post = s.tiering._sketch.numpy()
        rows, valid = last
        upd, _ = tsk.update_sketch(pre, torch.from_numpy(rows),
                                   torch.from_numpy(valid))
        ref_counts, ref_est = tsk.tick_read(upd, s.spec.rows)
        np.testing.assert_array_equal(est, ref_est.numpy())
        np.testing.assert_array_equal(post, ref_counts.numpy())
        jupd, _ = jsk.update_sketch(jnp.asarray(pre.numpy()),
                                    jnp.asarray(rows), jnp.asarray(valid))
        jc, je = jsk.tick_read(jupd, s.spec.rows)
        np.testing.assert_array_equal(est, np.asarray(je))
        np.testing.assert_array_equal(post, np.asarray(jc))
    finally:
        s.close()


# ---------------------------------------------------------------------------
# scheduler fallback + disable env
# ---------------------------------------------------------------------------

def test_scheduler_self_dispatch_on_idle(monkeypatch):
    """Zero traffic: the scheduler self-dispatches a standalone tick once
    a service's armed cadence is ``IDLE_FACTOR`` stale, and stays quiet
    while carried ticks keep the cadence fresh."""
    monkeypatch.setenv("SENTINEL_SINGLE_DISPATCH", "1")

    def scenario(pkg, s, clk):
        sched = pkg.CadenceScheduler(s, telemetry_interval_sec=1.0,
                                     tiering_interval_sec=0.2)
        s.telemetry.arm_carry(1000)
        s.tiering.arm_carry(200)
        s.intern_resources(["a"])

        def ticks():
            return [s.telemetry.snapshot()["ticks"],
                    s.tiering.snapshot()["ticks"]]

        out = [ticks()]
        sched.poll()
        out.append(ticks())
        clk.advance_ms(350)
        sched.poll()
        out.append(ticks())
        clk.advance_ms(1200)
        sched.poll()
        out.append(ticks())
        clk.advance_ms(250)
        _drive_fused(s, clk, steps=1, advance_ms=0)
        out.append(ticks())
        sched.poll()
        out.append(ticks())
        sched.stop()
        out += [s.telemetry._carry_ms, s.tiering._carry_ms]
        return out

    out = twin(scenario)
    assert out[:4] == [[0, 0], [0, 0], [0, 1], [1, 2]]
    assert out[5] == out[4] and out[4][1] == 3
    assert out[6:] == [None, None]


def test_scheduler_start_stop_thread():
    s = make(stt, stt.ManualClock(start_ms=T0))
    try:
        sched = stt.CadenceScheduler(s)
        sched.start()
        assert sched._thread is not None and sched._thread.is_alive()
        assert sched._thread.name == "sentinel-cadence"
        assert s.telemetry._carry_ms is not None
        assert s.tiering._carry_ms is not None
        sched.start()
        sched.stop()
        assert sched._thread is None
        sched.stop()
    finally:
        s.close()


def test_disable_env_restores_legacy_composition(monkeypatch):
    """Knob off: every decide pays a standalone sketch update again (two
    dispatches a batch) and the single-dispatch counter stays 0."""
    monkeypatch.setenv("SENTINEL_SINGLE_DISPATCH", "0")

    def scenario(pkg, s, clk):
        out = [s.tiering.enabled, bool(s._single_dispatch)]
        for _ in range(3):
            s.entry_batch(["a", "b"], acquire=[1, 1])
            clk.advance_ms(25)
        return out + [s.obs.counters.get(ck.ROUTE_SINGLE_DISPATCH),
                      s.obs.counters.get(ck.PIPE_DISPATCH)]

    assert twin(scenario, host_fast_path=False) == [True, False, 0, 6]


def test_single_dispatch_default_on(monkeypatch):
    monkeypatch.delenv("SENTINEL_SINGLE_DISPATCH", raising=False)

    def scenario(pkg, s, clk):
        out = [bool(s._single_dispatch)]
        s.entry_batch(["a"], acquire=[1])
        return out + [s.obs.counters.get(ck.ROUTE_SINGLE_DISPATCH),
                      s.obs.counters.get(ck.PIPE_DISPATCH)]

    assert twin(scenario, host_fast_path=False) == [True, 1, 1]
