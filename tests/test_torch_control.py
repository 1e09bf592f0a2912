"""Port parity: the overload controller (``sentinel_tpu_torch.control``)
against ``sentinel_tpu.control``.

Twins of the 15 tests of ``tests/test_control.py``: the pure policy core
under explicit timestamps, the deterministic admission gate and the
actuator seams against a real engine under a ManualClock. Every scenario
runs on both packages' modules (``_both``) and must give the same
actions, estimates, notes and gate patterns; the engine scenarios also
compare the breaker states the ``Degrade`` actuator forced.
"""

import pytest

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu import control as jctl
from sentinel_tpu.frontend import batcher as jbatcher
from sentinel_tpu.obs import hist as jhist
from sentinel_tpu_torch import control as tctl
from sentinel_tpu_torch.frontend import batcher as tbatcher
from sentinel_tpu_torch.obs import hist as thist

T0 = 1_785_000_000_000
SIDES = {
    "jax": dict(pkg=stpu, ctl=jctl, batcher=jbatcher, hist=jhist),
    "torch": dict(pkg=stt, ctl=tctl, batcher=tbatcher, hist=thist),
}


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.delenv("SENTINEL_CONTROL_DISABLE", raising=False)


def _plain(x):
    """Actions (NamedTuples of either package) as comparable tuples."""
    if isinstance(x, list):
        return [_plain(a) for a in x]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__,) + tuple(_plain(v) for v in x)
    return x


def _both(fn):
    """``fn(side)`` on both packages' modules → the port's result, which
    must equal the reference's."""
    want = _plain(fn(SIDES["jax"]))
    got = _plain(fn(SIDES["torch"]))
    assert got == want
    return got


def obs(c, ts_ms, *, p99_ms=0.0, queue_depth=0, queue_max=0,
        pass_per_s=0.0, block_per_s=0.0, rt_avg_ms=0.0, resource_rt=()):
    return c.Observation(ts_ms=ts_ms, pass_per_s=pass_per_s,
                         block_per_s=block_per_s, rt_avg_ms=rt_avg_ms,
                         p99_ms=p99_ms, queue_depth=queue_depth,
                         queue_max=queue_max, resource_rt=resource_rt)


# ------------------------------------------------------------ estimators

def test_windowed_filter_max_and_expiry():
    def run(x):
        f = x["ctl"].WindowedFilter(1000, "max")
        return [f.update(0, 5.0), f.update(100, 3.0), f.update(1100, 1.0),
                f.update(1200, 1.0), f.value]

    assert _both(run) == [5.0, 5.0, 3.0, 1.0, 1.0]


def test_windowed_filter_min_mode():
    def run(x):
        f = x["ctl"].WindowedFilter(1000, "min")
        return [f.value, f.update(0, 5.0), f.update(100, 2.0),
                f.update(900, 9.0), f.update(1500, 9.0)]

    assert _both(run) == [None, 5.0, 2.0, 2.0, 9.0]


def test_hist_delta_p99_isolates_the_interval():
    def run(x):
        n, base = x["hist"].NUM_BUCKETS, x["hist"].BASE_NS
        est = x["ctl"].HistDeltaP99()
        snap1 = [0] * n
        snap1[5] = 1000
        first = est.update(snap1)
        snap2 = list(snap1)
        snap2[16] = 100
        p99 = est.update(snap2)
        return [first, p99, est.update(snap2), (base << 15) / 1e6,
                (base << 16) / 1e6]

    first, p99, idle, lo, hi = _both(run)
    assert 0.0 < first < 1.0
    assert lo < p99 <= hi and p99 > 60.0
    assert idle == 0.0


# ---------------------------------------------------------- control law

def test_aimd_backoff_ramps_to_floor_with_one_retune():
    def run(x):
        c = x["ctl"]
        cfg = c.PolicyConfig(p99_hi_ms=20.0, p99_lo_ms=10.0, min_admit=0.3,
                             cooldown_ms=0, shed_backoff=0.5,
                             retune_budget_ms=0, retune_cap_frac=0.5)
        pol = c.OverloadPolicy(cfg, base_budget_ms=3, base_batch_cap=256)
        return [pol.observe(obs(c, 1000, p99_ms=50.0)),
                pol.observe(obs(c, 2000, p99_ms=50.0)),
                pol.observe(obs(c, 3000, p99_ms=50.0)),
                pol.admit_frac, pol.snapshot()["degraded_batcher"]]

    out = _both(run)
    assert out[0] == [("ShedRate", 0.5), ("RetuneBatcher", 6, 128)]
    assert out[1] == [("ShedRate", 0.3)]
    assert out[2:] == [[], 0.3, True]


def test_recovery_restores_operator_batcher_tuning():
    def run(x):
        c = x["ctl"]
        cfg = c.PolicyConfig(p99_hi_ms=20.0, p99_lo_ms=10.0, min_admit=0.3,
                             cooldown_ms=0, shed_backoff=0.5,
                             shed_recover=0.5)
        pol = c.OverloadPolicy(cfg, base_budget_ms=3, base_batch_cap=256)
        pol.observe(obs(c, 1000, p99_ms=50.0))
        return [pol.observe(obs(c, 2000, p99_ms=5.0)), pol.admit_frac,
                pol.degraded_batcher]

    assert _both(run) == [[("ShedRate", 1.0), ("RetuneBatcher", 3, 256)],
                          1.0, False]


def test_hysteresis_band_holds():
    def run(x):
        c = x["ctl"]
        pol = c.OverloadPolicy(c.PolicyConfig(p99_hi_ms=20.0, p99_lo_ms=10.0,
                                              cooldown_ms=0))
        pol.observe(obs(c, 1000, p99_ms=50.0))
        frac = pol.admit_frac
        held = [pol.observe(obs(c, ts, p99_ms=15.0))
                for ts in (2000, 3000, 4000)]
        return [frac, held, pol.admit_frac]

    frac, held, after = _both(run)
    assert frac < 1.0 and held == [[], [], []] and after == frac


def test_cooldown_bounds_action_repeat_rate():
    def run(x):
        c = x["ctl"]
        pol = c.OverloadPolicy(c.PolicyConfig(p99_hi_ms=20.0,
                                              cooldown_ms=2000))
        sheds = []
        for ts in range(0, 5000, 500):
            sheds += [a for a in pol.observe(obs(c, ts, p99_ms=50.0))
                      if isinstance(a, c.ShedRate)]
        return sheds

    assert len(_both(run)) == 3


def test_queue_depth_alone_triggers_shed():
    def run(x):
        c = x["ctl"]
        pol = c.OverloadPolicy(c.PolicyConfig(
            p99_hi_ms=20.0, p99_lo_ms=10.0, cooldown_ms=0,
            queue_hi_frac=0.75))
        acts = pol.observe(obs(c, 1000, p99_ms=0.0, queue_depth=80,
                               queue_max=100))
        frac = pol.admit_frac
        pol.observe(obs(c, 2000, p99_ms=0.0, queue_depth=80, queue_max=100))
        held = pol.admit_frac
        pol.observe(obs(c, 3000, p99_ms=0.0, queue_depth=0, queue_max=100))
        return [acts, frac, held, pol.admit_frac]

    acts, frac, held, after = _both(run)
    assert any(a[0] == "ShedRate" for a in acts)
    assert frac < 1.0 and held <= frac and after > held


def test_degrade_tracker_full_cycle():
    def run(x):
        c = x["ctl"]
        pol = c.OverloadPolicy(c.PolicyConfig(
            cooldown_ms=0, degrade_rt_ms=50.0, degrade_bad_ticks=2,
            degrade_hold_ms=1000))
        bad, good, idle = (("svc", 100.0),), (("svc", 10.0),), \
            (("svc", 0.0),)
        out = []
        for ts, sig in ((0, bad), (100, bad)):
            out.append(pol.observe(obs(c, ts, resource_rt=sig)))
        out.append(pol.snapshot()["degrade"])
        for ts, sig in ((500, bad), (1200, idle), (1300, idle),
                        (1400, good), (1500, bad), (1600, bad),
                        (2700, idle), (2800, bad)):
            out.append(pol.observe(obs(c, ts, resource_rt=sig)))
        return out

    out = _both(run)
    assert out == [[], [("Degrade", "svc", "open")], {"svc": "open"}, [],
                   [("Degrade", "svc", "half_open")], [],
                   [("Degrade", "svc", "close")], [],
                   [("Degrade", "svc", "open")],
                   [("Degrade", "svc", "half_open")],
                   [("Degrade", "svc", "open")]]


# ------------------------------------------------------- admission gate

def test_admission_gate_is_deterministic_and_proportional():
    def run(x):
        q = x["batcher"].IngestQueue(batch_max=16)
        q.set_admission(0.5, seed=42)
        run1 = [q.admitted("api") for _ in range(400)]
        q.set_admission(0.5, seed=42)
        run2 = [q.admitted("api") for _ in range(400)]
        q.set_admission(0.5, seed=43)
        run3 = [q.admitted("api") for _ in range(400)]
        return [run1, run2, run3]

    run1, run2, run3 = _both(run)
    assert run1 == run2 and run3 != run1
    assert 0.4 < sum(run1) / len(run1) < 0.6


def test_admission_wide_open_is_zero_state():
    def run(x):
        q = x["batcher"].IngestQueue(batch_max=16)
        q.set_admission(1.0, seed=7)
        return [all(q.admitted("api") for _ in range(10)), q._admit_idx]

    assert _both(run) == [True, 0]


# ------------------------------------------------- actuators (real engine)

def _engine(x):
    pkg = x["pkg"]
    cfg = pkg.load_config(max_resources=32, max_flow_rules=8,
                          max_degrade_rules=8, max_authority_rules=8,
                          host_fast_path=False)
    extra = {"device": "cpu"} if pkg is stt else {}
    return pkg.Sentinel(config=cfg, clock=pkg.ManualClock(start_ms=T0),
                        **extra)


def test_actuators_retune_matches_construction():
    def run(x):
        engine = _engine(x)
        c = x["ctl"]
        act = c.Actuators(engine)
        out = [act.apply(c.ShedRate(0.5)), act.apply(c.RetuneBatcher(6, 4))]
        b = x["pkg"].AdaptiveBatcher(engine, batch_max=8, budget_ms=3,
                                     queue_max=64)
        ref = x["pkg"].AdaptiveBatcher(engine, batch_max=4, budget_ms=6,
                                       queue_max=64)
        try:
            act.bind_batcher(b)
            out += [act.apply(c.ShedRate(0.5)), b.queue.admit_frac,
                    act.apply(c.RetuneBatcher(6, 4)),
                    (b.queue.batch_max, b.queue.budget_ms)
                    == (ref.queue.batch_max, ref.queue.budget_ms),
                    b.batch_max]
            act.apply(c.RetuneBatcher(6, 100))
            out.append(b.queue.batch_max)
            with pytest.raises(TypeError):
                act.apply("not-an-action")
        finally:
            b.close()
            ref.close()
            engine.close()
        return out

    assert _both(run) == [None, None, "admit_frac=0.500 seed=0", 0.5,
                          "budget_ms=6 batch_cap=4", True, 8, 8]


def test_idle_controller_is_zero_state():
    def run(x):
        engine = _engine(x)
        b = x["pkg"].AdaptiveBatcher(engine, batch_max=8, budget_ms=3,
                                     queue_max=64)
        try:
            ctl = x["ctl"].ControlLoop(engine, b, interval_ms=100)
            out = [engine.control is ctl]
            for _ in range(5):
                engine.clock.advance_ms(150)
                ctl.poll()
            out += [ctl.snapshot()["ticks"], ctl.total_actions,
                    b.queue.admit_frac, (b.budget_ms, b.queue.batch_max),
                    all(b.queue.admitted("api") for _ in range(8)),
                    b.queue._admit_idx,
                    engine.obs.counters.get("control.tick")]
        finally:
            b.close()
            engine.close()
        return out

    assert _both(run) == [True, 5, 0, 1.0, (3, 8), True, 0, 5]


def test_disable_env_kills_the_loop(monkeypatch):
    monkeypatch.setenv("SENTINEL_CONTROL_DISABLE", "1")

    def run(x):
        engine = _engine(x)
        try:
            ctl = x["ctl"].ControlLoop(engine)
            return [ctl.enabled, ctl.tick(), ctl.poll(),
                    ctl.snapshot()["ticks"]]
        finally:
            engine.close()

    assert _both(run) == [False, 0, 0, 0]


def test_actuators_degrade_forces_real_breaker():
    def run(x):
        pkg, c = x["pkg"], x["ctl"]
        engine = _engine(x)
        try:
            engine.load_degrade_rules([pkg.DegradeRule(
                resource="svc", grade=pkg.GRADE_EXCEPTION_COUNT, count=100,
                time_window=5)])
            with engine.entry("svc"):
                pass
            act = c.Actuators(engine)
            out = [act.apply(c.Degrade("svc", "open")),
                   engine.breaker_states()]
            with pytest.raises(pkg.DegradeException):
                engine.entry("svc")
            out += [act.apply(c.Degrade("svc", "close")),
                    engine.breaker_states()]
            with engine.entry("svc"):
                pass
            out.append(act.apply(c.Degrade("nope", "open")))
            return out
        finally:
            engine.close()

    out = _both(run)
    assert out[0] == "svc->open" and out[1][0] == 1
    assert out[2] == "svc->close" and out[3][0] == 0
    assert out[4] is None
