"""Port parity: event-driven breaker observers of ``sentinel_tpu_torch``
against ``sentinel_tpu``'s (``tests/test_breaker_events.py``).

Observers fire on the thread that reads the batch causing the arc (an
exit reads the states itself), with zero missed transitions under rapid
OPEN→HALF_OPEN→{CLOSED,OPEN} oscillation; a failing observer breaks
nothing; an observer may re-enter the engine. Each scenario runs on twin
runtimes (``host_fast_path=False``) under twin ManualClocks: the observed
transitions, the obs views, the block-log lines and the engine state must
agree. ``force_breaker`` and the breaker snapshots are held the same way.
"""

import pytest

from sentinel_tpu.rules.degrade import (
    STATE_CLOSED, STATE_HALF_OPEN, STATE_OPEN,
)

from test_torch_obs import twin

CFG = dict(max_flow_rules=16)


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SENTINEL_TIERING_DISABLE", "1")


def _count_rule(pkg, resource):
    return [pkg.DegradeRule(resource=resource,
                            grade=pkg.GRADE_EXCEPTION_COUNT, count=1,
                            time_window=1, min_request_amount=1)]


def test_rapid_oscillation_zero_missed_transitions(tmp_path):
    def scenario(pkg, sph, clk):
        sph.load_degrade_rules(_count_rule(pkg, "osc"))
        seen = []
        sph.add_breaker_observer(
            lambda res, old, new: seen.append((res, old, new)))

        def call(fail):
            try:
                e = sph.entry("osc")
            except pkg.BlockException:
                return False
            if fail:
                e.trace(RuntimeError("x"))
            e.exit()
            return True

        marks = [call(fail=True), len(seen)]
        for i in range(6):
            clk.advance_ms(1100)
            marks.append((call(fail=(i % 2 == 0)), len(seen)))
            if i % 2:
                marks.append((call(fail=True), len(seen)))
        marks.append(sph.check_breaker_transitions())
        return seen, marks

    _, (seen, marks), _ = twin(scenario, tmp_path, **CFG)
    arcs = [(o, n) for _r, o, n in seen]
    assert arcs[0] == (STATE_CLOSED, STATE_OPEN)
    assert arcs.count((STATE_OPEN, STATE_HALF_OPEN)) == 6
    assert (STATE_HALF_OPEN, STATE_CLOSED) in arcs
    for (o1, n1), (o2, n2) in zip(arcs, arcs[1:]):
        assert n1 == o2, f"missed transition between {n1} and {o2}"
    assert marks[-1] == 0          # the poll fallback has nothing left


def test_observer_errors_do_not_break_the_pipeline(tmp_path):
    def scenario(pkg, sph, clk):
        sph.load_degrade_rules(_count_rule(pkg, "r"))
        calls = []
        sph.add_breaker_observer(
            lambda *a: (_ for _ in ()).throw(RuntimeError("boom")))
        sph.add_breaker_observer(lambda res, old, new: calls.append(new))
        e = sph.entry("r")
        e.trace(RuntimeError("x"))
        e.exit()
        after = "pass"
        try:
            sph.entry("r").exit()
        except pkg.BlockException:
            after = "block"
        return calls, after

    _, (calls, after), _ = twin(scenario, tmp_path, **CFG)
    assert calls == [STATE_OPEN] and after == "block"


def test_observer_may_reenter_the_engine(tmp_path):
    def scenario(pkg, sph, clk):
        sph.load_degrade_rules(_count_rule(pkg, "re"))
        reentered = []

        def observer(res, old, new):
            sph.check_breaker_transitions()
            try:
                sph.entry("other").exit()
            except pkg.BlockException:
                pass
            reentered.append((old, new))

        sph.add_breaker_observer(observer)
        e = sph.entry("re")
        e.trace(RuntimeError("x"))
        e.exit()
        return reentered

    _, reentered, _ = twin(scenario, tmp_path, **CFG)
    assert reentered == [(STATE_CLOSED, STATE_OPEN)]


def test_force_breaker_and_breaker_snapshots(tmp_path):
    """``force_breaker`` drives every slot of a resource into a state
    (OPEN half-opens after the rule's window), observers see the arcs,
    and ``breaker_states`` / ``breaker_resources`` read them."""
    def scenario(pkg, sph, clk):
        sph.load_degrade_rules(_count_rule(pkg, "a") + _count_rule(pkg, "b")
                               + _count_rule(pkg, "a"))
        seen = []
        sph.add_breaker_observer(
            lambda res, old, new: seen.append((res, old, new)))
        sph.check_breaker_transitions()    # the baseline
        out = [sph.force_breaker("a", STATE_OPEN),
               sph.force_breaker("nope", STATE_OPEN),
               sph.breaker_states(), sph.breaker_resources()]
        try:
            sph.entry("a").exit()
            out.append("pass")
        except pkg.BlockException as e:
            out.append(type(e).__name__)
        clk.advance_ms(1100)
        sph.entry("a").exit()          # the probe closes the breakers
        out.append(sph.breaker_states())
        out.append(sph.force_breaker("b", STATE_HALF_OPEN))
        out.append(sph.breaker_resources())
        with pytest.raises(ValueError):
            sph.force_breaker("a", 7)
        return seen, out

    _, (seen, out), _ = twin(scenario, tmp_path, **CFG)
    assert out[:2] == [True, False]
    assert out[2][:3] == [STATE_OPEN, STATE_CLOSED, STATE_OPEN]
    assert out[4] == "DegradeException"
    assert ("a", STATE_CLOSED, STATE_OPEN) in seen
    assert ("b", STATE_CLOSED, STATE_HALF_OPEN) in seen


def test_batch_readback_carries_breaker_states(tmp_path):
    """With observers registered, a batch's verdict readback carries the
    states: the arc fires when the handle is read, not before."""
    def scenario(pkg, sph, clk):
        sph.load_degrade_rules(_count_rule(pkg, "osc"))
        seen = []
        sph.add_breaker_observer(
            lambda res, old, new: seen.append((old, new)))
        e = sph.entry("osc")
        e.trace(RuntimeError("x"))
        e.exit()                                   # CLOSED → OPEN
        clk.advance_ms(1100)
        h = sph.entry_batch_nowait(["osc"] * 4)    # OPEN → HALF_OPEN
        before = list(seen)
        v = h.result()
        return before, list(seen), v.allow.tolist()

    _, (before, after, allow), _ = twin(scenario, tmp_path, **CFG)
    assert before == [(STATE_CLOSED, STATE_OPEN)]
    assert after == before + [(STATE_OPEN, STATE_HALF_OPEN)]
    assert allow.count(True) == 1


def test_observers_ride_every_dispatch_route(tmp_path):
    """The split, fused and exit paths carry the breaker snapshot too."""
    import numpy as np

    def scenario(pkg, sph, clk):
        sph.load_degrade_rules(_count_rule(pkg, "api"))
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=1e6)])
        seen = []
        sph.add_breaker_observer(
            lambda res, old, new: seen.append((old, new)))
        sph.check_breaker_transitions()    # the baseline
        rows = sph.intern_resources(["api"] * 8)
        ra = sph.spec.alt_rows
        z = np.zeros(8, np.int32)
        h = sph.decide_and_exit_raw_nowait(
            rows, z, np.full(8, ra, np.int32), z, np.full(8, ra, np.int32),
            np.ones(8, np.int32), np.ones(8, np.bool_),
            np.zeros(8, np.bool_), exit_rows=rows[:1],
            exit_error=np.ones(1, np.bool_))
        out = [h.result().allow.tolist(), list(seen)]
        clk.advance_ms(1100)
        origins = ["o"] + [""] * 4200
        out.append(sph.entry_batch(["api"] * 4201,
                                   origins=origins).allow.sum().item())
        out.append(list(seen))
        return out

    ts, out, _ = twin(scenario, tmp_path, **CFG)
    assert out[1] == [(STATE_CLOSED, STATE_OPEN)]
    assert out[3][-1] == (STATE_OPEN, STATE_HALF_OPEN)
    assert ts.routes["split"] == 1 and ts.routes["fused"] == 1
    ts.close()
