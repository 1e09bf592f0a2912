"""Port parity: live window-geometry reload of ``sentinel_tpu_torch``
against ``sentinel_tpu``'s (``tests/test_window_reload.py``).

``update_window_geometry`` (and the sample-count / interval property
cells) change the second window mid-traffic: QPS enforcement holds under
the new geometry, the second windows and shaping state cold-reset, and
the minute ring, gauges and breakers carry over. Twin runtimes (the
default host fast path on, as in the reference's tests) must agree on
the verdicts, the obs views, the block-log lines and the engine state.
"""

import dataclasses

import pytest

from test_torch_obs import T0, twin


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SENTINEL_TIERING_DISABLE", "1")


CFG = dict(max_flow_rules=16, host_fast_path=True)


def drain(pkg, sph, n, resource="api"):
    out = []
    for _ in range(n):
        try:
            with sph.entry(resource):
                out.append("p")
        except pkg.BlockException:
            out.append("b")
    return "".join(out)


def test_sample_count_change_mid_traffic(tmp_path):
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=10.0)])
        out = [drain(pkg, sph, 15)]
        sph.update_window_geometry(sample_count=4)
        out.append((sph.spec.second.buckets, sph.spec.second.win_ms))
        out.append(drain(pkg, sph, 15))
        clk.advance_ms(1000)
        out.append(drain(pkg, sph, 15))
        return out

    _, out, _ = twin(scenario, tmp_path, **CFG)
    assert out[0].count("p") == 10 and out[1] == (4, 250)
    assert out[2].count("p") == 10 and out[3].count("p") == 10


def test_interval_change_rescales_budget_window(tmp_path):
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=4.0)])
        sph.update_window_geometry(interval_ms=2000)
        out = [sph.spec.second.win_ms, drain(pkg, sph, 8)]
        clk.advance_ms(1000)
        out.append(drain(pkg, sph, 4))
        return out

    _, out, _ = twin(scenario, tmp_path, **CFG)
    assert out[0] == 1000 and out[1].count("p") == 4
    assert out[2].count("p") == 0


def test_minute_ring_survives_geometry_change(tmp_path):
    def scenario(pkg, sph, clk):
        for _ in range(7):
            with sph.entry("svc"):
                pass
        sph._flush_fast()
        sph.update_window_geometry(sample_count=4)
        clk.advance_ms(1500)
        return [dataclasses.asdict(n) for n in sph.metrics_snapshot(T0)]

    _, snap, _ = twin(scenario, tmp_path, **CFG)
    assert {n["resource"]: n for n in snap}["svc"]["pass_qps"] == 7


def test_noop_and_invalid_geometry(tmp_path):
    def scenario(pkg, sph, clk):
        second = sph._state.second
        sph.update_window_geometry(sample_count=2, interval_ms=1000)
        out = [sph._state.second is second]
        for kw in (dict(sample_count=3), dict(sample_count=0),
                   dict(interval_ms=-500)):
            with pytest.raises(ValueError):
                sph.update_window_geometry(**kw)
        return out

    _, out, _ = twin(scenario, tmp_path, **CFG)
    assert out == [True]


def test_property_cell_drives_reload(tmp_path):
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="api", count=6.0)])
        out = [drain(pkg, sph, 8)]
        sph.sample_count_property.update_value(5)
        out.append((sph.spec.second.buckets, sph.spec.second.win_ms))
        sph.interval_property.update_value(2000)
        out.append((sph.spec.second.buckets, sph.spec.second.win_ms))
        out.append(drain(pkg, sph, 8))
        sph.flow_property.update_value(
            [pkg.FlowRule(resource="api", count=1.0)])
        clk.advance_ms(2500)
        out.append(drain(pkg, sph, 3))
        return out

    _, out, _ = twin(scenario, tmp_path, **CFG)
    assert out[1] == (5, 200) and out[2] == (5, 400)
    assert out[3].count("p") == 6 and out[4] == "pbb"


def test_geometry_change_keeps_gauges_breakers_and_occupy(tmp_path):
    """Held THREAD entries, open breakers and live bookings across a
    geometry change: gauges and breakers carry over, the shaping state
    (bookings included) cold-resets; the leased fast-path rows drop their
    leases."""
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([
            pkg.FlowRule(resource="t", count=2, grade=pkg.GRADE_THREAD),
            pkg.FlowRule(resource="lease", count=50.0),
            pkg.FlowRule(resource="svc", count=2.0)])
        sph.load_degrade_rules([pkg.DegradeRule(
            resource="d", grade=pkg.GRADE_EXCEPTION_COUNT, count=1,
            time_window=5, min_request_amount=1)])
        held = [sph.entry("t"), sph.entry("t")]
        e = sph.entry("d")
        e.trace(RuntimeError("x"))
        e.exit()
        leased = [sph.entry("lease").fast for _ in range(3)]
        drain(pkg, sph, 2, "svc")
        clk.advance_ms(500)
        drain(pkg, sph, 1, "svc")
        pr = sph.entry("svc", prioritized=True, sleep=False)
        sph.update_window_geometry(sample_count=4, interval_ms=2000)
        out = [leased, pr.wait_ms, drain(pkg, sph, 2, "t"),
               drain(pkg, sph, 2, "d"), drain(pkg, sph, 3, "lease")]
        for h in held:
            h.exit()
        out.append(drain(pkg, sph, 3, "t"))
        return out

    _, out, _ = twin(scenario, tmp_path, **CFG)
    assert out[0] == ["leased"] * 3 and out[1] == 500
    assert out[2] == "bb" and out[3] == "bb" and out[5].count("p") >= 2
