"""Port parity: ``sentinel_tpu_torch.obs.resource_hist`` against
``sentinel_tpu.obs.resource_hist``.

The quantile extraction (``quantiles_from_counts`` on tensors and its
numpy mirror ``np_quantiles``) must equal the reference's bit for bit on
random counts whose row totals stay below 2^24 — the range in which
float32 sums are exact in any order. Above 2^24 the reference's own
device and host sums disagree (ROADMAP C1); no test here goes there. The
known values and edge cases of ``tests/test_resource_hist.py`` run on both
packages' modules; the engine test records RT histograms through
``entry()`` on twin runtimes and reads the quantiles back through
``Sentinel.telemetry``; the tail tracker is compared on the same
sequences of cumulative vectors. With the reference's tiering ON, a
demoted row's histogram vector rides its cold entry and the promote
restores it; the controller's degrade lever reads the interval tails.
"""

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.obs import resource_hist as jrh
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.obs import counters as ck
from sentinel_tpu_torch.obs import resource_hist as trh

T0 = 1_785_000_000_000


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SENTINEL_TIERING_DISABLE", "1")


def _both(fn):
    want = fn(jrh)
    got = fn(trh)
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    return got


# ---- geometry -----------------------------------------------------------

def test_constants_and_edges_match():
    for name in ("DEFAULT_BUCKETS", "MIN_BUCKETS", "MAX_BUCKETS",
                 "QUANTILES", "RESOURCE_HIST_DISABLE_ENV",
                 "RESOURCE_HIST_BUCKETS_ENV"):
        assert getattr(trh, name) == getattr(jrh, name), name
    for hb in (8, 16, 32):
        _both(lambda m: m.bucket_edges_ms(hb))
        _both(lambda m: m.bucket_thresholds_ms(hb))


@pytest.mark.parametrize("hb", [8, 16, 32])
def test_bucket_index_both_forms_match(hb):
    rng = np.random.default_rng(hb)
    v = np.concatenate([rng.integers(-5, 1 << 20, size=257),
                        [0, 1, 2, 3, 4, 5, 8, 9, (1 << 30), (1 << 30) + 1]]
                       ).astype(np.int32)
    want = jrh.np_bucket_index(v, hb)
    np.testing.assert_array_equal(trh.np_bucket_index(v, hb), want)
    np.testing.assert_array_equal(
        trh.bucket_index(torch.from_numpy(v), hb).numpy(), want)
    # scalars, as the reference's edge test passes them
    assert int(trh.bucket_index(5, hb)) == int(jrh.bucket_index(5, hb))


# ---- quantile extraction --------------------------------------------------

@pytest.mark.parametrize("hb", [8, 16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantiles_equal_reference_below_2_24(hb, seed):
    """Random counts (row totals < 2^24, many zero buckets and an empty
    row): the port's tensor form and numpy form equal the reference's
    numpy form and its device form, bit for bit (the jitted form, inside
    the reference's telemetry tick, is held in test_torch_telemetry.py)."""
    rng = np.random.default_rng(100 + seed)
    counts = rng.integers(0, (1 << 24) // (2 * hb), size=(33, hb))
    counts[rng.random(counts.shape) < 0.4] = 0
    counts[5] = 0
    counts = counts.astype(np.int32)
    assert counts.sum(axis=1).max() < (1 << 24)
    want = jrh.np_quantiles(counts)
    dev = np.asarray(jrh.quantiles_from_counts(counts))
    np.testing.assert_array_equal(dev, want)
    got = trh.quantiles_from_counts(torch.from_numpy(counts))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(trh.np_quantiles(counts), want)
    assert np.all(got.numpy()[5] == 0.0)              # empty → no signal


def test_quantiles_known_values():
    hb = 32

    def run(m):
        c = np.zeros(hb, np.int32)
        c[0] = 100
        q1 = m.np_quantiles(c[None])[0]
        c[9] = 2
        q2 = m.np_quantiles(c[None])[0]
        return np.concatenate([q1, q2])

    q = _both(run)
    assert q[0] == np.float32(0.5)
    assert q[5] == pytest.approx(381.44, abs=0.01)
    assert q[3] == np.float32(0.51)
    # the tensor form on the same rows
    c = np.zeros((2, hb), np.int32)
    c[:, 0] = 100
    c[1, 9] = 2
    np.testing.assert_array_equal(
        trh.quantiles_from_counts(torch.from_numpy(c)).numpy().ravel(), q)


def test_quantile_rank_at_exact_bucket_boundary():
    hb = 16

    def run(m):
        c = np.zeros(hb, np.int32)
        c[2], c[4] = 10, 10
        q_half = m.np_quantiles(c[None], quantiles=(0.5,))[0]
        c = np.zeros(hb, np.int32)
        c[5] = 1
        return np.concatenate([q_half, m.np_quantiles(c[None])[0]])

    q = _both(run)
    assert q[0] == np.float32(4.0)                     # bucket 2 hi edge
    assert np.all(q[1:] == q[1]) and 16.0 < float(q[1]) <= 32.0
    c = np.zeros((1, hb), np.int32)
    c[0, 2], c[0, 4] = 10, 10
    assert trh.quantiles_from_counts(
        torch.from_numpy(c), quantiles=(0.5,)).item() == 4.0


def test_top_bucket_open_above_caps_at_last_edge():
    hb = 8
    c = np.zeros((1, hb), np.int32)
    c[0, hb - 1] = 4
    q = _both(lambda m: m.np_quantiles(c)[0])
    edges = trh.bucket_edges_ms(hb)
    assert np.all(q > edges[-2]) and np.all(q <= edges[-1])
    np.testing.assert_array_equal(
        trh.quantiles_from_counts(torch.from_numpy(c)).numpy()[0], q)


def test_merge_is_associative_and_order_free():
    """Shard sums below 2^24 a row: the quantiles of the sum agree in
    both packages whichever order the shards were added in."""
    rng = np.random.default_rng(5)
    shards = rng.integers(0, 10_000, size=(6, 32)).astype(np.int32)
    fwd = torch.zeros(32, dtype=torch.int32)
    for s in shards:
        fwd += torch.from_numpy(s)
    rev = shards[::-1].sum(axis=0)
    assert np.array_equal(fwd.numpy(), rev)
    want = jrh.np_quantiles(shards.sum(axis=0)[None])
    np.testing.assert_array_equal(
        trh.quantiles_from_counts(fwd[None]).numpy(), want)
    np.testing.assert_array_equal(trh.np_quantiles(rev[None]), want)


def test_knob_envs(monkeypatch):
    def run(m):
        out = [m.engine_hist_buckets()]
        for v in ("12", "2", "99", "x"):
            monkeypatch.setenv(m.RESOURCE_HIST_BUCKETS_ENV, v)
            out.append(m.engine_hist_buckets())
        for v in ("1", "off"):
            monkeypatch.setenv(m.RESOURCE_HIST_DISABLE_ENV, v)
            out.append(m.engine_hist_buckets())
        monkeypatch.delenv(m.RESOURCE_HIST_BUCKETS_ENV)
        monkeypatch.delenv(m.RESOURCE_HIST_DISABLE_ENV)
        return out

    assert _both(run) == [32, 12, 8, 32, 32, 0, 32]


# ---- the engine records, telemetry surfaces ---------------------------------

def _make(pkg, **over):
    base = dict(max_resources=64, max_flow_rules=16, max_degrade_rules=16,
                max_authority_rules=16, host_fast_path=False)
    cfg = pkg.load_config(**{**base, **over})
    extra = {"device": "cpu"} if pkg is stt else {}
    return pkg.Sentinel(cfg, clock=pkg.ManualClock(start_ms=T0), **extra)


def _timed_exit(s, name, rt_ms):
    e = s.entry(name)
    if rt_ms:
        s.clock.advance_ms(rt_ms)
    e.exit()


def test_engine_records_and_surfaces_quantiles():
    out = {}
    for name, pkg in (("jax", stpu), ("torch", stt)):
        s = _make(pkg)
        for _ in range(100):
            _timed_exit(s, "api", 1)
        for _ in range(2):
            _timed_exit(s, "api", 400)
        row = s.resources.lookup("api")
        vec = convert.to_numpy(s._state)["rt_hist"][row]
        assert vec[0] == 100 and vec[9] == 2 and vec.sum() == 102
        assert s.telemetry.poll() == 1
        hot = {h["resource"]: h for h in s.telemetry.hot_entries()}
        want = trh.np_quantiles(vec[None].astype(np.int64))[0]
        h = hot["api"]
        assert h["rt_p50_ms"] == round(float(want[0]), 3)
        assert h["rt_p99_ms"] == round(float(want[2]), 3)
        out[name] = (s.telemetry.hot_entries(),
                     s.obs.counters.get(ck.TELEMETRY_HIST_TICK),
                     convert.to_numpy(s._state))
        s.close()
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1] == 1
    assert convert.leaf_diff(out["jax"][2], out["torch"][2]) == []


# ---- interval tails ------------------------------------------------------

def test_tail_tracker_isolates_the_interval():
    hb = 32

    def run(m):
        tr = m.ResourceTailTracker()
        c = np.zeros(hb, np.int64)
        c[0] = 10_000
        out = [tr.update([("svc", c)])]
        c2 = c.copy()
        c2[9] += 20
        out.append(tr.update([("svc", c2)]))
        out.append(tr.update([("svc", c2)]))
        c3 = np.zeros(hb, np.int64)
        c3[2] = 4
        out.append(tr.update([("svc", c3)]))
        out.append(float(m.np_quantiles(c2[None])[0, -1]))
        return out

    first, slow, none, reset, cumulative = _both(run)
    assert dict(first)["svc"] <= 1.0
    assert dict(slow)["svc"] > 256.0
    assert none == ()
    assert 2.0 < dict(reset)["svc"] <= 4.0
    assert cumulative <= 1.0


def test_tail_tracker_cap_evicts_stale_names():
    def run(m):
        tr = m.ResourceTailTracker(cap=4)
        c = np.zeros(32, np.int64)
        c[0] = 1
        sizes = []
        for i in range(8):
            tr.update([(f"r{i}", c)])
            sizes.append(len(tr._prev))
        # too short a vector is skipped
        assert tr.update([("short", np.ones(4, np.int64))]) == ()
        return sizes

    sizes = _both(run)
    assert max(sizes) <= 5


# ---- tiering: counts ride demote → promote -----------------------------

def _tiered(monkeypatch):
    monkeypatch.delenv("SENTINEL_TIERING_DISABLE", raising=False)
    monkeypatch.setenv("SENTINEL_TPU_NATIVE", "0")


def test_demoted_cold_entry_carries_the_vector(monkeypatch):
    _tiered(monkeypatch)
    out = {}
    for name, pkg in (("jax", stpu), ("torch", stt)):
        s = _make(pkg, max_resources=32)
        try:
            t = s.tiering
            assert t.enabled
            for _ in range(5):
                _timed_exit(s, "r0", 2)          # bucket 1 ((1, 2])
            _timed_exit(s, "r0", 300)            # bucket 9 ((256, 512])
            row0 = s.resources.lookup("r0")
            before = convert.to_numpy(s._state)["rt_hist"][row0].copy()
            assert before[1] == 5 and before[9] == 1
            assert s.resources.evict_name("r0")
            s.entry("keepalive").exit()          # run the demote drain
            t.poll()                             # land the payload
            entry = t.cold.pop("r0")
            assert entry is not None and entry.rt_hist is not None
            assert np.array_equal(entry.rt_hist, before)
            out[name] = (before.tolist(), entry.rt_hist.tolist(),
                         convert.engine_to_numpy(s))
        finally:
            s.close()
    assert out["torch"][:2] == out["jax"][:2]
    assert convert.leaf_diff(out["jax"][2], out["torch"][2]) == []


def test_cold_entry_vector_round_trips_bit_exact(monkeypatch):
    _tiered(monkeypatch)
    out = {}
    for name, pkg in (("jax", stpu), ("torch", stt)):
        s = _make(pkg, max_resources=32)
        try:
            t = s.tiering
            for _ in range(5):
                _timed_exit(s, "r0", 2)
            _timed_exit(s, "r0", 300)
            row0 = s.resources.lookup("r0")
            before = convert.to_numpy(s._state)["rt_hist"][row0].copy()
            assert s.resources.evict_name("r0")
            s.entry("keepalive").exit()
            t.poll()
            assert "r0" in t.cold
            s.entry_batch(["r0"], acquire=[1])   # cold miss → promote
            assert t.snapshot()["promoted"] >= 1
            row1 = s.resources.lookup("r0")
            after = convert.to_numpy(s._state)["rt_hist"][row1].copy()
            assert np.array_equal(after, before)
            _timed_exit(s, "r0", 2)
            assert (convert.to_numpy(s._state)["rt_hist"][row1].sum()
                    == before.sum() + 1)
            out[name] = (row1, after.tolist(), convert.engine_to_numpy(s))
        finally:
            s.close()
    assert out["torch"][:2] == out["jax"][:2]
    assert convert.leaf_diff(out["jax"][2], out["torch"][2]) == []


# ---- controller: interval tails from cumulative vectors ------------------

def test_policy_prefers_tail_signal_over_mean():
    """Bimodal victim RT: mean under the bound, interval p99 above. The
    p99 signal trips the victim's tracker on both packages; the mean
    alone decides nothing."""
    from sentinel_tpu import control as jctl
    from sentinel_tpu_torch import control as tctl

    def run(c):
        cfg = c.PolicyConfig(cooldown_ms=0, degrade_rt_ms=100.0,
                             degrade_bad_ticks=2, degrade_hold_ms=1000)

        def ob(ts, p99_pairs, mean_pairs):
            return c.Observation(ts_ms=ts, pass_per_s=100.0,
                                 block_per_s=0.0, rt_avg_ms=10.0,
                                 p99_ms=0.0, queue_depth=0, queue_max=0,
                                 resource_rt=mean_pairs,
                                 resource_p99=p99_pairs)

        mean = (("victim", 10.5), ("steady", 0.6))
        tail = (("victim", 229.1), ("steady", 0.6))
        pol = c.OverloadPolicy(cfg)
        out = [[tuple(a) for a in pol.observe(ob(0, tail, mean))],
               [tuple(a) for a in pol.observe(ob(100, tail, mean))]]
        pol2 = c.OverloadPolicy(cfg)
        out.append([pol2.observe(ob(ts, (), mean))
                    for ts in range(0, 1000, 100)])
        return out

    got = run(tctl)
    assert got == run(jctl)
    assert got[0] == [] and got[1] == [("victim", "open")]
    assert all(a == [] for a in got[2])


def test_control_loop_force_opens_slow_consumer(monkeypatch):
    """End to end on twin engines: bimodal victim traffic whose MEAN
    stays under the bound and tail above it; the tick wires the device
    histogram deltas into the policy and the drain forces the victim's
    real breaker while the steady resource keeps serving."""
    monkeypatch.setenv("SENTINEL_CONTROL_DEGRADE_RT_MS", "100")
    from sentinel_tpu import control as jctl
    from sentinel_tpu_torch import control as tctl
    out = {}
    for name, pkg, c in (("jax", stpu, jctl), ("torch", stt, tctl)):
        s = _make(pkg)
        try:
            s.load_degrade_rules([
                pkg.DegradeRule(resource="victim",
                                grade=pkg.GRADE_EXCEPTION_COUNT,
                                count=10_000, time_window=5),
                pkg.DegradeRule(resource="steady",
                                grade=pkg.GRADE_EXCEPTION_COUNT,
                                count=10_000, time_window=5)])
            ctl = c.ControlLoop(s, interval_ms=50)
            assert ctl.enabled and ctl.policy.cfg.degrade_rt_ms == 100.0
            p99s = []
            for _tick in range(ctl.policy.cfg.degrade_bad_ticks):
                for _ in range(40):
                    _timed_exit(s, "victim", 1)
                    _timed_exit(s, "steady", 1)
                for _ in range(2):
                    _timed_exit(s, "victim", 200)
                assert s.telemetry.poll() == 1
                hot = {h["resource"]: h for h in s.telemetry.hot_entries()}
                assert float(hot["victim"].get("rt_ms", 0.0)) < 100.0
                assert hot["victim"]["rt_p99_ms"] > 100.0
                p99s.append(hot["victim"]["rt_p99_ms"])
                ctl.tick()
                ctl.drain()
            assert s.obs.counters.get(ck.CONTROL_TAIL_SIGNAL) >= 1
            assert s.obs.counters.get(ck.CONTROL_DEGRADE_ACTION) >= 1
            assert ctl.policy.snapshot()["degrade"].get("victim") == "open"
            with pytest.raises(pkg.DegradeException):
                s.entry("victim")
            with s.entry("steady"):
                pass
            out[name] = (p99s, [a["note"] for a in ctl.action_log()],
                         s.breaker_states(),
                         s.obs.counters.get(ck.CONTROL_TICK))
        finally:
            s.close()
    assert out["torch"] == out["jax"]
