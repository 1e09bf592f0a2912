"""Port parity: tiered resource state (``sentinel_tpu_torch.tiering``)
against ``sentinel_tpu.tiering``, with the reference's tiering ON.

Twins of every test of ``tests/test_tiering.py``. The sketch functions
take the same numpy-seeded tables and items in both packages (at
``bits`` 12 and 20, where the logical shift of the hash matters) and
must agree bit for bit; the cold-entry replay is held against both
packages' window settle; twin runtimes under twin ManualClocks must
agree on verdicts, engine state with the sketch table
(``convert.engine_to_numpy``), the cold tier's names and entries
(``convert.cold_tier_to_numpy``), ``tiering.snapshot()`` (less the
wall-clock migration times) and every counter. Inside the port, a
small tiered engine must equal a large all-resident one under churn.

Also here, with no counterpart in the reference's file: the dead-lane
spread of the sketch update, the row-slice extract/restore round trip
against the reference's, a forced collision of two promoted keys'
alt slots (the last lane wins, as on the reference's CPU), and the
port's one-shard ``shard_of_rows``.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.core.registry import Registry as JRegistry
from sentinel_tpu.engine import pipeline as jpl
from sentinel_tpu.stats import window as jwin
from sentinel_tpu.tiering import coldtier as jcold
from sentinel_tpu.tiering import sketch as jsk
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core.registry import Registry as TRegistry
from sentinel_tpu_torch.engine import pipeline as tpl
from sentinel_tpu_torch.obs import counters as ck
from sentinel_tpu_torch.parallel import local_shard
from sentinel_tpu_torch.stats import events as ev
from sentinel_tpu_torch.stats import window as twin_mod
from sentinel_tpu_torch.tiering import coldtier as tcold
from sentinel_tpu_torch.tiering import sketch as tsk

torch.set_num_threads(2)

T0 = 1_785_000_000_000
PKGS = {"jax": stpu, "torch": stt}
NEVER = twin_mod.NEVER
INT32_MAX = twin_mod.INT32_MAX


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    """The reference's Python registry (proactive demotion needs its
    ``evict_name``), logs under the test's temp dir, tiering ON."""
    monkeypatch.setenv("SENTINEL_TPU_NATIVE", "0")
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.delenv("SENTINEL_TIERING_DISABLE", raising=False)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# sketch: both packages on the same numpy-seeded tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [12, 20])
def test_bucket_hash_logical_shift_matches(bits):
    """Items whose products set the top bit hash alike in both packages
    (an arithmetic shift would differ once bits > 17)."""
    rng = np.random.default_rng(bits)
    counts = np.zeros((8, 1 << bits), np.int32)
    items = np.concatenate([
        rng.integers(0, 1 << 31, 4096),
        np.array([0, 1, (1 << 31) - 1, 1 << 20, 12345678])]).astype(np.int32)
    want = np.asarray(jsk._bucket_idx(_j(counts), _j(items)))
    got = tsk._bucket_idx(_t(counts), _t(items)).numpy()
    np.testing.assert_array_equal(got, want)
    # the top bit really is set for some products: the shifts differ there
    prod = (items.astype(np.int64)[None, :]
            * tsk._HASH_CONSTS[:8].astype(np.int64)[:, None]) & 0xFFFFFFFF
    assert (prod >= (1 << 31)).any()


@pytest.mark.parametrize("bits", [12, 20])
def test_update_and_tick_read_match_reference(bits):
    rng = np.random.default_rng(100 + bits)
    counts = rng.integers(0, 5000, (4, 1 << bits)).astype(np.int32)
    jc, tc = _j(counts), _t(counts)
    upd = jax.jit(jsk.update_sketch)
    for step in range(3):
        items = rng.integers(0, 1 << 20, 2048).astype(np.int32)
        valid = rng.random(2048) < 0.8
        jc, jo = upd(jc, _j(items), _j(valid))
        tc, to = tsk.update_sketch(tc, _t(items), _t(valid))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert bool(to) == bool(jo)
    jc2, je = jax.jit(jsk.tick_read, static_argnums=1)(jc, 3000)
    tc2, te = tsk.tick_read(tc, 3000)
    np.testing.assert_array_equal(tc2.numpy(), np.asarray(jc2))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te.dtype == torch.int32


def test_sketch_never_underestimates():
    counts_j = jsk.init_sketch(4, 8)
    counts_t = tsk.init_sketch(4, 8)
    rng = np.random.default_rng(3)
    true = {}
    for _ in range(200):
        item = int(rng.integers(0, 50))
        true[item] = true.get(item, 0) + 1
        counts_j, _ = jsk.update_sketch(counts_j, _j(np.int32([item])),
                                        _j([True]))
        counts_t, _ = tsk.update_sketch(counts_t, _t(np.int32([item])),
                                        _t([True]))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    items = np.asarray(sorted(true), np.int32)
    est = tsk._estimates(counts_t, tsk._bucket_idx(counts_t, _t(items)))
    for i, item in enumerate(sorted(true)):
        assert int(est[i]) >= true[item]


@pytest.mark.parametrize("impl", sorted(jsk.SKETCH_IMPLS))
def test_sketch_impls_identical(impl):
    """The port's one form equals each of the reference's A/B forms."""
    assert list(tsk.SKETCH_IMPLS) == ["scatter"]
    rng = np.random.default_rng(9)
    items = rng.integers(0, 1 << 16, size=64).astype(np.int32)
    valid = rng.random(64) < 0.9
    cj, ct = jsk.init_sketch(4, 10), tsk.init_sketch(4, 10)
    for _ in range(3):
        cj, _ = jsk.update_sketch(cj, _j(items), _j(valid), impl=impl)
        ct, _ = tsk.update_sketch(ct, _t(items), _t(valid))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_sketch_invalid_lanes_are_noops():
    counts = tsk.init_sketch(2, 6)
    counts, _ = tsk.update_sketch(counts, _t(np.int32([5, 7])),
                                  _t([False, False]))
    assert int(counts.max()) == 0


def test_sketch_dead_lanes_spread_off_their_buckets():
    """Padding lanes all hash from the pad row to the same SR buckets;
    they write nothing there (target 0 under max) and the table equals
    one updated with the live lanes alone, and the reference's."""
    rng = np.random.default_rng(21)
    live = rng.integers(1, 4096, 300).astype(np.int32)
    pad = np.full(2048 - 300, 4096, np.int32)          # the pad row R
    items = np.concatenate([live, pad])
    valid = np.arange(2048) < 300
    base = rng.integers(0, 50, (4, 1 << 12)).astype(np.int32)
    got, _ = tsk.update_sketch(_t(base), _t(items), _t(valid))
    alone, _ = tsk.update_sketch(_t(base), _t(live), _t(np.ones(300, bool)))
    want, _ = jsk.update_sketch(_j(base), _j(items), _j(valid))
    np.testing.assert_array_equal(got.numpy(), alone.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the pad row's own buckets are untouched by the dead lanes
    idx = tsk._bucket_idx(_t(base), _t(np.int32([4096]))).numpy()[:, 0]
    touched = set(tsk._bucket_idx(_t(base), _t(live)).numpy()[0].tolist())
    if idx[0] not in touched:
        assert int(got[0, idx[0]]) == int(base[0, idx[0]])


def test_sketch_decay_and_halve():
    counts = torch.full((2, 16), 800, dtype=torch.int32)
    dec = tsk.decay_sketch(counts)
    np.testing.assert_array_equal(dec.numpy(), 800 - (800 >> tsk.DECAY_SHIFT))
    np.testing.assert_array_equal(tsk.halve_sketch(counts).numpy(), 400)
    z = torch.zeros((2, 16), dtype=torch.int32)
    assert int(tsk.decay_sketch(z).max()) == 0
    rng = np.random.default_rng(5)
    c = rng.integers(-(1 << 31), (1 << 31) - 1, (2, 64)).astype(np.int32)
    np.testing.assert_array_equal(tsk.decay_sketch(_t(c)).numpy(),
                                  np.asarray(jsk.decay_sketch(_j(c))))
    np.testing.assert_array_equal(tsk.halve_sketch(_t(c)).numpy(),
                                  np.asarray(jsk.halve_sketch(_j(c))))


def test_sketch_overflow_flag():
    counts = torch.full((2, 16), tsk.OVERFLOW_CAP - 1, dtype=torch.int32)
    _, overflow = tsk.update_sketch(counts, _t(np.int32([3])), _t([True]))
    assert bool(overflow)
    counts = torch.zeros((2, 16), dtype=torch.int32)
    _, overflow = tsk.update_sketch(counts, _t(np.int32([3])), _t([True]))
    assert not bool(overflow)


def test_sketch_inline_halve_at_cap():
    counts = np.full((2, 16), jsk.OVERFLOW_CAP - 1, np.int32)
    out, overflow = tsk.update_sketch(_t(counts), _t(np.int32([3])),
                                      _t([True]))
    ref, _ = jsk.update_sketch(_j(counts), _j(np.int32([3])), _j([True]))
    assert bool(overflow)
    assert int(out.max()) <= tsk.OVERFLOW_CAP // 2
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sketch_decay_reaches_zero():
    counts = torch.full((1, 4), 7, dtype=torch.int32)
    for _ in range(7):
        counts = tsk.decay_sketch(counts)
    assert int(counts.max()) == 0 and int(counts.min()) == 0


# ---------------------------------------------------------------------------
# cold-entry reload replay: both packages' numpy copies vs the settles
# ---------------------------------------------------------------------------

def _entry_from_row(mod, counters, stamps, rt_sum, min_rt, occ_cnt, occ_win):
    z = np.zeros(0, np.int32)
    return mod.ColdEntry(
        sec_counters=counters.copy(), sec_stamps=stamps.copy(),
        sec_rt_sum=rt_sum.copy(), sec_min_rt=min_rt.copy(),
        min_counters=z.reshape(0, 0, 0).astype(np.int32),
        min_stamps=z, min_rt_sum=z.astype(np.float32), min_min_rt=z,
        threads=0, occ_cnt=occ_cnt.copy(), occ_win=occ_win.copy())


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_settle_entry_np_matches_device_settle(seed):
    """The port's settle_entry_np equals the reference's and the port's
    own (torch) settle_occupied for one row across landed-live,
    landed-dead, pending and expired bookings."""
    B = 4
    spec = twin_mod.WindowSpec(buckets=B, win_ms=500, track_rt=True)
    rng = np.random.default_rng(seed)
    now = 3_570_000 + int(rng.integers(0, 100))
    counters = rng.integers(0, 50, size=(1, B, ev.NUM_EVENTS)).astype(
        np.int32)
    stamps = np.empty((1, B), np.int32)
    for k in range(B):
        stamps[0, k] = rng.choice(
            [now - rng.integers(0, B), now - 2 * B, NEVER])
    rt_sum = rng.random((1, B)).astype(np.float32) * 100
    min_rt = rng.integers(1, 1000, size=(1, B)).astype(np.int32)
    occ_win = (now + rng.integers(-2 * B, 2, size=(1, B + 1))).astype(
        np.int32)
    occ_cnt = rng.integers(0, 4, size=(1, B + 1)).astype(np.float32)

    state = twin_mod.WindowState(_t(counters), _t(stamps), _t(rt_sum),
                                 _t(min_rt))
    dev_state, dev_pc, dev_pw = twin_mod.settle_occupied(
        spec, state, _t(occ_cnt), _t(occ_win), now, ev.PASS)
    entries = {}
    for name, mod in (("jax", jcold), ("torch", tcold)):
        e = _entry_from_row(mod, counters[0], stamps[0], rt_sum[0],
                            min_rt[0], occ_cnt[0], occ_win[0])
        mod.settle_entry_np(B, e, now, ev.PASS)
        entries[name] = e
    e = entries["torch"]
    for field in ("sec_counters", "sec_stamps", "sec_rt_sum", "sec_min_rt",
                  "occ_cnt", "occ_win"):
        np.testing.assert_array_equal(getattr(e, field),
                                      getattr(entries["jax"], field))
    np.testing.assert_array_equal(e.sec_counters, dev_state.counters[0])
    np.testing.assert_array_equal(e.sec_stamps, dev_state.stamps[0])
    np.testing.assert_array_equal(e.sec_rt_sum, dev_state.rt_sum[0])
    np.testing.assert_array_equal(e.sec_min_rt, dev_state.min_rt[0])
    np.testing.assert_array_equal(e.occ_cnt, dev_pc[0])
    np.testing.assert_array_equal(e.occ_win, dev_pw[0])


def test_settle_entry_np_dead_bucket_reset():
    B = 2
    now = 1000
    e = _entry_from_row(
        tcold, np.full((B, ev.NUM_EVENTS), 7, np.int32),
        np.asarray([now - 2 * B, now - 2 * B], np.int32),
        np.asarray([5.0, 5.0], np.float32), np.asarray([9, 9], np.int32),
        np.asarray([3.0, 0.0, 0.0], np.float32),
        np.asarray([now, NEVER, NEVER], np.int32))
    tcold.settle_entry_np(B, e, now, ev.PASS)
    k = now % B
    assert e.sec_stamps[k] == now
    assert e.sec_counters[k, ev.PASS] == 3
    assert e.sec_counters[k, ev.BLOCK] == 0
    assert e.sec_rt_sum[k] == 0.0
    assert e.sec_min_rt[k] == INT32_MAX
    assert e.sec_counters[1 - k, ev.PASS] == 7
    assert not e.occ_cnt.any()


# ---------------------------------------------------------------------------
# registry: targeted eviction + cross-family pin refcounts
# ---------------------------------------------------------------------------

def test_registry_evict_name():
    out = {}
    for name, cls in (("jax", JRegistry), ("torch", TRegistry)):
        reg = cls(8, reserved=("E",))
        ra, rb = reg.get_or_create("a"), reg.get_or_create("b")
        reg.pin("a")
        got = [reg.evict_name("a"), reg.evict_name("ghost"),
               reg.evict_name("b"), reg.lookup("b"), rb in reg.drain_evicted(),
               reg.get_or_create("c") == rb]
        reg.unpin("a")
        got += [reg.evict_name("a"), ra in reg.drain_evicted(), ra, rb]
        out[name] = got
    assert out["torch"] == out["jax"]
    assert out["torch"][:8] == [False, False, True, None, True, True, True,
                                True]


def _make(pkg, clk, **cfg):
    extra = {"device": "cpu"} if pkg is stt else {}
    sph = pkg.Sentinel(pkg.load_config(**cfg), clock=clk, **extra)
    sph._cpu.sample = lambda: (0.5, 0.25)
    return sph


SMALL = dict(max_resources=32, max_flow_rules=8, max_degrade_rules=8,
             max_authority_rules=8)


def _counters(sph) -> dict:
    return sph.obs.counters.snapshot()


def _tier_view(sph) -> dict:
    snap = dict(sph.tiering.snapshot())
    for k in ("migrate_p50_ms", "migrate_p99_ms"):     # wall-clock times
        snap[k] = snap[k] is not None
    return snap


def _cold_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for name in a:
        assert sorted(a[name]) == sorted(b[name]), name
        for leaf in a[name]:
            x, y = a[name][leaf], b[name][leaf]
            assert x.dtype == y.dtype and x.shape == y.shape, (name, leaf)
            np.testing.assert_array_equal(x, y, err_msg=f"{name}.{leaf}")


def twin(scenario, **cfg):
    """``scenario(pkg, sph, clk)`` on twin runtimes (tiering on) → the
    port's observations; observations, counters, tiering snapshots,
    engine state with the sketch, and cold tiers must agree."""
    got, views = {}, {}
    for name, pkg in PKGS.items():
        clk = pkg.ManualClock(start_ms=T0)
        sph = _make(pkg, clk, **cfg)
        try:
            got[name] = scenario(pkg, sph, clk)
            views[name] = (_counters(sph), _tier_view(sph),
                           convert.engine_to_numpy(sph),
                           convert.cold_tier_to_numpy(sph.tiering.cold))
        finally:
            sph.close()
    assert got["torch"] == got["jax"]
    j, t = views["jax"], views["torch"]
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert convert.SKETCH_LEAF in t[2] or not t[1]["enabled"]
    assert convert.leaf_diff(j[2], t[2]) == []
    assert set(t[2]) == set(j[2])
    _cold_equal(j[3], t[3])
    return got["torch"]


def test_rule_pins_are_refcounted_across_families():
    def scenario(pkg, s, clk):
        out = []
        s.load_flow_rules([pkg.FlowRule(resource="k", count=10.0)])
        s.load_degrade_rules([pkg.DegradeRule(
            resource="k", grade=pkg.GRADE_RT, count=50.0, time_window=5)])
        out.append(s.resources.evict_name("k"))
        s.load_flow_rules([])
        out.append(s.resources.evict_name("k"))
        s.load_degrade_rules([])
        out.append(s.resources.evict_name("k"))
        return out

    assert twin(scenario, max_resources=16, max_flow_rules=8,
                max_degrade_rules=8, max_authority_rules=8) == [
        False, False, True]


# ---------------------------------------------------------------------------
# cold tier store
# ---------------------------------------------------------------------------

def _dummy_entry():
    return _entry_from_row(
        tcold, np.zeros((2, ev.NUM_EVENTS), np.int32),
        np.full(2, NEVER, np.int32), np.zeros(2, np.float32),
        np.full(2, INT32_MAX, np.int32),
        np.zeros(3, np.float32), np.full(3, NEVER, np.int32))


def test_cold_tier_lru_bound():
    tier = tcold.ColdTier(max_entries=2)
    for n in ("a", "b", "c"):
        tier.put(n, _dummy_entry())
    assert len(tier) == 2 and tier.dropped == 1
    assert "a" not in tier and tier.pop("a") is None
    assert tier.pop("c") is not None
    assert tier.names() == ["b"]
    tier = tcold.ColdTier(None)
    for i in range(64):
        tier.put(f"n{i}", _dummy_entry())
    assert len(tier) == 64 and tier.dropped == 0


def test_cold_tier_geometry_reset_matches_reference():
    rng = np.random.default_rng(8)
    entries = []
    for mod in (jcold, tcold):
        e = _entry_from_row(
            mod, rng.integers(0, 9, (2, ev.NUM_EVENTS)).astype(np.int32),
            np.asarray([5, 6], np.int32), np.ones(2, np.float32),
            np.asarray([3, 4], np.int32), np.ones(3, np.float32),
            np.asarray([5, 6, 7], np.int32))
        e.alts[(0, 3)] = (np.ones((2, ev.NUM_EVENTS), np.int32),
                          np.zeros(2, np.int32), np.zeros(2, np.float32),
                          np.zeros(2, np.int32), 4)
        e.reload_gen = 2
        mod.reset_entry_geometry_np(e, 4)
        entries.append(e)
    for field in ("sec_counters", "sec_stamps", "sec_rt_sum", "sec_min_rt",
                  "occ_cnt", "occ_win", "reload_gen"):
        np.testing.assert_array_equal(getattr(entries[1], field),
                                      getattr(entries[0], field))
    for a, b in zip(entries[1].alts[(0, 3)], entries[0].alts[(0, 3)]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# row slices: extract / restore against the reference's
# ---------------------------------------------------------------------------

def _random_state(seed, R=64, RA=128, hb=8):
    spec_t = tpl.EngineSpec(rows=R, alt_rows=RA,
                            second=twin_mod.WindowSpec(2, 500),
                            minute=twin_mod.MINUTE_SPEC,
                            statistic_max_rt=5000, hist_buckets=hb)
    st = tpl.init_state(spec_t, 8, 4)
    d = convert.to_numpy(st)
    rng = np.random.default_rng(seed)
    for k, a in d.items():
        if a.dtype == np.int32:
            d[k] = rng.integers(-50, 5000, a.shape).astype(np.int32)
        elif a.dtype == np.float32:
            d[k] = (rng.random(a.shape) * 100).astype(np.float32)
    spec_j = jpl.EngineSpec(rows=R, alt_rows=RA,
                            second=jwin.WindowSpec(2, 500),
                            minute=jwin.MINUTE_SPEC, statistic_max_rt=5000,
                            hist_buckets=hb)
    js = jax.tree_util.tree_map(jnp.asarray, jpl.init_state(spec_j, 8, 4))
    leaves = convert.to_numpy(js)
    assert set(leaves) == set(d)
    jstate = _jax_state_from(js, d)
    return spec_j, jstate, spec_t, convert.state_from_numpy(d)


def _jax_state_from(js, d, prefix=""):
    if isinstance(js, tuple) and hasattr(js, "_fields"):
        return type(js)(**{f: _jax_state_from(getattr(js, f), d,
                                              prefix + f + ".")
                           for f in js._fields})
    if isinstance(js, tuple):
        return tuple(_jax_state_from(x, d, f"{prefix}{i}.")
                     for i, x in enumerate(js))
    if js is None:
        return None
    return jnp.asarray(d[prefix[:-1]])


def test_extract_resource_rows_matches_reference():
    spec_j, js, spec_t, ts = _random_state(31)
    rows = np.asarray([3, 9, 63, 64, 70, -1], np.int32)     # pads, wrap
    alt = np.asarray([0, 127, 128, 5], np.int32)
    want = convert.to_numpy(jpl.extract_resource_rows(
        spec_j, js, _j(rows), _j(alt)))
    got_p = tpl.extract_resource_rows(spec_t, ts, _t(rows), _t(alt))
    got = convert.to_numpy(got_p)
    assert convert.leaf_diff(want, got) == [] and set(got) == set(want)
    # fresh tensors: the invalidate that follows is not read back
    before = got_p.second.counters.clone()
    tpl.invalidate_resource_rows(spec_t, ts, _t(rows), _t(alt))
    ts.second.counters.zero_()
    assert torch.equal(got_p.second.counters, before)


def test_restore_round_trip_and_duplicate_alt_rows():
    """A restore with repeated main and alt rows (two promoted keys'
    re-hashed alt slots colliding, and pads that drop) equals the
    reference's on the CPU, where the last lane wins."""
    spec_j, js, spec_t, ts = _random_state(32)
    src_rows = np.asarray([1, 2, 3, 4], np.int32)
    src_alt = np.asarray([10, 11, 12, 13, 14, 15, 16, 17], np.int32)
    payload_j = jpl.extract_resource_rows(spec_j, js, _j(src_rows),
                                          _j(src_alt))
    payload_t = tpl.extract_resource_rows(spec_t, ts, _t(src_rows),
                                          _t(src_alt))
    dst_rows = np.asarray([40, 41, 40, 64], np.int32)      # dup + pad
    dst_alt = np.asarray([90, 91, 90, 92, 91, 128, 93, 90], np.int32)
    want = jax.jit(jpl.restore_resource_rows, static_argnums=0)(
        spec_j, js, _j(dst_rows), payload_j, _j(dst_alt))
    got = tpl.restore_resource_rows(spec_t, ts, _t(dst_rows), payload_t,
                                    _t(dst_alt))
    assert convert.leaf_diff(convert.to_numpy(want),
                             convert.to_numpy(got)) == []
    # the last lane's slice won the collided slot 90 (lane 7 ← src 17)
    np.testing.assert_array_equal(
        got.alt_second.counters[90].numpy(),
        payload_t.alt_second.counters[7].numpy())


def test_row_writer_without_a_kept_lane_changes_nothing():
    dest = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    before = dest.clone()
    w = twin_mod.RowWriter(_t(np.int32([4, 9, -7])), 4)
    w.write(dest, torch.full((3, 3), -1, dtype=torch.int32))
    assert torch.equal(dest, before)


def test_shard_of_rows_is_one_shard():
    """One shard without a mesh; on a row-block mesh, the reference's
    owner per row for the same geometry; a mesh without a ``"rows"``
    axis and one over several processes raise as ``Sentinel(mesh=)``
    does."""
    from sentinel_tpu.parallel import local_shard as jls
    from sentinel_tpu_torch.multihost.bootstrap import ShardDevice
    from sentinel_tpu_torch.multihost.mesh import GlobalMesh
    rows = np.asarray([0, 5, 1 << 17, 1 << 19, (1 << 20) - 1], np.int32)
    np.testing.assert_array_equal(
        local_shard.shard_of_rows(1 << 20, None, rows), [0] * 5)
    mesh = local_shard.local_mesh(devices=[torch.device("cpu")] * 8)
    got = local_shard.shard_of_rows(1 << 20, mesh, rows)
    np.testing.assert_array_equal(got, [0, 0, 1, 4, 7])
    np.testing.assert_array_equal(
        got, jls.shard_of_rows(1 << 20, jls.local_mesh(8), rows))
    assert got.dtype == np.int32
    with pytest.raises(ValueError, match="rows"):
        local_shard.shard_of_rows(1 << 20, object(), rows)
    two = GlobalMesh([ShardDevice(p, 0, "cpu") for p in (0, 1)], "rows")
    # a spanning mesh in a process without the process group: named
    with pytest.raises(RuntimeError, match="process group"):
        local_shard.shard_of_rows(1 << 20, two, rows)


def test_proactive_demotions_round_robin_across_shards():
    """The ticker's demotions on a meshed engine take the coldest row of
    each shard in turn (the reference's round-robin): the JAX engine on
    its 8-device mesh and the port on 8 row blocks demote the same
    names, and their cold tiers, tier views and state agree; on one
    device the same estimates demote the globally coldest instead."""
    from sentinel_tpu.parallel import local_shard as jls
    got = {}
    for kind in ("jax", "torch", "jax1", "torch1"):
        pkg = PKGS[kind.rstrip("1")]
        clk = pkg.ManualClock(start_ms=T0)
        cfg = pkg.load_config(max_resources=64, max_flow_rules=8,
                              max_degrade_rules=8, max_authority_rules=8)
        if kind == "jax":
            mesh = {"mesh": jls.local_mesh(8)}
        elif kind == "torch":
            mesh = {"mesh": local_shard.local_mesh(
                devices=[torch.device("cpu")] * 8)}
        else:
            mesh = {"device": "cpu"} if pkg is stt else {}
        s = pkg.Sentinel(cfg, clock=clk, **mesh)
        s._cpu.sample = lambda: (0.5, 0.25)
        try:
            names = [f"k{i}" for i in range(40)]
            s.entry_batch(names, acquire=[1] * 40)
            rows = [s.resources.lookup(n) for n in names]
            est = np.zeros(s.spec.rows, np.int32)
            rng = np.random.default_rng(4)
            est[rows] = rng.permutation(40) + 1
            s.tiering.hot_rows = 40 + 1 - 12        # 12 demotions
            s.tiering._demote_cold_rows(est)
            s.entry_batch(["k0"], acquire=[1])      # the drain demotes
            s.tiering.poll()
            demoted = sorted(s.tiering.cold.names())
            shards = sorted(int(r) // 8 for r in
                            (rows[names.index(n)] for n in demoted))
            got[kind] = (demoted, shards, _tier_view(s),
                         convert.engine_to_numpy(s),
                         convert.cold_tier_to_numpy(s.tiering.cold))
        finally:
            s.close()
    for a, b in (("jax", "torch"), ("jax1", "torch1")):
        assert got[a][:3] == got[b][:3], (a, b)
        assert convert.leaf_diff(got[a][3], got[b][3]) == []
        _cold_equal(got[a][4], got[b][4])
    assert len(got["torch"][0]) == 12
    # round-robin: the names sit in rows 1..40, so shards 0-4 hold 7-8
    # candidates and shard 5 one; the full shards give up rows in turn
    counts = np.bincount(got["torch"][1], minlength=8)
    assert counts[5] == 1 and counts[6:].sum() == 0
    assert counts[:5].max() - counts[:5].min() <= 1
    assert got["torch"][0] != got["torch1"][0]


# ---------------------------------------------------------------------------
# lifecycle counters: first-sight neither, hit, demote → cold → promote
# ---------------------------------------------------------------------------

def test_lifecycle_counters_and_hit_rate():
    def scenario(pkg, s, clk):
        t = s.tiering
        out = [t.enabled]
        names = [f"r{i}" for i in range(6)]
        s.entry_batch(names, acquire=[1] * 6)
        snap = t.snapshot()
        out += [snap["hot_hit"], snap["cold_miss"], t.hit_rate()]
        s.entry_batch(names, acquire=[1] * 6)
        snap = t.snapshot()
        out += [snap["hot_hit"], snap["cold_miss"], t.hit_rate()]
        out.append(s.resources.evict_name("r0"))
        s.entry_batch(["r1"], acquire=[1])
        out.append(t.snapshot()["demoted"])
        t.poll()
        out.append("r0" in t.cold)
        s.entry_batch(["r0"], acquire=[1])
        snap = t.snapshot()
        out += [snap["cold_miss"], snap["promoted"], "r0" in t.cold,
                snap["migrate_p50_ms"] is not None]
        return out

    assert twin(scenario, **SMALL) == [
        True, 0, 0, None, 6, 0, 1.0, True, 1, True, 1, 1, False, True]


def test_tiering_disable_env(monkeypatch):
    monkeypatch.setenv("SENTINEL_TIERING_DISABLE", "1")

    def scenario(pkg, s, clk):
        out = [s.tiering.enabled]
        s.tiering.start()
        out.append(s.tiering._thread is None)
        with s.entry("a"):
            pass
        snap = s.tiering.snapshot()
        return out + [snap["enabled"], snap["demoted"], snap["promoted"]]

    assert twin(scenario, **SMALL) == [False, True, False, 0, 0]


# ---------------------------------------------------------------------------
# the load-bearing property: tiered == all-resident, bit for bit
# ---------------------------------------------------------------------------

def _run_engine(pkg, capacity, steps, batch, keys, rules, reload_rules,
                seed, origins=None, geometry_step=None):
    """Seeded churn traffic against one engine → (verdict triples,
    tiering view, engine leaves with the sketch, cold tier, counters).
    The reload fires mid-run; ~25% of requests are prioritized so occupy
    bookings ride through demote/promote."""
    clk = pkg.ManualClock(start_ms=T0)
    s = _make(pkg, clk, max_resources=capacity, max_flow_rules=16,
              max_degrade_rules=16, max_authority_rules=16,
              host_fast_path=False)
    try:
        s.load_flow_rules([pkg.FlowRule(**r) for r in rules])
        rng = np.random.default_rng(seed)
        verdicts = []
        for step in range(steps):
            if step == steps // 2:
                s.load_flow_rules([pkg.FlowRule(**r) for r in reload_rules])
            if geometry_step is not None and step == geometry_step:
                s.update_window_geometry(sample_count=4)
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
        return (verdicts, _tier_view(s), convert.engine_to_numpy(s),
                convert.cold_tier_to_numpy(s.tiering.cold), _counters(s))
    finally:
        s.close()


def _check_churn(cap_small, cap_big, *args, **kw):
    """Port small == reference small (everything); port small == port
    resident (verdicts); the run really churned."""
    small_j = _run_engine(stpu, cap_small, *args, **kw)
    small = _run_engine(stt, cap_small, *args, **kw)
    big = _run_engine(stt, cap_big, *args, **kw)
    assert small[0] == small_j[0]
    assert small[1] == small_j[1]
    assert convert.leaf_diff(small_j[2], small[2]) == []
    _cold_equal(small_j[3], small[3])
    assert small[4] == small_j[4]
    assert small[0] == big[0]
    blocked = sum(a.count(False) for a, _r, _w in small[0])
    assert blocked > 0
    assert small[1]["demoted"] > 0 and small[1]["promoted"] > 0
    assert big[1]["demoted"] == 0
    assert small[1]["migrate_p50_ms"]
    return small


RULED = [f"zk{i}" for i in range(8)]
KEYS = [f"zk{i}" for i in range(48)]
RULES = [dict(resource=r, count=3.0) for r in RULED]
RELOAD = ([dict(resource=r, count=3.0) for r in RULED[:4]]
          + [dict(resource=f"zk{i}", count=2.0) for i in range(8, 12)])


@pytest.mark.parametrize("seed", [1501, 2026])
def test_parity_fuzz_small_vs_resident(seed):
    """A 24-row tiered engine equals the reference's twin (verdicts,
    state, sketch, cold tier, counters) and a 512-row all-resident port
    engine (verdicts) under flow rules, prioritized acquires and a
    mid-run reload, while demoting and promoting."""
    _check_churn(24, 512, 32, 12, KEYS, RULES, RELOAD, seed)


def test_parity_fuzz_on_row_blocks(monkeypatch):
    """The churn fuzz with origins on row-block engines: the port's 8
    blocks against the JAX engine on its 8-device mesh (verdicts, state,
    sketch, cold tier, counters) and against the port's 8-block
    all-resident engine (verdicts). Demotion gathers and promotion
    restores go through each row's owner."""
    from sentinel_tpu.parallel import local_shard as jls
    plain = _make

    def meshed(pkg, clk, **cfg):
        mesh = (jls.local_mesh(8) if pkg is stpu
                else local_shard.local_mesh(devices=[torch.device("cpu")]
                                            * 8))
        sph = pkg.Sentinel(pkg.load_config(**cfg), clock=clk, mesh=mesh)
        sph._cpu.sample = lambda: (0.5, 0.25)
        return sph

    monkeypatch.setattr(sys.modules[__name__], "_make", meshed)
    try:
        small = _check_churn(24, 512, 32, 12, KEYS, RULES, RELOAD, 1501,
                             origins=["app-a", "app-b"])
    finally:
        monkeypatch.setattr(sys.modules[__name__], "_make", plain)
    assert small[2]["second.counters"].shape[0] == 24


def test_parity_alt_rows_carry_through_churn():
    ruled = [f"ak{i}" for i in range(6)]
    keys = [f"ak{i}" for i in range(24)]
    rules = [dict(resource=r, count=3.0, limit_app="app-a") for r in ruled]
    reload_rules = [dict(resource=r, count=2.0, limit_app="app-a")
                    for r in ruled[:4]]
    _check_churn(16, 256, 24, 8, keys, rules, reload_rules, 711,
                 origins=["app-a", "app-b"])


def test_parity_through_geometry_change():
    ruled = [f"gk{i}" for i in range(8)]
    keys = [f"gk{i}" for i in range(48)]
    rules = [dict(resource=r, count=3.0) for r in ruled]
    reload_rules = ([dict(resource=r, count=3.0) for r in ruled[:4]]
                    + [dict(resource=f"gk{i}", count=2.0)
                       for i in range(8, 12)])
    _check_churn(24, 512, 32, 12, keys, rules, reload_rules, 77,
                 geometry_step=20)


# ---------------------------------------------------------------------------
# geometry change vs the cold tier, force-land race, demote rollback
# ---------------------------------------------------------------------------

def test_geometry_change_converts_cold_entries():
    def scenario(pkg, s, clk):
        t = s.tiering
        out = []
        s.entry_batch(["a", "b"], acquire=[1, 1])
        out.append(s.resources.evict_name("a"))
        s.entry_batch(["x"], acquire=[1])
        t._land_all()
        out.append("a" in t.cold)
        out.append(s.resources.evict_name("b"))
        s.entry_batch(["x"], acquire=[1])
        out.append("b" in t._pending_land)
        s.update_window_geometry(sample_count=4)
        B = s.spec.second.buckets
        e = t.cold._entries["a"]
        out += [B, "a" in t.cold, "b" in t.cold, e.sec_counters.shape[0],
                e.occ_cnt.shape[0], bool(t._pending_land),
                bool(t._land_q)]
        v = s.entry_batch(["a", "b"], acquire=[1, 1])
        out += [bool(np.asarray(v.allow).all()),
                t.snapshot()["promoted"], "a" in t.cold, "b" in t.cold]
        return out

    assert twin(scenario, **SMALL) == [
        True, True, True, True, 4, True, True, 4, 5, False, False, True, 2,
        False, False]


def test_promote_force_lands_dequeued_record():
    def scenario(pkg, s, clk):
        t = s.tiering
        out = []
        s.entry_batch(["k"], acquire=[1])
        out.append(s.resources.evict_name("k"))
        s.entry_batch(["x"], acquire=[1])
        with t._lock:
            rec = t._land_q.popleft()
        out.append(rec["landed"])
        s.entry_batch(["k"], acquire=[1])
        out += [t.snapshot()["promoted"], rec["landed"]]
        t._land_all()
        out.append("k" in t.cold)
        out.append(s.resources.evict_name("k"))
        s.entry_batch(["x"], acquire=[1])
        t._land_all()
        out.append(int(t.cold._entries["k"].sec_counters[:, ev.PASS].sum()))
        return out

    assert twin(scenario, **SMALL) == [True, False, 1, True, False, True, 2]


def test_proactive_demote_rolls_back_when_evict_refused():
    def scenario(pkg, s, clk):
        t = s.tiering
        s.entry_batch(["a", "b"], acquire=[1, 1])
        ra, rb = s.resources.lookup("a"), s.resources.lookup("b")
        s.resources.pin("a")
        t.hot_rows = 1
        est = np.zeros(s.spec.rows, np.int32)
        est[rb] = 5
        t._demote_cold_rows(est)
        with t._lock:
            return [t._shadow.get(ra), ra in t._pending_demote,
                    t._pending_demote.get(rb), rb in t._shadow]

    assert twin(scenario, max_resources=16, max_flow_rules=8,
                max_degrade_rules=8, max_authority_rules=8) == [
        "a", False, "b", False]


def test_default_runtime_constructs_tiered_and_single_dispatch(monkeypatch):
    """``stt.Sentinel(stt.load_config())`` constructs with tiering and
    single dispatch on, as the reference does."""
    monkeypatch.delenv("SENTINEL_SINGLE_DISPATCH", raising=False)
    sph = stt.Sentinel(stt.load_config(), device="cpu")
    try:
        assert sph.tiering.enabled and sph._single_dispatch
        assert tuple(sph.tiering._sketch.shape) == (4, 4096)
        assert sph.obs.counters.get(ck.TIER_DEMOTED) == 0
    finally:
        sph.close()
