"""Port parity: hot-parameter flow control of ``sentinel_tpu_torch``
against ``sentinel_tpu``: the rule compiler, the host key registry, pair
resolution, the device checks (sorted and rank forms), the key-state
helpers, fused engine steps with param rules on every route, and twin
runtimes running the reference's scenarios (``tests/test_param_flow.py``,
``tests/test_param_scalar.py``, ``tests/test_param_vector.py``).

Every input is made from a numpy seed and handed to both packages; the
comparisons are exact (verdicts, exceptions, key rows, every state leaf).
Range of the float32 math: token buckets, thresholds and acquires are
below 2^12 (fractional buckets included), times are int32 ms: every
float32 sum and product of the checks is exact (below 2^24), so the
summation order and a contracted ``a*b+c`` cannot change a bit.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.core.clock import ManualClock
from sentinel_tpu.engine import pipeline as jp
from sentinel_tpu.rules import param_flow as jpf
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.engine import pipeline as tp
from sentinel_tpu_torch.ops import scatter_add as sa
from sentinel_tpu_torch.rules import param_flow as tpf

from test_torch_engine import _port_spec
from test_torch_occupy import PKGS, ROUTE_KEYS

torch.set_num_threads(2)

T0 = 1_785_000_000_000
NEVER = -(2 ** 30)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_rule(r):
    """The port's ParamFlowRule with the JAX rule's fields."""
    kw = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    kw["param_flow_item_list"] = [
        tpf.ParamFlowItem(i.object, i.count, i.class_type)
        for i in r.param_flow_item_list]
    return tpf.ParamFlowRule(**kw)


class _Reg:
    """A resource registry stub: each name its own row."""

    def __init__(self):
        self.rows = {}

    def pin(self, name):
        return self.rows.setdefault(name, 3 + 2 * len(self.rows))


def _compile_both(rules, cap=16, k=4):
    jc = jpf.compile_param_rules(rules, resource_registry=_Reg(),
                                 capacity=cap, k_per_resource=k)
    tc = tpf.compile_param_rules([_port_rule(r) for r in rules],
                                 resource_registry=_Reg(), capacity=cap,
                                 k_per_resource=k)
    return jc, tc


def _same(want_tree, got_tree, tag):
    assert convert.leaf_diff(convert.to_numpy(want_tree),
                             convert.to_numpy(got_tree)) == [], tag


RULES = [
    jpf.ParamFlowRule(resource="hot", param_idx=0, count=5),
    jpf.ParamFlowRule(resource="hot", param_idx=1, count=3, burst_count=2),
    jpf.ParamFlowRule(resource="hot", param_idx=0, count=10,
                      control_behavior=jpf.BEHAVIOR_RATE_LIMITER,
                      max_queueing_time_ms=200),
    jpf.ParamFlowRule(resource="hot", param_idx=0, count=4,
                      grade=jpf.GRADE_THREAD),
    jpf.ParamFlowRule(resource="b", param_idx=2, count=0),     # zero count
    jpf.ParamFlowRule(resource="b", param_idx=0, count=1e9,    # cost 0
                      control_behavior=jpf.BEHAVIOR_RATE_LIMITER,
                      max_queueing_time_ms=100),
    jpf.ParamFlowRule(resource="b", param_idx=-1, count=7, duration_in_sec=2,
                      param_flow_item_list=[jpf.ParamFlowItem("vip", 20),
                                            jpf.ParamFlowItem(9, 0)]),
    jpf.ParamFlowRule(resource="c", param_idx=1, count=3,
                      control_behavior=jpf.BEHAVIOR_RATE_LIMITER),  # maxq 0
    jpf.ParamFlowRule(resource="c", param_idx=0, count=2.5, burst_count=1),
    jpf.ParamFlowRule(resource="bad", count=-1),               # invalid
    jpf.ParamFlowRule(resource="bad", duration_in_sec=0),      # invalid
]


# ---------------------------------------------------------------------------
# compiler
# ---------------------------------------------------------------------------

def test_compile_param_rules_matches():
    jc, tc = _compile_both(RULES)
    _same(jc.table, tc.table, "table")
    assert tc.by_row == jc.by_row and tc.num_active == jc.num_active == 9
    np.testing.assert_array_equal(tc.thread_slot_mask, jc.thread_slot_mask)
    assert jc.vector_meta is None and tc.vector_meta is None
    # one rule per resource, index >= 0, no overrides: the reference's
    # vector form, as the port's one-column tables in sorted order
    one = [jpf.ParamFlowRule(resource=f"r{i}", param_idx=i % 3,
                             count=float(i)) for i in range(5)]
    jc, tc = _compile_both(one)
    for a, b in zip(jc.vector_meta, tc.vector_meta):
        np.testing.assert_array_equal(b[:, 0], a)
        assert b.shape[1] == 1
    assert tc.vector_meta.sorted_order and tc.vector_meta.hot_keys.size == 0
    assert tc.table.count.dtype == torch.float32
    # loud overflow, like the reference's compiler
    for kw in (dict(cap=4), dict(k=1)):
        with pytest.raises(ValueError):
            _compile_both(RULES, **kw)


# ---------------------------------------------------------------------------
# host key registry
# ---------------------------------------------------------------------------

class _Key:
    def __init__(self, k):
        self.k = k

    def param_flow_key(self):
        return self.k


def _run_registry(reg, ops):
    out = []
    for op in ops:
        kind = op[0]
        try:
            if kind == "one":
                out.append(reg.get_or_create(op[1], op[2], override=op[3]))
            elif kind == "batch":
                out.append(reg.get_or_create_batch(op[1]))
            elif kind == "pin":
                reg.pin_rows(op[1])
            elif kind == "unpin":
                reg.unpin_rows(op[1])
            else:
                out.append(reg.drain_updates())
        except RuntimeError as exc:
            out.append(("raised", str(exc)))
        out.append((len(reg), reg.live_pin_count()))
    return out


def test_registry_matches_reference():
    """Row order, LRU eviction (pinned rows skipped), pins and unpins with
    multiplicity, overrides queued at creation and cancelled at eviction,
    and the drain, against the JAX package's Python registry."""
    rng = np.random.default_rng(5)
    cap = 16
    values = [f"u{i}" for i in range(24)] + list(range(12)) + [
        _Key("u3"), (1, 2), 2.0]
    ops = []
    for _ in range(600):
        r = rng.random()
        slot = int(rng.integers(0, 3))
        v = values[int(rng.integers(0, len(values)))]
        ov = int(rng.integers(0, 9)) if rng.random() < 0.2 else None
        if r < 0.45:
            ops.append(("one", slot, v, ov))
        elif r < 0.6:
            ops.append(("batch", [
                (int(rng.integers(0, 3)), jpf._key_form(
                    values[int(rng.integers(0, len(values)))]), ov)
                for _ in range(int(rng.integers(1, 9)))]))
        elif r < 0.75:
            rows = rng.integers(0, cap + 2, int(rng.integers(1, 5)))
            rows[rows >= cap] = 2 ** 31 - 1          # the no-op row
            ops.append(("pin", rows.astype(np.int32)))
        elif r < 0.9:
            ops.append(("unpin", rng.integers(0, cap, 3).astype(np.int32)))
        else:
            ops.append(("drain",))
    want = _run_registry(jpf.ParamKeyRegistry(cap), ops)
    got = _run_registry(tpf.ParamKeyRegistry(cap), ops)
    assert got == want
    drains = [x for x in want if isinstance(x, tuple) and len(x) == 2
              and isinstance(x[0], list)]
    assert any(ev for ev, _ in drains) and any(ov for _, ov in drains)


def test_registry_all_pinned_raises():
    for mod in (jpf, tpf):
        reg = mod.ParamKeyRegistry(2)
        rows = [reg.get_or_create(0, k) for k in ("a", "b")]
        reg.pin_rows(np.array(rows, np.int32))
        with pytest.raises(RuntimeError, match="param_table_slots"):
            reg.get_or_create(0, "c")


# ---------------------------------------------------------------------------
# pair resolution
# ---------------------------------------------------------------------------

def _resolve_rules():
    return [
        jpf.ParamFlowRule(resource="a", param_idx=0, count=5),
        jpf.ParamFlowRule(resource="a", param_idx=-1, count=3,
                          param_flow_item_list=[jpf.ParamFlowItem("vip", 9)]),
        jpf.ParamFlowRule(resource="a", param_idx=4, count=3,
                          grade=jpf.GRADE_THREAD),
        jpf.ParamFlowRule(resource="b", param_idx=-3, count=2),
    ]


ARGS = [("x",), ("x", "vip"), ("y", None, "z"), (["p", "q"], 7),
        ((1, 2),), (None,), (), (_Key("k1"), "k1"), ("a", 1, 2, 3, "t"),
        ({"h"}, frozenset({"i"})), ("solo",), (3, 4, 5)]


def _both_registries(cap=64):
    return jpf.ParamKeyRegistry(cap), tpf.ParamKeyRegistry(cap)


def test_resolve_pairs_matches():
    jc, tc = _compile_both(_resolve_rules())
    jr, tr = _both_registries()
    rows = sorted(jc.by_row) + [99]
    for i, args in enumerate(ARGS * 2):
        row = rows[i % len(rows)]
        want = jpf.resolve_pairs(jc, jr, row, args, 4)
        got = tpf.resolve_pairs(tc, tr, row, args, 4)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
            assert b.dtype == np.int32
    assert tr.drain_updates() == jr.drain_updates()
    # more pairs than PV raise in both
    for mod, c, r in ((jpf, jc, jr), (tpf, tc, tr)):
        with pytest.raises(ValueError, match="param_pairs_per_event"):
            mod.resolve_pairs(c, r, rows[0], (["a", "b", "c", "d"], 1), 4)
    # thread_key_rows: only THREAD-grade pairs pin
    pr, pk = tpf.resolve_pairs(tc, tr, rows[0], ("a", 1, 2, 3, "t"), 4)
    np.testing.assert_array_equal(tpf.thread_key_rows(tc, pr, pk),
                                  jpf.thread_key_rows(jc, pr, pk))


def test_resolve_pairs_many_matches():
    jc, tc = _compile_both(_resolve_rules())
    rng = np.random.default_rng(3)
    rows = np.array(sorted(jc.by_row) + [99], np.int32)
    ev_rows = rows[rng.integers(0, len(rows), 300)]
    args = [ARGS[i] for i in rng.integers(0, len(ARGS), 300)]
    jr, tr = _both_registries(256)
    want = jpf.resolve_pairs_many(jc, jr, ev_rows, args, 4)
    got = tpf.resolve_pairs_many(tc, tr, ev_rows, args, 4)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert tr.drain_updates() == jr.drain_updates()
    # an event past PV raises in both
    bad = args[:5] + [(["a", "b", "c", "d"], 1)]
    for mod, c, r in ((jpf, jc, jr), (tpf, tc, tr)):
        with pytest.raises(ValueError, match="param_pairs_per_event"):
            mod.resolve_pairs_many(c, r, np.full(6, rows[0], np.int32),
                                   bad, 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_resolve_pairs_vector_matches(seed):
    """One rule per resource: the vectorized path, with negative values,
    indexes past the arity, unruled rows and padding rows; and its
    fallbacks (ragged, strings, values that overflow the packed key)."""
    rules = [jpf.ParamFlowRule(resource=f"r{i}", param_idx=i % 3,
                               count=float(i + 1)) for i in range(5)]
    jc, tc = _compile_both(rules)
    assert jc.vector_meta is not None
    rng = np.random.default_rng(seed)
    n = 512
    ruled = np.array(sorted(jc.by_row), np.int32)
    ev_rows = np.where(rng.random(n) < 0.8,
                       ruled[rng.integers(0, len(ruled), n)],
                       rng.integers(0, 40, n)).astype(np.int32)
    for arity, dtype in ((2, np.int64), (3, np.int32)):
        args = rng.integers(-50, 50, (n, arity)).astype(dtype)
        jr, tr = _both_registries(128)
        want = jpf.resolve_pairs_many(jc, jr, ev_rows, args, 4)
        got = tpf.resolve_pairs_many(tc, tr, ev_rows, args, 4)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
        assert tr.drain_updates() == jr.drain_updates()
        assert len(tr) == len(jr) > 0
    pr = np.full((2, 4), 16, np.int32)
    pk = np.full((2, 4), 128, np.int32)
    row = int(ruled[0])                # param_idx 0
    for bad in ([(1,), (1, 2)], [("x",), ("y",)], [(2 ** 40,), (1,)],
                [(-2 ** 63,), (1,)]):
        jr, tr = _both_registries(8)
        assert jpf._resolve_pairs_vector(jc, jr, [row, row], bad, pr.copy(),
                                         pk.copy()) is None
        assert tpf._resolve_pairs_vector(tc, tr, [row, row], bad, pr.copy(),
                                         pk.copy()) is None


# ---------------------------------------------------------------------------
# device checks
# ---------------------------------------------------------------------------

def _random_dyn(rng, pk, now):
    """Key state with never-filled, in-window and refilling buckets,
    fractional tokens, pacing clocks around now, live threads and a few
    overrides (0 included)."""
    n = pk + 1
    last = np.where(rng.random(n) < 0.3, NEVER,
                    now - rng.integers(0, 2500, n)).astype(np.int32)
    latest = np.where(rng.random(n) < 0.3, NEVER,
                      now + rng.integers(-400, 400, n)).astype(np.int32)
    ov = np.where(rng.random(n) < 0.1, rng.integers(0, 6, n), -1)
    d = dict(tokens=rng.uniform(0, 12, n).astype(np.float32),
             last_fill_ms=last, latest_passed_ms=latest,
             threads=rng.integers(0, 5, n).astype(np.int32),
             override=ov.astype(np.float32))
    for k in ("tokens", "threads"):
        d[k][pk] = 0
    d["last_fill_ms"][pk] = NEVER
    d["latest_passed_ms"][pk] = NEVER
    d["override"][pk] = -1.0
    return d


def _pairs(rng, nrules, B, PV, PK, values=8):
    """Pairs whose key row belongs to one rule (rule · values + value), the
    NP sentinel and stray PK keys among them."""
    pr = rng.integers(0, nrules + 1, (B, PV)).astype(np.int32)
    vals = rng.integers(0, values, (B, PV))
    pk = np.where(pr < nrules, pr * values + vals,
                  rng.integers(0, PK + 1, (B, PV))).astype(np.int32)
    pk[rng.random((B, PV)) < 0.05] = PK
    return pr, pk


def _checks(form):
    jfn = jax.jit(jpf.param_check if form == "sorted"
                  else jpf.param_check_scalar)
    tfn = tpf.param_check if form == "sorted" else tpf.param_check_scalar
    return jfn, tfn


def _run_check(form, jc, tc, d_j, d_t, pr, pk, acq, valid, now):
    jfn, tfn = _checks(form)
    jd, jok, jw = jfn(jc.table, d_j, jnp.asarray(pr), jnp.asarray(pk),
                      jnp.asarray(acq), jnp.asarray(valid), jnp.int32(now))
    td, tok, tw_ = tfn(tc.table, d_t, _t(pr), _t(pk), _t(acq), _t(valid),
                       now)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tw_.numpy(), np.asarray(jw))
    assert tw_.dtype == torch.int32
    _same(jd, td, f"{form} dyn")
    return jd, td, np.asarray(jok)


@pytest.mark.parametrize("form,acquire", [("sorted", "mixed"),
                                          ("sorted", 1), ("scalar", 1),
                                          ("scalar", 2)])
def test_param_check_matches(form, acquire):
    jc, tc = _compile_both(RULES)
    PK, B, PV = 256, 192, 4
    rng = np.random.default_rng(17 + (acquire == 2))
    now = 50_000
    d = _random_dyn(rng, PK, now)
    d_j = jpf.ParamDynState(**{k: jnp.asarray(v) for k, v in d.items()})
    d_t = tpf.ParamDynState(**{k: _t(v) for k, v in d.items()})
    for step in range(10):
        pr, pk = _pairs(rng, jc.num_active, B, PV, PK)
        acq = (rng.integers(1, 4, B) if acquire == "mixed"
               else np.full(B, acquire)).astype(np.int32)
        valid = rng.random(B) > 0.15
        d_j, d_t, ok = _run_check(form, jc, tc, d_j, d_t, pr, pk, acq,
                                  valid, now)
        assert 0 < ok[valid].sum() < valid.sum()
        now += int(rng.integers(40, 1500))
        if step % 3 == 0:       # live threads move between steps
            k = int(rng.integers(0, PK))
            d_j = d_j._replace(threads=d_j.threads.at[k].add(1))
            d_t.threads[k] += 1


@pytest.mark.parametrize("form", ["sorted", "scalar"])
def test_param_check_one_key_thousands_of_lanes(form):
    """Thousands of lanes on one key of each grade: the scalar form's
    scatter-set has thousands of writers of one value, the consumption
    thousands of amounts into one bucket; the pacing ladder advances."""
    rules = [jpf.ParamFlowRule(resource="a", param_idx=0, count=3000,
                               burst_count=100),
             jpf.ParamFlowRule(resource="a", param_idx=1, count=2000,
                               control_behavior=jpf.BEHAVIOR_RATE_LIMITER,
                               max_queueing_time_ms=800),
             jpf.ParamFlowRule(resource="a", param_idx=2, count=1500,
                               grade=jpf.GRADE_THREAD)]
    jc, tc = _compile_both(rules)
    PK, B, PV = 64, 4096, 3
    d = {k: np.asarray(v) for k, v in jpf.init_param_dyn(PK)._asdict()
         .items()}
    d_j = jpf.ParamDynState(**{k: jnp.asarray(v) for k, v in d.items()})
    d_t = tpf.ParamDynState(**{k: _t(v.copy()) for k, v in d.items()})
    pr = np.tile(np.arange(3, dtype=np.int32), (B, 1))
    pk = np.tile(np.array([5, 17, 40], np.int32), (B, 1))
    rng = np.random.default_rng(2)
    now = 10_000
    for _ in range(3):
        valid = rng.random(B) > 0.05
        d_j, d_t, ok = _run_check(form, jc, tc, d_j, d_t, pr, pk,
                                  np.ones(B, np.int32), valid, now)
        assert 500 < ok[valid].sum() < valid.sum()
        now += 700


@pytest.mark.parametrize("form", ["sorted", "scalar"])
def test_param_check_row_shared_by_two_rules(form):
    """A batch with more distinct keys than key rows: the registry
    recycles a row within the batch, so two (rule, value) pairs share it.
    The rank form's bucket refresh then has writers of different values:
    the last lane wins, as in the reference."""
    jc, tc = _compile_both(RULES)
    PK, B, PV = 16, 128, 2
    rng = np.random.default_rng(12)
    now = 40_000
    d = _random_dyn(rng, PK, now)
    d_j = jpf.ParamDynState(**{k: jnp.asarray(v) for k, v in d.items()})
    d_t = tpf.ParamDynState(**{k: _t(v) for k, v in d.items()})
    for _ in range(4):
        pr = rng.integers(0, jc.num_active, (B, PV)).astype(np.int32)
        pk = rng.integers(0, PK, (B, PV)).astype(np.int32)   # shared rows
        d_j, d_t, _ = _run_check(form, jc, tc, d_j, d_t, pr, pk,
                                 np.ones(B, np.int32), rng.random(B) > 0.1,
                                 now)
        now += int(rng.integers(100, 1200))


def test_scatter_set_last_is_last_writer_wins():
    rng = np.random.default_rng(1)
    n, lanes = 32, 400
    dest = rng.random(n).astype(np.float32)
    idx = rng.integers(0, n + 3, lanes).astype(np.int32)
    vals = rng.random(lanes).astype(np.float32)
    keep = rng.random(lanes) < 0.7
    want = dest.copy()
    for i in range(lanes):
        if keep[i] and idx[i] < n:
            want[idx[i]] = vals[i]
    got = tpf.scatter_set_last(_t(dest), _t(idx), _t(vals),
                               _t(keep & (idx < n)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_param_checks_agree_across_forms():
    """The reference's own pin: the rank form equals the sorted form under
    a uniform acquire (``tests/test_param_scalar.py``), here in the port."""
    jc, tc = _compile_both(RULES)
    PK, B, PV = 128, 96, 3
    rng = np.random.default_rng(9)
    now = 5_000
    d = _random_dyn(rng, PK, now)
    a = tpf.ParamDynState(**{k: _t(v) for k, v in d.items()})
    b = tpf.ParamDynState(**{k: _t(v) for k, v in d.items()})
    for _ in range(8):
        pr, pk = _pairs(rng, tc.num_active, B, PV, PK)
        args = (_t(pr), _t(pk), _t(np.full(B, 2, np.int32)),
                _t(rng.random(B) > 0.2), now)
        a, ok1, w1 = tpf.param_check(tc.table, a, *args)
        b, ok2, w2 = tpf.param_check_scalar(tc.table, b, *args)
        assert torch.equal(ok1, ok2) and torch.equal(w1, w2)
        _same(a, b, "forms")
        now += int(rng.integers(50, 1500))


def test_key_state_helpers_match():
    """param_thread_update +1/-1 (the sentinel row PK with amount 0),
    invalidate_param_keys and apply_overrides with PK padding."""
    jc, tc = _compile_both(RULES)
    PK, B, PV = 64, 48, 4
    rng = np.random.default_rng(4)
    d = _random_dyn(rng, PK, 1000)
    d_j = jpf.ParamDynState(**{k: jnp.asarray(v) for k, v in d.items()})
    d_t = tpf.ParamDynState(**{k: _t(v) for k, v in d.items()})
    for delta in (+1, -1, -1, -1):
        pr, pk = _pairs(rng, jc.num_active, B, PV, PK)
        counted = rng.random(B) > 0.3
        d_j = jpf.param_thread_update(jc.table, d_j, jnp.asarray(pr),
                                      jnp.asarray(pk), jnp.asarray(counted),
                                      delta)
        d_t = tpf.param_thread_update(tc.table, d_t, _t(pr), _t(pk),
                                      _t(counted), delta)
        _same(d_j, d_t, f"threads {delta}")
    rows = np.array([3, 9, 9, 40, PK, PK, PK, PK], np.int32)
    d_j = jpf.invalidate_param_keys(d_j, jnp.asarray(rows))
    d_t = tpf.invalidate_param_keys(d_t, _t(rows))
    _same(d_j, d_t, "invalidate")
    vals = np.array([4.0, 0.0, 7.0, -1.0, -1.0, -1.0, -1.0, -1.0],
                    np.float32)
    rows = np.array([1, 2, 5, PK, PK, PK, PK, PK], np.int32)
    d_j = jpf.apply_overrides(d_j, jnp.asarray(rows), jnp.asarray(vals))
    d_t = tpf.apply_overrides(d_t, _t(rows), _t(vals))
    _same(d_j, d_t, "overrides")
    assert float(d_t.override[PK]) == -1.0


def test_plan_takes_the_param_shapes():
    """The kernel's launch plan for the two param scatters at full width:
    the float32 token consumption and the int32 THREAD update, [PK+1, 1]
    with PK = 2^16, N = B·PV = 2^21 lanes in payload mode."""
    pk1, n = 65_537, 1 << 21
    for dtype in (torch.float32, torch.int32):
        p = sa.plan(pk1, 1, 1, n, True, dtype, 132)
        assert p.path == sa.PATH_GLOBAL and p.index_bits == 32
        assert p.e_inst == 1 and p.block == sa.GLOBAL_BLOCK
        assert p.grid == 132 * (sa.THREADS_PER_SM // sa.GLOBAL_BLOCK)
    # a small key table takes the shared path once the stream is long
    p = sa.plan(1025, 1, 1, n, True, torch.float32, 132)
    assert p.path == sa.PATH_SHARED


# ---------------------------------------------------------------------------
# fused engine steps with param rules
# ---------------------------------------------------------------------------

ENGINE_CFG = dict(max_resources=64, max_origins=32, max_flow_rules=16,
                  max_degrade_rules=16, max_authority_rules=16,
                  max_param_rules=16, param_table_slots=512,
                  param_pairs_per_event=4, minute_enabled=True,
                  host_fast_path=False)
NAMES = ["hot", "b", "c", "plain", "paced"]


def _engine_sentinel(clk):
    sph = stpu.Sentinel(config=stpu.load_config(**ENGINE_CFG), clock=clk)
    sph.load_flow_rules([stpu.FlowRule(resource="hot", count=40.0),
                         stpu.FlowRule(resource="paced", count=30.0,
                                       control_behavior=stpu
                                       .BEHAVIOR_RATE_LIMITER,
                                       max_queueing_time_ms=300)])
    sph.load_param_flow_rules([r for r in RULES if r.is_valid()] + [
        jpf.ParamFlowRule(resource="paced", param_idx=0, count=6)])
    return sph


@pytest.mark.parametrize("route", ["scalar", "fast", "general"])
def test_fused_steps_with_param_rules_match(route):
    """~12 fused decide+exit steps over several windows, exits = the
    previous step's admissions with their pairs; verdicts and every state
    leaf (``param_dyn`` included) compared after each step."""
    clk = ManualClock(start_ms=T0)
    sph = _engine_sentinel(clk)
    spec = sph.spec
    tspec = _port_spec(spec)
    assert tspec.param_keys == 512 and tspec.param_pairs == 4
    assert not sph._skip_threads              # a THREAD-grade param rule
    flags = dict(skip_auth=sph._skip_auth, skip_sys=sph._skip_sys,
                 scalar_has_rl=sph._scalar_has_rl,
                 skip_threads=sph._skip_threads)
    rflags = dict(scalar_flow=route == "scalar", fast_flow=route == "fast",
                  record_alt=route != "scalar")
    fused = jax.jit(functools.partial(
        jp.decide_and_record_exits, spec, enable_occupy=False,
        sortfree=True, **rflags, **flags))
    trules = convert.ruleset_from_numpy(convert.to_numpy(sph._ruleset))
    assert trules.param_table is not None
    js = sph._state
    ts = convert.state_from_numpy(convert.to_numpy(js))
    rng = np.random.default_rng({"scalar": 1, "fast": 2, "general": 3}[route])
    rows_of = [sph.resources.get_or_create(x) for x in NAMES]
    oids = np.array([sph.origins.pin(o) for o in ("app-a", "app-b")],
                    np.int32)
    n, ra, r_pad, PV = 64, spec.alt_rows, spec.rows, 4
    prev = None
    sysv = np.array([0.25, 0.1], np.float32)
    values = ["u1", "u2", "vip", 9, 4, None]
    for step in range(12):
        rows = np.array([rows_of[i] for i in rng.integers(0, len(NAMES), n)],
                        np.int32)
        rows[::17] = r_pad
        args = [tuple(values[j] for j in rng.integers(0, len(values), 3))
                for _ in range(n)]
        pr, pk = jpf.resolve_pairs_many(sph._param, sph.param_key_registry,
                                        rows, args, PV)
        oid = np.zeros(n, np.int32)
        orow = np.full(n, ra, np.int32)
        if route != "scalar":
            oid = np.where(rng.random(n) < 0.5,
                           oids[rng.integers(0, 2, n)], 0).astype(np.int32)
            for i in range(n):
                if oid[i] and rows[i] < r_pad:
                    orow[i] = sph._alt_row(int(rows[i]), 0, int(oid[i]))
        acq = (rng.integers(1, 3, n) if route == "general"
               else np.full(n, 1 + step % 2)).astype(np.int32)
        eb = dict(rows=rows, origin_ids=oid, origin_rows=orow,
                  context_ids=np.zeros(n, np.int32),
                  chain_rows=np.full(n, ra, np.int32), acquire=acq,
                  is_in=rng.random(n) > 0.3, prioritized=np.zeros(n, bool),
                  valid=(rng.random(n) > 0.1) & (rows < r_pad),
                  param_rules=pr, param_keys=pk)
        if prev is None:
            prev = {k: v.copy() for k, v in eb.items()}
            prev["valid"] = np.zeros(n, bool)
        xb = dict(rows=prev["rows"], origin_rows=prev["origin_rows"],
                  chain_rows=prev["chain_rows"], acquire=prev["acquire"],
                  rt_ms=rng.integers(0, 90, n).astype(np.int32),
                  error=rng.random(n) < 0.3, is_in=prev["is_in"],
                  valid=prev["valid"], param_rules=prev["param_rules"],
                  param_keys=prev["param_keys"])
        times = np.asarray(sph._time_scalars(clk.now_ms()))
        js, jv = fused(sph._ruleset, js,
                       jp.EntryBatch(**{k: jnp.asarray(a)
                                        for k, a in eb.items()}),
                       jp.ExitBatch(**{k: jnp.asarray(a)
                                       for k, a in xb.items()}),
                       jnp.asarray(times), jnp.asarray(sysv))
        ts, tv = tp.decide_and_record_exits(
            tspec, trules, ts,
            tp.EntryBatch(**{k: _t(a) for k, a in eb.items()}),
            tp.ExitBatch(**{k: _t(a) for k, a in xb.items()}),
            tuple(int(x) for x in times), tuple(float(x) for x in sysv),
            sortfree=True, **rflags, **flags)
        for f in ("allow", "reason", "wait_ms"):
            np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                          np.asarray(getattr(jv, f)),
                                          err_msg=f"{f}, step {step}")
        _same(js, ts, f"state, step {step}")
        reasons = np.asarray(jv.reason)
        assert (reasons == stpu.BlockReason.PARAM_FLOW).any() or step == 0
        prev = dict(eb, valid=np.asarray(jv.allow) & eb["valid"])
        clk.advance_ms(int(rng.integers(150, 700)))
    assert int(np.asarray(js.param_dyn.threads).sum()) > 0


# ---------------------------------------------------------------------------
# twin runtimes: the reference's scenarios
# ---------------------------------------------------------------------------

def _make(pkg, clk, **over):
    cfg = pkg.load_config(**{**dict(
        max_resources=64, max_origins=32, max_flow_rules=16,
        max_degrade_rules=16, max_authority_rules=16, max_param_rules=16,
        param_table_slots=256), **over})
    extra = {"device": "cpu"} if pkg is stt else {}
    sph = pkg.Sentinel(config=cfg, clock=clk, **extra)
    sph._cpu.sample = lambda: (0.5, 0.25)
    return sph


def _twin(scenario, **over):
    """``scenario(pkg, sph, clk) -> observations`` on both packages (twin
    ManualClocks): observations, the whole engine state and the routes
    must agree → the port's observations."""
    got, engines = {}, {}
    for name, pkg in PKGS.items():
        clk = pkg.ManualClock(start_ms=T0)
        sph = _make(pkg, clk, **over)
        got[name] = scenario(pkg, sph, clk)
        engines[name] = sph
    js, ts = engines["jax"], engines["torch"]
    assert got["torch"] == got["jax"]
    _same(js._state, ts._state, "state")
    c = js.obs.counters
    assert {k: ts.routes.get(k, 0) for k in ROUTE_KEYS} == {
        k: c.get(v) for k, v in ROUTE_KEYS.items()}
    return got["torch"]


def _burst(pkg, sph, resource, n, args, **kw):
    p = b = 0
    for _ in range(n):
        try:
            with sph.entry(resource, args=args, **kw):
                p += 1
        except pkg.ParamFlowException:
            b += 1
    return p, b


def _rule(pkg, **kw):
    return pkg.ParamFlowRule(resource=kw.pop("resource", "r"),
                             param_idx=kw.pop("param_idx", 0), **kw)


def _sc_qps_per_value(pkg, sph, clk):
    sph.load_param_flow_rules([_rule(pkg, count=5)])
    return [_burst(pkg, sph, "r", 8, ("alice",)),
            _burst(pkg, sph, "r", 8, ("bob",)),
            _burst(pkg, sph, "other", 3, ("alice",))]


def _sc_refill(pkg, sph, clk):
    sph.load_param_flow_rules([_rule(pkg, count=5)])
    out = [_burst(pkg, sph, "r", 6, ("k",))]
    clk.advance_ms(400)
    out.append(_burst(pkg, sph, "r", 2, ("k",)))
    clk.advance_ms(700)
    out.append(_burst(pkg, sph, "r", 6, ("k",)))
    return out


def _sc_burst_and_duration(pkg, sph, clk):
    sph.load_param_flow_rules([_rule(pkg, count=3, burst_count=2),
                               _rule(pkg, resource="d", count=4,
                                     duration_in_sec=2)])
    out = [_burst(pkg, sph, "r", 7, ("k",)), _burst(pkg, sph, "d", 5, ("k",))]
    clk.advance_ms(1200)
    out.append(_burst(pkg, sph, "d", 2, ("k",)))
    clk.advance_ms(1000)
    out.append(_burst(pkg, sph, "d", 5, ("k",)))
    return out


def _sc_zero_and_over_cap(pkg, sph, clk):
    sph.load_param_flow_rules([_rule(pkg, count=0, burst_count=5),
                               _rule(pkg, resource="cap", count=3)])
    out = [_burst(pkg, sph, "r", 3, ("k",))]
    out.append(_burst(pkg, sph, "cap", 1, ("k",), acquire=4))
    out.append(_burst(pkg, sph, "cap", 1, ("k",), acquire=3))
    return out


def _sc_overrides(pkg, sph, clk):
    sph.load_param_flow_rules([_rule(pkg, count=5, param_flow_item_list=[
        pkg.ParamFlowItem(object="vip", count=10),
        pkg.ParamFlowItem(object="banned", count=0)])])
    return [_burst(pkg, sph, "r", 12, ("vip",)),
            _burst(pkg, sph, "r", 7, ("normal",)),
            _burst(pkg, sph, "r", 2, ("banned",))]


def _sc_indexes_and_values(pkg, sph, clk):
    class User:
        def __init__(self, uid):
            self.uid = uid

        def param_flow_key(self):
            return self.uid
    sph.load_param_flow_rules([_rule(pkg, param_idx=2, count=1),
                               _rule(pkg, resource="t", param_idx=-1,
                                     count=2),
                               _rule(pkg, resource="l", count=2),
                               _rule(pkg, resource="u", count=2)])
    return [_burst(pkg, sph, "r", 4, ("a",)),
            _burst(pkg, sph, "r", 4, ("a", "b", None)),
            _burst(pkg, sph, "t", 4, ("x", "hot")),
            _burst(pkg, sph, "t", 4, ("x", "cold")),
            _burst(pkg, sph, "l", 2, (["a", "b"],)),
            _burst(pkg, sph, "l", 1, (["a", "b"],)),
            _burst(pkg, sph, "l", 1, (["c", "a"],)),
            _burst(pkg, sph, "l", 1, (["c"],)),
            _burst(pkg, sph, "u", 3, (User("u1"),)),
            _burst(pkg, sph, "u", 1, ("u1",))]


def _sc_throttle(pkg, sph, clk):
    rl = pkg.PARAM_BEHAVIOR_RATE_LIMITER
    sph.load_param_flow_rules([
        _rule(pkg, count=10, control_behavior=rl),
        _rule(pkg, resource="q", count=10, max_queueing_time_ms=500,
              control_behavior=rl)])
    out = [_burst(pkg, sph, "r", 2, ("k",))]
    clk.advance_ms(100)
    out.append(_burst(pkg, sph, "r", 1, ("k",)))
    out.append(_burst(pkg, sph, "r", 1, ("other",)))
    t0 = clk.now_ms()
    out.append(_burst(pkg, sph, "q", 4, ("k",)))
    out.append(clk.now_ms() - t0)
    v = sph.entry_batch(["q"] * 8, args_list=[("k",)] * 8)
    out.append((v.allow.tolist(), v.wait_ms.tolist()))
    v = sph.entry_batch(["q"] * 3, args_list=[("j",)] * 3,
                        acquire=[1, 100, 1])
    out.append((v.allow.tolist(), v.wait_ms.tolist()))
    return out


def _sc_thread_grade(pkg, sph, clk):
    sph.load_param_flow_rules([_rule(pkg, grade=pkg.GRADE_THREAD, count=2)])
    out = []
    e1 = sph.entry("r", args=("k",))
    e2 = sph.entry("r", args=("k",))
    out.append(_burst(pkg, sph, "r", 1, ("k",)))
    sph.entry("r", args=("other",)).exit()
    e1.exit()
    e4 = sph.entry("r", args=("k",))
    e4.exit()
    e2.exit()
    sph.entry("r", args=("k",)).exit()
    out.append(sph.param_key_registry.live_pin_count())
    return out


def _sc_batch(pkg, sph, clk):
    sph.load_param_flow_rules([_rule(pkg, count=3),
                               _rule(pkg, resource="m", count=2)])
    v1 = sph.entry_batch(["r"] * 8, args_list=[("k",)] * 8)
    v2 = sph.entry_batch(["m"] * 6, args_list=[("a",), ("b",)] * 3)
    return [v1.allow.tolist(), v1.reason.tolist(), v2.allow.tolist()]


def _sc_lru_eviction(pkg, sph, clk):
    sph.load_param_flow_rules([_rule(pkg, count=1)])
    out = [_burst(pkg, sph, "r", 2, ("k0",))]
    for i in range(1, 5):
        out.append(_burst(pkg, sph, "r", 1, (f"k{i}",)))
    out.append(_burst(pkg, sph, "r", 1, ("k0",)))
    return out


def _sc_pins_survive(pkg, sph, clk):
    sph.load_param_flow_rules([_rule(pkg, grade=pkg.GRADE_THREAD, count=1)])
    e1 = sph.entry("r", args=("held",))
    for i in range(6):
        with sph.entry("r", args=(f"f{i}",)):
            pass
    out = [_burst(pkg, sph, "r", 1, ("held",))]
    e1.exit()
    out.append(_burst(pkg, sph, "r", 1, ("held",)))
    return out


def _sc_override_not_leaked(pkg, sph, clk):
    sph.load_param_flow_rules([_rule(pkg, count=1, param_flow_item_list=[
        pkg.ParamFlowItem(object="vip", count=50)])])
    v = sph.entry_batch(["r"] * 4,
                        args_list=[("vip",), ("a",), ("b",), ("c",)])
    return [v.allow.tolist(), _burst(pkg, sph, "r", 3, ("d",))]


def _sc_reload(pkg, sph, clk):
    sph.load_param_flow_rules([_rule(pkg, count=1),
                               _rule(pkg, resource="t",
                                     grade=pkg.GRADE_THREAD, count=1)])
    out = [_burst(pkg, sph, "r", 2, ("k",))]
    held = sph.entry("t", args=("k",))         # pinned, then a reload
    sph.load_param_flow_rules([_rule(pkg, count=5),
                               _rule(pkg, resource="t",
                                     grade=pkg.GRADE_THREAD, count=1)])
    out.append(_burst(pkg, sph, "r", 6, ("k",)))
    inner = sph.entry("t", args=("k",))
    held.exit()             # an older generation: no decrement, no unpin
    out.append(_burst(pkg, sph, "t", 1, ("k",)))
    inner.exit()
    out.append(_burst(pkg, sph, "t", 1, ("k",)))
    out.append(sph.param_key_registry.live_pin_count())
    return out


def _sc_compose_with_flow(pkg, sph, clk):
    sph.load_flow_rules([pkg.FlowRule(resource="r", count=10),
                         pkg.FlowRule(resource="s", count=5)])
    sph.load_param_flow_rules([_rule(pkg, count=3),
                               _rule(pkg, resource="s", count=1)])
    out = [_burst(pkg, sph, "r", 5, ("hot",))]
    p = b = 0
    for i in range(12):
        try:
            with sph.entry("r", args=(f"u{i}",)):
                p += 1
        except pkg.BlockException:
            b += 1
    out.append((p, b))
    out.append(_burst(pkg, sph, "s", 5, ("hot",)))
    p = f = 0
    for _ in range(6):
        try:
            with sph.entry("s", args=(None,)):
                p += 1
        except pkg.FlowException:
            f += 1
    out.append((p, f))
    return out


def _sc_vector_batches(pkg, sph, clk):
    """``tests/test_param_vector.py``: 2-D integer args (the vector path)
    and the same keys as tuples (the general loop) give one verdict
    stream; and a 2-D int64 array straight in."""
    sph.load_param_flow_rules([_rule(pkg, resource="hot", count=3)])
    rng = np.random.default_rng(7)
    out = []
    for step in range(4):
        ks = rng.integers(0, 5, size=32)
        args = ks[:, None] if step % 2 else [(int(k),) for k in ks]
        out.append(sph.entry_batch(["hot"] * 32, args_list=args)
                   .allow.tolist())
        clk.advance_ms(250)
    keys = np.array([[5], [5], [5], [9]], np.int64)
    sph.load_param_flow_rules([_rule(pkg, resource="hot", count=2)])
    out.append(sph.entry_batch(["hot"] * 4, args_list=keys).allow.tolist())
    return out


def _sc_scalar_and_split_routes(pkg, sph, clk):
    """Param pairs on the scalar route (uniform acquire), the fast route
    (origins), the general route (mixed acquire) and a batch that splits
    (4096+ scalar events and a few with an origin)."""
    sph.load_param_flow_rules([
        _rule(pkg, resource="hot", count=40),
        _rule(pkg, resource="hot", param_idx=1, count=25,
              control_behavior=pkg.PARAM_BEHAVIOR_RATE_LIMITER,
              max_queueing_time_ms=400),
        _rule(pkg, resource="cold", grade=pkg.GRADE_THREAD, count=30)])
    rng = np.random.default_rng(3)
    out = []
    n = 5000
    names = ["hot" if x else "cold" for x in rng.random(n) < 0.6]
    args = [(int(a), int(b)) for a, b in rng.integers(0, 6, (n, 2))]
    origins = ["app-a" if i % 97 == 5 else "" for i in range(n)]
    for m, kw in ((n, {}), (512, dict(origins=origins[:512])),
                  (512, dict(acquire=rng.integers(1, 3, 512).tolist())),
                  (n, dict(origins=origins))):
        v = sph.entry_batch(names[:m], args_list=args[:m], **kw)
        out.append((v.allow.tolist(), v.reason.tolist(), v.wait_ms.tolist()))
        clk.advance_ms(300)
    c = None if pkg is stt else sph.obs.counters
    taken = sorted(k for k, v in ROUTE_KEYS.items()
                   if (sph.routes.get(k, 0) if c is None else c.get(v)))
    assert taken == ["fast", "general", "scalar", "split"], taken
    return out


SCENARIOS = {
    "qps_per_value": (_sc_qps_per_value, {}),
    "refill": (_sc_refill, {}),
    "burst_and_duration": (_sc_burst_and_duration, {}),
    "zero_and_over_cap": (_sc_zero_and_over_cap, {}),
    "overrides": (_sc_overrides, {}),
    "indexes_and_values": (_sc_indexes_and_values, {}),
    "throttle": (_sc_throttle, {}),
    "thread_grade": (_sc_thread_grade, {}),
    "batch": (_sc_batch, {}),
    "lru_eviction": (_sc_lru_eviction, dict(param_table_slots=4)),
    "pins_survive": (_sc_pins_survive, dict(param_table_slots=4)),
    "override_not_leaked": (_sc_override_not_leaked,
                            dict(param_table_slots=2)),
    "reload": (_sc_reload, {}),
    "compose_with_flow": (_sc_compose_with_flow, {}),
    "vector_batches": (_sc_vector_batches, {}),
    "routes": (_sc_scalar_and_split_routes, dict(max_resources=256)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_twin_param_scenario(name):
    fn, over = SCENARIOS[name]
    obs = _twin(fn, **over)
    assert obs


def test_twin_scenarios_hold_the_reference_numbers():
    """The reference test's expected counts, on the port's side."""
    assert _twin(_sc_qps_per_value) == [(5, 3), (5, 3), (3, 0)]
    assert _twin(_sc_refill) == [(5, 1), (0, 2), (5, 1)]
    assert _twin(_sc_overrides) == [(10, 2), (5, 2), (0, 2)]
    assert _twin(_sc_lru_eviction, param_table_slots=4)[-1] == (1, 0)
    assert _twin(_sc_pins_survive, param_table_slots=4) == [(0, 1), (1, 0)]
    assert _twin(_sc_override_not_leaked,
                 param_table_slots=2)[1] == (1, 2)
    out = _twin(_sc_reload)
    assert out[:2] == [(1, 1), (5, 1)] and out[-1] == 0
    assert _twin(_sc_compose_with_flow) == [(3, 2), (7, 5), (1, 4), (4, 2)]
