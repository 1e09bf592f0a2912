"""Hot-parameter rules on the fused serving path
(``Sentinel.decide_and_exit_raw_nowait(param_args=)``, and so
``DispatchPipeline.submit_fused``) and the vector resolution tier that
serves it.

* The fused path resolves its batch's integer arguments itself: its
  verdicts and its whole engine state (the key state ``param_dyn`` and
  the windows included) equal, bit for bit, a twin's that takes
  ``decide_raw_nowait`` with pairs from the general resolution loop and
  then ``exit_batch``, with the staging ring on and off.
* The vector tier (several rules a resource, hot items) gives the
  general loop's pairs and registry state exactly, on the Python and the
  C++ key registries, under LRU pressure too.
* THREAD-grade and cluster-mode param rules refuse the path.
* ``param_args=None`` leaves the fused dispatch's spans and its staging
  note as they were; with it the dispatch records ``dispatch.param``.
"""

import re

import numpy as np
import pytest
import torch

import sentinel_tpu_torch as stt
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.rules import param_flow as tpf

torch.set_num_threads(2)

T0 = 1_785_000_000_000
PV = 3
N = 600          # a serving-sized batch: the staging ring's path
RL = tpf.BEHAVIOR_RATE_LIMITER
Item = tpf.ParamFlowItem


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


def _param_rules():
    """Two rules on most resources: DEFAULT with and without burst and a
    longer duration, RATE_LIMITER, hot items (one at count 0), an index
    past the events' arity, and a resource without rules (``r5``)."""
    R = tpf.ParamFlowRule
    return [
        R(resource="r0", param_idx=0, count=3),
        R(resource="r0", param_idx=1, count=50, control_behavior=RL,
          max_queueing_time_ms=100),
        R(resource="r1", param_idx=0, count=5, burst_count=2,
          duration_in_sec=2),
        R(resource="r1", param_idx=1, count=4,
          param_flow_item_list=[Item(0, 20), Item(1, 0), Item(7, 9)]),
        R(resource="r2", param_idx=1, count=10, control_behavior=RL,
          max_queueing_time_ms=300, param_flow_item_list=[Item(3, 100)]),
        R(resource="r3", param_idx=5, count=1),
        R(resource="r3", param_idx=0, count=2, duration_in_sec=3,
          burst_count=1),
        R(resource="r4", param_idx=1, count=6,
          param_flow_item_list=[Item(True, 12), Item(2.0, 1),
                                Item("s", 30)]),
    ]


def _sentinel(**over):
    cfg = dict(max_resources=64, max_flow_rules=16, max_degrade_rules=16,
               max_param_rules=16, param_table_slots=512,
               param_pairs_per_event=PV, host_fast_path=False)
    cfg.update(over)
    sph = stt.Sentinel(config=stt.load_config(**cfg),
                       clock=stt.ManualClock(start_ms=T0), device="cpu")
    sph._cpu.sample = lambda: (0.5, 0.25)
    sph.load_flow_rules([stt.FlowRule(resource="r0", count=200.0),
                         stt.FlowRule(resource="r5", count=40.0)])
    sph.load_degrade_rules([stt.DegradeRule(
        resource="r1", grade=stt.GRADE_EXCEPTION_RATIO, count=0.5,
        time_window=1, min_request_amount=5)])
    sph.load_param_flow_rules(_param_rules())
    return sph


def _batches(seed, steps):
    """Each step's resource rows (by name index) and int32 arguments
    ``[N, 2]`` (contended values, and the int32 edges now and then)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        names = rng.integers(0, 7, N)          # r6 is never ruled
        args = rng.integers(0, 9, (N, 2)).astype(np.int32)
        edge = rng.random((N, 2)) < 0.02
        args[edge] = rng.choice([-(2 ** 31) + 1, 2 ** 31 - 1],
                                int(edge.sum()))
        out.append((names, args))
    return out


def _decide_cols(sph, rows):
    n, ra = rows.shape[0], sph.spec.alt_rows
    z = np.zeros(n, np.int32)
    return (rows, z, np.full(n, ra, np.int32), z, np.full(n, ra, np.int32),
            np.ones(n, np.int32), np.ones(n, np.bool_),
            np.zeros(n, np.bool_))


@pytest.mark.parametrize("staging", ["1", "0"])
def test_fused_param_args_equal_decide_then_exit_bit_for_bit(
        staging, monkeypatch):
    monkeypatch.setenv("SENTINEL_HOST_STAGING", staging)
    fused, twin = _sentinel(), _sentinel()
    names = [f"r{i}" for i in range(7)]
    rows_of = {id(s): s.intern_resources(names) for s in (fused, twin)}
    assert (rows_of[id(fused)] == rows_of[id(twin)]).all()
    rng = np.random.default_rng(11)
    prev = None
    blocked_by_param = waited = 0
    for k, (ix, args) in enumerate(_batches(3, 8)):
        at = T0 + 137 * k
        rows = rows_of[id(fused)][ix]
        cols = _decide_cols(fused, rows)
        ex = {"exit_rows": np.empty(0, np.int32)}
        if prev is not None:
            lanes = np.flatnonzero(prev)
            ex = {"exit_rows": rows_prev[lanes],
                  "exit_rt_ms": rng.integers(0, 90, lanes.size)
                  .astype(np.int32),
                  "exit_error": rng.random(lanes.size) < 0.3}
        got = fused.decide_and_exit_raw_nowait(
            *cols, at_ms=at, param_args=args, **ex).result()
        compiled = twin._param
        pr, pk = tpf.resolve_pairs_many(
            compiled._replace(vector_meta=None), twin.param_key_registry,
            rows, [tuple(int(v) for v in a) for a in args], PV)
        want = twin.decide_raw_nowait(
            *cols, param_rules=pr, param_keys=pk,
            param_gen=twin._param_gen, at_ms=at).result()
        if ex["exit_rows"].size:
            m = ex["exit_rows"].shape[0]
            twin.exit_batch(
                rows=ex["exit_rows"],
                origin_rows=np.full(m, twin.spec.alt_rows, np.int32),
                chain_rows=np.full(m, twin.spec.alt_rows, np.int32),
                acquire=np.ones(m, np.int32), rt_ms=ex["exit_rt_ms"],
                error=ex["exit_error"], is_in=np.ones(m, np.bool_), at_ms=at)
        for f in ("allow", "reason", "wait_ms"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{f}, step {k}")
        blocked_by_param += int((np.asarray(got.reason)
                                 == stt.BlockReason.PARAM_FLOW).sum())
        waited += int((np.asarray(got.wait_ms) > 0).sum())
        prev, rows_prev = np.asarray(got.allow), rows
    assert blocked_by_param > 0 and waited > 0
    assert fused.routes["fused"] == 8
    assert convert.leaf_diff(convert.to_numpy(twin._state),
                             convert.to_numpy(fused._state)) == []
    assert fused.param_key_registry.items() == \
        twin.param_key_registry.items()
    for s in (fused, twin):
        s.close()


class _Rows:
    """A resource registry stub: ``r<i>`` on row ``2 + 3i``."""

    def pin(self, name):
        return 2 + 3 * int(name[1:])


def _registry(kind, cap):
    return (tpf.ParamKeyRegistry(cap) if kind == "python"
            else tpf.NativeParamKeyRegistry(cap))


def _registry_state(reg):
    return (reg.items(), reg.drain_updates(), reg.created, reg.evicted,
            len(reg))


@pytest.mark.parametrize("kind", ["python", "native"])
@pytest.mark.parametrize("cap", [4096, 23])
@pytest.mark.parametrize("seed", [0, 1])
def test_vector_tier_equals_the_general_loop(kind, cap, seed):
    """Pairs, rows, LRU order, queued overrides (cancelled where a
    recycled row takes a new key: ``cap`` 23 is below a batch's distinct
    keys) and the counters, batch after batch."""
    compiled = tpf.compile_param_rules(
        _param_rules(), resource_registry=_Rows(), capacity=16,
        k_per_resource=4)
    meta = compiled.vector_meta
    assert meta is not None and not meta.sorted_order
    assert meta.slot.shape[1] == 2 and meta.hot_keys.size == 6
    general = compiled._replace(vector_meta=None)
    rv, rg = _registry(kind, cap), _registry(kind, cap)
    rng = np.random.default_rng(seed)
    # ruled rows, an unruled row inside the tables, one past them
    rows_pool = np.array([2 + 3 * i for i in range(5)] + [3, 200], np.int32)
    for step in range(5):
        rows = rows_pool[rng.integers(0, rows_pool.size, 400)]
        args = rng.integers(-3, 12, (400, 2 + step % 2)).astype(np.int64)
        args[rng.random(args.shape) < 0.03] = 2 ** 31 - 1
        args[rng.random(args.shape) < 0.03] = -(2 ** 31) + 1
        stats, stats_g = {}, {}
        got = tpf.resolve_pairs_many(compiled, rv, rows, args, PV, stats)
        want = tpf.resolve_pairs_many(general, rg, rows, args, PV, stats_g)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
        assert stats == stats_g
        assert stats["pairs"] == int((got[1] < cap).sum()) > 0
        assert _registry_state(rv) == _registry_state(rg)
    assert rv.created == len(rv) + rv.evicted
    assert (rv.evicted > 0) == (cap == 23)


@pytest.mark.parametrize("value", [2 ** 31, -(2 ** 31)])
def test_values_outside_int32_take_the_general_loop(value):
    compiled = tpf.compile_param_rules(
        _param_rules(), resource_registry=_Rows(), capacity=16,
        k_per_resource=4)
    rows = np.array([2, 5, 8], np.int32)
    args = np.array([[1, 2], [value, 0], [3, 3]], np.int64)
    pr = np.full((3, PV), 16, np.int32)
    pk = np.full((3, PV), 64, np.int32)
    assert tpf._resolve_pairs_vector(compiled, tpf.ParamKeyRegistry(64),
                                     rows, args, pr, pk) is None
    rv, rg = tpf.ParamKeyRegistry(64), tpf.ParamKeyRegistry(64)
    got = tpf.resolve_pairs_many(compiled, rv, rows, args, PV)
    want = tpf.resolve_pairs_many(compiled._replace(vector_meta=None), rg,
                                  rows, args, PV)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert _registry_state(rv) == _registry_state(rg)


@pytest.mark.parametrize("rule", [
    dict(grade=tpf.GRADE_THREAD, count=4),
    dict(cluster_mode=True, cluster_flow_id=7, count=4)])
def test_pinned_key_rules_refuse_the_fused_path(rule):
    sph = _sentinel()
    sph.load_param_flow_rules(_param_rules() + [tpf.ParamFlowRule(
        resource="r6", param_idx=0, **rule)])
    rows = sph.intern_resources(["r0", "r6", "r1"])
    args = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    with pytest.raises(ValueError, match="entry_batch.*exit_batch"):
        sph.decide_and_exit_raw_nowait(
            *_decide_cols(sph, rows), exit_rows=np.empty(0, np.int32),
            param_args=args)
    # a batch that does not touch the resource goes through
    keep = np.array([0, 2])
    v = sph.decide_and_exit_raw_nowait(
        *_decide_cols(sph, rows[keep]), exit_rows=np.empty(0, np.int32),
        param_args=args[keep]).result()
    assert v.allow.tolist() == [True, True]
    sph.close()


def _real_clock_fused(param_args):
    cfg = stt.load_config(max_resources=64, max_flow_rules=16,
                          max_degrade_rules=16, max_param_rules=16,
                          param_pairs_per_event=PV, host_fast_path=False)
    sph = stt.Sentinel(config=cfg, device="cpu")
    sph._cpu.sample = lambda: (0.5, 0.25)
    sph.load_flow_rules([stt.FlowRule(resource="r0", count=100.0)])
    sph.load_param_flow_rules(_param_rules())
    rows = sph.intern_resources(["r0", "r1"] * (N // 2))
    sph.decide_and_exit_raw_nowait(
        *_decide_cols(sph, rows), exit_rows=rows,
        exit_rt_ms=np.full(N, 7, np.int32),
        exit_error=np.arange(N) % 2 == 0,
        param_args=(None if param_args is None else
                    np.tile(np.array([[1, 2], [1, 3]], np.int32),
                            (N // 2, 1)))).result()
    spans = sph.obs.spans.snapshot()
    sph.close()
    return spans


@pytest.mark.parametrize("with_args", [False, True])
def test_dispatch_param_span_and_stage_note(with_args):
    """Without ``param_args`` the dispatch records its three parts and the
    stage note of a serving-sized batch as before; with them a
    ``dispatch.param`` span, between the route and the staging, notes the
    pairs, their distinct keys and the key rows created, and the two
    pair columns go through ring slots."""
    spans = _real_clock_fused([[1]] if with_args else None)
    (parent,) = [s for s in spans if s["name"] == "fused.dispatch"]
    parts = {s["name"]: s for s in spans if s["name"].startswith("dispatch.")
             and s["name"] != "dispatch.readback"}
    want = {"dispatch.route", "dispatch.stage", "dispatch.engine"}
    (stage,) = [s for s in spans if s["name"] == "dispatch.stage"]
    if not with_args:
        assert set(parts) == want
        assert stage["note"] == "ring=9 fresh=0 const=8"
        return
    assert set(parts) == want | {"dispatch.param"}
    p = parts["dispatch.param"]
    assert parts["dispatch.route"]["end_ns"] <= p["start_ns"]
    assert p["end_ns"] <= stage["start_ns"]
    assert parent["start_ns"] <= p["start_ns"] <= p["end_ns"] \
        <= parent["end_ns"]
    # r0: rule A on value 1, rule B on 2 or 3; r1: rule A on 1, B on 2, 3
    assert re.fullmatch(r"pairs=1200 distinct=4 created=4", p["note"]), \
        p["note"]
    assert stage["note"] == "ring=11 fresh=0 const=8"


def test_a_reload_during_the_dispatch_resolves_again(monkeypatch):
    """Rules reloaded between the dispatch's resolution and its engine
    step: the step resolves the batch again against the rules it runs,
    as a twin that had those rules from the start decides it."""
    # r0's rule moves to slot 1: pairs of the old rules would name r1's
    tight = [tpf.ParamFlowRule(resource="r1", param_idx=0, count=100),
             tpf.ParamFlowRule(resource="r0", param_idx=0, count=2)]
    fused, twin = _sentinel(), _sentinel()
    twin.load_param_flow_rules(tight)
    rows = fused.intern_resources(["r0"] * 8)
    args = np.array([[1, 0]] * 8, np.int32)
    real = stt.Sentinel._entry_batch

    def reloading(self, *a, **kw):
        if self is fused and kw.get("param_rules") is not None:
            fused.load_param_flow_rules(tight)
        return real(self, *a, **kw)
    monkeypatch.setattr(stt.Sentinel, "_entry_batch", reloading)
    got = fused.decide_and_exit_raw_nowait(
        *_decide_cols(fused, rows), exit_rows=np.empty(0, np.int32),
        param_args=args, at_ms=T0).result()
    want = twin.decide_and_exit_raw_nowait(
        *_decide_cols(twin, rows), exit_rows=np.empty(0, np.int32),
        param_args=args, at_ms=T0).result()
    assert got.allow.tolist() == want.allow.tolist() == [True] * 2 + [
        False] * 6
    assert convert.leaf_diff(convert.to_numpy(twin._state),
                             convert.to_numpy(fused._state)) == []
    for s in (fused, twin):
        s.close()
