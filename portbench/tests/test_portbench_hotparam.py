"""The ``hotparam_1m.fused`` cell on the CPU at a small size (defined
here): the program against the plain reference, the controls, three
faults planted under the timed path that the comparison has to catch,
the refusal of a program without the fused path's ``param_args``, the
program's key leaves, and the readers of the param slot's span and
device time on synthetic events."""

import numpy as np
import pytest
import torch

from portbench import calibrate, compare, harness, slot_device
from portbench.deployments import sentinel_param
from portbench.metrics import (
    degrade_device_ms, param_device_ms, param_resolve_ms,
)
from portbench.tests import small
from portbench.tests.test_portbench_readers import _ctx, _ev
from portbench.tests.test_portbench_span_readers import EVENTS, _on, _span

#: ``hotparam_1m`` at 2^12 rows: its rules on the 16 hottest names, each
#: argument over 40 values (32 rules · 40 values fit the 4,096 key rows)
HOTPARAM_1M = dict(
    small.FLOW_1M,
    sentinel=dict(small.FLOW_1M["sentinel"], max_param_rules=64,
                  param_pairs_per_event=2, param_table_slots=4096),
    param_rules=[dict(g, count=16) for g in
                 harness.deploy.load_config("hotparam_1m")["param_rules"]])
FUSED_HOTPARAM = dict(small.FUSED_ZIPF, verdict_sample=1.0,
                      args=[{"values": 40, "zipf_s": 0.99},
                            {"values": 40, "zipf_s": 0.99}])
CELL = "hotparam_1m.fused"


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(seed=2 ** 31 + 11, seconds=0.5, traced=False):
    return harness.run_cell(CELL, seed, seconds, traced, "cpu",
                            config_override=HOTPARAM_1M,
                            mix_override=FUSED_HOTPARAM)


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 5])
def test_the_cell_equals_its_reference(seed):
    out = _run(seed)
    assert out["correct"] is True, out["checks"]
    assert all(c["value"] == 0 for k, c in out["checks"].items()
               if k != "rt_sum_gap")
    assert set(out["checks"]) == set(harness.load_checks(CELL))
    assert set(out["metrics"]) == {"decisions_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


def test_the_param_cell_blocks_paces_and_reports_its_span():
    """The small cell's traffic meets every rule kind (PARAM_FLOW denials
    and RATE_LIMITER waits), and a traced run reports the time of the
    program's key resolution."""
    seen = {}
    real = harness.replay_reference

    def replay(*a, **kw):
        ref, kept = real(*a, **kw)
        seen["reasons"] = torch.cat([v[1].to(torch.int64)
                                     for v in kept.values()])
        seen["waits"] = torch.cat([v[2] for v in kept.values()])
        seen["keys"] = int(ref.pk_keys.shape[0])
        return ref, kept
    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "replay_reference", replay)
    try:
        out = _run(traced=True, seconds=2.0)
    finally:
        mp.undo()
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["param_resolve_ms"]["value"] > 0
    assert (seen["reasons"] == 5).any() and (seen["waits"] > 0).any()
    assert 0 < seen["keys"] <= 32 * 40


def test_controls_fail_the_comparison():
    got = calibrate.readings(CELL, 13, 0.6, "cpu", HOTPARAM_1M,
                             FUSED_HOTPARAM, harness.load_benchmark())
    limits = {k: v for k, v in harness.load_checks(CELL).items()
              if k in got["program"]}
    assert compare.judge(got["program"], limits), got
    assert not compare.judge(got["control_order"], limits), got
    assert not compare.judge(got["control_precision"], limits), got


def _flip_a_param_denial(real):
    def step(*a, **kw):
        st, v = real(*a, **kw)
        hit = torch.nonzero(v.reason == 5).view(-1)
        if hit.numel():
            i = hit[0]
            allow, reason = v.allow.clone(), v.reason.clone()
            allow[i], reason[i] = True, 0
            v = v._replace(allow=allow, reason=reason)
        return st, v
    return step


def _one_bucket_changed(real):
    def step(*a, **kw):
        st, v = real(*a, **kw)
        tokens = st.param_dyn.tokens.clone()
        tokens[0] += 1.0
        return st._replace(param_dyn=st.param_dyn._replace(
            tokens=tokens)), v
    return step


@pytest.mark.parametrize("fault", [_flip_a_param_denial,
                                   _one_bucket_changed, "override"])
def test_a_broken_param_path_is_not_correct(fault, monkeypatch):
    from sentinel_tpu_torch import runtime
    if fault == "override":
        # a hot item's threshold never reaches the device
        monkeypatch.setattr(runtime.pf_mod, "apply_overrides",
                            lambda dyn, rows, values: dyn)
    else:
        step = "decide_and_record_exits"
        monkeypatch.setattr(runtime, step, fault(getattr(runtime, step)))
    out = _run()
    assert out["correct"] is False, out["checks"]


def test_a_program_without_param_args_is_refused_before_it_builds(
        monkeypatch):
    import sentinel_tpu_torch as stt

    def older(self, rows, origin_ids, origin_rows, context_ids, chain_rows,
              acquire, is_in, prioritized, *, exit_rows, at_ms=None):
        raise AssertionError("not reached")
    monkeypatch.setattr(stt.Sentinel, "decide_and_exit_raw_nowait", older)
    with pytest.raises(SystemExit, match="param_args"):
        sentinel_param.build(HOTPARAM_1M, "cpu")


def test_param_resolve_ms_is_the_mean_of_its_spans():
    spans = [_span("fused.dispatch", 0, 40), _span("dispatch.param", 1, 3),
             _span("fused.dispatch", 50, 44), _span("dispatch.param", 52, 5)]
    assert param_resolve_ms.read(_ctx(spans=spans)) == pytest.approx(4.0)
    assert param_resolve_ms.read(_ctx(spans=spans[:1])) is None


def test_param_device_ms_reads_the_kernels_launched_in_its_ranges():
    # the degrade reader's events with one engine.param range around the
    # third launch (device 650..680): 30 us over 2 steps
    events = EVENTS + [_on(_ev("engine.param", "user_annotation", 640.0,
                               20.0))]
    assert param_device_ms.read(_ctx(events=events)) == \
        pytest.approx(0.030 / 2)
    assert param_device_ms.read(_ctx(events=EVENTS)) is None
    # the shared reader gives the degrade slot's number as its reader does
    assert slot_device.ms_a_step(_ctx(events=EVENTS), "engine.degrade") \
        == degrade_device_ms.read(_ctx(events=EVENTS))


def test_param_leaves_sort_the_program_keys_and_pad_them():
    class Registry:
        def items(self):
            return [((1, 5), 0), ((0, -2), 2), ((1, 3), 1)]
    state = {"param_dyn.tokens": np.array([4, 7, 9, 0, 0], np.float32),
             "param_dyn.last_fill_ms": np.array([10, 11, 12, 0, 0],
                                                np.int32),
             "param_dyn.latest_passed_ms": np.array([1, 2, 3, 0, 0],
                                                    np.int32),
             "param_dyn.override": np.array([-1, 50, -1, -1, -1],
                                            np.float32)}
    config = {"rule_kinds": ["param"], "param_rules": [
        {"first": 0, "count": 1, "rules": [
            {"rule": {"param_idx": 0, "count": 10.0}},
            {"rule": {"param_idx": 1, "count": 20.0}}]}]}
    out = sentinel_param.param_leaves(config, Registry(), state)
    assert out["param_buckets.count"].tolist() == [3]
    assert out["param_buckets.keys"].tolist() == [
        2 ** 31 - 2, 2 ** 32 + 2 ** 31 + 3, 2 ** 32 + 2 ** 31 + 5, -1, -1]
    assert out["param_buckets.tokens"].tolist() == [9, 7, 4, 0, 0]
    assert out["param_buckets.threshold"].tolist() == [10, 50, 20, -1, -1]
