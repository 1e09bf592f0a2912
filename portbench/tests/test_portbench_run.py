"""Whole runs of the harness on the CPU at small sizes: the program
against the plain reference, the result line, the controls and the
faults that ``correct`` has to catch, the isolation rules, and a cell
added as files alone. The measuring entry (``portbench.run``) refuses
the CPU; these call ``harness.run_cell`` with ``device="cpu"``."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import calibrate, harness, isolation
from portbench.tests import small

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    # one intra-op thread: beside other test workers, a full thread pool
    # spins against them and a small step takes seconds
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(workload="flow_1m.fused", seed=2 ** 31 + 7, seconds=0.4,
         traced=False, device="cpu"):
    cfg, mix = small.CELLS[workload]
    return harness.run_cell(workload, seed, seconds, traced, device,
                            bench=small.bench(), config_override=cfg,
                            mix_override=mix)


@pytest.mark.parametrize("workload", sorted(small.CELLS))
def test_program_equals_reference_and_the_line_has_its_shape(workload):
    out = _run(workload)
    assert out["correct"] is True, out["checks"]
    assert all(c["value"] == 0 for k, c in out["checks"].items()
               if k != "rt_sum_gap")
    assert set(out["checks"]) == set(harness.load_checks(workload))
    assert list(out)[:5] == RESULT_KEYS
    assert list(out)[-2:] == ["checks", "forbidden_modules"]
    assert out["forbidden_modules"] == []
    assert set(out["metrics"]) == {"decisions_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(out)


@pytest.mark.parametrize("workload", sorted(small.CELLS))
def test_traced_run_reports_the_per_layer_metrics(workload):
    # long enough for the stretch to start on a loaded CPU
    out = _run(workload, traced=True, seconds=2.0)
    assert out["correct"] is True, out["checks"]
    # a CPU trace has no device operations: only the host-side readers
    assert {"generator_ms", "enqueue_ms", "dispatch_ms"} <= set(out["metrics"])
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", sorted(small.CELLS))
def test_controls_fail_the_comparison(workload):
    cfg, mix = small.CELLS[workload]
    got = calibrate.readings(workload, 11, 0.6, "cpu", cfg, mix,
                             small.bench())
    # the comparison's numbers (route and answers are the run's own)
    limits = {k: v for k, v in harness.load_checks(workload).items()
              if k in got["program"]}
    from portbench import compare
    assert compare.judge(got["program"], limits), got
    assert not compare.judge(got["control_order"], limits), got
    assert got["control_order"]["verdicts_differ"] > 0
    if "rt_sum_gap" in limits:
        assert got["control_precision"]["rt_sum_gap"] > limits["rt_sum_gap"]


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        items = [_clone(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return tree


def _unchanged(real):
    def step(spec, rules, state, *a, **kw):
        _st, v = real(spec, rules, _clone(state), *a, **kw)
        return state, v
    return step


def _half_left_out(real):
    def step(spec, rules, state, batch, *a, **kw):
        valid = batch.valid.clone()
        valid[valid.shape[0] // 2:] = False
        return real(spec, rules, state, batch._replace(valid=valid), *a,
                    **kw)
    return step


def _answer_altered(real):
    def step(*a, **kw):
        st, v = real(*a, **kw)
        allow = v.allow.clone()
        allow[0] = ~allow[0]
        return st, v._replace(allow=allow)
    return step


@pytest.mark.parametrize("workload", sorted(small.CELLS))
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _answer_altered])
def test_a_broken_timed_path_is_not_correct(fault, workload, monkeypatch):
    from sentinel_tpu_torch import runtime
    step = "decide_and_record_exits"
    monkeypatch.setattr(runtime, step, fault(getattr(runtime, step)))
    out = _run(workload, seconds=0.5)
    assert out["correct"] is False, out["checks"]


def test_forbidden_modules_by_whole_top_level_name():
    names = ["sentinel_tpu_torch", "sentinel_tpu_torch.runtime", "numpy",
             "jaxtyping", "sentinel_tpu_x"]
    assert isolation.loaded_forbidden(names) == []
    assert isolation.loaded_forbidden(names + ["jax.numpy", "flax"]) == [
        "flax", "jax"]
    assert isolation.loaded_forbidden(["sentinel_tpu.runtime"]) == [
        "sentinel_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_and_the_reference_no_program():
    for root, _dirs, files in os.walk(PB):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            tops = isolation.top_level(_imports(path))
            assert not tops & isolation.FORBIDDEN, path
            if os.sep + "reference" + os.sep in path:
                assert "sentinel_tpu_torch" not in tops, path


DUMMY_METRIC = '''"""A reader a later change adds: batches in the window."""


def read(ctx):
    return float(ctx.run.last - ctx.run.first)
'''

DUMMY_GENERATOR = '''"""A generator a later change adds: the Zipf batches, hottest first."""

import numpy as np

from portbench.generators import zipf_batches


class Traffic(zipf_batches.Traffic):
    def __init__(self, mix, config, seed, device):
        super().__init__(mix, config, seed, device)
        self.pool = [np.sort(p) for p in self.pool]
'''

DUMMY_LOOP = '''"""A loop a later change adds: the closed loop, counted."""

from portbench.loops import closed

CALLS = []


def drive(*args, **kwargs):
    CALLS.append(1)
    return closed.drive(*args, **kwargs)
'''

DUMMY_RULES = '''"""A rule kind a later change adds (this one loads nothing)."""

CODES = {}


def load(stt, sph, rules):
    assert rules == []
'''


def _digest(root):
    out = {}
    for r, _d, files in os.walk(root):
        for f in files:
            if "__pycache__" not in r:
                p = os.path.join(r, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_is_files_alone(tmp_path):
    # a configuration, a mix with its own generator and loop, a rule
    # kind, the comparison's limits and a per-layer metric, each a new
    # file; the cell drives the raw entry, which no cell of the
    # benchmark drives yet
    co = tmp_path / "checkout"
    shutil.copytree(PB, co / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(co / "portbench")
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(PB, "configs", "flow_1m.json")))
    cfg.update(small.FLOW_1M)
    cfg["rule_kinds"] = cfg["rule_kinds"] + ["dummy_kind"]
    mix = json.load(open(os.path.join(PB, "traffic", "fused_zipf.json")))
    mix.update(small.DECIDE_ZIPF)
    mix.update(generator="dummy_gen", loop="dummy_loop")
    checks = json.load(open(os.path.join(PB, "checks",
                                         "flow_1m.fused.json")))
    pb = co / "portbench"
    (pb / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (pb / "checks" / "dummy.decide.json").write_text(json.dumps(checks))
    (pb / "metrics" / "dummy_batches.py").write_text(DUMMY_METRIC)
    (pb / "generators" / "dummy_gen.py").write_text(DUMMY_GENERATOR)
    (pb / "loops" / "dummy_loop.py").write_text(DUMMY_LOOP)
    (pb / "rules" / "dummy_kind.py").write_text(DUMMY_RULES)
    bench["configs"].append(dict(bench["configs"][0], name="dummy",
                                 file="portbench/configs/dummy.json"))
    bench["workloads"].append({"name": "dummy.decide", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({
        "name": "dummy_batches", "unit": "batches", "better": "higher",
        "source": "host_clock", "layer": "caller",
        "moves": "decisions_per_s", "workloads": ["dummy.decide"]})
    (co / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys\n"
            f"sys.path[:0] = [{str(co)!r}, {REPO!r}]\n"
            "from portbench import harness\n"
            "from portbench.loops import dummy_loop\n"
            "out = harness.run_cell('dummy.decide', 3, 0.3, True, 'cpu', "
            f"bench=harness.load_benchmark({str(co)!r}))\n"
            "out['loop_calls'] = len(dummy_loop.CALLS)\n"
            "print(json.dumps(out))\n")
    env = dict(os.environ, SENTINEL_TPU_LOG_DIR=str(tmp_path / "logs"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(co),
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["loop_calls"] == 1
    assert out["metrics"]["dummy_batches"]["value"] > 0
    assert out["forbidden_modules"] == []
    after = _digest(co / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.gpu
def test_a_small_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run(device="cuda", seconds=1.0, traced=True)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["scatter_add_roofline"]["value"] <= 100
