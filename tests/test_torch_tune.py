"""Port parity: the serving autotuner (``sentinel_tpu_torch.tune``) against
``sentinel_tpu.tune``.

Twins of the 15 tests of ``tests/test_tune.py``. The policy core runs the
same synthetic response surfaces through both packages' ``TuneSearch``
under twin ManualClocks (results, histories and eliminations equal); the
artifact, validator and registry tests run each package's functions on
the same inputs (documents, files, events and warnings equal); the
startup and ``frontend()`` tests run twin runtimes (the port on the CPU)
under the same environment, each on an artifact carrying its own
package's live fingerprint, with ``_tuned``, the batcher's knobs, the
pipeline depth and the ``tune.*`` counters equal. The registry is pinned
against the port's read sites.

Two more: a ``TUNED.json`` saved by either package loads in the other
with equal knobs (the fingerprints differ — the conftest gives JAX 8
virtual CPUs, the port sees one device — so each falls back to defaults
on ``n_devices_visible``), and one real ``ServingTrialRunner`` trial of
150 ms on the CPU.
"""

import json
import os

import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.obs import counters as jck
from sentinel_tpu.tune import artifact as jart
from sentinel_tpu.tune import knobs as jknobs
from sentinel_tpu.tune import search as jsearch
from sentinel_tpu_torch.core.clock import ManualClock
from sentinel_tpu_torch.obs import counters as tck
from sentinel_tpu_torch.tune import artifact as tart
from sentinel_tpu_torch.tune import knobs as tknobs
from sentinel_tpu_torch.tune import search as tsearch

torch.set_num_threads(2)

T0 = 1_785_000_000_000
PKGS = {"jax": (stpu, jart, jknobs, jsearch, jck),
        "torch": (stt, tart, tknobs, tsearch, tck)}


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


def _fp(name):
    """The package's live fingerprint on the CPU."""
    art = PKGS[name][1]
    return art.fingerprint() if name == "jax" else art.fingerprint("cpu")


def _startup(name, environ):
    art = PKGS[name][1]
    if name == "jax":
        return art.resolve_startup(environ=environ)
    return art.resolve_startup(device="cpu", environ=environ)


def _make_sph(name, **over):
    pkg = PKGS[name][0]
    kw = dict(max_resources=64, max_origins=16, max_flow_rules=16,
              max_degrade_rules=8, max_authority_rules=8)
    kw.update(over)
    extra = {"device": "cpu"} if name == "torch" else {}
    return pkg.Sentinel(config=pkg.load_config(**kw),
                        clock=pkg.ManualClock(start_ms=T0), **extra)


def _tune_counters(sph) -> dict:
    return {k: v for k, v in sph.obs.counters.snapshot().items()
            if k.startswith("tune.")}


def _search_twin(scenario):
    """``scenario(name, knobs, search, clk)`` → SearchResult on both
    packages; the port's result, which must equal the reference's."""
    out = {}
    for name, (_, _, knobs, search, _) in PKGS.items():
        res = scenario(name, knobs, search, ManualClock(start_ms=T0))
        out[name] = (res.best_config, tuple(res.best_outcome),
                     tuple(res.baseline_outcome),
                     [(r.config, r.episode_ms, r.rung, tuple(r.outcome),
                       r.score, r.t_ms) for r in res.history],
                     [tuple(e) for e in res.eliminations], res.converged)
    assert out["torch"] == out["jax"]
    return out["torch"]


def _spec(knobs, env, **over):
    return knobs.KNOB_BY_ENV[env]._replace(**over)


# ------------------------------------------------------------- policy core

def test_synthetic_surface_convergence():
    def scenario(name, knobs, search, clk):
        space = [_spec(knobs, "SENTINEL_PIPELINE_DEPTH", values=(1, 2, 4, 8)),
                 _spec(knobs, "SENTINEL_FRONTEND_BATCH",
                       values=(64, 128, 256))]

        def surface(cfg, episode_ms, rung):
            d = cfg["SENTINEL_PIPELINE_DEPTH"]
            b = cfg["SENTINEL_FRONTEND_BATCH"]
            dps = 1000.0 - 30.0 * abs(d - 4) - 0.5 * abs(b - 128)
            clk.advance_ms(episode_ms)
            return search.TrialOutcome(decisions_per_s=dps, p99_ms=10.0)

        return search.TuneSearch(space, slo_p99_ms=50.0, clock=clk,
                                 rung_ms=(100, 300)).run(surface)

    best, best_o, base_o, hist, _elim, converged = _search_twin(scenario)
    assert converged
    assert best == {"SENTINEL_PIPELINE_DEPTH": 4,
                    "SENTINEL_FRONTEND_BATCH": 128}
    assert best_o[0] >= base_o[0]
    stamps = [h[5] for h in hist]
    assert stamps == sorted(stamps) and stamps[0] > T0


def test_slo_constraint_dominates_throughput():
    def scenario(name, knobs, search, clk):
        space = [_spec(knobs, "SENTINEL_FRONTEND_BATCH", values=(64, 512))]

        def surface(cfg, episode_ms, rung):
            if cfg["SENTINEL_FRONTEND_BATCH"] == 512:
                return search.TrialOutcome(decisions_per_s=5000.0,
                                           p99_ms=80.0)
            return search.TrialOutcome(decisions_per_s=1000.0, p99_ms=9.0)

        return search.TuneSearch(space, slo_p99_ms=50.0, clock=clk,
                                 rung_ms=(100,)).run(surface)

    best = _search_twin(scenario)[0]
    assert best["SENTINEL_FRONTEND_BATCH"] != 512
    for search in (jsearch, tsearch):
        hi = search.score_outcome(search.TrialOutcome(5000.0, 80.0), 50.0)
        lo = search.score_outcome(search.TrialOutcome(1000.0, 9.0), 50.0)
        assert hi < 0 < lo
        assert (hi, lo) == (-30.0, 1000.0)


def test_successive_halving_elimination_order():
    seen = {}

    def scenario(name, knobs, search, clk):
        rungs_seen = seen.setdefault(name, {})
        space = [_spec(knobs, "SENTINEL_PIPELINE_DEPTH", values=(1, 2, 4, 8))]

        def surface(cfg, episode_ms, rung):
            d = cfg["SENTINEL_PIPELINE_DEPTH"]
            rungs_seen.setdefault(d, set()).add(episode_ms)
            return search.TrialOutcome(decisions_per_s=float(100 * d),
                                       p99_ms=5.0)

        return search.TuneSearch(space, slo_p99_ms=50.0, clock=clk,
                                 rung_ms=(100, 400), eta=2).run(surface)

    best, _, _, _, elims, converged = _search_twin(scenario)
    assert converged and best["SENTINEL_PIPELINE_DEPTH"] == 8
    (env0, rung0, surv0, cut0), (_, rung1, surv1, _) = elims
    assert env0 == "SENTINEL_PIPELINE_DEPTH" and rung0 == 0
    assert set(cut0) == {1, 2} and set(surv0) == {8, 4}
    assert rung1 == 1 and surv1 == (8,)
    assert seen["torch"] == seen["jax"]
    assert 400 not in seen["torch"][1]
    for d in (2, 4, 8):
        assert 400 in seen["torch"][d]


def test_parity_failure_disqualifies_and_blocks_convergence():
    def scenario(name, knobs, search, clk):
        space = [_spec(knobs, "SENTINEL_SORTFREE", values=(True, False))]

        def surface(cfg, episode_ms, rung):
            bad = cfg["SENTINEL_SORTFREE"] is False
            return search.TrialOutcome(
                decisions_per_s=9999.0 if bad else 100.0, p99_ms=5.0,
                parity_ok=not bad)

        return search.TuneSearch(space, slo_p99_ms=50.0, clock=clk,
                                 rung_ms=(100,)).run(surface)

    best, _, _, hist, _, converged = _search_twin(scenario)
    assert best["SENTINEL_SORTFREE"] is True
    assert not converged
    assert any(h[4] == tsearch.DISQUALIFIED for h in hist)


def test_trial_memoization_by_config_and_budget():
    calls = {}

    def scenario(name, knobs, search, clk):
        space = [_spec(knobs, "SENTINEL_PIPELINE_DEPTH", values=(2, 4))]
        mine = calls.setdefault(name, [])

        def surface(cfg, episode_ms, rung):
            mine.append((cfg["SENTINEL_PIPELINE_DEPTH"], episode_ms))
            return search.TrialOutcome(decisions_per_s=100.0, p99_ms=5.0)

        return search.TuneSearch(space, slo_p99_ms=50.0, clock=clk,
                                 rung_ms=(100, 300)).run(surface)

    _search_twin(scenario)
    assert calls["torch"] == calls["jax"]
    assert len(calls["torch"]) == len(set(calls["torch"]))


# ---------------------------------------------------------------- artifact

FP = {"backend": "cpu", "device_kind": "cpu", "n_devices_visible": 1,
      "host_cores": 4,
      "mesh": {"n_devices": 1, "axis": None, "sharded": False}}


def test_tuned_json_round_trip(tmp_path):
    docs, files = {}, {}
    for name, (_, art, _, _, _) in PKGS.items():
        p = str(tmp_path / f"{name}.json")
        doc = art.save_tuned(
            p, fingerprint=FP,
            knob_values={"SENTINEL_PIPELINE_DEPTH": 4,
                         "SENTINEL_FRONTEND_BATCH": 999999},
            score={"decisions_per_s": 1200.0, "p99_ms": 8.0},
            baseline={"decisions_per_s": 1000.0, "p99_ms": 9.0},
            slo_p99_ms=50.0, workload={"name": "steady", "seed": 11},
            trials=12, parity_checks=3)
        assert doc["knobs"]["SENTINEL_FRONTEND_BATCH"] == 1 << 16
        back = art.load_tuned(p)
        assert back == doc
        assert art.overrides_for(back, FP) == doc["knobs"]
        docs[name], files[name] = doc, open(p, "rb").read()
    assert docs["torch"] == docs["jax"]
    assert files["torch"] == files["jax"]        # byte for byte


def test_load_tuned_rejects_bad_schema_and_unknown_knobs(tmp_path):
    p = tmp_path / "bad.json"
    for art in (jart, tart):
        p.write_text(json.dumps({"schema": "something/9", "knobs": {}}))
        with pytest.raises(ValueError, match="schema"):
            art.load_tuned(str(p))
        p.write_text(json.dumps({"schema": art.SCHEMA,
                                 "knobs": {"SENTINEL_EVIL": 1},
                                 "fingerprint": {}}))
        with pytest.raises(ValueError, match="SENTINEL_EVIL"):
            art.load_tuned(str(p))
    assert tart.SCHEMA == jart.SCHEMA
    assert tart.TUNED_CONFIG_ENV == jart.TUNED_CONFIG_ENV


def test_fingerprint_mismatch_falls_back_to_defaults(tmp_path):
    got = {}
    for name, (_, art, _, _, keys) in PKGS.items():
        p = str(tmp_path / f"{name}.json")
        fp = _fp(name)
        art.save_tuned(
            p, fingerprint=dict(fp, device_kind="TPU v9"),
            knob_values={"SENTINEL_PIPELINE_DEPTH": 8},
            score={}, baseline={}, slo_p99_ms=50.0, workload={}, trials=1,
            parity_checks=1)
        doc = art.load_tuned(p)
        assert art.overrides_for(doc, fp) is None
        overrides, events = _startup(name, {art.TUNED_CONFIG_ENV: p})
        assert overrides == {}
        assert keys.TUNE_FALLBACK in [k for k, _ in events]
        prov = (art.provenance(environ={art.TUNED_CONFIG_ENV: p})
                if name == "jax" else
                art.provenance("cpu", environ={art.TUNED_CONFIG_ENV: p}))
        assert prov["tuned"] is False
        assert "device_kind" in str(prov["fingerprint_mismatch"])
        got[name] = ([(k, m.replace(p, "<path>")) for k, m in events],
                     prov["fingerprint_mismatch"])
    assert got["torch"] == got["jax"]


def test_env_beats_artifact_per_knob(tmp_path):
    got = {}
    for name, (_, art, _, _, keys) in PKGS.items():
        p = str(tmp_path / f"{name}.json")
        art.save_tuned(
            p, fingerprint=_fp(name),
            knob_values={"SENTINEL_PIPELINE_DEPTH": 8,
                         "SENTINEL_FRONTEND_BATCH": 128},
            score={}, baseline={}, slo_p99_ms=50.0, workload={}, trials=1,
            parity_checks=1)
        overrides, events = _startup(name, {
            art.TUNED_CONFIG_ENV: p, "SENTINEL_PIPELINE_DEPTH": "2"})
        assert overrides == {"SENTINEL_FRONTEND_BATCH": 128}
        assert keys.TUNE_LOADED in [k for k, _ in events]
        got[name] = (overrides, [(k, m.replace(p, "<path>"))
                                 for k, m in events])
    assert got["torch"] == got["jax"]


def _artifact(name, path, knobs, **fp_over):
    PKGS[name][1].save_tuned(
        path, fingerprint=dict(_fp(name), **fp_over), knob_values=knobs,
        score={}, baseline={}, slo_p99_ms=50.0, workload={}, trials=1,
        parity_checks=1)


def test_sentinel_startup_loads_and_falls_back(tmp_path, monkeypatch):
    """At construction: a matching artifact fills ``_tuned``, ticks
    tune.config_loaded and sets DispatchPipeline's default depth; a
    mismatched one leaves defaults and ticks tune.fingerprint_fallback."""
    from sentinel_tpu import runtime as jrt
    from sentinel_tpu import serving as jserving
    from sentinel_tpu_torch import runtime as trt
    from sentinel_tpu_torch import serving as tserving
    serving = {"jax": (jserving, jrt), "torch": (tserving, trt)}
    got = {}
    for name in PKGS:
        good = str(tmp_path / f"good_{name}.json")
        _artifact(name, good, {"SENTINEL_PIPELINE_DEPTH": 4})
        bad = str(tmp_path / f"bad_{name}.json")
        _artifact(name, bad, {"SENTINEL_PIPELINE_DEPTH": 4},
                  host_cores=10_000)
        srv, rt = serving[name]
        runs = []
        for path in (good, bad):
            monkeypatch.setenv(jart.TUNED_CONFIG_ENV, path)
            sph = _make_sph(name)
            try:
                runs.append((dict(sph._tuned), _tune_counters(sph),
                             srv.DispatchPipeline(sph).depth,
                             rt.pipeline_depth()))
            finally:
                sph.close()
        got[name] = runs
    assert got["torch"] == got["jax"]
    (tuned, counters, depth, _), (tuned_b, counters_b, depth_b, dflt) = \
        got["torch"]
    assert tuned == {"SENTINEL_PIPELINE_DEPTH": 4} and depth == 4
    assert counters == {tck.TUNE_LOADED: 1}
    assert tuned_b == {} and depth_b == dflt
    assert counters_b == {tck.TUNE_FALLBACK: 1}


def test_frontend_kwarg_precedence(tmp_path, monkeypatch):
    """kwarg > env > artifact for Sentinel.frontend()'s batcher knobs."""
    monkeypatch.setenv("SENTINEL_FRONTEND_DEADLINE_MS", "15")   # env pin
    got = {}
    for name in PKGS:
        p = str(tmp_path / f"{name}.json")
        _artifact(name, p, {"SENTINEL_FRONTEND_BATCH": 128,
                            "SENTINEL_FRONTEND_DEADLINE_MS": 40,
                            "SENTINEL_FRONTEND_BUDGET_MS": 5,
                            "SENTINEL_PIPELINE_DEPTH": 8})
        monkeypatch.setenv(jart.TUNED_CONFIG_ENV, p)
        sph = _make_sph(name)
        try:
            fe = sph.frontend(budget_ms=7)       # explicit kwarg pin
            try:
                got[name] = (fe.batch_max, fe.deadline_ms, fe.budget_ms,
                             fe.idle_ms, fe.queue.queue_max, fe.depth,
                             _tune_counters(sph))
            finally:
                fe.close()
        finally:
            sph.close()
    assert got["torch"] == got["jax"]
    batch, deadline, budget, _idle, _q, depth, _c = got["torch"]
    assert (batch, deadline, budget, depth) == (128, 15, 7, 8)


# ---------------------------------------------------------- env validation

def test_validate_environ_findings():
    env = {
        "SENTINEL_FRONTEND_BATHC": "512",
        "SENTINEL_PIPELINE_DEPTH": "999",
        "SENTINEL_DONATE": "nope",
        "SENTINEL_TRACE_SAMPLE": "abc",
        "SENTINEL_FRONTEND_BATCH": "256",
        "SENTINEL_OBS_DISABLE": "1",
        "UNRELATED": "x",
    }
    warns = tknobs.validate_environ(env)
    assert warns == jknobs.validate_environ(env)
    assert len(warns) == 4
    joined = "\n".join(warns)
    assert "did you mean SENTINEL_FRONTEND_BATCH?" in joined
    assert "SENTINEL_PIPELINE_DEPTH" in joined and "[1, 64]" in joined
    assert "boolean spelling" in joined
    assert "SENTINEL_TRACE_SAMPLE" in joined
    assert tknobs.known_envs() == jknobs.known_envs()


def test_startup_warns_on_bad_env_knob(monkeypatch):
    monkeypatch.setenv("SENTINEL_FRONTEND_DEADLINE_MS", "0")  # below clamp
    monkeypatch.setenv("SENTINEL_PIPLINE_DEPTH", "4")         # a typo
    got = {}
    for name in PKGS:
        sph = _make_sph(name)
        try:
            got[name] = _tune_counters(sph)
        finally:
            sph.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][tck.TUNE_KNOB_REJECTED] >= 2


# ------------------------------------------------------------- anti-drift

def _fields(spec):
    return spec._replace(doc="")


def test_registry_matches_runtime_clamps(monkeypatch):
    """The port's registry is the reference's (every field but the one-line
    doc), and every KnobSpec's parse() agrees with the PORT's read-site
    helper under extreme env values. ``SENTINEL_DONATE`` and
    ``SENTINEL_SORTFREE_CHUNK`` have no read site in the port (no buffer
    donation, no claim-scan chunk): they are pinned by the registry
    equality alone."""
    from sentinel_tpu_torch.control.loop import (
        control_cooldown_ms, control_degrade_rt_ms, control_interval_ms,
        control_min_admit, control_p99_hi_ms, control_p99_lo_ms,
    )
    from sentinel_tpu_torch.frontend.batcher import (
        frontend_batch_max, frontend_budget_ms, frontend_deadline_ms,
        frontend_idle_ms,
    )
    from sentinel_tpu_torch.obs.resource_hist import (
        resource_hist_buckets, resource_hist_disabled,
    )
    from sentinel_tpu_torch.ops.sortfree import table_bits
    from sentinel_tpu_torch.runtime import (
        host_staging_enabled, pipeline_depth, single_dispatch_enabled,
        sortfree_enabled,
    )
    from sentinel_tpu_torch.tiering.manager import (
        tier_hot_rows, tier_sketch_bits, tier_sketch_rows, tier_tick_ms,
    )
    assert [_fields(k) for k in tknobs.KNOBS] == \
        [_fields(k) for k in jknobs.KNOBS]
    assert tknobs.FRONTEND_KWARG_ENVS == jknobs.FRONTEND_KWARG_ENVS
    assert tknobs.OPERATIONAL_ENVS == jknobs.OPERATIONAL_ENVS
    numeric = {
        "SENTINEL_PIPELINE_DEPTH": pipeline_depth,
        "SENTINEL_FRONTEND_BATCH": frontend_batch_max,
        "SENTINEL_FRONTEND_DEADLINE_MS": frontend_deadline_ms,
        "SENTINEL_FRONTEND_BUDGET_MS": frontend_budget_ms,
        "SENTINEL_FRONTEND_IDLE_MS": frontend_idle_ms,
        "SENTINEL_SORTFREE_BITS": lambda: table_bits(4096),
        "SENTINEL_HOT_ROWS": tier_hot_rows,
        "SENTINEL_SKETCH_BITS": tier_sketch_bits,
        "SENTINEL_SKETCH_ROWS": tier_sketch_rows,
        "SENTINEL_TIER_TICK_MS": tier_tick_ms,
        "SENTINEL_CONTROL_INTERVAL_MS": control_interval_ms,
        "SENTINEL_CONTROL_P99_HI_MS": control_p99_hi_ms,
        "SENTINEL_CONTROL_P99_LO_MS": control_p99_lo_ms,
        "SENTINEL_CONTROL_MIN_ADMIT": control_min_admit,
        "SENTINEL_CONTROL_COOLDOWN_MS": control_cooldown_ms,
        "SENTINEL_CONTROL_DEGRADE_RT_MS": control_degrade_rt_ms,
        "SENTINEL_RESOURCE_HIST_BUCKETS": resource_hist_buckets,
    }
    for env, helper in numeric.items():
        spec = tknobs.KNOB_BY_ENV[env]
        for raw in ("-1000000", "0", "3", "999999999"):
            monkeypatch.setenv(env, raw)
            expect, _ok = spec.parse(raw)
            if env == "SENTINEL_SORTFREE_BITS" and raw == "0":
                expect = 1
            assert helper() == expect, (env, raw)
        monkeypatch.delenv(env)
        if spec.default is not None:
            assert helper() == spec.default, env
    booleans = {
        "SENTINEL_HOST_STAGING": host_staging_enabled,
        "SENTINEL_SORTFREE": sortfree_enabled,
        "SENTINEL_SINGLE_DISPATCH": single_dispatch_enabled,
        "SENTINEL_RESOURCE_HIST_DISABLE": resource_hist_disabled,
    }
    for env, helper in booleans.items():
        spec = tknobs.KNOB_BY_ENV[env]
        for raw in ("0", "off", "FALSE", "1", "on", "weird"):
            monkeypatch.setenv(env, raw)
            expect, _ok = spec.parse(raw)
            assert helper() == expect, (env, raw)
        monkeypatch.delenv(env)
        assert helper() == spec.default, env
    pinned = set(numeric) | set(booleans) | {
        "SENTINEL_DONATE", "SENTINEL_SORTFREE_CHUNK",
        "SENTINEL_FRONTEND_QUEUE"}
    assert pinned == set(tknobs.KNOB_BY_ENV)


def test_env_overrides_context_restores():
    key = "SENTINEL_PIPELINE_DEPTH"
    assert key not in os.environ
    for knobs in (jknobs, tknobs):
        with knobs.env_overrides({key: 7, "SENTINEL_DONATE": False,
                                  "SENTINEL_FRONTEND_IDLE_MS": 0.5}):
            assert os.environ[key] == "7"
            assert os.environ["SENTINEL_DONATE"] == "0"
            assert os.environ["SENTINEL_FRONTEND_IDLE_MS"] == "0.5"
        assert key not in os.environ and "SENTINEL_DONATE" not in os.environ
    cfg = {key: 7, "SENTINEL_SORTFREE": True, "SENTINEL_FRONTEND_IDLE_MS": 2}
    assert tknobs.env_strings(cfg) == jknobs.env_strings(cfg)
    assert tknobs.trace_knobs(cfg) == jknobs.trace_knobs(cfg)
    assert tknobs.coerce_config(cfg) == jknobs.coerce_config(cfg)


# ------------------------------------------------------- cross-package

def test_tuned_json_loads_across_packages(tmp_path, monkeypatch):
    """An artifact saved by either package loads in the other with equal
    knobs; at startup each falls back on the other's fingerprint
    (``n_devices_visible``: 8 virtual JAX CPUs against the port's one
    device), with one tune.fingerprint_fallback tick each."""
    knobs = {"SENTINEL_PIPELINE_DEPTH": 4, "SENTINEL_FRONTEND_BATCH": 512,
             "SENTINEL_FRONTEND_IDLE_MS": 2.0, "SENTINEL_SORTFREE": True}
    paths = {}
    for name in PKGS:
        paths[name] = str(tmp_path / f"{name}.json")
        _artifact(name, paths[name], knobs)
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        doc = PKGS[reader][1].load_tuned(paths[writer])
        assert doc == PKGS[writer][1].load_tuned(paths[writer])
        assert doc["knobs"] == knobs
        ok, why = PKGS[reader][1].fingerprints_match(doc["fingerprint"],
                                                    _fp(reader))
        assert not ok and why.startswith("n_devices_visible")
        monkeypatch.setenv(jart.TUNED_CONFIG_ENV, paths[writer])
        sph = _make_sph(reader)
        try:
            assert sph._tuned == {}
            assert _tune_counters(sph) == {tck.TUNE_FALLBACK: 1}
        finally:
            sph.close()
    # with the reader's own device count filled in, both documents apply
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        doc = json.loads(open(paths[writer]).read())
        doc["fingerprint"] = _fp(reader)
        fixed = str(tmp_path / f"{writer}_for_{reader}.json")
        open(fixed, "w").write(json.dumps(doc))
        overrides, _ = _startup(reader, {jart.TUNED_CONFIG_ENV: fixed})
        assert overrides == knobs


def test_serving_trial_runner_one_real_trial():
    """One real 150 ms trial through the port's serving path on the CPU:
    a measured outcome, the parity spot-check against the defaults, and
    the tune.trial tick."""
    from sentinel_tpu_torch.tune.runner import ServingTrialRunner
    runner = ServingTrialRunner(workload="steady", seed=11, rate_rps=2000.0,
                                device="cpu")
    out = runner({"SENTINEL_PIPELINE_DEPTH": 2,
                  "SENTINEL_FRONTEND_BATCH": 64}, 150, 0)
    assert out.parity_ok
    assert out.meta["completed"] > 0 and out.meta["shed"] == 0
    assert out.meta["completed"] == pytest.approx(out.decisions_per_s * 0.150)
    assert out.p99_ms is not None and out.p99_ms > 0
    assert runner.trials == 1 and runner.parity_checks == 1
    assert runner.counters.snapshot() == {tck.TUNE_TRIAL: 1}


def test_cli_takes_the_reference_flags(capsys):
    """``python -m sentinel_tpu_torch.tune`` offers every flag of
    ``python -m sentinel_tpu.tune`` with the same defaults, plus
    ``--device``."""
    import re

    from sentinel_tpu.tune import __main__ as jcli
    from sentinel_tpu_torch.tune import __main__ as tcli

    def flags(cli):
        with pytest.raises(SystemExit):
            cli.main(["--help"])
        text = capsys.readouterr().out
        return dict(re.findall(r"(--[a-z0-9-]+)[^\n]*?(?:\(default ([^)]*)\))?"
                               r"\n", text))

    jflags, tflags = flags(jcli), flags(tcli)
    assert set(tflags) == set(jflags) | {"--device"}
    assert {k: tflags[k] for k in jflags} == jflags


def test_fingerprint_mesh_block_and_meshed_startup(tmp_path, monkeypatch):
    """The fingerprint's ``mesh`` block of a row-sharded engine is the
    reference's for the same geometry — from ``mesh_topology`` with the
    engine's geometry, from the mesh alone without it — and the round
    trip keeps it; a meshed runtime loads an artifact swept on its own
    layout and falls back on another's, naming ``mesh.n_devices``, with
    counters equal to the JAX meshed runtime's."""
    from sentinel_tpu.parallel import local_shard as jls
    from sentinel_tpu_torch.parallel import local_shard as tls
    jm = jls.local_mesh(8)
    tm = tls.local_mesh(devices=[torch.device("cpu")] * 8)
    cfg = dict(max_resources=64, max_flow_rules=8, max_degrade_rules=8,
               max_authority_rules=8, host_fast_path=False)
    js = stpu.Sentinel(stpu.load_config(**cfg),
                       clock=stpu.ManualClock(start_ms=T0))
    ts = stt.Sentinel(stt.load_config(**cfg), clock=ManualClock(start_ms=T0),
                      device="cpu")
    want = {"n_devices": 8, "axis": "rows", "sharded": True}
    for spec_j, spec_t in ((js.spec, ts.spec), (None, None)):
        fj = jart.fingerprint(spec_j, jm)
        ft = tart.fingerprint(mesh=tm, spec=spec_t)
        assert ft["mesh"] == fj["mesh"] == want
        assert ft["backend"] == "cpu" and ft["n_devices_visible"] == 1
    assert tart.fingerprint("cpu")["mesh"] == jart.fingerprint()["mesh"] \
        == {"n_devices": 1, "axis": None, "sharded": False}
    js.close()
    ts.close()
    got = {}
    for name, (pkg, art, _, _, keys) in PKGS.items():
        mesh = jm if name == "jax" else tm
        live = (art.fingerprint(None, mesh) if name == "jax"
                else art.fingerprint(mesh=mesh))
        good, other = (str(tmp_path / f"{name}_{k}.json")
                       for k in ("good", "other"))
        for path, fp in ((good, live), (other, dict(
                live, mesh={"n_devices": 1, "axis": None,
                            "sharded": False}))):
            art.save_tuned(path, fingerprint=fp,
                           knob_values={"SENTINEL_PIPELINE_DEPTH": 4},
                           score={}, baseline={}, slo_p99_ms=50.0,
                           workload={}, trials=1, parity_checks=1)
            assert art.load_tuned(path)["fingerprint"]["mesh"] == fp["mesh"]
        runs = []
        for path in (good, other):
            monkeypatch.setenv(art.TUNED_CONFIG_ENV, path)
            sph = pkg.Sentinel(pkg.load_config(**cfg),
                               clock=pkg.ManualClock(start_ms=T0),
                               mesh=mesh)
            try:
                prov = (art.provenance(None, mesh) if name == "jax"
                        else art.provenance(mesh=mesh))
                runs.append((dict(sph._tuned), _tune_counters(sph),
                             prov["tuned"],
                             prov.get("fingerprint_mismatch")))
            finally:
                sph.close()
        got[name] = runs
    assert got["torch"] == got["jax"]
    (tuned, counters, prov_ok, _), (tuned_b, counters_b, prov_b, why) = \
        got["torch"]
    assert tuned == {"SENTINEL_PIPELINE_DEPTH": 4} and prov_ok
    assert counters == {tck.TUNE_LOADED: 1}
    assert tuned_b == {} and counters_b == {tck.TUNE_FALLBACK: 1}
    assert not prov_b and why.startswith("mesh.n_devices")
