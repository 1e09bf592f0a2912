"""Port parity: the Prometheus exporter (``sentinel_tpu_torch.metrics.
exporter``) against ``sentinel_tpu``'s.

Twins of the 7 tests of ``tests/test_exporter.py``, of the exporter and
heartbeat tests of ``tests/test_obs.py`` (``test_prometheus_obs_families``,
``test_heartbeat_advertises_exporter_port``) and of
``tests/test_tracing.py::test_every_catalog_key_reaches_prometheus``.
Each scenario runs on twin runtimes (twin ManualClocks; the port on the
CPU), each scraped through its own package's exporter into a private
``CollectorRegistry``. The scrapes must name the same families and carry
the same samples, exactly, less the families of the ``compile_cache.*``
and ``tune.*`` counters: the reference's XLA program cache and autotuner,
which the port does not have (its families export 0; the same two
families ``tests/test_torch_obs.py`` leaves out). There is no tolerance.
"""

import urllib.request

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.metrics import exporter as jexp
from sentinel_tpu.obs import counters as jck
from sentinel_tpu.transport import heartbeat as jhb
from sentinel_tpu_torch.metrics import exporter as texp
from sentinel_tpu_torch.obs import counters as tck
from sentinel_tpu_torch.transport import heartbeat as thb

prometheus_client = pytest.importorskip("prometheus_client")
from prometheus_client import CollectorRegistry, generate_latest  # noqa: E402

torch.set_num_threads(2)

T0 = 1_785_000_000_000
PKGS = {"jax": (stpu, jexp, jck), "torch": (stt, texp, tck)}
#: the families the comparison leaves out (see the module docstring)
EXCLUDED = ("sentinel_compile_cache_", "sentinel_tune")
CFG = dict(max_resources=64, max_flow_rules=16, max_degrade_rules=16,
           max_authority_rules=16)


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))


def _make(name, **over):
    pkg = PKGS[name][0]
    extra = {"device": "cpu"} if name == "torch" else {}
    sph = pkg.Sentinel(config=pkg.load_config(**{**CFG, **over}),
                       clock=pkg.ManualClock(start_ms=T0), **extra)
    sph._cpu.sample = lambda: (0.5, 0.25)
    return sph


def samples(registry):
    """(family names, samples) of one scrape, less the excluded
    families' samples."""
    fams = list(registry.collect())
    return (sorted(f.name for f in fams),
            sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                   for f in fams if not f.name.startswith(EXCLUDED)
                   for s in f.samples))


def _text(registry) -> str:
    """The exposition text, less the excluded families' lines."""
    return "\n".join(
        ln for ln in generate_latest(registry).decode("utf-8").splitlines()
        if not any(f" {x}" in ln or ln.startswith(x) for x in EXCLUDED))


def twin(scenario, **over):
    """``scenario(pkg, exporter_mod, ck, sph, registry)`` on both packages
    → the port's observations, equal to the reference's."""
    got = {}
    for name, (pkg, exp, ck) in PKGS.items():
        sph = _make(name, **over)
        try:
            got[name] = scenario(pkg, exp, ck, sph, CollectorRegistry())
        finally:
            sph.close()
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_exporter_reports_pass_block_and_breaker():
    def sc(pkg, exp_mod, ck, sph, registry):
        exp = exp_mod.PrometheusExporter(sph, registry=registry)
        try:
            sph.load_flow_rules([pkg.FlowRule(resource="svc", count=2)])
            sph.load_degrade_rules([pkg.DegradeRule(
                resource="svc", grade=pkg.GRADE_EXCEPTION_RATIO, count=0.5,
                time_window=10)])
            for _ in range(4):
                try:
                    with sph.entry("svc"):
                        pass
                except pkg.BlockException:
                    pass
            return [samples(registry), _text(registry)]
        finally:
            exp.close()
    text = twin(sc)[1]
    assert 'sentinel_pass_qps{resource="svc"} 2.0' in text
    assert 'sentinel_block_qps{resource="svc"} 2.0' in text
    assert 'sentinel_breaker_state{resource="svc"} 0.0' in text


def test_exporter_http_endpoint():
    def sc(pkg, exp_mod, ck, sph, registry):
        exp = exp_mod.PrometheusExporter(sph, registry=registry)
        try:
            with sph.entry("ping"):
                pass
            exp.serve(port=0, addr="127.0.0.1")
            port = exp._server.server_address[1]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics") as r:
                body = r.read().decode("utf-8")
            return [ln for ln in body.splitlines()
                    if ln.startswith("sentinel_pass_qps")
                    or ln.startswith("sentinel_block_qps")]
        finally:
            exp.close()
    assert 'sentinel_pass_qps{resource="ping"} 1.0' in twin(sc)


def test_exporter_unregister_is_idempotent():
    def sc(pkg, exp_mod, ck, sph, registry):
        exp = exp_mod.PrometheusExporter(sph, registry=registry)
        exp.close()
        exp.close()
        return "sentinel_pass_qps" in _text(registry)
    assert twin(sc) is False


def test_breaker_states_dedup_per_resource():
    def sc(pkg, exp_mod, ck, sph, registry):
        exp = exp_mod.PrometheusExporter(sph, registry=registry)
        try:
            sph.load_degrade_rules([
                pkg.DegradeRule(resource="svc", grade=pkg.GRADE_RT,
                                count=50, time_window=10),
                pkg.DegradeRule(resource="svc",
                                grade=pkg.GRADE_EXCEPTION_RATIO,
                                count=0.5, time_window=10),
            ])
            return [samples(registry), _text(registry).count(
                'sentinel_breaker_state{resource="svc"}')]
        finally:
            exp.close()
    assert twin(sc)[1] == 1


def test_describe_avoids_collect_on_register():
    def sc(pkg, exp_mod, ck, sph, registry):
        calls = []
        orig = sph.all_node_totals
        sph.all_node_totals = lambda: calls.append(1) or orig()
        exp = exp_mod.PrometheusExporter(sph, registry=registry)
        try:
            return [list(calls), sorted(
                f.name for f in exp.collector.describe())]
        finally:
            exp.close()
    assert twin(sc)[0] == []


def test_label_cardinality_cap_keeps_hottest_and_counts():
    def sc(pkg, exp_mod, ck, sph, registry):
        exp = exp_mod.PrometheusExporter(sph, registry=registry,
                                         label_cap=4)
        try:
            for i in range(10):          # r00 coldest … r09 hottest
                for _ in range(i + 1):
                    with sph.entry(f"r{i:02d}"):
                        pass
            first = samples(registry)
            return [first, sph.obs.counters.get(ck.EXPORTER_LABEL_OVERFLOW),
                    samples(registry)]
        finally:
            exp.close()
    first, dropped, second = twin(sc)
    text = [s for s in first[1] if s[0] == "sentinel_pass_qps"]
    assert [dict(s[1])["resource"] for s in text] == [
        "__entry_node__", "r07", "r08", "r09"]
    assert dropped == 7            # after the first scrape
    assert second[1] != first[1]   # the overflow counter moved


def test_resource_qps_family_is_topk_bounded():
    def sc(pkg, exp_mod, ck, sph, registry):
        exp = exp_mod.PrometheusExporter(sph, registry=registry)
        try:
            for i in range(30):
                for _ in range(2 if i else 9):
                    with sph.entry(f"res-{i:02d}"):
                        pass
            sph.telemetry.poll()
            text = _text(registry)
            lines = [ln for ln in text.splitlines()
                     if ln.startswith("sentinel_resource_qps{")]
            return [samples(registry), lines, sph.telemetry.k,
                    'sentinel_telemetry_total{event="tick"} 1.0' in text]
        finally:
            exp.close()
    _s, lines, k, tick = twin(sc)
    assert lines and len(lines) <= k and tick
    assert any('resource="res-00"' in ln for ln in lines)


def test_prometheus_obs_families():
    """``tests/test_obs.py::test_prometheus_obs_families``: a split batch
    twice (scalar and origin sides), the obs families scraped, then the
    runtime's close unregisters the collector."""
    def sc(pkg, exp_mod, ck, sph, registry):
        rng = np.random.default_rng(9)
        sph.load_flow_rules([
            pkg.FlowRule(resource="api", count=100.0),
            pkg.FlowRule(resource="api", count=3.0, limit_app="app-a")])
        resources = ["api"] * 8192
        origins = ["app-a" if x else "" for x in (rng.random(8192) < 0.1)]
        exporter = exp_mod.PrometheusExporter(sph, registry=registry)
        sph.entry_batch(resources, origins=origins)
        sph.clock.advance_ms(20)
        sph.entry_batch(resources, origins=origins)
        got = samples(registry)
        text = _text(registry)
        sph.close()
        after = _text(registry)
        exporter.close()
        return [got, [m for m in (
            'sentinel_split_route_total{route="split_fired"} 2.0',
            "sentinel_rt_p99_ms",
            'sentinel_rt_quantile_ms{quantile="0.99"}',
            'sentinel_block_reason_total{reason="FlowException"}')
            if m in text], "sentinel_split_route_total" in after]
    got = twin(sc, max_origins=32, host_fast_path=False)
    assert len(got[1]) == 4 and got[2] is False


def test_heartbeat_advertises_exporter_port():
    out = {}
    for name, hb in (("jax", jhb), ("torch", thb)):
        a = hb.HeartbeatSender("127.0.0.1:9999", app_name="a",
                               exporter_port=9464).message()
        b = hb.HeartbeatSender("127.0.0.1:9999", app_name="a").message()
        for m in (a, b):
            m.pop("heartbeatVersion", None)
            m.pop("version", None)
        out[name] = (a, b)
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["exporterPort"] == "9464"
    assert "exporterPort" not in out["torch"][1]


def test_every_catalog_key_reaches_prometheus():
    """``tests/test_tracing.py``'s guard on the port: every CATALOG key,
    each given a distinct value, surfaces in some scraped sample, and
    the two scrapes agree sample for sample (the excluded families
    compared on their names only)."""
    def sc(pkg, exp_mod, ck, sph, registry):
        exp_mod.PrometheusExporter(sph, registry=registry)
        want = {}
        for i, key in enumerate(ck.CATALOG):
            sph.obs.counters.add(key, 100_000 + i)
            want[key] = float(100_000 + i)
        exported = {s.value for fam in registry.collect()
                    for s in fam.samples}
        return [samples(registry), sorted(k for k, v in want.items()
                                          if v not in exported)]
    assert list(jck.CATALOG) == list(tck.CATALOG)
    got = twin(sc)
    assert got[1] == [], f"CATALOG keys reached no family: {got[1]}"


def test_missing_client_raises_naming_the_package(monkeypatch):
    """Without ``prometheus_client`` the port's exporter raises an
    ImportError that names the package; the rest of the port never
    needs it."""
    sph = _make("torch")
    try:
        monkeypatch.setattr(texp, "GaugeMetricFamily", None)
        for build in (lambda: texp.SentinelCollector(sph),
                      lambda: texp.PrometheusExporter(
                          sph, registry=CollectorRegistry())):
            with pytest.raises(ImportError, match="prometheus_client"):
                build()
    finally:
        sph.close()
