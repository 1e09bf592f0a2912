"""Port parity: the dashboard's UI ⇄ server contract, twin of
``tests/test_ui_contract.py`` on ``sentinel_tpu_torch.dashboard``.

The port serves the reference's single-page app byte for byte. Pinned
here: the three static files equal the JAX package's; every URL path the
port's SPA references matches a route of the port's server; every field
of the SPA's rule editors survives the port's codec canonicalization, to
the same dict the JAX dashboard stores; the port's metric parser skips the
agent's elision marker as the reference's does.
"""

import dataclasses
import json
import re
from pathlib import Path

import pytest

from sentinel_tpu.dashboard import server as jserver
from sentinel_tpu_torch.dashboard import client as tclient
from sentinel_tpu_torch.dashboard import server as tserver
from sentinel_tpu_torch.metrics.node import MetricNode

REPO = Path(__file__).resolve().parent.parent
STATIC = REPO / "sentinel_tpu_torch" / "dashboard" / "static"
JAX_STATIC = REPO / "sentinel_tpu" / "dashboard" / "static"
SERVER_SRC = (REPO / "sentinel_tpu_torch" / "dashboard"
              / "server.py").read_text()
APP_JS = (STATIC / "app.js").read_text()


@pytest.mark.parametrize("name", ["index.html", "app.js", "style.css"])
def test_static_file_byte_equal_to_reference(name):
    assert (STATIC / name).read_bytes() == (JAX_STATIC / name).read_bytes()


def test_static_dir_resolves_to_the_port():
    assert tserver._STATIC_DIR == STATIC
    assert sorted(p.name for p in STATIC.iterdir()) == sorted(
        p.name for p in JAX_STATIC.iterdir())


def _served_paths():
    """Literal paths + regex routes from the port's server source."""
    literals = set(re.findall(r'path == "([^"]+)"', SERVER_SRC))
    literals |= {m for m in re.findall(r'path in \(([^)]+)\)', SERVER_SRC)
                 for m in re.findall(r'"([^"]+)"', m)}
    patterns = [re.compile(p) for p in
                re.findall(r're\.fullmatch\(r"([^"]+)"', SERVER_SRC)]
    return literals, patterns


def _spa_paths():
    """URL paths the SPA fetches (template params normalized)."""
    raw = set(re.findall(r'[`"](/[A-Za-z0-9_./${}()-]*)[`"?]', APP_JS))
    raw |= set(re.findall(r'[`"](/[A-Za-z0-9_./${}()-]*)\?', APP_JS))
    out = set()
    for p in raw:
        p = re.sub(r"\$\{[^}]*\}", "X", p)     # ${...} → X
        if p in ("/", "/static/app.js", "/static/style.css"):
            continue
        out.add(p)
    return sorted(out)


def test_every_spa_path_is_served():
    literals, patterns = _served_paths()
    assert literals and patterns
    missing = []
    for p in _spa_paths():
        if p in literals:
            continue
        candidates = [p, p.replace("/v1/X/", "/v1/flow/"),
                      p.replace("/v1/X/", "/v1/flow/").replace("/rule/X",
                                                               "/rule/1")]
        if p.startswith("/app/"):
            candidates.append(p.replace("/app/X/", "/app/anyapp/"))
        if any(pat.fullmatch(c) for pat in patterns for c in candidates):
            continue
        missing.append(p)
    assert not missing, f"SPA references unserved paths: {missing}"


def test_port_serves_the_reference_routes():
    """The port's route table is the reference's: the same literal paths
    and the same regex routes, in the same order."""
    jsrc = Path(jserver.__file__).read_text()
    for pattern in (r'path == "([^"]+)"', r're\.fullmatch\(r"([^"]+)"'):
        assert re.findall(pattern, SERVER_SRC) == re.findall(pattern, jsrc)


def _schema_fields():
    """rtype → top-level field names from the SPA's SCHEMAS block."""
    m = re.search(r"const SCHEMAS = \{(.*?)\n\};", APP_JS, re.S)
    assert m, "SCHEMAS block not found in app.js"
    out = {}
    for tm in re.finditer(r"\n  (\w+): \[(.*?)\n  \],", m.group(1), re.S):
        fields = set()
        for fm in re.finditer(r'(?<![A-Za-z])n: "([^"]+)"', tm.group(2)):
            if not fm.group(1).startswith("_"):
                fields.add(fm.group(1).split(".")[0])
        out[tm.group(1)] = fields
    return out


SAMPLES = {
    "flow": {"resource": "r", "limitApp": "default", "grade": 1, "count": 1,
             "strategy": 1, "refResource": "other", "controlBehavior": 3,
             "warmUpPeriodSec": 10, "maxQueueingTimeMs": 500,
             "clusterMode": True, "clusterConfig": {"flowId": 1}},
    "degrade": {"resource": "r", "grade": 0, "count": 0.5,
                "slowRatioThreshold": 0.6, "timeWindow": 10,
                "minRequestAmount": 5, "statIntervalMs": 1000},
    "paramFlow": {"resource": "r", "paramIdx": 0, "grade": 1, "count": 1,
                  "durationInSec": 1, "burstCount": 0, "controlBehavior": 2,
                  "maxQueueingTimeMs": 100, "clusterMode": True,
                  "clusterConfig": {"flowId": 2},
                  "paramFlowItemList": [{"object": "v", "count": 1,
                                         "classType": "String"}]},
    "system": {"highestSystemLoad": 1.0, "highestCpuUsage": 0.5, "qps": 10,
               "avgRt": 5, "maxThread": 8},
    "authority": {"resource": "r", "limitApp": "a,b", "strategy": 0},
    "gatewayFlow": {"resource": "route", "resourceMode": 0, "grade": 1,
                    "count": 1, "intervalSec": 1, "controlBehavior": 2,
                    "burst": 0, "maxQueueingTimeoutMs": 100,
                    "paramItem": {"parseStrategy": 2, "fieldName": "H",
                                  "pattern": "x", "matchStrategy": 0}},
    "gatewayApi": {"apiName": "api", "predicateItems": [
        {"pattern": "/x/**", "matchStrategy": 1}]},
}


@pytest.mark.parametrize("rtype", sorted(SAMPLES))
def test_editor_fields_survive_codec_roundtrip(rtype):
    assert rtype in tserver.RULE_TYPES
    fields = _schema_fields()[rtype]
    assert fields, f"no fields scraped for {rtype}"
    canonical = tserver.Dashboard._canonical(
        rtype, json.loads(json.dumps(SAMPLES[rtype])))
    dropped = [f for f in fields if f not in canonical]
    assert not dropped, (
        f"{rtype}: editor fields silently dropped by the codec: {dropped}")
    # the port stores what the JAX dashboard stores
    assert canonical == jserver.Dashboard._canonical(
        rtype, json.loads(json.dumps(SAMPLES[rtype])))


def test_canonical_keeps_what_the_codec_refuses():
    bad = {"resource": "r", "grade": "not-a-number"}
    for rtype in ("flow", "gatewayFlow", "gatewayApi"):
        assert tserver.Dashboard._canonical(rtype, dict(bad)) == \
            jserver.Dashboard._canonical(rtype, dict(bad))


def test_dashboard_metric_parser_skips_elision_marker(monkeypatch):
    node = MetricNode(timestamp=1_785_000_000_000, resource="svc",
                      pass_qps=7, block_qps=2)
    body = "# threadsElided=true\n" + node.to_thin_string() + "\n"
    cli = tclient.SentinelApiClient()
    monkeypatch.setattr(cli, "_get", lambda *a, **k: body)
    parsed = cli.fetch_metrics("127.0.0.1", 8719, 0, 10)
    assert [dataclasses.asdict(n) for n in parsed] == [
        dataclasses.asdict(node)]
