"""Port parity: the metric-file pipeline of ``sentinel_tpu_torch``
against ``sentinel_tpu``'s (``tests/test_metric_pipeline.py``).

Per-second snapshot (``metrics_snapshot``, one masked read of the minute
ring's bucket) → ``MetricTimerListener`` → ``MetricWriter`` (fat lines +
``.idx``) → ``MetricSearcher``, and the per-second block log, over
virtual time on twin runtimes. The ``MetricNode``s, the metric files byte
for byte, the searcher's results, the block-log lines, the obs views and
the engine state must agree.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.metrics import searcher as jsearcher
from sentinel_tpu.metrics import timer as jtimer
from sentinel_tpu.metrics import writer as jwriter
from sentinel_tpu.stats import window as jw
from sentinel_tpu_torch.metrics import searcher as tsearcher
from sentinel_tpu_torch.metrics import timer as ttimer
from sentinel_tpu_torch.metrics import writer as twriter
from sentinel_tpu_torch.metrics.node import TOTAL_IN_RESOURCE_NAME
from sentinel_tpu_torch.stats import window as tw

from test_torch_obs import T0, twin

METRICS = {stpu: (jtimer, jwriter, jsearcher), stt: (ttimer, twriter,
                                                     tsearcher)}


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SENTINEL_TIERING_DISABLE", "1")


def run_traffic(pkg, sph, n_ok, n_blocked_attempts, resource="svc"):
    sph.load_flow_rules([pkg.FlowRule(resource=resource, count=n_ok)])
    passed = blocked = 0
    for _ in range(n_ok + n_blocked_attempts):
        try:
            with sph.entry(resource):
                passed += 1
        except pkg.BlockException:
            blocked += 1
    return passed, blocked


def nodes(ns):
    return [dataclasses.asdict(n) for n in ns]


def test_metrics_snapshot_counts_completed_second(tmp_path):
    def scenario(pkg, sph, clk):
        out = [run_traffic(pkg, sph, 5, 3)]
        clk.advance_ms(1500)
        out.append(nodes(sph.metrics_snapshot(T0)))
        return out

    _, (counts, snap), lines = twin(scenario, tmp_path)
    assert counts == (5, 3)
    by_res = {n["resource"]: n for n in snap}
    assert by_res["svc"]["pass_qps"] == 5 and by_res["svc"]["block_qps"] == 3
    assert by_res["svc"]["success_qps"] == 5
    assert by_res["svc"]["timestamp"] == T0
    assert by_res[TOTAL_IN_RESOURCE_NAME]["pass_qps"] == 5
    assert lines and lines[0].split("|")[1].startswith("svc,FlowException")


def test_metrics_snapshot_empty_second(tmp_path):
    def scenario(pkg, sph, clk):
        return nodes(sph.metrics_snapshot(T0 - 5000))

    _, snap, _ = twin(scenario, tmp_path)
    assert snap == []


def test_timer_writer_searcher_roundtrip(tmp_path):
    def scenario(pkg, sph, clk):
        timer_mod, writer_mod, searcher_mod = METRICS[pkg]
        d = tmp_path / ("jax" if pkg is stpu else "torch") / "metrics"
        writer = writer_mod.MetricWriter(str(d), sph.cfg.app_name)
        timer = timer_mod.MetricTimerListener(sph, writer=writer)
        run_traffic(pkg, sph, 4, 2)
        clk.advance_ms(2100)
        written = timer.tick()
        base = writer_mod.form_metric_file_name(sph.cfg.app_name)
        searcher = searcher_mod.MetricSearcher(str(d), base)
        found = nodes(searcher.find(T0 - 1000, T0 + 10_000))
        only = nodes(searcher.find(T0 - 1000, T0 + 10_000,
                                   identity="svc"))
        writer.close()
        files = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
        return written, found, only, files

    _, (written, found, only, files), _ = twin(scenario, tmp_path)
    assert written >= 1 and any(".idx" in f for f in files)
    svc = [n for n in found if n["resource"] == "svc"]
    assert svc and svc[0]["pass_qps"] == 4 and svc[0]["block_qps"] == 2
    assert {n["resource"] for n in only} == {"svc"}


def test_block_log_rolls_up_per_second(tmp_path):
    def scenario(pkg, sph, clk):
        return run_traffic(pkg, sph, 2, 7)

    _, counts, lines = twin(scenario, tmp_path)
    assert counts == (2, 7) and len(lines) == 1
    _ms, key, count = lines[0].split("|")
    assert key.startswith("svc,FlowException") and int(count) == 7


def test_batch_tier_blocks_reach_block_log(tmp_path):
    def scenario(pkg, sph, clk):
        sph.load_flow_rules([pkg.FlowRule(resource="b", count=3)])
        return sph.entry_batch(["b"] * 8).allow.tolist()

    _, allow, lines = twin(scenario, tmp_path)
    assert sum(allow) == 3
    assert any("b,FlowException" in ln and ln.endswith("|5")
               for ln in lines)


@pytest.mark.parametrize("buckets", [2, 60])
def test_bucket_snapshot_matches(buckets):
    """``window.bucket_snapshot``: live, rotated and dead buckets, rt
    tracked or not, against the reference function on random state."""
    import jax.numpy as jnp

    from test_torch_occupy import NEVER

    rng = np.random.default_rng(7 + buckets)
    rows = 300
    for track_rt in (True, False):
        spec_j = jw.WindowSpec(buckets, 1000, track_rt)
        spec_t = tw.WindowSpec(buckets, 1000, track_rt)
        b_rt = buckets if track_rt else 0
        for idx in (1_785_000, 2 ** 31 - 1, -3):
            st = dict(
                counters=rng.integers(0, 9, (rows, buckets, 8)
                                      ).astype(np.int32),
                stamps=np.where(rng.random((rows, buckets)) < 0.2, NEVER,
                                idx - rng.integers(0, 2, (rows, buckets))
                                ).astype(np.int32),
                rt_sum=rng.integers(0, 500, (rows, b_rt)).astype(np.float32),
                min_rt=rng.integers(0, 90, (rows, b_rt)).astype(np.int32))
            want = jw.bucket_snapshot(
                spec_j, jw.WindowState(**{k: jnp.asarray(v)
                                          for k, v in st.items()}),
                jnp.int32(idx))
            got = tw.bucket_snapshot(
                spec_t, tw.WindowState(**{k: torch.from_numpy(v)
                                          for k, v in st.items()}), idx)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
