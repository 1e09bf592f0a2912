"""Small sizes of the cells for the CPU tests: 2^12 rows (2^15 for
``origins_1m``), batches of 2^10 and 2^11 (the measuring path refuses the
CPU; these call the harness's functions directly)."""

from portbench import deploy, harness

FLOW_1M = {
    "sentinel": {"max_resources": 4096, "second_sample_count": 2,
                 "second_interval_ms": 1000, "minute_enabled": True,
                 "statistic_max_rt": 5000, "max_flow_rules": 256,
                 "max_degrade_rules": 256, "max_rules_per_resource": 4},
    "names": 4095,
    "flow_rules": [{"first": 0, "count": 64, "rule": {
        "count": 50.0, "grade": "QPS", "control_behavior": "DEFAULT"}}],
    "degrade_rules": [{"first": 0, "count": 16, "rule": {
        "grade": "EXCEPTION_RATIO", "count": 0.5, "time_window": 10,
        "min_request_amount": 5, "stat_interval_ms": 1000}}],
}

FUSED_ZIPF = {"batch": 1024, "pool_batches": 4, "warmup_steps": 3,
              "failing_ranks": 4, "trace_start_s": 0.1, "trace_steps": 4}

#: decides alone, through ``pipeline_raw`` (no cell of its own yet)
DECIDE_ZIPF = dict(FUSED_ZIPF, entry="pipeline_raw", exit_lag=0)

ORIGINS_1M = dict(
    FLOW_1M, names=(1 << 15) - 1,
    sentinel=dict(FLOW_1M["sentinel"], max_resources=1 << 15,
                  max_flow_rules=(1 << 15) - 1, max_origins=128),
    flow_rules=[dict(g, count=64) for g in
                deploy.load_config("origins_1m")["flow_rules"]],
    reference="sentinel")
# (max_flow_rules + 1) · (node rows + 1) >= 2^31: the fast route's key
# does not fit, so the batches take the general route, as at full size

FUSED_ORIGINS = dict(FUSED_ZIPF, batch=2048)

CELLS = {"flow_1m.fused": (FLOW_1M, FUSED_ZIPF),
         "origins_1m.fused": (ORIGINS_1M, FUSED_ORIGINS)}

#: cells whose files are under ``portbench/`` and whose ``BENCHMARK.json``
#: entry waits (PERF.md, Open questions)
HELD = [{"name": "origins_1m.fused", "config": "origins_1m",
         "traffic": "fused_origins", "chips": 1, "why": "held"}]


def bench() -> dict:
    """``BENCHMARK.json`` with the held cells added, each reporting
    every per-layer metric."""
    b = harness.load_benchmark()
    names = {w["name"] for w in b["workloads"]}
    held = [w for w in HELD if w["name"] not in names]
    b["workloads"] += held
    for m in b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [w["name"] for w in held]
    return b
