"""Worker for the cluster-wide hot-view merge test (multihost/obs_agg.py
``aggregate_topk``).

Port of ``sentinel_tpu/multihost/_topk_worker.py``. Spawned by
:func:`sentinel_tpu_torch.multihost.launch.launch`. Each process builds
its OWN local engine on its device (independent per-process engines —
the cluster-health-view topology, not the sharded token engine), drives
a deterministic per-process traffic mix with one process-specific hot
key plus one key hot on EVERY process, runs one telemetry poll, and
joins the collective top-K gather. The coordinator prints one
``TOPK_JSON:``-prefixed line with the merged hot view —
``tests/test_torch_multihost.py`` asserts the per-process keys surface
and the shared key's load is the cross-process sum.

After that each process exits a few more entries with response times
(``SLOW_MS`` times its process number on the shared key), polls again
and joins :func:`aggregate_counters` and :func:`aggregate_resource_hist`:
the coordinator's ``TOPK_JSON`` carries both under ``counters`` and
``resource_hist``, and every rank prints a ``RANK_JSON:`` line with its
own counter vector and hot entries, which the merge must sum.
"""

from __future__ import annotations

import json
import sys

NOW0 = 10_000_000
HOT_N = 30        # per-process hot key entries
SHARED_N = 20     # entries every process sends to the shared key
COLD_N = 2
TOPK_K = 8
SLOW_N = 5        # timed exits a process on the shared key
SLOW_MS = 40      # ... each SLOW_MS × (process index + 1) long


def main(argv) -> int:
    import sentinel_tpu_torch as stt
    from sentinel_tpu_torch import multihost
    from sentinel_tpu_torch.core.clock import ManualClock
    from sentinel_tpu_torch.core.errors import BlockException
    from sentinel_tpu_torch.multihost.obs_agg import (
        aggregate_counters, aggregate_resource_hist, aggregate_topk,
        local_counter_vector,
    )

    with multihost.initialize() as rt:
        p = rt.process_index
        cfg = stt.load_config(max_resources=64, max_flow_rules=16,
                              max_degrade_rules=16, host_fast_path=False)
        s = stt.Sentinel(cfg, clock=ManualClock(start_ms=NOW0),
                         device=rt.device)
        for name, n in ((f"hot-{p}", HOT_N), ("shared-hot", SHARED_N),
                        (f"cold-{p}", COLD_N)):
            for _ in range(n):
                try:
                    s.entry(name).exit()
                except BlockException:   # rule-free: never taken
                    pass
        s.clock.advance_ms(50)
        s.telemetry.poll()
        agg = aggregate_topk(s, k=TOPK_K)
        agg["local_hot"] = s.telemetry.hot_entries()
        for _ in range(SLOW_N):
            e = s.entry("shared-hot")
            s.clock.advance_ms(SLOW_MS * (p + 1))
            e.exit()
        s.clock.advance_ms(50)
        s.telemetry.poll()
        agg["counters"] = aggregate_counters(s)
        agg["resource_hist"] = aggregate_resource_hist(s, k=TOPK_K)
        print("RANK_JSON:" + json.dumps({
            "process_index": p, "backend": rt.backend,
            "device": str(rt.device),
            "counters": local_counter_vector(s).tolist(),
            "hot": s.telemetry.hot_entries(TOPK_K)}), flush=True)
        if p == 0:
            print("TOPK_JSON:" + json.dumps(agg), flush=True)
        rt.barrier("topk-done")
        s.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
