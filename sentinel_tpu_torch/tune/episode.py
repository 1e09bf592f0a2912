"""One serving episode for the trial runner: a workload-zoo replay,
open loop, through the full serving path.

The port's copy of the open-loop replay of the reference's
``benchmarks/serving_bench.run_workload`` (which builds a JAX
``Sentinel``): a fresh ``Sentinel`` at ``max_resources=4096`` with the
zoo's rules, every padded batch geometry warmed, the counters cleared, a
:class:`~sentinel_tpu_torch.serving.CadenceScheduler` at 1 s, and the
workload's requests submitted at their arrival times on the wall clock
through an :class:`~sentinel_tpu_torch.frontend.AdaptiveBatcher` with
the given kwargs. It returns the subset of ``run_workload``'s metrics
that the runner and its callers read; the scores come from the engine's
own request histogram (``p99_obs_ms``, ``decisions_per_s``), as there.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional


def rules_for(stt, name: str):
    """Per-workload rule sets: mostly generous so steady traffic passes,
    with a tight rule on the flash hot key (``serving_bench._rules_for``)."""
    generous = [stt.FlowRule(resource=f"{name.split('_')[0]}/{i}",
                             count=1e9) for i in range(16)]
    if name == "flash_crowd":
        generous = [stt.FlowRule(resource=f"flash/{i}", count=1e9)
                    for i in range(16)]
        generous.append(stt.FlowRule(resource="flash/hot", count=300.0))
    elif name == "overload_episode":
        generous = [stt.FlowRule(resource=f"{p}/{i}", count=1e9)
                    for p in ("steady", "flash", "slow")
                    for i in range(16)]
        generous.append(stt.FlowRule(resource="flash/hot", count=300.0))
    elif name == "priority_mix":
        generous = [stt.FlowRule(resource=f"prio/{i}", count=400.0)
                    for i in range(8)]
    return generous


def warm(sph, batch_max: int, resource: str = "warm/0") -> None:
    """Dispatch every padded geometry the replay can hit once, in the
    no-prio and mixed-prio variants, with and without origins, so the
    replay pays no first-dispatch cost (``serving_bench._warm``)."""
    import numpy as np
    rows = sph.intern_resources([resource])
    n = 1
    while n <= batch_max:
        r = np.full(n, rows[0], np.int32)
        ones = np.ones(n, np.int32)
        noprio = np.zeros(n, np.bool_)
        mixed = np.zeros(n, np.bool_)
        mixed[0] = True
        for prio in (noprio, mixed):
            sph.entry_batch_nowait(r, acquire=ones,
                                   prioritized=prio).result()
            sph.entry_batch_nowait(r, acquire=ones, prioritized=prio,
                                   origins=["warm-app"] * n).result()
        n *= 2


def run_episode(name: str, *, seed: int, duration_ms: float,
                rate_rps: float, batch_max: int = 256, deadline_ms: int = 25,
                budget_ms: int = 3, idle_ms: float = 1.0, depth: int = 2,
                queue_max: Optional[int] = None,
                wl_kwargs: Optional[dict] = None,
                device="cuda") -> Dict:
    """Replay workload ``name`` open loop through a fresh ``Sentinel`` on
    ``device`` and an ``AdaptiveBatcher`` → the metrics dict (keys as in
    ``run_workload``)."""
    import sentinel_tpu_torch as stt
    from sentinel_tpu_torch.frontend import AdaptiveBatcher, IngestOverload
    from sentinel_tpu_torch.frontend.workloads import make as make_workload
    from sentinel_tpu_torch.obs.hist import LogHistogram
    from sentinel_tpu_torch.serving import CadenceScheduler

    reqs = make_workload(name, seed, duration_ms=duration_ms,
                         rate_rps=rate_rps, **(wl_kwargs or {}))
    sph = stt.Sentinel(stt.load_config(
        max_resources=4096, max_origins=64, max_flow_rules=64,
        max_degrade_rules=16, max_authority_rules=16), device=device)
    try:
        sph.load_flow_rules(rules_for(stt, name))
        warm(sph, batch_max, reqs[0].resource if reqs else "warm/0")
        sph.obs.counters.clear()
        sph.obs.hist_request.clear()
        CadenceScheduler(sph, telemetry_interval_sec=1.0).start()

        lat = LogHistogram()
        stats = {"shed": 0, "allowed": 0, "blocked": 0, "deadline_miss": 0}
        deadline_ns = deadline_ms * 1e6

        async def replay() -> None:
            batcher = AdaptiveBatcher(
                sph, batch_max=batch_max, deadline_ms=deadline_ms,
                budget_ms=budget_ms, idle_ms=idle_ms, depth=depth,
                queue_max=queue_max)
            loop = asyncio.get_running_loop()
            t_start = loop.time()

            async def fire(r) -> None:
                delay = t_start + r.t_ms / 1000.0 - loop.time()
                if delay > 0:
                    await asyncio.sleep(delay)
                t0 = time.perf_counter_ns()
                try:
                    v = await batcher.submit(r.resource, count=r.count,
                                             prioritized=r.prioritized,
                                             origin=r.origin)
                except IngestOverload:
                    stats["shed"] += 1
                    return
                dt = time.perf_counter_ns() - t0
                lat.record(dt)
                if dt > deadline_ns:
                    stats["deadline_miss"] += 1
                stats["allowed" if v.allow else "blocked"] += 1

            await asyncio.gather(*(fire(r) for r in reqs))
            await batcher.drain()
            batcher.close()

        asyncio.run(replay())
        c = sph.obs.counters
        from sentinel_tpu_torch.obs import counters as obs_keys
        completed = stats["allowed"] + stats["blocked"]
        return {
            "workload": name, "seed": seed, "duration_ms": duration_ms,
            "rate_rps": rate_rps, "offered": len(reqs),
            "completed": completed, "shed": stats["shed"],
            "allowed": stats["allowed"], "blocked": stats["blocked"],
            "deadline_miss": stats["deadline_miss"],
            "p50_ms": lat.percentile_ms(0.50),
            "p99_ms": lat.percentile_ms(0.99),
            "p99_obs_ms": sph.obs.hist_request.percentile_ms(0.99),
            "settled_obs": sph.obs.hist_request.count,
            "pipe_stall": c.get(obs_keys.PIPE_STALL),
            "decisions_per_s": (sph.obs.hist_request.count
                                / (duration_ms / 1e3)
                                if duration_ms else 0.0),
        }
    finally:
        sph.close()
