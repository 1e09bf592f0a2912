"""Worker for multihost tests/benchmarks: deterministic token streams.

Port of ``sentinel_tpu/multihost/_parity_worker.py``. Spawned by
:func:`sentinel_tpu_torch.multihost.launch.launch` (any process count —
the same script is the 1-process reference and the N-process subject).
Bootstraps from env, builds the global mesh + cluster engine, replays a
fixed rule set and a seeded request stream through
:class:`MultihostIngest`, and prints one ``PARITY_JSON:``-prefixed line
from the coordinator with every decision and the gathered flow window —
the payload ``tests/test_torch_multihost.py`` compares across process
counts and with the JAX package's. Every rank also prints a
``RANK_JSON:`` line: its backend, device, shards and kernel launches.

``--bench`` switches to a throughput loop (same engine, bigger batches)
and emits ``BENCH_JSON:`` instead.

``--width full`` runs the cluster tier at the JAX bench's config 5
geometry with flow requests only (S = 8 shards of 512 flow rows, 4
namespaces, 2^16 requests a step, Zipf(1.1) flow ids, 1/8 prioritized;
``--steps`` steps 10 ms apart) in turns: this mesh's engine, and — on
the coordinator, with the other ranks waiting — a one-process engine of
all 8 shards on the same device. Every rank prints one ``FULL_JSON:``
line: per turn, each step's host ms and a digest of its verdicts, the
grants, the ms spent in the namespace ``all_reduce`` and in the verdict
``all_gather``, and its kernel launches. ``--capture PATH`` saves the
scatter-add launches of one warm-up step (this rank's block shapes) to
``PATH.<rank>.pt``, so that a caller can hold the kernel against its
plain version on them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import numpy as np

NOW0 = 10_000_000
SEED = 0xC1A0
N_FLOWS = 24
FLOW0 = 100
#: flow ids whose ``flow_metrics`` the parity payload carries
METRIC_PROBES = (FLOW0, FLOW0 + 5, FLOW0 + 13, FLOW0 + 23, FLOW0 + 40)

#: ``--width full``: the JAX bench's config 5 geometry, flow requests only
FULL_SHARDS = 8
FULL_FLOWS = 512             # L: flow rows a shard (4096 in all)
FULL_NS = 4
FULL_BATCH = 1 << 16
FULL_STEP_MS = 10
FULL_T0 = 1_790_000_000_000
FULL_SEED = 61


def build_engine():
    from sentinel_tpu_torch.multihost import mesh as mh_mesh
    from sentinel_tpu_torch.parallel.cluster import (
        THRESHOLD_AVG_LOCAL, THRESHOLD_GLOBAL, ClusterEngine,
        ClusterFlowRule, ClusterSpec,
    )
    mesh = mh_mesh.global_mesh()
    n_dev = mesh.size
    spec = ClusterSpec(n_shards=n_dev, flows_per_shard=16, namespaces=4)
    engine = ClusterEngine(spec, mesh=mesh)

    # identical replay on every process (SPMD requirement)
    rules_a = [ClusterFlowRule(
        flow_id=FLOW0 + i, count=3 + (i % 5),
        threshold_type=(THRESHOLD_AVG_LOCAL if i % 4 == 0
                        else THRESHOLD_GLOBAL))
        for i in range(N_FLOWS // 2)]
    rules_b = [ClusterFlowRule(
        flow_id=FLOW0 + i, count=4 + (i % 7), threshold_type=THRESHOLD_GLOBAL)
        for i in range(N_FLOWS // 2, N_FLOWS)]
    engine.load_rules("ns-a", rules_a)
    engine.load_rules("ns-b", rules_b)
    engine.set_connected_count("ns-a", 3)
    engine.set_namespace_qps_limit("ns-b", 40)
    return engine


def stream(batches: int, batch: int):
    """Seeded request stream, independent of topology."""
    rng = np.random.RandomState(SEED)
    for t in range(batches):
        ids = rng.randint(FLOW0 - 2, FLOW0 + N_FLOWS + 2, size=batch)
        acq = rng.randint(-1, 4, size=batch)   # includes bad requests
        prio = rng.rand(batch) < 0.25
        yield ids, acq, prio, NOW0 + t * 137
    # and one batch a window later: slide/replenish must agree too
    ids = rng.randint(FLOW0, FLOW0 + N_FLOWS, size=batch)
    yield ids, np.ones(batch, np.int64), np.zeros(batch, np.bool_), \
        NOW0 + 2_000


def run_parity(ingest) -> dict:
    out = []
    for ids, acq, prio, now in stream(batches=6, batch=64):
        out.extend(list(map(list, ingest.request_tokens(
            ids, acq, prio, now_ms=now))))
    return {"decisions": out}


def run_bench(ingest, batches: int = 0, batch: int = 0) -> dict:
    import os
    batch = batch or int(os.environ.get("MH_BENCH_BATCH", "512"))
    batches = batches or int(os.environ.get("MH_BENCH_BATCHES", "40"))
    # warmup: every allocation and the kernel's load outside the timed
    # region
    for ids, acq, prio, now in stream(batches=2, batch=batch):
        ingest.request_tokens(ids, acq, prio, now_ms=now)
    t0 = time.perf_counter()
    n = 0
    for t in range(batches):
        ids = np.arange(batch, dtype=np.int64) % N_FLOWS + FLOW0
        acq = np.ones(batch, np.int64)
        ingest.request_tokens(ids, acq, None,
                              now_ms=NOW0 + 10_000 + t * 97)
        n += batch
    dt = time.perf_counter() - t0
    return {"requests": n, "elapsed_s": dt, "rps": n / dt,
            "batch": batch, "batches": batches}


# ---------------------------------------------------------------------------
# --width full
# ---------------------------------------------------------------------------

def full_engine(mesh):
    """The config 5 engine on ``mesh`` (8 shards): 4096 flow rules over 4
    namespaces — GLOBAL and AVG_LOCAL, ``exceed`` 1.0–1.5, a quarter with
    ``max_occupy_ratio`` 0.5, flow 1 an AVG_LOCAL count of 1e9 in ``ns1``
    with 3 connected clients; ``ns0`` keeps the default 30,000/s request
    limit, the others 1e9."""
    from sentinel_tpu_torch.parallel import cluster as tcl
    eng = tcl.ClusterEngine(tcl.ClusterSpec(
        n_shards=FULL_SHARDS, flows_per_shard=FULL_FLOWS,
        namespaces=FULL_NS), mesh=mesh)
    flow = {ns: [] for ns in range(FULL_NS)}
    for i in range(FULL_SHARDS * FULL_FLOWS):
        if i == 1:
            r = tcl.ClusterFlowRule(flow_id=i, count=1e9,
                                    threshold_type=tcl.THRESHOLD_AVG_LOCAL)
        else:
            r = tcl.ClusterFlowRule(
                flow_id=i, count=float(40 + (i * 37) % 400),
                threshold_type=(tcl.THRESHOLD_GLOBAL if i % 3
                                else tcl.THRESHOLD_AVG_LOCAL),
                exceed_count=1.0 + 0.125 * (i % 5),
                max_occupy_ratio=0.5 if i % 4 == 3 else 1.0)
        flow[i % FULL_NS].append(r)
    for ns in range(FULL_NS):
        eng.load_rules(f"ns{ns}", flow[ns])
        if ns:
            eng.set_namespace_qps_limit(f"ns{ns}", 1e9)
    eng.set_connected_count("ns1", 3)
    return eng


def full_stream(steps: int, batch: int = FULL_BATCH, seed: int = FULL_SEED):
    """Per step: Zipf(1.1) flow ids over the 4096 rules and 16 ids past
    them (NO_RULE_EXISTS), acquire 1–2, 1/8 prioritized."""
    rng = np.random.default_rng(seed)
    n = FULL_SHARDS * FULL_FLOWS + 16
    return [((rng.zipf(1.1, batch) - 1) % n, rng.integers(1, 3, batch),
             rng.random(batch) < 0.125) for _ in range(steps)]


def _digest(decisions) -> str:
    return hashlib.sha1(np.asarray(decisions, np.int64).tobytes()
                        ).hexdigest()


class _Timed:
    """Host ms spent in one mesh collective (the call, including the wait
    for the device work it reads)."""

    def __init__(self, fn):
        self.fn = fn
        self.ms = 0.0
        self.calls = 0

    def __call__(self, *args):
        t0 = time.perf_counter()
        out = self.fn(*args)
        self.ms += (time.perf_counter() - t0) * 1e3
        self.calls += 1
        return out


def _full_turn(mesh, stream_, sa) -> dict:
    """One turn: a fresh engine on ``mesh`` over the whole stream."""
    from sentinel_tpu_torch import multihost
    from sentinel_tpu_torch.parallel.cluster import STATUS_OK
    eng = full_engine(mesh)
    ingest = multihost.MultihostIngest(eng)
    reduce_t = mesh.all_reduce_sum = _Timed(mesh.all_reduce_sum)
    gather_t = mesh.all_gather = _Timed(mesh.all_gather)
    step_ms, digests, grants = [], [], 0
    launches0 = sa.LAUNCHES["scatter_add"]
    for i, (ids, acq, prio) in enumerate(stream_):
        t0 = time.perf_counter()
        out = ingest.request_tokens(ids, acq, prio,
                                    now_ms=FULL_T0 + i * FULL_STEP_MS)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        digests.append(_digest(out))
        grants += sum(1 for s, _w, _r in out if s == STATUS_OK)
    del mesh.all_reduce_sum, mesh.all_gather
    return {"processes": mesh.process_count, "step_ms": step_ms,
            "digests": digests, "grants": grants,
            "all_reduce_ms": reduce_t.ms, "all_reduce_calls": reduce_t.calls,
            "all_gather_ms": gather_t.ms, "all_gather_calls": gather_t.calls,
            "launches": sa.LAUNCHES["scatter_add"] - launches0}


def _capture_step(mesh, stream_, sa, path: str) -> None:
    """Warm-up on a throwaway engine (two steps); the second step's
    scatter-add launches are saved with their tables' contents."""
    import torch
    from sentinel_tpu_torch import multihost
    ingest = multihost.MultihostIngest(full_engine(mesh))
    real = sa.scatter_add
    seen = []

    def spy(counters, keys, events, amounts):
        base = counters._base if counters._base is not None else counters
        seen.append({
            "table": base.detach().cpu().clone(),
            "shape": tuple(counters.shape), "stride": counters.stride(),
            "offset": counters.storage_offset() - base.storage_offset(),
            "keys": keys.cpu().clone(),
            "events": None if events is None else events.cpu().clone(),
            "amounts": amounts.cpu().clone()})
        return real(counters, keys, events, amounts)

    for i, (ids, acq, prio) in enumerate(stream_[:2]):
        if i == 1 and path:
            sa.scatter_add = spy
        try:
            ingest.request_tokens(ids, acq, prio,
                                  now_ms=FULL_T0 + i * FULL_STEP_MS)
        finally:
            sa.scatter_add = real
    if path:
        torch.save(seen, f"{path}.{mesh.process_index}.pt")


def run_full(rt, steps: int, capture: str = "") -> dict:
    """The ``--width full`` turns → this rank's ``FULL_JSON`` payload."""
    from sentinel_tpu_torch.multihost import mesh as mh_mesh
    from sentinel_tpu_torch.multihost.bootstrap import ShardDevice
    from sentinel_tpu_torch.ops import scatter_add as sa
    mesh = mh_mesh.global_mesh()
    one = mh_mesh.GlobalMesh(
        [ShardDevice(0, i, str(rt.device)) for i in range(FULL_SHARDS)],
        mh_mesh.CLUSTER_AXIS)
    stream_ = full_stream(steps)
    _capture_step(mesh, stream_, sa, capture)
    kinds = (["mesh", "single", "single", "mesh"] if rt.process_count > 1
             else ["mesh", "mesh"])
    turns = []
    for kind in kinds:
        if kind == "mesh":
            turns.append(dict(kind=kind, **_full_turn(mesh, stream_, sa)))
        else:
            # the one-process engine runs on the coordinator alone; the
            # other ranks wait at the barrier below
            if rt.process_index == 0:
                turns.append(dict(kind=kind, **_full_turn(one, stream_, sa)))
            rt.barrier("full-turn")
    return {"process_index": rt.process_index, "backend": rt.backend,
            "device": str(rt.device), "shards": FULL_SHARDS,
            "local_shards": mh_mesh.local_shard_indices(mesh),
            "flows_per_shard": FULL_FLOWS, "batch": FULL_BATCH,
            "steps": steps, "turns": turns}


def main(argv) -> int:
    from sentinel_tpu_torch import multihost
    from sentinel_tpu_torch.ops import scatter_add as sa

    ap = argparse.ArgumentParser(prog="_parity_worker")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--width", choices=("parity", "full"), default="parity")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--capture", default="")
    args = ap.parse_args(argv)
    with multihost.initialize() as rt:
        if args.width == "full":
            payload = run_full(rt, args.steps, args.capture)
            print("FULL_JSON:" + json.dumps(payload), flush=True)
            rt.barrier("full-done")
            return 0
        sa.LAUNCHES.clear()
        engine = build_engine()
        ingest = multihost.MultihostIngest(engine)
        payload = run_bench(ingest) if args.bench else run_parity(ingest)
        launches = sa.LAUNCHES["scatter_add"]
        counters = engine._to_host_rows(engine.state.flows.counters)
        stamps = engine._to_host_rows(engine.state.flows.stamps)
        payload.update(
            process_count=rt.process_count,
            n_devices=len(rt.global_devices()),
            local_shards=list(ingest.local_shards))
        if not args.bench:
            payload["flow_window"] = {"counters": counters.tolist(),
                                      "stamps": stamps.tolist()}
            # one row snapshot a probe: a broadcast from the row's owner
            payload["flow_metrics"] = [
                engine.flow_metrics(fid, now_ms=NOW0 + 2_000)
                for fid in METRIC_PROBES]
        print("RANK_JSON:" + json.dumps({
            "process_index": rt.process_index, "backend": rt.backend,
            "device": str(rt.device), "local_shards": payload["local_shards"],
            "launches": launches}), flush=True)
        if rt.process_index == 0:
            tag = "BENCH_JSON:" if args.bench else "PARITY_JSON:"
            print(tag + json.dumps(payload), flush=True)
        rt.barrier("parity-done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
