"""Worker for the row-sharded engine over processes: one seeded stream.

Spawned by :func:`sentinel_tpu_torch.multihost.launch.launch` (any
process count): each rank bootstraps from the environment, builds
``Sentinel(config, clock=ManualClock(T0), mesh=global_mesh(axis="rows"))``
and replays :func:`stream` — the SPMD contract: every rank makes the same
calls in the same order at the same virtual times. Each rank prints one
``ROWS_JSON:`` line (its observations, every ``obs`` counter, its
collectives and kernel launches, the global row offset of each row-split
leaf it holds) — then replays :func:`twin_stream` on a second engine
of the same mesh — and saves its state at each checkpoint to
``<out>/<checkpoint>.<rank>.npz`` (:func:`~sentinel_tpu_torch.convert.
rank_state_to_numpy`), so that a caller can join the ranks' rows and hold
them to a one-process engine. ``--refusals`` then calls each host reader
that the multi-process engine refuses and records what it raised.

:func:`stream` is written against a package module (``pkg``: this one,
or any package with the same API), so a test can replay the same calls
on other engines; it draws its random numbers inside itself.

``--rows N`` sizes the engine (``max_resources``; 64 by default, 16k in
``chip_smoke.py``'s phase 19 (c)). The full-width multi-process run is
``chip_smoke.py --rows-mp``, on phase 18's runtime.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

T0 = 1_785_000_000_000
#: the small stream's engine (every row count divides over 8 blocks)
CFG = dict(max_resources=64, max_origins=32, max_flow_rules=32,
           max_degrade_rules=16, max_authority_rules=16,
           minute_enabled=True)
SVC = [f"svc-{i}" for i in range(8)]
ORIGINS = ["", "up-a", "up-b", "bad-app"]
CONTEXTS = ["", "ctx-a", "ctx-b"]
#: the fused steps' lanes inside the JAX meshed engine's range (ROADMAP
#: C18: up to 64 lanes a fused step) and past it
SMALL_LANES = 32
BIG_LANES = 256
#: the checkpoints :func:`stream` calls back at
CHECKPOINTS = ("inrange", "end")


def make_sentinel(pkg, mesh=None, rows: int = CFG["max_resources"], **kw):
    """The stream's engine in package ``pkg`` at ``rows`` rows (the CPU
    sampler pinned: system rules read it)."""
    cfg = pkg.load_config(**{**CFG, "max_resources": rows})
    s = pkg.Sentinel(cfg, clock=pkg.ManualClock(start_ms=T0), mesh=mesh,
                     **kw)
    s._cpu.sample = lambda: (0.5, 0.25)
    return s


def _verd(v) -> list:
    return [np.asarray(v.allow).astype(int).tolist(),
            np.asarray(v.reason).astype(int).tolist(),
            np.asarray(v.wait_ms).astype(int).tolist()]


def _entry(pkg, s, name, **kw):
    """One ``entry`` + ``exit`` → "pass" or the exception's class name."""
    try:
        e = s.entry(name, **kw)
    except pkg.BlockException as exc:
        return type(exc).__name__
    e.exit()
    return "pass"


def _flow_rules(pkg, scale: float = 1.0):
    return ([pkg.FlowRule(resource=n, count=(12.0 + i) * scale)
             for i, n in enumerate(SVC)]
            + [pkg.FlowRule(resource="leased", count=40.0 * scale),
               pkg.FlowRule(resource="thr", count=3.0,
                            grade=pkg.GRADE_THREAD),
               pkg.FlowRule(resource="by-origin", count=5.0 * scale,
                            limit_app="up-a"),
               pkg.FlowRule(resource="chained", count=4.0 * scale,
                            strategy=pkg.STRATEGY_CHAIN,
                            ref_resource="ctx-a")])


def _raw_cols(s, n: int, route: str, seed: int):
    """Columns for ``decide_and_exit_raw_nowait``: the scalar route (no
    origins, acquire 1, none prioritized) or the general one (origins on
    a third of the lanes, acquire 1–2, 1/8 prioritized)."""
    rng = np.random.default_rng(seed)
    rows_of = np.asarray([s.resources.get_or_create(x)
                          for x in SVC + ["by-origin", "wide"]], np.int32)
    rows = rows_of[rng.integers(0, len(rows_of), n)]
    ra = s.spec.alt_rows
    if route == "scalar":
        oids = np.zeros(n, np.int32)
        orow = np.full(n, ra, np.int32)
        acq = np.ones(n, np.int32)
        prio = np.zeros(n, np.bool_)
    else:
        oid = int(s.origins.pin("up-a"))
        has = rng.random(n) < 0.33
        oids = np.where(has, oid, 0).astype(np.int32)
        alt = np.asarray([s._alt_row(int(r), 0, oid) for r in rows],
                         np.int32)
        orow = np.where(has, alt, ra).astype(np.int32)
        acq = rng.integers(1, 3, n).astype(np.int32)
        prio = rng.random(n) < 0.125
    return dict(rows=rows, oids=oids, orow=orow,
                ctx=np.zeros(n, np.int32), chain=np.full(n, ra, np.int32),
                acq=acq, is_in=rng.random(n) < 0.85, prio=prio,
                rt=rng.integers(0, 40, n).astype(np.int32),
                err=rng.random(n) < 0.1)


def _fused(s, c, at_ms, submit=None):
    args = (c["rows"], c["oids"], c["orow"], c["ctx"], c["chain"],
            c["acq"], c["is_in"], c["prio"])
    kw = dict(exit_rows=c["rows"], exit_origin_rows=c["orow"],
              exit_chain_rows=c["chain"], exit_acquire=c["acq"],
              exit_rt_ms=c["rt"], exit_error=c["err"],
              exit_is_in=c["is_in"], at_ms=at_ms)
    return (submit or s.decide_and_exit_raw_nowait)(*args, **kw)


def stream(pkg, s, checkpoint=None) -> dict:
    """The seeded SPMD stream on engine ``s`` of package ``pkg`` →
    ``{stage: observations}`` (plain lists). ``checkpoint(tag)`` is
    called at each of :data:`CHECKPOINTS`: ``"inrange"`` after the stages
    inside the JAX meshed engine's range (C18), ``"end"`` after the
    fused steps of :data:`BIG_LANES` past it."""
    out = {}
    clk = s.clock
    rng = np.random.default_rng(1717)
    # rule loads of all five kinds; the host fast path (the default
    # config) runs before the system rules, which turn it off
    s.load_flow_rules(_flow_rules(pkg))
    fast = []
    for step in range(3):
        for name in ("leased", "free-a", "svc-60", "leased"):
            fast.extend(_entry(pkg, s, name) for _ in range(9))
        clk.advance_ms(450)
    out["fast_path"] = fast
    s.load_degrade_rules([pkg.DegradeRule(
        resource="svc-1", grade=pkg.GRADE_EXCEPTION_COUNT, count=2.0,
        time_window=5, min_request_amount=1)])
    s.load_system_rules([pkg.SystemRule(qps=5000.0, max_thread=400)])
    s.load_authority_rules([pkg.AuthorityRule(
        resource="guarded", limit_app="bad-app",
        strategy=pkg.STRATEGY_BLACK)])
    s.load_param_flow_rules([pkg.ParamFlowRule(
        resource="api", param_idx=0, count=3.0)])
    # entries with call args (hot-parameter rules), origins and contexts
    args = []
    for i in range(8):
        args.append(_entry(pkg, s, "api", args=(f"user-{i % 2}",)))
    for i in range(6):
        pkg.enter_context(CONTEXTS[i % 3], origin=ORIGINS[i % 4])
        try:
            for name in ("chained", "by-origin", "guarded", "thr"):
                args.append(_entry(pkg, s, name))
        finally:
            pkg.exit_context()
    out["entries"] = args
    clk.advance_ms(300)
    n = 48
    names = list(np.asarray(SVC + ["chained", "by-origin", "guarded",
                                   "api"])[rng.integers(0, 12, n)])
    v = s.entry_batch(names,
                      origins=[ORIGINS[i] for i in rng.integers(0, 4, n)],
                      contexts=[CONTEXTS[i] for i in rng.integers(0, 3, n)])
    out["entry_batch"] = _verd(v)
    # fused decide+exit steps on the scalar and the general route; the
    # general route's prioritized lanes book the next window
    fused = []
    for route in ("scalar", "general"):
        for i in range(3):
            clk.advance_ms(150)
            c = _raw_cols(s, SMALL_LANES, route, seed=100 + i)
            fused.append(_verd(_fused(s, c, clk.now_ms()).result()))
    out["fused"] = fused
    # completions, then a reload while bookings are live
    c = _raw_cols(s, 16, "general", seed=7)
    s.exit_batch(rows=c["rows"], origin_rows=c["orow"],
                 chain_rows=c["chain"], acquire=c["acq"], rt_ms=c["rt"],
                 error=c["err"], is_in=c["is_in"], at_ms=clk.now_ms())
    c = _raw_cols(s, SMALL_LANES, "general", seed=8)
    c["prio"][:] = True
    out["booked"] = _verd(_fused(s, c, clk.now_ms()).result())
    s.load_flow_rules(_flow_rules(pkg, scale=1.5))
    # the dispatch pipeline, two steps in flight
    pipe = pkg.DispatchPipeline(s, depth=2)
    handles = []
    for i in range(3):
        clk.advance_ms(120)
        handles.append(_fused(s, _raw_cols(s, SMALL_LANES, "general",
                                           seed=200 + i), clk.now_ms(),
                              submit=pipe.submit_fused))
    out["pipeline"] = [_verd(h.result()) for h in handles]
    pipe.flush()
    out["breakers"] = [int(x) for x in s.breaker_states()]
    s.frontend(batch_max=8).close()        # the serving front end builds
    # a telemetry tick (the hot set), then the live geometry change
    clk.advance_ms(100)
    tel = s.telemetry
    if not tel.enabled:        # obs off: a service of its own
        tel = importlib.import_module(
            pkg.__name__ + ".obs.telemetry").HotTelemetry(s, enabled=True)
    tel.poll()
    top = tel.last_topk
    out["topk"] = [np.asarray(x).astype(int).tolist() for x in top]
    s.update_window_geometry(sample_count=4)
    clk.advance_ms(250)
    v = s.entry_batch(list(np.asarray(SVC)[rng.integers(0, 8, 24)]))
    out["after_geometry"] = _verd(v)
    s._flush_fast()
    if checkpoint is not None:
        checkpoint("inrange")
    big = []
    for i in range(2):
        clk.advance_ms(200)
        c = _raw_cols(s, BIG_LANES, "general", seed=300 + i)
        big.append(_verd(_fused(s, c, clk.now_ms()).result()))
    out["big"] = big
    if checkpoint is not None:
        checkpoint("end")
    return out


#: the checkpoints :func:`twin_stream` calls back at
TWIN_CHECKPOINTS = ("twin_inrange", "twin_end")


def twin_stream(pkg, s, checkpoint=None) -> dict:
    """A short stream for the JAX runtime's own rows mesh over processes,
    whose compiles and collectives make every call dear: rule loads of
    all five kinds, one ``entry_batch`` with origins and contexts, fused
    steps of
    :data:`SMALL_LANES` on the scalar and the general route (checkpoint
    ``"twin_inrange"``), then of :data:`BIG_LANES` (``"twin_end"``)."""
    out = {}
    clk = s.clock
    rng = np.random.default_rng(2929)
    s.load_flow_rules(_flow_rules(pkg, scale=0.5))
    s.load_degrade_rules([pkg.DegradeRule(
        resource="svc-2", grade=pkg.GRADE_EXCEPTION_COUNT, count=1.0,
        time_window=5, min_request_amount=1)])
    s.load_system_rules([pkg.SystemRule(qps=5000.0)])
    s.load_authority_rules([pkg.AuthorityRule(
        resource="by-origin", limit_app="bad-app",
        strategy=pkg.STRATEGY_BLACK)])
    s.load_param_flow_rules([pkg.ParamFlowRule(
        resource="api", param_idx=0, count=3.0)])
    n = 32
    names = list(np.asarray(SVC + ["chained", "by-origin"])[
        rng.integers(0, 10, n)])
    out["entry_batch"] = _verd(s.entry_batch(
        names, origins=[ORIGINS[i] for i in rng.integers(0, 4, n)],
        contexts=[CONTEXTS[i] for i in rng.integers(0, 3, n)]))
    fused = []
    for route in ("scalar", "general"):
        for i in range(2):
            clk.advance_ms(150)
            c = _raw_cols(s, SMALL_LANES, route, seed=400 + i)
            fused.append(_verd(_fused(s, c, clk.now_ms()).result()))
    out["fused"] = fused
    if checkpoint is not None:
        checkpoint("twin_inrange")
    big = []
    for i in range(2):
        clk.advance_ms(200)
        c = _raw_cols(s, BIG_LANES, "general", seed=500 + i)
        big.append(_verd(_fused(s, c, clk.now_ms()).result()))
    out["big"] = big
    if checkpoint is not None:
        checkpoint("twin_end")
    return out


#: the host readers the multi-process engine refuses (the JAX runtime's
#: raise too), each as ``(name, call)``
REFUSED = (
    ("metrics_snapshot", lambda s: s.metrics_snapshot(s.clock.now_ms())),
    ("node_totals", lambda s: s.node_totals("svc-0")),
    ("all_node_totals", lambda s: s.all_node_totals()),
    ("origin_totals", lambda s: s.origin_totals("by-origin")),
    ("system_status", lambda s: s.system_status()),
    ("save_state", None),
)


def refusals(pkg, s, snapshot_mod, tmpdir: str) -> dict:
    """Call each of :data:`REFUSED` → ``{name: (class, message)}`` (or
    ``"returned"`` when a call did not raise)."""
    got = {}
    for name, call in REFUSED:
        if call is None:
            def call(s, _m=snapshot_mod):
                return _m.save_state(s, os.path.join(tmpdir, "snap"))
        try:
            call(s)
            got[name] = "returned"
        except RuntimeError as exc:
            got[name] = [type(exc).__name__, str(exc)[:300]]
    return got


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--refusals", action="store_true")
    ap.add_argument("--rows", type=int, default=CFG["max_resources"])
    opts = ap.parse_args(argv)
    import torch

    import sentinel_tpu_torch as stt
    from sentinel_tpu_torch import convert, multihost
    from sentinel_tpu_torch.core import snapshot
    from sentinel_tpu_torch.multihost import mesh as mh_mesh
    from sentinel_tpu_torch.ops import scatter_add as sa
    from sentinel_tpu_torch.parallel import local_shard
    from sentinel_tpu_torch.tune import artifact as tune_art

    torch.set_num_threads(1)
    os.makedirs(opts.out, exist_ok=True)
    with multihost.initialize() as rt:
        rank = rt.process_index
        mesh = mh_mesh.global_mesh(axis="rows")
        s = make_sentinel(stt, mesh=mesh, rows=opts.rows)
        offsets = {}

        def checkpoint_of(engine):
            def checkpoint(tag):
                leaves, offs = convert.rank_state_to_numpy(engine)
                offsets.update(offs)
                np.savez(os.path.join(opts.out, f"{tag}.{rank}.npz"),
                         **leaves)
            return checkpoint
        checkpoint = checkpoint_of(s)

        launches0 = sa.LAUNCHES["scatter_add"]
        obs = stream(stt, s, checkpoint)
        twin = make_sentinel(stt, mesh=mesh, rows=opts.rows)
        twin_obs = twin_stream(stt, twin, checkpoint_of(twin))
        twin.close()
        line = {"rank": rank, "process_count": rt.process_count,
                "backend": rt.backend, "device": str(rt.device),
                "blocks": [s.mesh.first, len(s.mesh.devices)],
                "observations": obs, "twin": twin_obs,
                "counters": s.obs.counters.snapshot(),
                "routes": dict(s.routes),
                "collectives": mesh.stats.snapshot(),
                "topology": local_shard.mesh_topology(s.spec, s.mesh),
                "fingerprint_mesh": tune_art.fingerprint(
                    mesh=s.mesh, spec=s.spec)["mesh"],
                "offsets": offsets,
                "launches": sa.LAUNCHES["scatter_add"] - launches0}
        if opts.refusals:
            t0 = time.perf_counter()
            line["refusals"] = refusals(stt, s, snapshot, opts.out)
            line["refusal_s"] = time.perf_counter() - t0
            line["collectives_after_refusals"] = mesh.stats.snapshot()
        print("ROWS_JSON:" + json.dumps(line), flush=True)
        rt.barrier("rows-done")
        s.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
