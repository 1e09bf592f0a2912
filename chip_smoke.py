"""Chip smoke test of the PyTorch / CUDA port (``sentinel_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU (written
for an H100)::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``sentinel_tpu_torch/csrc`` (into
the git-ignored ``sentinel_tpu_torch/_build/``), then:

1. builds every kernel, in parallel, and prints the build times;
2. holds each kernel against its plain PyTorch version on the card, exactly,
   at the shapes the main path gives it (and at a one-key stream and both
   sides of the shared-memory threshold), as its launch plan launches it;
   then times each launch cold (L2 flushed before every launch) and warm,
   in alternating turns with one PyTorch library call as a yardstick
   (``library_ms``; the port never calls it), beside the bound, the plain
   version's time and an empty interval after the same flush;
3. drives the engine at the serving headline's geometry (1M resources,
   512k-event batches, 4096 QPS rules, 1024 exception-ratio breakers, RT
   histograms on) for a run of fused decide+exit steps twice from one
   initial state — with the kernel, and with the plain scatter put in the
   seam — and requires identical verdicts and state, and 6 kernel launches
   per step;
4. drives the runtime through the entry points a user calls
   (``Sentinel(device="cuda")`` at 1M resources: ``entry``,
   ``entry_batch``, ``exit_batch``, full-width fused decide+exit steps)
   with the launch counters zeroed just before and read just after, and
   checks the verdicts against a CPU twin of the same runtime;
5. prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
   line, and as the last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile`` also records the engine steps with
``torch.profiler`` (device time by operator and per step, and a Chrome
trace in ``chiprun_out/engine_trace.json``) and fails if ``index_add_``
still runs in the step.

Any failed phase exits non-zero before the last line is printed. Without
a CUDA device, or outside a checkout of the repository, it fails at once.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
REPLACES = "sentinel_tpu/ops/pallas_kernels.py:46"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync() -> None:
    torch.cuda.synchronize()


class CudaTimer:
    """Device time of single launches, cold and warm, in turns.

    Every timed interval is preceded by a ``torch.cuda._sleep`` long enough
    for the host to enqueue the events and the launches behind it, so the
    interval holds device work only and no host dispatch gaps.

    * cold: before each launch a 256 MB scratch buffer is read (the L2
      holds 50 MB), which evicts the last launch's lines and leaves the L2
      holding clean lines only, so no write-back of the flush falls into
      the timed interval; then that one launch is timed alone. ``empty``
      times an interval with nothing in it after the same flush: the
      floor of the method;
    * warm: one untimed launch, then ``iters`` launches back to back on the
      same data, timed together (mean per launch).

    Functions are timed in alternating turns: a, b, c, then c, b, a, ...
    (with two: kernel, library, library, kernel, ...), so a drift of the
    card's clocks falls on all of them alike."""

    FLUSH_BYTES = 256 << 20
    HOST_MS_PER_LAUNCH = 0.25          # generous host cost of one launch

    def __init__(self):
        self.flush = torch.zeros(self.FLUSH_BYTES // 4, dtype=torch.int32,
                                 device="cuda")
        start, end = self._events()
        torch.cuda._sleep(1_000)
        start.record()
        torch.cuda._sleep(1_000_000)
        end.record()
        end.synchronize()
        self.cycles_per_ms = 1_000_000 / max(start.elapsed_time(end), 1e-3)

    @staticmethod
    def _events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _hold(self, launches: int) -> None:
        torch.cuda._sleep(int(self.cycles_per_ms * (
            0.2 + launches * self.HOST_MS_PER_LAUNCH)))

    @staticmethod
    def _order(names, turn):
        return names if turn % 2 == 0 else names[::-1]

    def cold(self, fns: dict, samples: int) -> dict:
        fns = {**fns, "empty": lambda: None}
        names = list(fns)
        marks = {name: [] for name in names}
        for turn in range(samples):
            for name in self._order(names, turn):
                self.flush.amax()               # read-only L2 flush
                self._hold(1)
                start, end = self._events()
                start.record()
                fns[name]()
                end.record()
                marks[name].append((start, end))
        torch.cuda.synchronize()
        return {name: [s.elapsed_time(e) for s, e in marks[name]]
                for name in names}

    def warm(self, fns: dict, rounds: int = 6, iters: int = 20) -> dict:
        names = list(fns)
        out = {name: [] for name in names}
        for turn in range(rounds):
            for name in self._order(names, turn):
                fns[name]()
                self._hold(iters)
                start, end = self._events()
                start.record()
                for _ in range(iters):
                    fns[name]()
                end.record()
                end.synchronize()
                out[name].append(start.elapsed_time(end) / iters)
        return out


def host_time_ms(fn, iters: int) -> float:
    """Mean wall time of ``fn()`` over ``iters`` calls, synchronised (the
    plain version, whose boolean indexing synchronises anyway)."""
    fn()
    sync()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t) / iters * 1e3


def summary(times) -> dict:
    """median, min and max of a list of ms."""
    return {"median": float(np.median(times)), "min": float(min(times)),
            "max": float(max(times)), "n": len(times)}


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

def phase_build(_build) -> dict:
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(_build.build, sources)))
    wall = time.perf_counter() - t0
    for name in sources:
        _build.load(name)
        log(f"[build] {name}: {_build.build_seconds[name]:.2f} s -> "
            f"{os.path.relpath(paths[name])}")
        for line in _build.ptxas_report.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] wall {wall:.2f} s for {len(sources)} source(s)")
    return {"wall_s": wall, "per_source_s": dict(_build.build_seconds)}


# ---------------------------------------------------------------------------
# Phase 2: kernel against its plain version, main-path shapes
# ---------------------------------------------------------------------------

def _bound_ms(keys, events, amounts, k_dim, row_stride, e_dim,
              itemsize=4) -> float:
    """Least time for the scatter on this data: the stream read once plus
    one 32-byte sector read and written back per distinct sector that a
    nonzero, in-range amount touches."""
    k = keys.long()
    k = torch.where(k < 0, k + k_dim, k)
    n = k.shape[0]
    if events is None:                       # payload: each nonzero lane
        lane = torch.arange(e_dim, device=k.device).expand(n, e_dim)
        hit = (amounts != 0) & ((k >= 0) & (k < k_dim))[:, None]
        flat = (k[:, None] * row_stride + lane)[hit]
        stream = n * 4 + amounts.numel() * 4
    else:
        ev = events.long()
        ev = torch.where(ev < 0, ev + e_dim, ev)
        ok = (k >= 0) & (k < k_dim) & (ev >= 0) & (ev < e_dim)
        flat = (k * row_stride + ev)[ok & (amounts != 0)]
        stream = n * 12
    sectors = torch.unique(torch.div(flat * itemsize, 32,
                                     rounding_mode="floor")).numel()
    return (stream + 2 * 32 * sectors) / HBM_BYTES_PER_S * 1e3


def _library_call(table, view, keys, events, amounts):
    """The yardstick: ONE ``index_add_`` over the flattened table with the
    flat index precomputed and the dropped lanes removed (a call the port
    never makes)."""
    k_dim, e_dim = view.shape
    flat_t = table.view(-1)
    kk = torch.where(keys < 0, keys + k_dim, keys).long()
    if events is None:
        lane = torch.arange(e_dim, device=keys.device).expand(keys.shape[0],
                                                              e_dim)
        fi = kk[:, None] * view.stride(0) + lane
        ok = ((kk >= 0) & (kk < k_dim))[:, None].expand_as(fi)
    else:
        ev = torch.where(events < 0, events + e_dim, events).long()
        fi = kk * view.stride(0) + ev
        ok = (kk >= 0) & (kk < k_dim) & (ev >= 0) & (ev < e_dim)
    fi = (fi + view.storage_offset() - table.storage_offset())[ok]
    fi = fi.contiguous()
    amt = amounts[ok].to(table.dtype).contiguous()
    return lambda: flat_t.index_add_(0, fi, amt)


def phase_kernels(sa, hist_buckets: int, dev="cuda", R=1 << 20,
                  B=1 << 19, timer=None, samples: int = 31) -> list:
    g = torch.Generator(device=dev)
    g.manual_seed(7)

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, dtype=torch.int32, device=dev,
                             generator=g)

    def hot_keys(n, k_dim, hot_rows=4096):
        hot = rint(1, hot_rows + 1, (n // 4,))
        cold = rint(1, k_dim, (n - n // 4,))
        keys = torch.cat([hot, cold])[torch.randperm(n, device=dev,
                                                     generator=g)]
        keys[::97] = k_dim                   # padding lanes (dropped)
        keys[5] = -1                         # wraps once to K-1
        return keys.contiguous()

    ones = torch.ones(B, dtype=torch.int32, device=dev)
    cases = []

    def case(name, per_step, table, view_of, keys, events, amounts,
             path=None):
        cases.append(dict(name=name, per_step=per_step, table=table,
                          view_of=view_of, keys=keys, events=events,
                          amounts=amounts, path=path))

    whole = (lambda t: t)
    bucket1 = (lambda t: t[:, 1, :])
    # (a) decide step: the second window's bucket slice [R, 8] of [R, 2, 8]
    base = rint(0, 50, (R, 2, 8))
    case("decide [R,8] slice of [R,2,8], N=B", 1, base, bucket1,
         hot_keys(B, R), rint(0, 2, (B,)), ones)
    # (b) exit step: payload mode, SUCCESS/EXCEPTION lanes of [N, 8]
    payload = torch.zeros((B, 8), dtype=torch.int32, device=dev)
    payload[:, 3] = 1
    payload[:, 2] = (torch.rand(B, device=dev, generator=g) < 0.1).int()
    case("exit payload [R,8] slice, N=B", 1, base.clone(), bucket1,
         hot_keys(B, R), None, payload)
    # (c) rt_hist: [R, HB]
    case(f"rt_hist [R,{hist_buckets}], N=B", 1,
         torch.zeros((R, hist_buckets), dtype=torch.int32, device=dev),
         whole, hot_keys(B, R), rint(0, hist_buckets, (B,)), ones)
    # (d) rt_sum: f32 column [R, 1] of [R, 2] (row stride 2), payload E=1;
    # a quarter of the lanes are exit padding (row R), rt in [1, 200]
    rt_keys = hot_keys(B, R)
    rt_keys[torch.rand(B, device=dev, generator=g) < 0.25] = R
    case("rt_sum f32 [R,1] col of [R,2], N=B", 1,
         torch.randint(0, 50, (R, 2), device=dev, generator=g).float(),
         lambda t: t[:, 1:2], rt_keys, None, rint(1, 201, (B, 1)))
    # (e) breakers' per-rule counts: [1025, 1], 1024 rules + the ND row;
    # 1/16 of the lanes carry a rule and a 1, the rest sit on ND with 0
    brk = torch.full((B,), 1024, dtype=torch.int32, device=dev)
    on = torch.rand(B, device=dev, generator=g) < 1 / 16
    brk[on] = rint(0, 1024, (int(on.sum()),))
    case("breakers int32 [1025,1], N=B", 2,
         torch.zeros((1025, 1), dtype=torch.int32, device=dev), whole,
         brk, None, on.int()[:, None].contiguous(), sa.PATH_SHARED)
    # (f) every element on one cell
    case("one key: [R,8] table, all on [12345, 6], N=B", 0,
         torch.zeros((R, 8), dtype=torch.int32, device=dev), whole,
         torch.full((B,), 12345, dtype=torch.int32, device=dev),
         torch.full((B,), 6, dtype=torch.int32, device=dev), ones)
    # (g, h) the shared-memory threshold: [7264, 8] int32 is 232,448 bytes,
    # the largest table one block can privatise. The stream has 16·B
    # elements, so that the private copies (one per SM) hold fewer cells
    # than it has amounts and the plan takes the shared path where the
    # table fits.
    n_long = 16 * B
    for k_small, path in ((7264, sa.PATH_SHARED), (7265, sa.PATH_GLOBAL)):
        case(f"int32 [{k_small},8], N=16B", 0,
             rint(0, 50, (k_small, 8)), whole,
             hot_keys(n_long, k_small, 512), rint(0, 8, (n_long,)),
             rint(1, 4, (n_long,)), path)
    # (i) float32 counters [4096, 8] (sums stay far below 2^24)
    case("f32 [4096,8], N=B", 0,
         torch.randint(0, 50, (4096, 8), device=dev, generator=g).float(),
         whole, hot_keys(B, 4096, 512), rint(0, 8, (B,)), rint(1, 4, (B,)))

    results = []
    for c in cases:
        name, view_of = c["name"], c["view_of"]
        keys, events, amounts = c["keys"], c["events"], c["amounts"]
        table = c["table"]
        view = view_of(table)
        k_dim, e_dim = view.shape
        plan = sa.plan_for(view, keys, events)
        if c["path"] is not None and plan.path != c["path"]:
            fail(f"{name}: planned the {plan.path} path, want {c['path']}")
        want = table.clone()
        sa.scatter_add_reference(view_of(want), keys, events, amounts)
        got = table.clone()
        sa.scatter_add_kernel(view_of(got), keys, events, amounts)
        sync()
        err = float((got.double() - want.double()).abs().max())
        if err != 0.0 or not torch.equal(got, want):
            fail(f"kernel disagrees with its plain version on {name}: "
                 f"max |diff| = {err}")
        del got, want
        tk = table.clone()
        tv = view_of(tk)
        # turns: kernel, library, library, kernel, ...
        fns = {"kernel": lambda: sa.scatter_add_kernel(tv, keys, events,
                                                       amounts),
               "library": _library_call(tk, tv, keys, events, amounts)}
        cold = {n: summary(v) for n, v in timer.cold(fns, samples).items()}
        warm = {n: summary(v) for n, v in timer.warm(fns).items()}
        plain_ms = host_time_ms(
            lambda: sa.scatter_add_reference(tv, keys, events, amounts), 3)
        bound = _bound_ms(keys, events, amounts, k_dim, view.stride(0),
                          e_dim, table.element_size())
        share = bound / cold["kernel"]["median"]
        log(f"[kernel] {name}: plan {plan.path}/E{plan.e_inst}/"
            f"i{plan.index_bits} grid {plan.grid}x{plan.block} "
            f"smem {plan.smem_bytes}; max_abs_err={err}")
        for n in cold:
            if n not in warm:
                log(f"[kernel]   {n:12s} cold median {cold[n]['median']:.4f}"
                    f" ms [{cold[n]['min']:.4f}, {cold[n]['max']:.4f}]")
                continue
            log(f"[kernel]   {n:12s} cold median {cold[n]['median']:.4f} ms "
                f"[{cold[n]['min']:.4f}, {cold[n]['max']:.4f}]  warm "
                f"{warm[n]['median']:.4f} ms [{warm[n]['min']:.4f}, "
                f"{warm[n]['max']:.4f}]")
        log(f"[kernel]   bound {bound:.4f} ms (bytes), share of bound "
            f"(cold median) {share:.3f}, plain {plain_ms:.3f} ms")
        results.append({"case": name, "launches_per_step": c["per_step"],
                        "plan": dataclasses.asdict(plan),
                        "max_abs_err": err, "bound_ms": bound,
                        "plain_ms": plain_ms, "cold": cold, "warm": warm,
                        "share_of_bound_cold": share})
        del tk, tv, fns
    return results


# ---------------------------------------------------------------------------
# Phase 3: engine at the headline geometry, kernel vs plain seam
# ---------------------------------------------------------------------------

def _clone_state(state):
    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(clone(v) for v in x))
        return x
    return clone(state)


def phase_engine(stt, sa, dev="cuda", R=1 << 20, B=1 << 19,
                 steps: int = 20, profile: bool = False) -> dict:
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.core.registry import (
        OriginRegistry, Registry, ResourceRegistry,
    )
    from sentinel_tpu_torch.engine import pipeline as pl
    from sentinel_tpu_torch.rules import authority as auth_mod
    from sentinel_tpu_torch.rules import degrade as deg_mod
    from sentinel_tpu_torch.rules import flow as flow_mod
    from sentinel_tpu_torch.rules import system as sys_mod
    from sentinel_tpu_torch.stats.window import WindowSpec

    dev = torch.device(dev)
    NRULES = 4096
    spec = pl.EngineSpec(rows=R, alt_rows=1024,
                         second=WindowSpec(buckets=2, win_ms=500),
                         minute=None, statistic_max_rt=5000,
                         hist_buckets=32)
    resources = ResourceRegistry(R)
    origins = OriginRegistry(64)
    contexts = Registry(64, reserved=("sentinel_default_context",))
    flow = flow_mod.compile_flow_rules(
        [flow_mod.FlowRule(resource=f"r{i}", count=50.0)
         for i in range(NRULES)],
        resource_registry=resources, context_registry=contexts,
        capacity=NRULES, k_per_resource=2, num_rows=R,
        origin_registry=origins, device=dev)
    deg_rules = [deg_mod.DegradeRule(resource=f"r{i}",
                                     grade=deg_mod.GRADE_EXCEPTION_RATIO,
                                     count=0.5, time_window=10)
                 for i in range(1024)]
    deg = deg_mod.compile_degrade_rules(
        deg_rules, resource_registry=resources, capacity=1024,
        k_per_resource=2, num_rows=R, device=dev)
    auth = auth_mod.compile_authority_rules(
        [], resource_registry=resources, origin_registry=origins,
        capacity=16, k_per_resource=2, num_rows=R, device=dev)
    rules = pl.RuleSet(
        flow_table=flow.table, flow_idx=flow.rule_idx[:, :flow.k_used],
        deg_table=deg.table, deg_idx=deg.rule_idx[:, :deg.k_used],
        auth_table=auth.table, auth_idx=auth.rule_idx,
        sys_thresholds=sys_mod.compile_system_rules([], device=dev),
    ).with_joint()
    flags = dict(skip_auth=True, skip_sys=True, scalar_has_rl=False,
                 skip_threads=True)

    rng = np.random.default_rng(42)
    batches = []
    for _ in range(4):
        hot = rng.integers(1, NRULES, B // 4)
        cold = rng.integers(1, R, B - B // 4)
        rows = np.concatenate([hot, cold]).astype(np.int32)
        rng.shuffle(rows)
        t = torch.from_numpy(rows).to(dev)
        batches.append(pl.EntryBatch(
            rows=t, origin_ids=torch.zeros_like(t),
            origin_rows=torch.full_like(t, spec.alt_rows),
            context_ids=torch.zeros_like(t),
            chain_rows=torch.full_like(t, spec.alt_rows),
            acquire=torch.ones_like(t),
            is_in=torch.ones(B, dtype=torch.bool, device=dev),
            prioritized=torch.zeros(B, dtype=torch.bool, device=dev),
            valid=torch.ones(B, dtype=torch.bool, device=dev)))
    rt_ms = [torch.from_numpy(rng.integers(0, 200, B).astype(np.int32)).to(dev)
             for _ in range(4)]
    errors = [torch.from_numpy(rng.random(B) < 0.3).to(dev) for _ in range(4)]
    t0_ms = 1_000_000_000

    def times(i):
        now = t0_ms + i * 2
        return (spec.second.index_of(now), 0, now - t0_ms,
                now % spec.second.win_ms)

    init = pl.init_state(spec, NRULES, 1024, device=dev)

    def run(state):
        verdicts = []
        step_s = []
        prev_rows = torch.full((B,), R, dtype=torch.int32, device=dev)
        prev_valid = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(steps):
            xb = pl.ExitBatch(
                rows=prev_rows, origin_rows=torch.full_like(prev_rows, 1024),
                chain_rows=torch.full_like(prev_rows, 1024),
                acquire=torch.ones_like(prev_rows), rt_ms=rt_ms[i % 4],
                error=errors[i % 4], is_in=torch.ones_like(prev_valid),
                valid=prev_valid)
            sync()
            t = time.perf_counter()
            state, v = pl.decide_and_record_exits(
                spec, rules, state, batches[i % 4], xb, times(i),
                (0.5, 0.1), **flags)
            sync()
            step_s.append(time.perf_counter() - t)
            verdicts.append(v)
            prev_rows = torch.where(v.allow, batches[i % 4].rows, R)
            prev_valid = v.allow.clone()
        return state, verdicts, step_s

    # warm-up on a throwaway copy (allocator, library handles)
    run(_clone_state(init))
    sa.LAUNCHES.clear()
    s_kernel, v_kernel, step_s = run(_clone_state(init))
    launches = sa.LAUNCHES["scatter_add"]
    # per fused step: the decide record; the exit payload, rt_sum and
    # rt_hist adds; the breakers' two per-rule counts
    if launches != 6 * steps:
        fail(f"engine phase: {launches} kernel launches in {steps} steps, "
             f"want 6 per step")
    real = sa.scatter_add
    sa.scatter_add = sa.scatter_add_reference     # the plain seam, explicitly
    try:
        sa.LAUNCHES.clear()
        s_plain, v_plain, _ = run(_clone_state(init))
        if sa.LAUNCHES["scatter_add"]:
            fail("engine phase: the plain run launched the kernel")
    finally:
        sa.scatter_add = real
    for i, (a, b) in enumerate(zip(v_kernel, v_plain)):
        for f in ("allow", "reason", "wait_ms"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                fail(f"engine phase: verdict {f} differs at step {i}")
    bad = convert.leaf_diff(convert.to_numpy(s_plain),
                            convert.to_numpy(s_kernel))
    if bad:
        fail(f"engine phase: state leaves differ: {bad}")
    allowed = int(sum(int(v.allow.sum()) for v in v_kernel))
    med = float(np.median(step_s[1:]))
    out = {"R": R, "B": B, "steps": steps, "launches": launches,
           "launches_per_step": launches / steps,
           "step_ms_median": med * 1e3,
           "step_ms_all": [s * 1e3 for s in step_s],
           "decisions_per_s": B / med, "allowed": allowed}
    log(f"[engine] R={R} B={B} steps={steps}: verdicts and state equal "
        f"(kernel vs plain seam); step median {med * 1e3:.3f} ms, "
        f"{B / med:.0f} decisions/s, kernel launches {launches} "
        f"({launches / steps:.1f}/step), allowed {allowed}")
    if profile:
        out["profile"] = prof = _profile_steps(
            lambda: run(_clone_state(init)), steps)
        if prof["index_add"]:
            fail(f"engine phase: index_add_ still runs in the step: "
                 f"{prof['index_add']}")
        log(f"[engine] device time {prof['device_ms_per_step']:.3f} ms per "
            f"step (sum of kernel, memcpy and memset durations in the trace)")
    return out


def _profile_steps(run_steps, steps: int) -> dict:
    """Device time by operator over one run of engine steps, and device
    busy time per step from the trace (``torch.profiler``; ``--profile``
    only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_steps()
        sync()
    os.makedirs("chiprun_out", exist_ok=True)
    trace = os.path.join("chiprun_out", "engine_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    busy_us = sum(float(e.get("dur", 0.0)) for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        rows.append({"name": e.key, "count": e.count,
                     "device_us": float(dev_us),
                     "cpu_us": float(e.cpu_time_total)})
    rows.sort(key=lambda r: -r["device_us"])
    log("[profile] top operators by device time (us, whole run):")
    for r in rows[:30]:
        log(f"[profile]   {r['device_us']:12.1f} dev  {r['cpu_us']:12.1f} "
            f"cpu  x{r['count']:<5d} {r['name'][:90]}")
    ours = [r for r in rows if "scatter_add_" in r["name"]]
    for r in ours:
        log(f"[profile]   scatter-add kernel {r['device_us'] / steps:8.1f} us "
            f"per step  x{r['count']:<4d} {r['name'][:90]}")
    return {"top": rows[:60], "scatter_add_kernels": ours,
            "index_add": [r for r in rows if "index_add" in r["name"]],
            "device_ms_per_step": busy_us / 1e3 / steps}


# ---------------------------------------------------------------------------
# Phase 4: the runtime, through the user entry points
# ---------------------------------------------------------------------------

def _drive_runtime(stt, sph, clock, hello_n: int = 25) -> dict:
    sph.load_flow_rules(
        [stt.FlowRule(resource="HelloWorld", count=20)]
        + [stt.FlowRule(resource=f"r{i}", count=50.0) for i in range(4096)])
    sph.load_degrade_rules(
        [stt.DegradeRule(resource=f"r{i}", grade=stt.GRADE_EXCEPTION_RATIO,
                         count=0.5, time_window=10) for i in range(1024)])
    passes = blocks = 0
    for _ in range(hello_n):
        try:
            with sph.entry("HelloWorld"):
                passes += 1
        except stt.FlowException:
            blocks += 1
    rng = np.random.default_rng(3)
    names = [f"r{i}" for i in rng.integers(0, 8192, 4096)]
    v = sph.entry_batch(names)
    clock.advance_ms(7)
    done = sph.intern_resources(names)[v.allow]
    m = done.shape[0]
    ra = sph.spec.alt_rows
    sph.exit_batch(rows=done, origin_rows=np.full(m, ra, np.int32),
                   chain_rows=np.full(m, ra, np.int32),
                   acquire=np.ones(m, np.int32),
                   rt_ms=rng.integers(0, 50, m).astype(np.int32),
                   error=rng.random(m) < 0.2, is_in=np.ones(m, np.bool_))
    return {"passes": passes, "blocks": blocks,
            "batch_allow": v.allow.tolist(), "batch_reason": v.reason.tolist(),
            "hello": sph.node_totals("HelloWorld"),
            "first": sph.node_totals(names[0])}


def phase_runtime(stt, sa, dev="cuda", R=1 << 20, B=1 << 19,
                  full_steps: int = 4) -> dict:
    cfg_kw = dict(max_resources=R, minute_enabled=True,
                  host_fast_path=False, max_flow_rules=8192,
                  max_degrade_rules=2048)
    t0 = 1_800_000_000_000
    clock = stt.ManualClock(start_ms=t0)
    sph = stt.Sentinel(config=stt.load_config(**cfg_kw), clock=clock,
                       device=dev)
    sa.LAUNCHES.clear()
    got = _drive_runtime(stt, sph, clock)
    # full-width serving steps through the fused raw entry point
    rng = np.random.default_rng(11)
    names = [f"r{i}" for i in range(4096)] + [f"u{i}" for i in range(60000)]
    pool = sph.intern_resources(names)
    ra = sph.spec.alt_rows
    prev = np.empty(0, np.int32)
    step_s = []
    allowed = 0
    for _ in range(full_steps):
        rows = pool[rng.integers(0, len(pool), B)]
        clock.advance_ms(2)
        t = time.perf_counter()
        h = sph.decide_and_exit_raw_nowait(
            rows, np.zeros(B, np.int32), np.full(B, ra, np.int32),
            np.zeros(B, np.int32), np.full(B, ra, np.int32),
            np.ones(B, np.int32), np.ones(B, np.bool_), np.zeros(B, np.bool_),
            exit_rows=prev,
            exit_rt_ms=rng.integers(0, 100, prev.shape[0]).astype(np.int32),
            exit_error=rng.random(prev.shape[0]) < 0.1)
        v = h.result()
        step_s.append(time.perf_counter() - t)
        allowed += int(v.allow.sum())
        prev = rows[v.allow]
    launches = sa.LAUNCHES["scatter_add"]
    if launches == 0:
        fail("runtime phase: the scatter-add kernel was never launched")
    if (got["passes"], got["blocks"]) != (20, 5):
        fail(f"runtime phase: HelloWorld gave {got['passes']} passes and "
             f"{got['blocks']} FlowExceptions, want 20 and 5")

    # the same entry / entry_batch / exit stream on a CPU twin
    twin_clock = stt.ManualClock(start_ms=t0)
    twin = stt.Sentinel(config=stt.load_config(
        **{**cfg_kw, "max_resources": 1 << 14}), clock=twin_clock,
        device="cpu")
    want = _drive_runtime(stt, twin, twin_clock)
    for key in ("passes", "blocks", "batch_allow", "batch_reason", "hello",
                "first"):
        if got[key] != want[key]:
            fail(f"runtime phase: {key} differs from the CPU twin: "
                 f"{got[key]} vs {want[key]}")
    med = float(np.median(step_s[1:]))
    log(f"[runtime] Sentinel(device={dev!r}) R={R}: HelloWorld 20 passes + "
        f"5 FlowExceptions; entry_batch(4096) and exit_batch agree with a "
        f"CPU twin; fused raw steps B={B}: median {med * 1e3:.2f} ms "
        f"({B / med:.0f} decisions/s end to end), allowed {allowed}; "
        f"kernel launches {launches}")
    return {"launches": launches, "hello": got["hello"],
            "full_step_ms": [s * 1e3 for s in step_s],
            "full_step_ms_median": med * 1e3,
            "decisions_per_s": B / med}


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the GPU only")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import sentinel_tpu_torch as stt
        from sentinel_tpu_torch.obs.resource_hist import DEFAULT_BUCKETS
        from sentinel_tpu_torch.ops import _build
        from sentinel_tpu_torch.ops import scatter_add as sa
    except ImportError as exc:
        fail(f"sentinel_tpu_torch not importable next to this script: {exc}")
    if not os.path.abspath(stt.__file__).startswith(here + os.sep):
        fail(f"sentinel_tpu_torch comes from {stt.__file__}, not from the "
             f"checkout that holds this script")
    if any(m == "jax" or m.startswith(("jax.", "sentinel_tpu."))
           or m == "sentinel_tpu" for m in sys.modules):
        fail("the port imported JAX or the JAX package")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t_all = time.perf_counter()
    report = {"card": card, "torch": torch.__version__}
    report["build"] = phase_build(_build)
    report["kernel_cases"] = phase_kernels(sa, DEFAULT_BUCKETS,
                                           timer=CudaTimer())
    report["engine"] = phase_engine(stt, sa,
                                    profile="--profile" in sys.argv[1:])
    report["runtime"] = phase_runtime(stt, sa)
    report["seconds"] = time.perf_counter() - t_all

    decide = report["kernel_cases"][0]
    kernels = [{
        "name": "scatter_add", "route": "cuda",
        "source": "sentinel_tpu_torch/csrc/scatter_add.cu",
        "replaces": REPLACES,
        "launches": report["runtime"]["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in report["kernel_cases"]),
        "ms": decide["cold"]["kernel"]["median"],
        "plain_ms": decide["plain_ms"],
        "bound_ms": decide["bound_ms"], "bound_by": "bytes",
        "library_ms": decide["cold"]["library"]["median"],
    }]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    log(f"[done] {report['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
