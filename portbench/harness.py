"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, the comparison with the plain reference, the result.

Everything that belongs to one configuration, one traffic mix, one
entry or one per-layer metric is a file of its own that this module
finds by the name ``BENCHMARK.json`` gives: ``configs/<config>.json``
(which names its ``deployments/``, ``reference/`` and ``rules/``
modules), ``traffic/<mix>.json`` (which names its ``generators/``,
``loops/`` and ``entries/`` modules), ``metrics/<metric>.py`` and
``checks/<workload>.json`` (the limits of the comparison).
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import compare, deploy, isolation, trace, traffic as mixes
from portbench.window import Run

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
#: the counters printed on an earlier line of every run
COUNTER_PREFIXES = ("split_route.", "pipeline.", "sortfree.", "obs.",
                    "compile_cache.")
#: the width of the buckets of the window's step rate on the log
RATE_BUCKET_S = 5.0


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_benchmark(root: str = CHECKOUT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    ends = {m["name"] for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])}
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if m["name"] in ends]
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in ends]


def load_checks(workload: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "checks", workload + ".json")) as fh:
        return json.load(fh)["limits"]


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads (``metrics/<name>.py``
    defines ``read(ctx)`` → a number, or None when it finds nothing to
    read)."""

    run: Run
    traffic: object
    config: dict
    device: str
    spans: list                    # the program's spans of the window
    events: Optional[list] = None  # the traced stretch's trace events
    lo: float = 0.0                # the stretch on the trace's clock (us)
    hi: float = 0.0
    offset_us: Optional[float] = None   # perf_counter_ns / 1e3 → trace
    pool: Optional[list] = None    # the batches as the program took them
    alt_rows: int = 0              # the program's node-table rows

    @property
    def traced_steps(self) -> range:
        t = self.run.traced
        return range(t["first"], t["last"]) if t else range(0)


def card() -> str:
    """The card's name, power limit, clock and draw (``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw", "--format=csv,noheader"], capture_output=True,
            text=True, timeout=20)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"
    return "nvidia-smi: " + out.stdout.strip()


def host_line(run: Run, ru0, ru1) -> str:
    """The host's side of the run: the process's CPU time over the loop
    (all threads), and the window's steps in buckets of
    :data:`RATE_BUCKET_S`."""
    rate = collections.Counter(
        int((s.t_sub - run.t_start) // RATE_BUCKET_S)
        for s in run.steps[run.first:run.last])
    return (f"host: loop user {ru1.ru_utime - ru0.ru_utime:.3f} s, sys "
            f"{ru1.ru_stime - ru0.ru_stime:.3f} s, max RSS {ru1.ru_maxrss} "
            f"KiB, cores {len(os.sched_getaffinity(0))}; steps a "
            f"{RATE_BUCKET_S:g} s {[rate[i] for i in sorted(rate)]}")


def warm_profiler(activities, device) -> None:
    """Start and stop the profiler once at set-up: its first start on a
    process initialises the device tracing, which takes seconds."""
    with torch.profiler.profile(activities=activities):
        torch.ones(8, device=device).sum().item()


def window_spans(spans, run: Run) -> list:
    lo, hi = run.t_start * 1e9, run.t_close * 1e9
    return [s for s in spans if lo <= s["start_ns"] <= hi]


def read_trace(run: Run, tmp: str):
    """Export the stretch's profile under ``tmp``, read it and delete
    it → ``(events, lo, hi, offset_us)``."""
    path = os.path.join(tmp, "portbench_trace.json")
    run.traced["prof"].export_chrome_trace(path)
    try:
        events = trace.load_events(path)
    finally:
        os.remove(path)
    run.traced.pop("prof")
    lo, hi = trace.span_of(events, trace.STRETCH)
    mark = trace.span_of(events, trace.CLOCK_MARK)
    offset = None if mark is None else mark[0] - run.traced["mark_ns"] / 1e3
    return events, lo, hi, offset


def replay_reference(ref_mod, config: dict, traffic, run: Run,
                     epoch_ms: int, device, **precision):
    """The plain reference over every step the program took, on the
    same inputs → ``(reference, {step: verdict tensors})`` for the steps
    whose verdicts were kept."""
    ref = ref_mod.build(config, deploy.rules_of(config), traffic, epoch_ms,
                        device, **precision)
    kept = {}
    lag = traffic.lag
    # the pool's batches go to the device once
    inputs = [{c: torch.from_numpy(v).to(device)
               for c, v in traffic.inputs(p).items()}
              for p in range(len(traffic.pool))]
    for k, st in enumerate(run.steps):
        ex = {}
        if traffic.exits and k >= lag and st.exit_n:
            ex = traffic.reference_exits(k, run.steps[k - lag].allow(),
                                         inputs, device)
        out = ref.step(at_ms=st.at_ms, **inputs[k % len(inputs)], **ex)
        if st.verdicts is not None:
            kept[k] = out
    return ref, kept


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclasses.dataclass
class Setup:
    """A cell's files read and its program built, ready for the window."""

    config: dict
    mix: dict
    limits: dict
    ref_mod: object
    loop: object
    traffic: object
    prog: object
    entry: object
    pool: list
    epoch_ms: int
    phases: Dict[str, float]


def set_up(workload: str, seed: int, device: str, bench: dict,
           config_override: Optional[dict] = None,
           mix_override: Optional[dict] = None) -> Setup:
    """Read the cell's files (the overrides replace keys of the
    configuration and the mix: the tests' small sizes), make the
    traffic, build the program and hand it the traffic's batches."""
    cell = cell_of(bench, workload)
    config = deploy.load_config(cell["config"])
    config.update(config_override or {})
    mix = mixes.load_mix(cell["traffic"])
    mix.update(mix_override or {})
    entry_mod = importlib.import_module(f"portbench.entries.{mix['entry']}")
    loop = importlib.import_module(f"portbench.loops.{mix['loop']}")
    ref_mod = importlib.import_module(
        f"portbench.reference.{config['reference']}")
    phases = {}
    t_ph = time.perf_counter()
    traffic = mixes.make(mix, config, seed, device)
    phases["traffic"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    prog = deploy.build(config, device)
    phases["build"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    pool = traffic.program_pool(prog)
    entry = entry_mod.Entry(prog, traffic.batch, mix["route"])
    phases["inputs"] = time.perf_counter() - t_ph
    return Setup(config, mix, load_checks(workload), ref_mod, loop, traffic,
                 prog, entry, pool, prog.epoch_ms, phases)


def drive(su: Setup, seconds: float, trace_cfg=None,
          device: str = "cuda") -> Run:
    """The cell's loop over its window."""
    return su.loop.drive(su.entry, su.traffic, su.pool, seconds,
                         su.prog.clock, trace_cfg, su.prog.spans, device)


def free_program(su: Setup, device: str) -> dict:
    """The program's state (host copies), then the program closed and its
    device memory freed."""
    state = su.prog.state()
    su.prog.close()
    su.prog = su.entry = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return state


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_proc: Optional[float] = None,
             bench: Optional[dict] = None,
             config_override: Optional[dict] = None,
             mix_override: Optional[dict] = None) -> dict:
    """One run of ``workload`` → the result line's fields (see
    :func:`set_up` for the overrides)."""
    t_proc = time.time() if t_proc is None else t_proc
    bench = load_benchmark() if bench is None else bench
    su = set_up(workload, seed, device, bench, config_override,
                mix_override)
    config, mix, limits, traffic = su.config, su.mix, su.limits, su.traffic
    prog, entry, phases = su.prog, su.entry, su.phases
    from sentinel_tpu_torch.ops import _build
    from sentinel_tpu_torch.ops import scatter_add as sa
    trace_cfg = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        trace_cfg = {"activities": acts,
                     "start_s": float(mix["trace_start_s"]),
                     "steps": int(mix["trace_steps"])}
        warm_profiler(acts, device)
    sa.LAUNCHES.clear()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    run = drive(su, seconds, trace_cfg, device)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    # process start (wall clock) to the first timed submit (perf clock)
    setup_s = run.t_start + (time.time() - time.perf_counter()) - t_proc
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phases.items())
        + f", warm-up {traffic.warmup} steps "
        f"{run.t_start - run.steps[0].t_sub:.3f} s")
    if device == "cuda":
        torch.cuda.synchronize()
        run.memory_peak = int(torch.cuda.max_memory_allocated())
    run.spans = prog.spans()
    run.counters = {k: v for k, v in prog.counters().items()
                    if k.startswith(COUNTER_PREFIXES)}
    window = range(run.first, run.last)
    # what the window did, and which route it took
    dispatch = [s for s in run.spans if s["name"] in
                ("fused.dispatch", "decide.dispatch")]
    routes = collections.Counter(s["note"].split(" ")[0] for s in dispatch)
    off_route = sum(n for r, n in routes.items() if r != entry.route)
    log(f"workload {workload} seed {seed}: {len(window)} batches of "
        f"{run.batch} in {run.t_close - run.t_start:.3f} s; routes of the "
        f"{len(dispatch)} dispatches the span ring holds: {dict(routes)}")
    log(f"counters {json.dumps(run.counters, sort_keys=True)}")
    ws = run.steps[run.first:run.last]
    disp = [s["dur_ns"] / 1e6 for s in window_spans(dispatch, run)]
    log(f"ms a step over the window: step "
        f"{(run.t_close - run.t_start) * 1e3 / max(len(ws), 1):.3f}, "
        f"generator {np.mean([s.gen_s for s in ws]) * 1e3:.3f}, "
        f"dispatch span {np.mean(disp) if disp else float('nan'):.3f}, "
        f"result wait {np.mean([s.wait_s for s in ws]) * 1e3:.3f}; "
        f"torch threads {torch.get_num_threads()}")
    log(host_line(run, ru0, ru1))
    log(f"sentinel.routes {prog.routes()}; scatter-add launches "
        f"{sa.LAUNCHES.get('scatter_add', 0)} "
        f"({sa.LAUNCHES.get('scatter_add', 0) / max(len(run.steps), 1):.2f}"
        f" a step); builds {dict(_build.build_seconds)} s")
    log(f"device memory peak {run.memory_peak} bytes; {card()}")
    forbidden = isolation.loaded_forbidden()

    ctx = Context(run=run, traffic=traffic, config=config,
                  device=device, spans=window_spans(run.spans, run),
                  pool=su.pool, alt_rows=prog.alt_rows)
    breakdown = None
    if traced and run.traced is not None:
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            ctx.events, ctx.lo, ctx.hi, ctx.offset_us = read_trace(run, tmp)
        ops = trace.device_ops(ctx.events, ctx.lo, ctx.hi)
        n = len(ctx.traced_steps)
        idle = trace.gaps(trace.merge(ops), ctx.lo, ctx.hi)
        hosts = trace.host_intervals(ctx.events, run.traced["spans"],
                                     ctx.offset_us)
        breakdown = {"device_ops": trace.top_device_ops(ops, n),
                     "idle_gaps": trace.longest_gaps(idle, hosts)}

    # the program's state, then the program freed, then the reference
    del prog, entry
    prog_state = free_program(su, device)
    t_ref = time.perf_counter()
    ref, kept = replay_reference(su.ref_mod, config, traffic, run,
                                 su.epoch_ms, device)
    numbers = {"verdicts_differ": sum(
        compare.verdicts_differ(run.steps[k].kept(), v)
        for k, v in kept.items())}
    numbers.update(compare.state_numbers(
        prog_state, ref.leaves(), run.steps[-1].at_ms, ref.windows, device))
    numbers["off_route"] = off_route
    numbers["unanswered"] = sum(1 for st in run.steps
                                if st.allow_bits is None)
    del prog_state, ref
    log(f"reference: {len(run.steps)} steps replayed, {len(kept)} batches' "
        f"verdicts compared, in {time.perf_counter() - t_ref:.2f} s")
    forbidden = sorted(set(forbidden) | set(isolation.loaded_forbidden()))
    correct = compare.judge(numbers, limits)

    if traced:
        metrics = {}
        for m in metrics_of(bench, workload, "per_layer"):
            reader = importlib.import_module(f"portbench.metrics.{m['name']}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        lat = [(run.steps[k].t_ready - run.steps[k].t_sub) * 1e3
               for k in window]
        values = {
            "decisions_per_s": len(window) * run.batch
            / (run.t_close - run.t_start),
            "verdict_p95_ms": percentile(lat, 95),
            "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench, workload, "end_to_end")}
        held = [(run.steps[k].t_done - run.steps[k].t_sub) * 1e3
                for k in window]
        log(f"verdict latency ms over {len(lat)} batches, submit to host "
            f"memory: p50 {percentile(lat, 50):.3f}, p95 "
            f"{percentile(lat, 95):.3f}, max {max(lat):.3f}; submit to the "
            f"caller's hands: p50 {percentile(held, 50):.3f}, p95 "
            f"{percentile(held, 95):.3f}")
    device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(0)
                            if device == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": run.memory_peak}
    if traced and ctx.events is not None:
        device_info["busy_s"] = trace.busy(
            trace.device_ops(ctx.events, ctx.lo, ctx.hi)) / 1e6
        device_info["window_s"] = (ctx.hi - ctx.lo) / 1e6
    out = {"correct": correct, "attempted": len(window) * run.batch,
           "failed": numbers["unanswered"] * run.batch,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    log(f"numbers {json.dumps(numbers)}")
    out["checks"] = {k: {"value": numbers.get(k), "limit": v}
                     for k, v in limits.items()}
    out["forbidden_modules"] = forbidden
    return out
