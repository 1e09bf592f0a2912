"""The closed loop of a gateway tier's batcher: each step collects the
batch submitted ``lag`` steps back (the entry's pipeline depth where the
traffic has no exits), makes this step's batch and its exits, and
submits it; the next batch goes as soon as the pipeline takes it."""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from portbench import trace
from portbench.window import ReadyClock, Run, Step, Tracer


def drive(entry, traffic, pool, seconds: float, clock,
          trace_cfg: Optional[dict], spans=None, device: str = "cuda"
          ) -> Run:
    """Warm-up steps, then the measured window until ``seconds`` have
    passed since the first timed submit; then every batch in flight is
    collected. With ``trace_cfg`` a stretch of ``trace_cfg["steps"]``
    steps from ``trace_cfg["start_s"]`` into the window runs under the
    profiler, and ``spans()`` (the program's span snapshot) is kept as
    it stands when the stretch ends: the span rings hold the last few
    hundred steps only."""
    lag = traffic.lag or entry.pipe.depth
    steps: List[Step] = []
    tickets: list = []
    # the admissions of the steps whose exits are still to come
    recent: dict = {}
    tracer = Tracer()
    ready = ReadyClock(device)
    prof = stretch = traced = None
    t_start = t_end = None

    def collect(j):
        t_w = time.perf_counter()
        with tracer.region("portbench.result_wait"):
            v = tickets[j].result()
        s = steps[j]
        s.t_done = time.perf_counter()
        s.wait_s = s.t_done - t_w
        allow = v.allow
        s.allow_bits = np.packbits(allow)
        if traffic.keep_verdicts(j):
            s.keep(v)
        if traffic.exits:
            recent[j] = allow
        tickets[j] = None

    def stop_trace():
        nonlocal prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        stretch.__exit__(None, None, None)
        prof.stop()
        tracer.on = False
        traced["last"] = len(steps)
        traced["prof"] = prof
        traced["spans"] = spans() if spans is not None else []
        prof = None

    ready.anchor()
    k = 0
    while True:
        if (trace_cfg is not None and traced is None and t_start is not None
                and time.perf_counter() >= t_start + trace_cfg["start_s"]):
            # the stretch starts with the device idle, so that all of its
            # device work is its own steps'
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=trace_cfg["activities"])
            prof.start()
            tracer.on = True
            stretch = torch.profiler.record_function(trace.STRETCH)
            stretch.__enter__()
            traced = {"first": k, "mark_ns": time.perf_counter_ns()}
            with torch.profiler.record_function(trace.CLOCK_MARK):
                pass
        if k >= lag:
            collect(k - lag)
        t0 = time.perf_counter()
        with tracer.region("portbench.generator"):
            cols = pool[k % len(pool)]
            exits = None
            if entry.exits and k >= traffic.lag:
                exits = traffic.program_exits(k, recent.pop(k - traffic.lag),
                                              pool)
        step = Step(at_ms=clock.now_ms(), n=traffic.batch,
                    gen_s=time.perf_counter() - t0)
        if exits is not None:
            step.exit_n = exits["exit_rows"].shape[0]
        steps.append(step)
        step.t_sub = time.perf_counter()
        with tracer.region("portbench.submit"):
            tickets.append(entry.submit(cols, step.at_ms, exits))
        ready.mark()
        if k == traffic.warmup:
            t_start = step.t_sub
            t_end = t_start + seconds
        k += 1
        now = time.perf_counter()
        if prof is not None and k - traced["first"] >= trace_cfg["steps"]:
            stop_trace()
        if t_end is not None and now >= t_end:
            break
    if prof is not None:
        stop_trace()
    last = k
    for j in range(len(tickets)):
        if tickets[j] is not None:
            collect(j)
    entry.flush()
    ready.anchor()
    ready.stamp(steps)
    return Run(steps=steps, first=traffic.warmup, last=last,
               t_start=t_start, t_close=steps[last - 1].t_done,
               batch=traffic.batch, spans=[], counters={}, memory_peak=0,
               traced=traced)
