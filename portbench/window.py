"""What a loop keeps of each step of a run, and the clocks it reads.

A loop (``portbench/loops/<loop>.py``) fills a :class:`Run` with one
:class:`Step` a batch. A step keeps little: the batch's admissions as
packed bits (the exits of a later step and the reference's replay read
them) and, for the batches the traffic samples, a compact copy of the
verdicts for the comparison. Nothing of the program's verdict arrays is
kept past the step that reads them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import types
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Step:
    at_ms: int
    n: int = 0                     # events in the batch
    t_sub: float = 0.0             # the caller's submit call (perf clock)
    t_ready: float = 0.0           # its verdicts in host memory
    t_done: float = 0.0            # its verdicts in the caller's hands
    gen_s: float = 0.0             # making the batch and its exits
    wait_s: float = 0.0            # the caller's wait in ``result()``
    allow_bits: Optional[np.ndarray] = None
    exit_n: int = 0
    verdicts: Optional[tuple] = None   # (allow bits, reason, wait lanes,
    #                                    wait values) of a sampled batch

    def allow(self) -> np.ndarray:
        return np.unpackbits(self.allow_bits, count=self.n).view(np.bool_)

    def keep(self, v) -> None:
        """Keep the sampled batch's verdicts ``v`` (copies: the program's
        arrays are let go)."""
        wait = np.asarray(v.wait_ms)
        lanes = np.flatnonzero(wait)
        self.verdicts = (self.allow_bits, np.array(v.reason, np.int8),
                         lanes, wait[lanes].copy())

    def kept(self):
        """The kept verdicts as ``Verdicts``-like arrays."""
        bits, reason, lanes, vals = self.verdicts
        wait = np.zeros(self.n, np.int32)
        wait[lanes] = vals
        return types.SimpleNamespace(
            allow=np.unpackbits(bits, count=self.n).view(np.bool_),
            reason=reason, wait_ms=wait)


@dataclasses.dataclass
class Run:
    """What a run measured and kept."""

    steps: List[Step]
    first: int                 # first step of the window
    last: int                  # one past the window's last step
    t_start: float
    t_close: float
    batch: int
    spans: list
    counters: dict
    memory_peak: int
    traced: Optional[dict] = None


class Tracer:
    """The benchmark's own host regions, recorded only in a traced
    stretch (``torch.profiler.record_function``)."""

    def __init__(self):
        self.on = False

    def region(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


class ReadyClock:
    """When each step's verdicts reached host memory, on the host's
    clock, with no host work in the loop beyond recording an event.

    The program enqueues a step and the copy of its verdicts into pinned
    host memory on the current stream; a timing event recorded behind
    the submit completes when that copy has. Two anchors, each an event
    recorded with the device idle, place the device's event clock on
    ``perf_counter`` (the second corrects the drift between the clocks).
    Off CUDA nothing is in flight: a step is ready when it is
    collected."""

    def __init__(self, device: str):
        self.on = device == "cuda" and torch.cuda.is_available()
        self.events: list = []
        self.anchors: list = []

    def anchor(self) -> None:
        if not self.on:
            return
        torch.cuda.synchronize()
        e = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e.record()
        e.synchronize()
        self.anchors.append((e, t))

    def mark(self) -> None:
        """Behind the submit just made."""
        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)

    def stamp(self, steps: List[Step]) -> None:
        """Set every step's ``t_ready`` (after the closing anchor)."""
        if not self.on:
            for s in steps:
                s.t_ready = s.t_done
            return
        (a, ta), (b, tb) = self.anchors[0], self.anchors[-1]
        span_dev = a.elapsed_time(b) / 1e3
        scale = (tb - ta) / span_dev if span_dev > 0 else 1.0
        for s, e in zip(steps, self.events):
            s.t_ready = ta + a.elapsed_time(e) / 1e3 * scale
        self.events = []
