"""``DispatchPipeline.submit_fused`` → ``Sentinel.decide_and_exit_raw_nowait``:
each step decides a batch and records the completions of an earlier one
in one engine step, at the pipeline's default depth."""

from __future__ import annotations

import numpy as np


class Entry:
    exits = True

    def __init__(self, prog, batch: int, route: str):
        self.pipe = prog.stt.DispatchPipeline(prog.sph)
        self.route = route
        ra = prog.alt_rows
        # the columns a batch does not carry: no origin, the default
        # context, acquire 1, inbound, not prioritized
        self.base = {"origin_ids": np.zeros(batch, np.int32),
                     "origin_rows": np.full(batch, ra, np.int32),
                     "context_ids": np.zeros(batch, np.int32),
                     "chain_rows": np.full(batch, ra, np.int32)}
        self.rest = (np.ones(batch, np.int32), np.ones(batch, np.bool_),
                     np.zeros(batch, np.bool_))

    def submit(self, cols: dict, at_ms: int, exits):
        c = {**self.base, **cols}
        return self.pipe.submit_fused(
            c["rows"], c["origin_ids"], c["origin_rows"], c["context_ids"],
            c["chain_rows"], *self.rest, at_ms=at_ms,
            **(exits or {"exit_rows": np.empty(0, np.int32)}))

    def flush(self) -> None:
        self.pipe.flush()
