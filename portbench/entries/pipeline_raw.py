"""``DispatchPipeline.submit_raw`` → ``Sentinel.decide_raw_nowait``: each
step decides a batch; no completion is ever reported (token-check
callers)."""

from __future__ import annotations

from portbench.entries import pipeline_fused


class Entry(pipeline_fused.Entry):
    exits = False

    def submit(self, cols: dict, at_ms: int, exits):
        c = {**self.base, **cols}
        return self.pipe.submit_raw(
            c["rows"], c["origin_ids"], c["origin_rows"], c["context_ids"],
            c["chain_rows"], *self.rest, at_ms=at_ms)
