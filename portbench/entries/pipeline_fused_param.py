"""``DispatchPipeline.submit_fused`` → ``Sentinel.decide_and_exit_raw_nowait``
with ``param_args``: :mod:`pipeline_fused`'s steps, each batch's call
arguments put through the hot-parameter rules by the program itself."""

from __future__ import annotations

import numpy as np

from portbench.entries import pipeline_fused


class Entry(pipeline_fused.Entry):

    def submit(self, cols: dict, at_ms: int, exits):
        c = {**self.base, **cols}
        return self.pipe.submit_fused(
            c["rows"], c["origin_ids"], c["origin_rows"], c["context_ids"],
            c["chain_rows"], *self.rest, at_ms=at_ms,
            param_args=c["param_args"],
            **(exits or {"exit_rows": np.empty(0, np.int32)}))
