"""``zipf_batches`` with each event's call arguments for the hot-parameter
rules.

A mix adds ``args``: one entry an argument position, in order, each
``{"values": v, "zipf_s": s}``: the argument is a value in ``[0, v)``,
Zipf(``s``) (value 0 the hottest), drawn on its own for every event of
the pool. The program's entry takes them as the int32 column
``param_args`` ``[batch, A]``; the reference as ``args``.
"""

from __future__ import annotations

import torch

from portbench.generators import zipf_batches
from portbench.traffic import seed64, zipf_ranks


class Traffic(zipf_batches.Traffic):
    """The inputs of one run of a cell (see the module docstring)."""

    def __init__(self, mix: dict, config: dict, seed: int, device):
        super().__init__(mix, config, seed, device)
        dev = torch.device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed64(seed, 3))
        pool = len(self.pool)
        cols = [zipf_ranks(pool * self.batch, int(a["values"]),
                           float(a["zipf_s"]), gen, dev)
                for a in mix["args"]]
        args = torch.stack(cols, 1).view(pool, self.batch, len(cols))
        self.args = list(args.cpu().numpy())

    def inputs(self, p: int) -> dict:
        return {**super().inputs(p), "args": self.args[p]}

    def program_pool(self, prog) -> list:
        return [{**cols, "param_args": self.args[p]}
                for p, cols in enumerate(super().program_pool(prog))]
