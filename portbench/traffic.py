"""Traffic mixes: data files of parameters, each read by the generator it
names.

A mix (``portbench/traffic/<mix>.json``) names its generator
(``"generator"``: ``portbench/generators/<generator>.py``), the loop that
drives it (``"loop"``: ``portbench/loops/<loop>.py``) and the entry the
loop submits to (``"entry"``: ``portbench/entries/<entry>.py``). A
generator module defines ``Traffic(mix, config, seed, device)``; what
a loop and the replay ask of it is in ``generators/__init__.py``. The
helpers here are shared by the generators.
"""

from __future__ import annotations

import importlib
import json
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

#: steps of the verdict-sample plan (far more than a window holds)
SAMPLE_PLAN = 1 << 16


def load_mix(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "traffic", name + ".json")) as fh:
        return json.load(fh)


def make(mix: dict, config: dict, seed: int, device):
    """The inputs of one run, by the generator the mix names."""
    gen = importlib.import_module(f"portbench.generators.{mix['generator']}")
    return gen.Traffic(mix, config, seed, device)


def seed64(seed: int, salt: int) -> int:
    """A 64-bit generator seed from ``--seed`` (any size, any sign) and
    a salt that keeps the streams of one run apart."""
    return (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) \
        % (1 << 64)


def zipf_ranks(n: int, names: int, s: float, gen: torch.Generator,
               device) -> torch.Tensor:
    """``n`` ranks in ``[0, names)``, P(rank i) ∝ 1 / (i + 1)^s, by the
    inverse of the cumulative distribution (float64)."""
    w = torch.arange(1, names + 1, dtype=torch.float64, device=device).pow(-s)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    return torch.clamp(torch.searchsorted(cdf, u, right=True),
                       max=names - 1).to(torch.int32)
