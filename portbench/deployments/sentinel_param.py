""":mod:`sentinel`'s program with hot-parameter rules: it also exports
the state of every (rule, value) key the program interned, as the plain
reference (``reference/sentinel_param.py``) exports its own, under the
same leaf names and in the same order: sorted by (rule position, value),
read through the key registry's ``items()``.

The leaves (``param_buckets.*``): ``count`` (the number of keys),
``keys`` (``position · 2^32 + value + 2^31``), ``tokens``,
``last_fill_ms``, ``latest_passed_ms`` (the pacing clock) and
``threshold`` (a hot item's count, else the rule's). The program's
arrays are padded to its key capacity, so that a key it lacks shifts
every later key against the reference's instead of cutting the
comparison short.

A program whose fused entry takes no ``param_args`` (one older than the
fused path's hot-parameter support) cannot run the configuration:
:func:`build` refuses it before it builds anything.
"""

from __future__ import annotations

import inspect

import numpy as np

from portbench import deploy
from portbench.deployments import sentinel

#: the leaves of the keys' state, by the program's ``param_dyn`` names
DYN = ("tokens", "last_fill_ms", "latest_passed_ms")


def param_leaves(config: dict, registry, state: dict) -> dict:
    """``param_buckets.*`` of the program: ``registry`` its key registry,
    ``state`` its engine state as numpy leaves (``param_dyn.*``)."""
    items = registry.items()
    n = len(items)
    slot = np.fromiter((s for (s, _v), _r in items), np.int64, count=n)
    value = np.fromiter((v for (_s, v), _r in items), np.int64, count=n)
    row = np.fromiter((r for _k, r in items), np.int64, count=n)
    keys = slot * 2 ** 32 + value + 2 ** 31
    order = np.argsort(keys, kind="stable")
    slot, keys, row = slot[order], keys[order], row[order]
    count = np.array([float(f["count"]) for _rank, f in
                      deploy.rules_of(config)["param"]], np.float64)
    override = state["param_dyn.override"][row].astype(np.float64)
    size = state["param_dyn.tokens"].shape[0]

    def padded(a, fill):
        out = np.full(size, fill, a.dtype)
        out[:n] = a
        return out

    out = {"param_buckets.count": np.array([n], np.int64),
           "param_buckets.keys": padded(keys, -1),
           "param_buckets.threshold": padded(
               np.where(override >= 0, override, count[slot]), -1.0)}
    for name in DYN:
        out[f"param_buckets.{name}"] = padded(
            state[f"param_dyn.{name}"][row], 0)
    return out


class Program(sentinel.Program):
    """:class:`sentinel.Program`, its state with the keys' leaves."""

    def __init__(self, config: dict, device):
        self.config = config
        super().__init__(config, device)

    def state(self) -> dict:
        out = super().state()
        out.update(param_leaves(self.config, self.sph.param_key_registry,
                                out))
        return out


def build(config: dict, device) -> Program:
    import sentinel_tpu_torch as stt
    if "param_args" not in inspect.signature(
            stt.Sentinel.decide_and_exit_raw_nowait).parameters:
        raise SystemExit("portbench: this program's fused entry takes no "
                         "param_args: it cannot run hot-parameter rules")
    return Program(config, device)
