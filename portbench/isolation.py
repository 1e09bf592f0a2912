"""Which forbidden packages a process has loaded: the JAX package this
port was made from, JAX itself and its companions. Modules are compared
by their whole top-level name (``sentinel_tpu_torch`` is not
``sentinel_tpu``)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sentinel_tpu"})


def top_level(names) -> set:
    return {n.split(".", 1)[0] for n in names}


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted(top_level(names) & FORBIDDEN)
