"""Carry engine state and rule tables between the JAX package and the port.

Both packages keep their device state as nested ``NamedTuple``\\ s with the
same field names. :func:`to_numpy` flattens either package's tree into a
dict of numpy arrays keyed by leaf path (``"second.counters"``,
``"flow_table.count"``, ``"param_dyn.tokens"``, ...);
:func:`state_from_numpy` and :func:`ruleset_from_numpy` build the port's
tensors from such a dict. A row-sharded engine's state carries over the
same way: :func:`state_blocks_from_numpy` builds the port's N row blocks
from the dict of a JAX engine's sharded state (``np.asarray`` of each
leaf gives the whole array), and :func:`state_blocks_to_numpy` brings the
blocks back to that dict, block by block. The device slots' states (``custom``) are
tuples whose items are arrays or tuples again: they flatten by position
(``"custom.0"``, ``"custom.1.0"``, ...) and come back as nested tuples.
:func:`engine_to_numpy` adds a runtime's tiering sketch table to its
state leaves, and :func:`cold_tier_to_numpy` flattens its host cold tier
by name. :func:`cluster_to_numpy` flattens a cluster token engine's
windows and rule table (``state.flows.counters``, ``table.count``, ...)
and :func:`cluster_from_numpy` builds the port's ``ClusterState`` and
``ClusterRuleTable`` from such a dict. Nothing here imports JAX: a JAX array converts through
``np.asarray``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sentinel_tpu_torch.engine.pipeline import RuleSet, SentinelState
from sentinel_tpu_torch.parallel.cluster import ClusterRuleTable, ClusterState
from sentinel_tpu_torch.parallel.row_blocks import RowBlocks
from sentinel_tpu_torch.rules.authority import AuthorityRuleTable
from sentinel_tpu_torch.rules.degrade import BreakerState, DegradeRuleTable
from sentinel_tpu_torch.rules.flow import FlowDynState, FlowRuleTable
from sentinel_tpu_torch.rules.param_flow import ParamDynState, ParamRuleTable
from sentinel_tpu_torch.rules.system import SystemThresholds
from sentinel_tpu_torch.stats.window import WindowState

# NamedTuple type of each nested field (the rest are array leaves)
_NESTED = {
    SentinelState: {"second": WindowState, "minute": WindowState,
                    "alt_second": WindowState, "flow_dyn": FlowDynState,
                    "breakers": BreakerState, "param_dyn": ParamDynState},
    RuleSet: {"flow_table": FlowRuleTable, "deg_table": DegradeRuleTable,
              "auth_table": AuthorityRuleTable,
              "sys_thresholds": SystemThresholds,
              "param_table": ParamRuleTable},
    ClusterState: {"flows": WindowState, "ns": WindowState,
                   "params": WindowState},
}


def to_numpy(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a (nested) NamedTuple of arrays/tensors → ``{path: array}``.
    ``None`` leaves and empty tuples are skipped."""
    out: Dict[str, np.ndarray] = {}
    if tree is None:
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            out.update(to_numpy(getattr(tree, name), prefix + name + "."))
        return out
    if isinstance(tree, tuple):
        for i, item in enumerate(tree):
            out.update(to_numpy(item, f"{prefix}{i}."))
        return out
    if isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    elif isinstance(tree, RowBlocks):
        out[prefix[:-1]] = tree.to_numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_numpy(cls, d: Dict[str, np.ndarray], device="cpu",
               prefix: str = ""):
    """A port ``NamedTuple`` of type ``cls`` (e.g. ``FlowDynState``) from a
    :func:`to_numpy` dict, leaves under ``prefix`` (fresh tensors on
    ``device``; optional fields absent from ``d`` keep their default)."""
    nested = _NESTED.get(cls, {})
    fields = {}
    for name in cls._fields:
        key = prefix + name
        if cls is SentinelState and name == "custom":
            fields[name] = _positional(d, device, key + ".")
        elif name in nested:
            fields[name] = from_numpy(nested[name], d, device, key + ".")
        elif key in d:
            fields[name] = _tensor(d[key], device)
        elif name not in cls._field_defaults:
            raise KeyError(f"missing leaf {key!r}")
    return cls(**fields)


def _positional(d: Dict[str, np.ndarray], device, prefix: str):
    """The nested tuple whose leaves sit under ``prefix`` by position
    (``prefix + "0"``, ``prefix + "1.0"``, ...)."""
    if prefix[:-1] in d:
        return _tensor(d[prefix[:-1]], device)
    heads = sorted({int(k[len(prefix):].split(".")[0]) for k in d
                    if k.startswith(prefix)})
    return tuple(_positional(d, device, f"{prefix}{i}.") for i in heads)


def state_from_numpy(d: Dict[str, np.ndarray],
                     device="cpu") -> SentinelState:
    """The port's :class:`SentinelState` from a :func:`to_numpy` dict
    (fresh tensors on ``device``; ``rt_hist`` None when absent)."""
    return from_numpy(SentinelState, d, device)


def state_blocks_from_numpy(d: Dict[str, np.ndarray], spec,
                            mesh) -> SentinelState:
    """The port's row-sharded :class:`SentinelState` on ``mesh`` (a
    ``parallel.local_shard`` mesh) from a :func:`to_numpy` dict — of a
    JAX engine's sharded state or of a one-block engine's: each row-split
    leaf becomes the mesh's row blocks, block ``i`` holding the rows
    ``[i·R/N, (i+1)·R/N)`` on ``mesh.devices[i]``; the replicated leaves
    land on the home device. ``spec`` is the engine's ``EngineSpec``."""
    from sentinel_tpu_torch.parallel import local_shard
    state = state_from_numpy(d, "cpu")
    return local_shard.pin_state(
        state, local_shard.state_shardings(spec, mesh, state))


def state_blocks_to_numpy(state: SentinelState) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_blocks_from_numpy`: a row-sharded
    state's leaves as one :func:`to_numpy` dict, each row-split leaf's
    blocks copied to the host one by one and joined there (fresh
    arrays)."""
    return {k: np.array(v, copy=True) for k, v in to_numpy(state).items()}


def ruleset_from_numpy(d: Dict[str, np.ndarray],
                       device="cpu") -> RuleSet:
    """The port's :class:`RuleSet` from a :func:`to_numpy` dict
    (``joint_idx`` None when absent)."""
    return from_numpy(RuleSet, d, device)


#: the leaf :func:`engine_to_numpy` files the tiering sketch table under
SKETCH_LEAF = "tiering.sketch"


def engine_to_numpy(sentinel) -> Dict[str, np.ndarray]:
    """A runtime's (either package's) engine state as :func:`to_numpy`
    leaves, plus the tiering count-min table as :data:`SKETCH_LEAF`
    when its tiering keeps one — copies, so the snapshot outlives the
    in-place updates of later steps (a CPU tensor's ``numpy()`` is a
    view)."""
    out = to_numpy(sentinel._state)
    tiering = getattr(sentinel, "tiering", None)
    sketch = getattr(tiering, "_sketch", None)
    if sketch is not None:
        out[SKETCH_LEAF] = to_numpy((sketch,))["0"]
    return {k: np.array(v, copy=True) for k, v in out.items()}


def rank_state_to_numpy(sentinel):
    """A runtime's state as this process holds it → ``(leaves,
    offsets)``: :func:`engine_to_numpy`'s leaves, but a row-split leaf of
    a mesh over processes holds only this rank's blocks (joined), and
    ``offsets[path]`` is the global row of its first row (replicated
    leaves have no entry). :func:`merge_rank_states` joins the ranks'."""
    offsets: Dict[str, int] = {}

    def local(tree, prefix=""):
        out: Dict[str, np.ndarray] = {}
        if tree is None:
            return out
        if isinstance(tree, tuple):
            names = (tree._fields if hasattr(tree, "_fields")
                     else [str(i) for i in range(len(tree))])
            for name, item in zip(names, tree):
                out.update(local(item, prefix + name + "."))
        elif isinstance(tree, RowBlocks) and tree.rank_local:
            out[prefix[:-1]] = np.concatenate(
                [b.detach().cpu().numpy() for b in tree.blocks])
            offsets[prefix[:-1]] = tree.first * tree.per
        else:
            out.update(to_numpy(tree, prefix))
        return out

    out = local(sentinel._state)
    tiering = getattr(sentinel, "tiering", None)
    sketch = getattr(tiering, "_sketch", None)
    if sketch is not None:
        out[SKETCH_LEAF] = to_numpy((sketch,))["0"]
    return {k: np.array(v, copy=True) for k, v in out.items()}, offsets


def merge_rank_states(dumps, offsets: Dict[str, int] = None):
    """Join per-rank :func:`rank_state_to_numpy` leaves (in rank order)
    → ``(leaves, unequal)``: each row-split leaf (a key of ``offsets``,
    any rank's) from the ranks' rows in row order, each other leaf
    rank 0's, and ``unequal`` the replicated paths on which some rank
    differs from rank 0. ``dumps`` is a list of ``(leaves, offsets)``."""
    split = {}
    for _leaves, offs in dumps:
        split.update(offs)
    merged, unequal = {}, []
    for key in dumps[0][0]:
        if key in split:
            parts = sorted(((offs[key], leaves[key])
                            for leaves, offs in dumps), key=lambda p: p[0])
            merged[key] = np.concatenate([p[1] for p in parts])
        else:
            merged[key] = dumps[0][0][key]
            if any(leaf_diff({key: merged[key]}, {key: leaves[key]})
                   for leaves, _o in dumps[1:]):
                unequal.append(key)
    return merged, unequal


def sketch_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> torch.Tensor:
    """The port's sketch table from an :func:`engine_to_numpy` dict."""
    return _tensor(d[SKETCH_LEAF], device)


def cold_tier_to_numpy(cold) -> Dict[str, Dict[str, np.ndarray]]:
    """A cold tier's (either package's) entries → ``{name: {field:
    array}}`` in the tier's order: every ``ColdEntry`` field, scalars as
    0-d arrays, each alt slice as ``alts.<kind>.<key id>.<i>``."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    with cold._lock:
        items = list(cold._entries.items())
    for name, e in items:
        leaves: Dict[str, np.ndarray] = {}
        for field, value in vars(e).items():
            if field == "alts":
                for (kind, key_id), alt in value.items():
                    for i, a in enumerate(alt):
                        leaves[f"alts.{kind}.{key_id}.{i}"] = np.asarray(a)
            elif value is not None:
                leaves[field] = np.asarray(value)
        out[name] = leaves
    return out


def cluster_to_numpy(engine) -> Dict[str, np.ndarray]:
    """A cluster token engine's (either package's) three windows under
    ``state.`` and its rule table under ``table.`` — copies (the port
    updates its state in place). A JAX engine's row-sharded arrays come
    back whole, shard ``s``'s rows at ``[s·L, (s+1)·L)`` as in the
    port."""
    out = to_numpy(engine.state, "state.")
    out.update(to_numpy(engine._table, "table."))
    return {k: np.array(v, copy=True) for k, v in out.items()}


def cluster_from_numpy(d: Dict[str, np.ndarray], device="cpu"):
    """The port's ``(ClusterState, ClusterRuleTable)`` from a
    :func:`cluster_to_numpy` dict (fresh tensors on ``device``)."""
    return (from_numpy(ClusterState, d, device, "state."),
            from_numpy(ClusterRuleTable, d, device, "table."))


def leaf_diff(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> list:
    """Paths of ``b`` whose arrays differ (missing, shape, dtype or any
    element) in ``a`` — both :func:`to_numpy` dicts."""
    bad = []
    for k in sorted(b):
        x, y = a.get(k), b.get(k)
        if (x is None or y is None or x.shape != y.shape
                or x.dtype != y.dtype or not np.array_equal(x, y)):
            bad.append(k)
    return bad
