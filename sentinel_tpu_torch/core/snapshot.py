"""Counter-state snapshot / warm restart.

Port of ``sentinel_tpu/core/snapshot.py``, with the same file format, so
a snapshot written by either package restores in the other. The
reference deliberately has NO stats checkpointing (windows are seconds
deep; restart = cold counters), and rules persist through writable
datasources. This module keeps that stance but adds the cheap extra the
dense design makes possible: the whole counter state is a handful of
tensors, so a warm restart can resume sliding windows, breaker states,
pacing clocks, and occupy bookings across a process restart.

Format: one ``.npz`` whose ``leaf_<i>`` arrays are the engine state's
leaves in the order of the reference's ``jax.tree.flatten`` of its state
(the NamedTuples' field order, ``None`` fields left out, device-slot
states by position — the port's state has the same fields in the same
order), plus a ``.meta.json`` sidecar with the geometry, a digest of the
loaded rules, the registries' contents (name → row) and the epoch, so
absolute window indices stay meaningful. Restore requires identical
engine geometry. Neither the tiering sketch nor the cold tier is saved,
as in the reference. A row-sharded engine saves each row-split leaf whole,
its blocks copied to the host one by one, and restores through its
placements (``Sentinel._pin_state_locked``), so a snapshot of an N-block
engine restores into a one-block engine and back.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Iterator, List

import numpy as np
import torch

from sentinel_tpu_torch.parallel.row_blocks import RowBlocks

_META_SUFFIX = ".meta.json"

_FORMAT_VERSION = 1


def _leaves(tree) -> Iterator[torch.Tensor]:
    """The state's tensors in ``jax.tree.flatten`` order (``None`` and
    empty tuples yield nothing)."""
    if tree is None:
        return
    if isinstance(tree, tuple):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def _rebuild(tree, it: Iterator[torch.Tensor]):
    """``tree`` with each leaf replaced by the next item of ``it``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_rebuild(v, it) for v in tree)
    return next(it)


def _rules_digest(sentinel) -> str:
    """Fingerprint of the loaded rule sets: flow_dyn/breaker state is
    slot-indexed, so restoring it under a different rule compilation would
    attach pacing clocks and breaker states to the wrong rules."""
    from sentinel_tpu_torch.rules import codec
    parts = [codec.rules_to_json(t, g()) for t, g in (
        ("flow", sentinel.get_flow_rules),
        ("degrade", sentinel.get_degrade_rules),
        ("system", sentinel.get_system_rules),
        ("authority", sentinel.get_authority_rules),
        ("paramFlow", sentinel.get_param_flow_rules))]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def _geometry(sentinel) -> dict:
    s = sentinel.spec
    return {
        "rows": s.rows, "alt_rows": s.alt_rows,
        "second": [s.second.buckets, s.second.win_ms],
        "minute": [s.minute.buckets, s.minute.win_ms] if s.minute else None,
        "param_keys": s.param_keys,
        "max_flow_rules": sentinel.cfg.max_flow_rules,
        "max_degrade_rules": sentinel.cfg.max_degrade_rules,
    }


def save_state(sentinel, path: str) -> None:
    """Snapshot the device state + registries of a Sentinel instance.
    On a ``"rows"`` mesh that spans processes it raises
    :class:`~sentinel_tpu_torch.parallel.row_blocks.RemoteRowsError`
    before it flushes anything, as the JAX package's raises."""
    sentinel._refuse_remote_rows("save_state")
    # land buffered fast-path stats and reconcile live lease remainders
    # first: the restored process knows nothing about host-held tokens, so
    # leaving them reserved would snapshot phantom passes
    sentinel._fast.expire_all()
    sentinel._flush_fast()
    with sentinel._lock:
        arrays = {f"leaf_{i}": (x.to_numpy() if isinstance(x, RowBlocks)
                                else x.detach().cpu().numpy())
                  for i, x in enumerate(_leaves(sentinel._state))}
        meta = {
            "version": _FORMAT_VERSION,
            "geometry": _geometry(sentinel),
            "rules_digest": _rules_digest(sentinel),
            "epoch_ms": sentinel.epoch_ms,
            "saved_at_ms": sentinel.clock.now_ms(),
            "resources": sentinel.resources.items(),
            "origins": sentinel.origins.items(),
            "contexts": sentinel.contexts.items(),
        }
    # atomic: a crash mid-save must not leave a truncated snapshot that a
    # later warm restart trips over
    npz_final = path if str(path).endswith(".npz") else str(path) + ".npz"
    tmp_npz = f"{npz_final}.{os.getpid()}.tmp"
    with open(tmp_npz, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp_npz, npz_final)
    tmp_meta = f"{path}{_META_SUFFIX}.{os.getpid()}.tmp"
    Path(tmp_meta).write_text(json.dumps(meta))
    os.replace(tmp_meta, str(path) + _META_SUFFIX)


def load_state(sentinel, path: str):
    """Warm-restore a snapshot into a fresh Sentinel with the same geometry.

    → ``"full"`` (everything restored), ``"partial"`` (the loaded RULES
    differ from the snapshot's: window counters + epoch restore — their
    meaning is keyed by resource rows, which matched — while the
    slot-indexed flow pacing / breaker / hot-param state stays cold), or
    ``False`` (missing, corrupt, geometry or registry mismatch → cold
    start, the reference's own restart behavior). Both truthy results
    restore; callers needing exactly-full check ``== "full"``. Rules are
    NOT restored (they live in datasources): load rules first, then
    restore counters.
    """
    meta_path = Path(str(path) + _META_SUFFIX)
    npz_path = Path(path if str(path).endswith(".npz") else str(path) + ".npz")
    if not meta_path.exists() or not npz_path.exists():
        return False
    try:
        meta = json.loads(meta_path.read_text())
        data = np.load(npz_path)
    except Exception:        # truncated/corrupt snapshot → cold start
        return False
    if meta.get("version") != _FORMAT_VERSION:
        return False
    if meta.get("geometry") != _geometry(sentinel):
        return False
    digest_ok = meta.get("rules_digest") == _rules_digest(sentinel)
    with sentinel._lock:
        live = list(_leaves(sentinel._state))
        if len(live) != len(data.files):
            return False
        restored: List[np.ndarray] = []
        try:
            for i, cur in enumerate(live):
                arr = data[f"leaf_{i}"]
                if tuple(arr.shape) != tuple(cur.shape):
                    return False
                restored.append(arr)
        except Exception:    # a corrupt member → cold start
            return False
        # registries FIRST (before touching device state): re-intern in
        # row-id order so a fresh registry assigns the same ids. Snapshots
        # taken after evictions have id holes and restore cold. On
        # mismatch the instance stays cold (some names pre-interned,
        # counters untouched).
        for reg_name, reg in (("resources", sentinel.resources),
                              ("origins", sentinel.origins),
                              ("contexts", sentinel.contexts)):
            for name, rid in sorted(meta[reg_name], key=lambda p: p[1]):
                if reg.get_or_create(name) != rid:
                    return False      # interning drifted: treat as cold
        # a meshed engine splits the host arrays into its blocks below
        dev = "cpu" if sentinel.mesh is not None else sentinel.device
        full = _rebuild(sentinel._state, iter([
            torch.from_numpy(np.ascontiguousarray(
                arr.astype(_NP_DTYPES[cur.dtype]))).to(dev)
            for arr, cur in zip(restored, live)]))
        if digest_ok:
            # live-concurrency counters must NOT survive: the snapshot's
            # in-flight entries never exit in this process, so restored
            # thread counts would be phantom forever
            new_state = full._replace(
                threads=sentinel._state.threads,
                alt_threads=sentinel._state.alt_threads)
        else:
            # rules changed since the snapshot → windows (row-keyed,
            # still meaningful) carry over, slot-indexed state stays cold
            new_state = sentinel._state._replace(
                second=full.second, minute=full.minute,
                alt_second=full.alt_second)
        sentinel._state = new_state
        sentinel._pin_state_locked()
        # window indices derive from absolute wall time, so they stay
        # valid across the restart; the relative-ms epoch must carry over
        # for pacing clocks/warm-up state to stay meaningful
        sentinel.epoch_ms = meta["epoch_ms"]
    return "full" if digest_ok else "partial"


_NP_DTYPES = {torch.bool: np.bool_, torch.int8: np.int8, torch.int16: np.int16,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.uint8: np.uint8, torch.float32: np.float32,
              torch.float64: np.float64}
