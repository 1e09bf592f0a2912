"""TUNED.json: the per-hardware pinned-config artifact.

Port of ``sentinel_tpu/tune/artifact.py``, same schema and same document.
A sweep (:mod:`sentinel_tpu_torch.tune.runner`, ``python -m
sentinel_tpu_torch.tune``) ends by writing one small JSON document — the
winning knob values, the hardware fingerprint they were measured on,
and the scores that justify them — so every later deployment on the
same hardware starts pre-tuned: point ``SENTINEL_TUNED_CONFIG`` at the
artifact and ``Sentinel`` / ``Sentinel.frontend()`` /
``DispatchPipeline`` pick the knobs up at startup.

Fingerprint (:func:`fingerprint`), read from torch for the engine's own
device: ``backend`` (``"cuda"`` or ``"cpu"``), ``device_kind``
(``torch.cuda.get_device_name`` on the card, ``"cpu"`` on the CPU),
``n_devices_visible`` (``torch.cuda.device_count()``, 1 on the CPU),
``host_cores`` and the ``mesh`` block (``n_devices``, ``axis`` and
``sharded``: one unsharded device, or a row-sharded engine's layout from
``parallel.local_shard.mesh_topology``; a ``"rows"`` mesh over processes
adds ``process_count``, and its ``n_devices`` counts the global blocks).
The five fields are the reference's, so an artifact swept
on a TPU is read here and falls back to defaults on its
``backend``/``device_kind``. Geometry is deliberately not part of it:
geometry is configuration, not hardware.

Mismatch semantics: :func:`overrides_for` returns ``None`` when the
stored fingerprint differs from the live one in ANY field — the engine
then runs on defaults exactly as if ``SENTINEL_TUNED_CONFIG`` were
unset, logs the first differing field via RecordLog, and ticks
``tune.fingerprint_fallback``. A matching load ticks
``tune.config_loaded``.

Precedence: explicit env always beats the artifact — a knob whose
``SENTINEL_*`` variable is set in the environment keeps the env value;
the artifact only fills knobs the operator left unset.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

from sentinel_tpu_torch.obs import counters as obs_keys
from sentinel_tpu_torch.tune import knobs as knobs_mod

SCHEMA = "sentinel_tune/1"
TUNED_CONFIG_ENV = "SENTINEL_TUNED_CONFIG"


def fingerprint(device=None, mesh=None, spec=None) -> Dict:
    """The live hardware/layout fingerprint of ``device`` (``cuda``
    unless given; a mesh's home device when ``mesh`` is given) and of
    the row blocks of ``mesh`` (see module docstring; ``spec`` is the
    engine's geometry, when known)."""
    import torch

    from sentinel_tpu_torch.parallel import local_shard
    from sentinel_tpu_torch.runtime import resolve_device
    if mesh is None:
        mesh_block = {"n_devices": 1, "axis": None, "sharded": False}
    else:
        m = local_shard.as_row_mesh(mesh)
        if device is None:
            device = m.home
        if spec is not None:
            topo = local_shard.mesh_topology(spec, m)
            mesh_block = {k: topo.get(k)
                          for k in ("n_devices", "axis", "sharded")}
        else:
            mesh_block = {"n_devices": int(m.shape[local_shard.MESH_AXIS]),
                          "axis": local_shard.MESH_AXIS, "sharded": True}
        if m.process_count > 1:
            # a mesh over processes: n_devices counts the global blocks
            mesh_block["process_count"] = m.process_count
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        kind = str(torch.cuda.get_device_name(index))
        visible = int(torch.cuda.device_count())
    else:
        kind, visible = dev.type, 1
    return {
        "backend": dev.type,
        "device_kind": kind,
        "n_devices_visible": visible,
        "host_cores": int(os.cpu_count() or 1),
        "mesh": mesh_block,
    }


def fingerprints_match(stored: Dict, live: Dict) -> Tuple[bool, str]:
    """(match, first differing field) — exact equality field by field."""
    for k in ("backend", "device_kind", "n_devices_visible", "host_cores"):
        if stored.get(k) != live.get(k):
            return False, f"{k}: {stored.get(k)!r} != {live.get(k)!r}"
    sm, lm = stored.get("mesh") or {}, live.get("mesh") or {}
    for k in ("n_devices", "axis", "sharded"):
        if sm.get(k) != lm.get(k):
            return False, f"mesh.{k}: {sm.get(k)!r} != {lm.get(k)!r}"
    # one process when the block has no count (the JAX package's artifacts)
    if sm.get("process_count", 1) != lm.get("process_count", 1):
        return False, (f"mesh.process_count: {sm.get('process_count', 1)!r}"
                       f" != {lm.get('process_count', 1)!r}")
    return True, ""


def save_tuned(path: str, *, fingerprint: Dict, knob_values: Dict,
               score: Dict, baseline: Dict, slo_p99_ms: float,
               workload: Dict, trials: int, parity_checks: int) -> Dict:
    """Write the artifact (atomically: temp + rename) and return it."""
    doc = {
        "schema": SCHEMA,
        "fingerprint": fingerprint,
        "knobs": knobs_mod.coerce_config(knob_values),
        "score": score,
        "baseline": baseline,
        "slo_p99_ms": float(slo_p99_ms),
        "workload": workload,
        "trials": int(trials),
        "parity_checks": int(parity_checks),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1)
    os.replace(tmp, path)
    return doc


def load_tuned(path: str) -> Dict:
    """Read + schema/knob-validate an artifact (raises on malformation;
    the startup path below downgrades every failure to a logged
    fallback)."""
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: unknown schema {doc.get('schema')!r} "
                         f"(want {SCHEMA})")
    doc["knobs"] = knobs_mod.coerce_config(doc.get("knobs") or {})
    return doc


def overrides_for(doc: Dict, live_fp: Dict) -> Optional[Dict]:
    """Artifact knobs when the fingerprint matches, else ``None``."""
    ok, _why = fingerprints_match(doc.get("fingerprint") or {}, live_fp)
    return dict(doc["knobs"]) if ok else None


def resolve_startup(device=None, environ=None, mesh=None, spec=None):
    """Everything ``Sentinel.__init__`` needs for its ``device``, in one
    call that a missing, corrupt or mismatched artifact never makes
    raise: (overrides, events).

    * ``overrides`` — knob env → value from a fingerprint-matching
      artifact, MINUS any knob explicitly set in the environment (env
      wins per knob); ``{}`` when ``SENTINEL_TUNED_CONFIG`` is unset,
      unreadable, or mismatched.
    * ``events`` — ``(counter_key, message)`` pairs for the caller to
      route to RecordLog + obs counters once telemetry exists (the
      knob-validation warnings ride along here too).
    """
    env = os.environ if environ is None else environ
    events = [(obs_keys.TUNE_KNOB_REJECTED, w)
              for w in knobs_mod.validate_environ(env)]
    path = env.get(TUNED_CONFIG_ENV, "")
    if not path:
        return {}, events
    try:
        doc = load_tuned(path)
    except (OSError, ValueError) as e:
        events.append((obs_keys.TUNE_FALLBACK,
                       f"tuned config {path}: unreadable ({e}); "
                       f"serving on defaults"))
        return {}, events
    live = fingerprint(device, mesh, spec)
    ok, why = fingerprints_match(doc.get("fingerprint") or {}, live)
    if not ok:
        events.append((obs_keys.TUNE_FALLBACK,
                       f"tuned config {path}: fingerprint mismatch "
                       f"({why}); serving on defaults"))
        return {}, events
    overrides = {e: v for e, v in doc["knobs"].items() if e not in env}
    events.append((obs_keys.TUNE_LOADED,
                   f"tuned config {path}: loaded "
                   f"{len(overrides)}/{len(doc['knobs'])} knobs "
                   f"(env-set knobs keep their env values)"))
    return overrides, events


def provenance(device=None, environ=None, mesh=None, spec=None) -> Dict:
    """The provenance block for a bench record: did a tuned config
    apply, from where, under which fingerprint, and which per-knob
    values."""
    env = os.environ if environ is None else environ
    path = env.get(TUNED_CONFIG_ENV, "")
    block: Dict = {"tuned": False, "artifact": path or None}
    if not path:
        return block
    try:
        doc = load_tuned(path)
    except (OSError, ValueError) as e:
        block["error"] = str(e)
        return block
    live = fingerprint(device, mesh, spec)
    ok, why = fingerprints_match(doc.get("fingerprint") or {}, live)
    if not ok:
        block["fingerprint_mismatch"] = why
        return block
    block.update(tuned=True, fingerprint=doc["fingerprint"],
                 knobs=doc["knobs"])
    return block
