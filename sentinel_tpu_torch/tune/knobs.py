"""The serving knob registry: every ``SENTINEL_*`` tuning knob, typed.

Port of ``sentinel_tpu/tune/knobs.py``: the same knobs, names, defaults,
clamps and sweep grids, so the validator's findings and an artifact's
knob set agree in both packages. Each read site stays authoritative for
its own hot path (``runtime.pipeline_depth``, the ``frontend_*`` clamps
in frontend/batcher.py, ``ops/sortfree.table_bits``, the tiering,
control and RT-histogram helpers); this module is the REGISTRY over
them: one :class:`KnobSpec` per knob declaring type, clamp range,
default, and whether the knob is **runtime-applicable** (a new
:class:`~sentinel_tpu_torch.frontend.AdaptiveBatcher` /
:class:`~sentinel_tpu_torch.serving.DispatchPipeline` over the same
engine picks it up) or **trace-scope** (read when the engine is built or
at every step: host staging, single dispatch, the sort-free switch and
its table sizing — the runner gives each a fresh ``Sentinel``).

Two knobs have no read site in the port and stay registered so that
setting them is not reported as a typo: ``SENTINEL_DONATE`` (torch has
no buffer donation; the port's steps update state in place) and
``SENTINEL_SORTFREE_CHUNK`` (the reference's ``lax.scan`` chunk; the
port ranks without a scan).

``tests/test_torch_tune.py::test_registry_matches_runtime_clamps`` pins
every spec's (default, clamp) against the port's read-site helper under
extreme env values.

:func:`validate_environ` scans ``os.environ`` for ``SENTINEL_*`` keys
and reports typos and out-of-clamp or unparsable values — surfaced via
RecordLog and the ``tune.knob_rejected`` counter at ``Sentinel``
construction.
"""

from __future__ import annotations

import contextlib
import difflib
import os
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

SCOPE_RUNTIME = "runtime"   # new batcher/pipeline picks it up in place
SCOPE_TRACE = "trace"       # read at engine build / every step

#: Spellings the ``_env_on`` boolean reader recognizes (runtime.py) —
#: anything else is "on", which is exactly the silent-typo trap the
#: validator warns about.
_BOOL_FALSE = ("0", "off", "false", "disable", "disabled")
_BOOL_TRUE = ("1", "on", "true", "yes", "enable", "enabled")


class KnobSpec(NamedTuple):
    """One tunable serving knob (see module docstring for field roles)."""

    env: str                       # the environment variable
    kind: str                      # "int" | "float" | "bool"
    default: object                # value when unset (None = auto/derived)
    lo: Optional[float]            # clamp bounds (None for bool/auto)
    hi: Optional[float]
    scope: str                     # SCOPE_RUNTIME | SCOPE_TRACE
    values: Tuple                  # default sweep grid for the search
    doc: str                       # one-line operator description

    def parse(self, raw: str):
        """(value, ok): the value the READ SITE would actually use for
        ``raw`` (clamped — the helpers clamp rather than reject), and
        whether ``raw`` was well-formed and inside the clamp range."""
        if self.kind == "bool":
            v = raw.lower() not in _BOOL_FALSE
            ok = raw.lower() in _BOOL_FALSE + _BOOL_TRUE
            return v, ok
        cast = float if self.kind == "float" else int
        try:
            v = cast(raw)
        except ValueError:
            return self.default, False
        clamped = min(self.hi, max(self.lo, v))
        if self.kind == "int":
            clamped = int(clamped)
        return clamped, clamped == v

    def coerce(self, v):
        """Clamp an artifact/search value into this knob's domain."""
        if self.kind == "bool":
            return bool(v)
        cast = float if self.kind == "float" else int
        v = cast(v)
        if self.lo is not None:
            v = min(self.hi, max(self.lo, v))
        return cast(v)


#: The tunable registry. Clamp bounds and defaults MIRROR the read-site
#: helpers (named per knob below); test_tune.py pins the agreement.
KNOBS: Tuple[KnobSpec, ...] = (
    # runtime.pipeline_depth() — dispatch-pipeline in-flight window
    KnobSpec("SENTINEL_PIPELINE_DEPTH", "int", 2, 1, 64, SCOPE_RUNTIME,
             (1, 2, 4, 8),
             "depth-k dispatch window (serving.py DispatchPipeline)"),
    # frontend/batcher.py frontend_batch_max()
    KnobSpec("SENTINEL_FRONTEND_BATCH", "int", 256, 1, 1 << 16,
             SCOPE_RUNTIME, (64, 128, 256, 512),
             "adaptive-batcher B_max (flush-when-full bound)"),
    # frontend/batcher.py frontend_deadline_ms()
    KnobSpec("SENTINEL_FRONTEND_DEADLINE_MS", "int", 25, 1, 60_000,
             SCOPE_RUNTIME, (10, 25, 50),
             "default per-request latency budget"),
    # frontend/batcher.py frontend_budget_ms()
    KnobSpec("SENTINEL_FRONTEND_BUDGET_MS", "int", 3, 0, 10_000,
             SCOPE_RUNTIME, (1, 3, 6),
             "dispatch+device reserve subtracted from each deadline"),
    # frontend/batcher.py frontend_idle_ms()
    KnobSpec("SENTINEL_FRONTEND_IDLE_MS", "float", 1.0, 0.0, 1000.0,
             SCOPE_RUNTIME, (0.5, 1.0, 2.0),
             "arrival gap after which a partial batch flushes"),
    # frontend/batcher.py frontend_queue_max() — default derives from
    # B_max (8·B_max), so the registry default is None ("auto")
    KnobSpec("SENTINEL_FRONTEND_QUEUE", "int", None, 1, 1 << 22,
             SCOPE_RUNTIME, (),
             "backpressure bound (default 8·B_max)"),
    # the reference's runtime.donation_enabled(); no read site here
    KnobSpec("SENTINEL_DONATE", "bool", True, None, None, SCOPE_TRACE,
             (True, False),
             "no effect in the port (the reference donates state buffers)"),
    # runtime.host_staging_enabled() — preallocated host batch columns
    KnobSpec("SENTINEL_HOST_STAGING", "bool", True, None, None,
             SCOPE_TRACE, (True, False),
             "reuse pinned host staging rings for batch columns"),
    # runtime.sortfree_enabled() — hash-bucketed general aggregation
    KnobSpec("SENTINEL_SORTFREE", "bool", True, None, None, SCOPE_TRACE,
             (True, False),
             "sort-free claim-cascade general path (vs sorted reference)"),
    # runtime.single_dispatch_enabled() — the tiering sketch update (and
    # the telemetry / decay epilogue on the fused path) ride the decide
    # call; =0 makes them calls of their own
    KnobSpec("SENTINEL_SINGLE_DISPATCH", "bool", True, None, None,
             SCOPE_TRACE, (True, False),
             "fuse sketch observe + tick epilogue into the decide dispatch"),
    # ops/sortfree.py table_bits() — auto-sized from the batch when
    # unset (default None); an explicit override clamps to [1, 18] (the
    # sub-6 range exists for the collision-forcing parity tests)
    KnobSpec("SENTINEL_SORTFREE_BITS", "int", None, 1, 18, SCOPE_TRACE,
             (8, 10, 12, 14),
             "claim-table size override (2^bits buckets)"),
    # the reference's ops/sortfree.py chunk_size(); no read site here
    KnobSpec("SENTINEL_SORTFREE_CHUNK", "int", 256, 16, 4096, SCOPE_TRACE,
             (64, 256, 1024),
             "no effect in the port (the reference's claim-scan chunk)"),
    # tiering/manager.py tier_hot_rows() — device hot-tier row target;
    # default None = the engine's max_resources (tiering keeps the whole
    # table hot). Empty sweep grid: sizing is workload-skew-bound, not a
    # latency/throughput trade the halving search can score.
    KnobSpec("SENTINEL_HOT_ROWS", "int", None, 64, 1 << 24, SCOPE_RUNTIME,
             (),
             "device hot-tier size (rows the ticker keeps resident)"),
    # tiering/manager.py tier_sketch_bits() — count-min width = 2^bits
    KnobSpec("SENTINEL_SKETCH_BITS", "int", 12, 4, 22, SCOPE_RUNTIME,
             (),
             "count-min sketch width exponent (2^bits counters per row)"),
    # tiering/manager.py tier_sketch_rows()
    KnobSpec("SENTINEL_SKETCH_ROWS", "int", 4, 1, 8, SCOPE_RUNTIME,
             (),
             "count-min sketch depth (independent hash rows)"),
    # tiering/manager.py tier_tick_ms() — promotion/demotion cadence
    KnobSpec("SENTINEL_TIER_TICK_MS", "int", 200, 10, 60_000,
             SCOPE_RUNTIME, (),
             "tiering ticker period (sketch decay + demote scan)"),
    # control/loop.py — the overload controller (empty sweep grids:
    # the control law is an SLO policy, not a latency/throughput trade
    # the halving search can score; the gate (n) episode pins behavior)
    KnobSpec("SENTINEL_CONTROL_INTERVAL_MS", "int", 1000, 50, 60_000,
             SCOPE_RUNTIME, (),
             "overload-controller tick cadence (control/loop.py)"),
    KnobSpec("SENTINEL_CONTROL_P99_HI_MS", "float", 20.0, 1.0, 60_000.0,
             SCOPE_RUNTIME, (),
             "interval p99 above which the controller sheds (AIMD MD)"),
    KnobSpec("SENTINEL_CONTROL_P99_LO_MS", "float", 10.0, 0.5, 60_000.0,
             SCOPE_RUNTIME, (),
             "interval p99 below which admission recovers (AIMD AI)"),
    KnobSpec("SENTINEL_CONTROL_MIN_ADMIT", "float", 0.05, 0.01, 1.0,
             SCOPE_RUNTIME, (),
             "admission-fraction floor (the shed never black-holes)"),
    KnobSpec("SENTINEL_CONTROL_COOLDOWN_MS", "int", 2000, 100, 600_000,
             SCOPE_RUNTIME, (),
             "per-action repeat bound (anti-flap, with the hysteresis band)"),
    KnobSpec("SENTINEL_CONTROL_DEGRADE_RT_MS", "float", 0.0, 0.0, 60_000.0,
             SCOPE_RUNTIME, (),
             "per-resource RT tail (p99) bound forcing breaker arcs (0 = off)"),
    # obs/resource_hist.py — device-resident per-resource RT histograms.
    # Both trace-scope: they size the ``rt_hist`` state leaf. Empty sweep
    # grids — observability switches, not latency/throughput trades.
    KnobSpec("SENTINEL_RESOURCE_HIST_DISABLE", "bool", False, None, None,
             SCOPE_TRACE, (),
             "drop the per-resource RT histogram table (pre-r20 programs)"),
    KnobSpec("SENTINEL_RESOURCE_HIST_BUCKETS", "int", 32, 8, 32,
             SCOPE_TRACE, (),
             "RT histogram bucket count (log2 ms buckets, int32-safe cap)"),
)

KNOB_BY_ENV: Dict[str, KnobSpec] = {k.env: k for k in KNOBS}

#: AdaptiveBatcher constructor kwarg ↔ knob env (Sentinel.frontend()
#: fills unset kwargs from a loaded TUNED.json through this map).
FRONTEND_KWARG_ENVS: Tuple[Tuple[str, str], ...] = (
    ("batch_max", "SENTINEL_FRONTEND_BATCH"),
    ("deadline_ms", "SENTINEL_FRONTEND_DEADLINE_MS"),
    ("budget_ms", "SENTINEL_FRONTEND_BUDGET_MS"),
    ("idle_ms", "SENTINEL_FRONTEND_IDLE_MS"),
    ("queue_max", "SENTINEL_FRONTEND_QUEUE"),
    ("depth", "SENTINEL_PIPELINE_DEPTH"),
)

#: Recognized NON-tunable operational keys (observability, multihost
#: bootstrap, cold start, native path, ...) — listed so the validator
#: can tell a typo from a real operational knob. Value checking for
#: these is parse-only where a caster is declared.
OPERATIONAL_ENVS: Dict[str, Optional[type]] = {
    "SENTINEL_OBS_DISABLE": None,
    "SENTINEL_TRACE_SAMPLE": float,
    "SENTINEL_FLIGHT_DISABLE": None,
    "SENTINEL_FLIGHT_WINDOW_MS": int,
    "SENTINEL_FLIGHT_P99_MS": float,
    "SENTINEL_FLIGHT_BLOCK_BURST": int,
    "SENTINEL_TELEMETRY_K": int,
    "SENTINEL_TELEMETRY_DISABLE": None,
    "SENTINEL_CONTROL_DISABLE": None,
    "SENTINEL_TIERING_DISABLE": None,
    "SENTINEL_TIER_COLD_MAX": int,
    "SENTINEL_FIRST_LOAD_TIMEOUT_S": float,
    "SENTINEL_FIRST_LOAD_RETRIES": int,
    "SENTINEL_COMPILE_CACHE": None,
    "SENTINEL_INIT_MODE": None,
    "SENTINEL_INIT_WAIT_TIMEOUT_S": float,
    "SENTINEL_COORDINATOR": None,
    "SENTINEL_NUM_PROCESSES": int,
    "SENTINEL_PROCESS_ID": int,
    "SENTINEL_LOCAL_DEVICES": int,
    "SENTINEL_MH_PLATFORM": None,
    "SENTINEL_DASH_AGENT_TIMEOUT_S": float,
    "SENTINEL_DEMO_ONESHOT": None,
    "SENTINEL_TUNED_CONFIG": None,
    "SENTINEL_TPU_NATIVE": None,
    "SENTINEL_TPU_LOG_DIR": None,
    "SENTINEL_TPU_PLUGINS": None,
    "SENTINEL_TPU_CONFIG_FILE": None,
}


def _config_field_envs() -> frozenset:
    """``SENTINEL_TPU_<FIELD>`` keys from the SentinelConfig dataclass
    (core/config.py maps the prefix onto config fields)."""
    import dataclasses
    from sentinel_tpu_torch.core.config import SentinelConfig
    return frozenset("SENTINEL_TPU_" + f.name.upper()
                     for f in dataclasses.fields(SentinelConfig))


def known_envs() -> frozenset:
    """Every recognized ``SENTINEL_*`` environment key."""
    return (frozenset(KNOB_BY_ENV) | frozenset(OPERATIONAL_ENVS)
            | _config_field_envs())


def validate_environ(environ=None) -> List[str]:
    """Scan for ``SENTINEL_*`` keys that are unknown (typos — with a
    did-you-mean when close), unparsable, or outside a knob's clamp
    range. Returns one warning string per finding; the caller
    (``Sentinel.__init__``) routes them to RecordLog and ticks
    ``tune.knob_rejected`` once per finding."""
    env = os.environ if environ is None else environ
    known = known_envs()
    warnings: List[str] = []
    for key in sorted(k for k in env if k.startswith("SENTINEL_")):
        raw = env[key]
        if key not in known:
            hint = difflib.get_close_matches(key, known, n=1, cutoff=0.75)
            suffix = f" (did you mean {hint[0]}?)" if hint else ""
            warnings.append(
                f"unknown env knob {key}={raw!r} is ignored{suffix}")
            continue
        spec = KNOB_BY_ENV.get(key)
        if spec is not None:
            used, ok = spec.parse(raw)
            if not ok:
                warnings.append(
                    f"env knob {key}={raw!r} is outside "
                    f"[{spec.lo}, {spec.hi}]" if spec.kind != "bool"
                    else f"env knob {key}={raw!r} is not a recognized "
                    f"boolean spelling (reads as "
                    f"{'on' if used else 'off'})")
            continue
        caster = OPERATIONAL_ENVS.get(key)
        if caster is not None and raw:
            try:
                caster(raw)
            except ValueError:
                warnings.append(
                    f"env knob {key}={raw!r} does not parse as "
                    f"{caster.__name__}")
    return warnings


def defaults() -> Dict[str, object]:
    """env → default value for every knob with a concrete default."""
    return {k.env: k.default for k in KNOBS if k.default is not None}


def coerce_config(knob_values: Dict[str, object]) -> Dict[str, object]:
    """Validate + clamp an artifact/search config dict; unknown knob
    names raise (an artifact must never smuggle arbitrary env keys)."""
    out: Dict[str, object] = {}
    for env, v in knob_values.items():
        spec = KNOB_BY_ENV.get(env)
        if spec is None:
            raise ValueError(f"unknown tuning knob {env!r}")
        out[env] = spec.coerce(v)
    return out


def trace_knobs(knob_values: Dict[str, object]) -> Dict[str, object]:
    """The trace-scope subset — the part whose change forces a fresh
    engine (the runner keys its parity checks on this)."""
    return {e: v for e, v in knob_values.items()
            if KNOB_BY_ENV[e].scope == SCOPE_TRACE}


def env_strings(knob_values: Dict[str, object]) -> Dict[str, str]:
    """Knob values → the env-var string encoding the read sites parse."""
    out = {}
    for env, v in knob_values.items():
        if KNOB_BY_ENV[env].kind == "bool":
            out[env] = "1" if v else "0"
        else:
            out[env] = repr(v) if isinstance(v, float) else str(v)
    return out


@contextlib.contextmanager
def env_overrides(knob_values: Dict[str, object]):
    """Apply a trial config through the env read sites (the only way
    trace-scope knobs reach a fresh engine), restoring the previous
    values on exit."""
    strs = env_strings(knob_values)
    saved = {k: os.environ.get(k) for k in strs}
    os.environ.update(strs)
    try:
        yield
    finally:
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
