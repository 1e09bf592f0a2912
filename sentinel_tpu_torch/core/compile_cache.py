"""Built-library cache and first-dispatch accounting — the cold-start
story of the port.

Port of ``sentinel_tpu/core/compile_cache.py``. The reference compiles
XLA programs per (geometry, variant) and keeps them in JAX's persistent
compilation cache. The port compiles no programs: its device code is
eager PyTorch plus hand-written libraries — the CUDA kernel
(``csrc/*.cu``, ``nvcc``) and the C++ interning tables
(``native/src``, ``g++``) — built at first use by ``ops/_build.py``
under names that carry a hash of their source and flags. So:

- ``SENTINEL_COMPILE_CACHE`` names the directory those libraries are
  built into and found in (:func:`cache_dir`). Unset keeps the
  git-ignored ``sentinel_tpu_torch/_build/``; ``0``/``off`` builds into
  a fresh directory for the process, so nothing is reused. A second
  process pointed at the same directory finds both libraries and runs
  neither ``nvcc`` nor ``g++``.
- ``compile_cache.hit`` / ``.miss`` count first against repeat
  dispatches of each :func:`program_key`, exactly as the reference
  counts them (``Sentinel._first_dispatch_locked``): the keys follow the
  reference's partition of jitted programs, so the twins' counts agree.
- ``SENTINEL_FIRST_LOAD_TIMEOUT_S`` / ``SENTINEL_FIRST_LOAD_RETRIES``
  keep the reference's meaning for :func:`guarded_first_fetch`. The
  port has no remote program fetch, so the guard is off by default on
  every device; a timeout the operator sets runs the reference's
  throwaway first execution under it and counts
  ``compile_cache.first_fetch_retry`` for each retry.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
from typing import Mapping, Optional, Tuple

CACHE_ENV = "SENTINEL_COMPILE_CACHE"
_OFF = ("0", "off", "disable", "disabled")

_lock = threading.Lock()
_fresh_dir: Optional[str] = None


def default_cache_dir() -> str:
    """The package's git-ignored ``_build/`` directory."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "_build")


def cache_dir() -> str:
    """Where the port's libraries are built and looked up (see module
    docstring): ``SENTINEL_COMPILE_CACHE``, a fresh per-process directory
    when it is ``0``/``off``, else :func:`default_cache_dir`."""
    global _fresh_dir
    env = os.environ.get(CACHE_ENV, "")
    if env.lower() in _OFF:
        with _lock:
            if _fresh_dir is None:
                _fresh_dir = tempfile.mkdtemp(prefix="sentinel_build_")
            return _fresh_dir
    return env or default_cache_dir()


def active_cache_dir() -> Optional[str]:
    """The directory reused across processes, or None when
    ``SENTINEL_COMPILE_CACHE`` turns reuse off."""
    if os.environ.get(CACHE_ENV, "").lower() in _OFF:
        return None
    return cache_dir()


def program_key(kind: str, step_id, geometry, statics: Mapping) -> tuple:
    """Hashable identity of one step variant for first-dispatch
    bookkeeping (``Sentinel._fetched_programs`` / ``compile_cache.hit`` /
    ``.miss``).

    ``kind`` names the family (``"decide"``, ``"decide_sd"``,
    ``"fused"``, ``"fused_sd"``, ``"fused_sd_epi"``); ``step_id`` names
    the variant inside it, fresh whenever the reference would rebuild
    its jitted steps (a device slot registered, a geometry change);
    ``geometry`` is the padded batch-shape tuple (one entry for decide,
    ``(b_entry, b_exit)`` for decide+exit); ``statics`` the step flags
    the reference specializes on."""
    return (kind, step_id, tuple(geometry), tuple(sorted(statics.items())))


# ---------------------------------------------------------------------------
# First dispatch guard (the reference's cold-start tail cap).
# ---------------------------------------------------------------------------

_log = logging.getLogger("sentinel_tpu_torch.coldstart")


def _fire_retry(on_retry) -> None:
    if on_retry is None:
        return
    try:
        on_retry()
    except Exception:   # telemetry must never mask the fetch itself
        _log.debug("first-fetch on_retry callback failed", exc_info=True)


def first_fetch_policy() -> Tuple[float, int]:
    """→ ``(timeout_s, retries)`` for :func:`guarded_first_fetch`.

    ``SENTINEL_FIRST_LOAD_TIMEOUT_S`` sets the timeout (``0`` or unset:
    the guard is off — the default on every device, since the port has
    no remote program fetch); ``SENTINEL_FIRST_LOAD_RETRIES`` the retry
    budget (2 unless set)."""
    retries = 2
    env_r = os.environ.get("SENTINEL_FIRST_LOAD_RETRIES", "")
    if env_r:
        try:
            retries = max(0, int(env_r))
        except ValueError:
            pass
    env_t = os.environ.get("SENTINEL_FIRST_LOAD_TIMEOUT_S", "")
    if env_t:
        try:
            return max(0.0, float(env_t)), retries
        except ValueError:
            return 0.0, 0
    return 0.0, 0


def guarded_first_fetch(fn, what: str, timeout_s: float, retries: int,
                        on_retry=None):
    """Run ``fn`` — an IDEMPOTENT first execution — with a wall-clock
    timeout and a bounded retry budget; → the first attempt's result to
    complete. A warning is logged every time a retry fires, and
    ``on_retry`` (when given) is invoked once per fired retry (the
    runtime counts ``compile_cache.first_fetch_retry`` there).

    ``fn`` MUST be safe to run concurrently with a stalled copy of
    itself (throwaway inputs, no shared mutable state): a timed-out
    attempt cannot be cancelled, so the retry races it and the
    straggler's result is discarded. The LAST attempt waits without a
    timeout."""
    if timeout_s <= 0:
        return fn()
    import queue
    q: "queue.Queue" = queue.Queue()

    def _run():
        try:
            q.put((None, fn()))
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            q.put((e, None))

    last_err: Optional[BaseException] = None
    for attempt in range(retries + 1):
        threading.Thread(target=_run, daemon=True,
                         name=f"sentinel-first-fetch-{attempt}").start()
        final = attempt == retries
        try:
            err, out = q.get(timeout=None if final else timeout_s)
        except queue.Empty:
            _log.warning(
                "first dispatch of %s stalled > %gs (attempt %d/%d) — "
                "retrying", what, timeout_s, attempt + 1, retries + 1)
            _fire_retry(on_retry)
            continue
        if err is None:
            return out
        last_err = err
        if final:
            raise err
        _log.warning(
            "first dispatch of %s failed (%s: %s) on attempt %d/%d "
            "— retrying", what, type(err).__name__, err, attempt + 1,
            retries + 1)
        _fire_retry(on_retry)
    if last_err is not None:  # pragma: no cover - straggler-error race
        raise last_err
    raise RuntimeError(f"first dispatch of {what} did not complete")
