"""Ordered startup hooks — the ``InitExecutor`` / ``InitFunc`` /
``@InitOrder`` analog (reference ``init/InitExecutor.java``,
``init/InitFunc.java``, ``init/InitOrder.java``).

An init func is any callable ``fn(sentinel)`` registered under the
``init_func`` SPI service (directly, via :func:`init_func`, or from a
plugin module — see :mod:`sentinel_tpu_torch.core.spi`). ``InitExecutor``
runs them once per process in ascending order, triggered by the static
facade's instance creation (``api.init()`` — the analog of ``Env``'s
static init firing on the first ``SphU.entry``); class-based users call
:meth:`InitExecutor.do_init` themselves.

Failure semantics match the reference: the first raising func interrupts
the remaining ones (logged, not propagated — ``InitExecutor.doInit``
catches at the loop level), and initialization never re-runs.

The PyTorch port's own copy of ``sentinel_tpu/core/initexec.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from sentinel_tpu_torch.core.spi import (
    LOWEST_PRECEDENCE, SERVICE_INIT_FUNC, SpiLoader,
)


def init_func(order: int = LOWEST_PRECEDENCE,
              alias: Optional[str] = None) -> Callable:
    """Decorator registering ``fn(sentinel)`` as an InitFunc::

        @init_func(order=10)
        def wire_metrics(sph): ...
    """
    def wrap(fn):
        return SpiLoader.of(SERVICE_INIT_FUNC).register(
            fn, alias=alias, order=order)
    return wrap


class InitExecutor:
    # Claim-then-Event design: the lock is held only to CLAIM the init (never
    # while hooks run — user callbacks under a held lock would be an AB/BA
    # deadlock hazard); losers wait on the completion Event, so no caller can
    # observe (and use) the instance mid-initialization. The Event also gives
    # the steady-state fast path: one lock-free is_set() per call, so hot-path
    # accessors (api.instance) can rendezvous on every call for free.
    _lock = threading.Lock()
    _done = False                        # claimed
    _complete = threading.Event()        # hooks finished
    _owner: Optional[int] = None         # claiming thread id (re-entrancy)
    # Bound on the loser rendezvous; configurable because "slow" is
    # deployment-specific (a first process's kernel builds can legitimately
    # take tens of seconds). Env override: SENTINEL_INIT_WAIT_TIMEOUT_S.
    WAIT_TIMEOUT_S = 10.0

    @classmethod
    def do_init(cls, sentinel) -> bool:
        """Run all registered init funcs in order, once per process.
        → True if this call performed the initialization. Concurrent calls
        block until the winning call's hooks have completed ("hooks run
        before first use")."""
        if cls._complete.is_set():       # steady state: lock-free
            return False
        with cls._lock:
            if cls._done:
                winner = False
            else:
                cls._done = True
                cls._owner = threading.get_ident()
                winner = True
            complete = cls._complete     # reset() swaps the Event
        if not winner:
            if cls._owner != threading.get_ident():
                # Bounded wait: an init hook that spawns a helper thread
                # which itself reaches do_init would otherwise deadlock
                # (hook waits on helper, helper waits on hook's Event).
                # After the timeout we log and proceed — weaker ordering
                # beats a silent process hang. Re-check is_set() after the
                # wait so a completion racing the timeout edge isn't
                # mis-reported as a hang.
                timeout = cls._wait_timeout_s()
                if not complete.wait(timeout=timeout) \
                        and not complete.is_set():
                    from sentinel_tpu_torch.core.logs import record_log
                    record_log().warning(
                        "[InitExecutor] waited %.0fs for init hooks to "
                        "finish; proceeding before completion (is an init "
                        "hook blocking on a thread that uses the facade? "
                        "Slow-but-healthy hooks: raise "
                        "SENTINEL_INIT_WAIT_TIMEOUT_S)", timeout)
            return False
        from sentinel_tpu_torch.core.logs import record_log
        try:
            for fn in SpiLoader.of(
                    SERVICE_INIT_FUNC).load_instance_list_sorted():
                record_log().info("[InitExecutor] executing %s",
                                  getattr(fn, "__name__", fn))
                fn(sentinel)
        except Exception as exc:
            # first failure interrupts the remaining funcs but never
            # propagates (InitExecutor.java:56-63)
            record_log().warning(
                "[InitExecutor] initialization failed: %r", exc)
        finally:
            cls._owner = None
            complete.set()
        return True

    @classmethod
    def _wait_timeout_s(cls) -> float:
        import math
        import os
        try:
            v = float(os.environ.get("SENTINEL_INIT_WAIT_TIMEOUT_S",
                                     cls.WAIT_TIMEOUT_S))
        except ValueError:
            return cls.WAIT_TIMEOUT_S
        # non-positive/non-finite values would silently disable the
        # rendezvous bound — fall back rather than obey them
        if not math.isfinite(v) or v <= 0:
            return cls.WAIT_TIMEOUT_S
        return v

    @classmethod
    def reset(cls) -> None:
        """Test hygiene: allow do_init to run again."""
        with cls._lock:
            cls._done = False
            cls._owner = None
            cls._complete = threading.Event()
