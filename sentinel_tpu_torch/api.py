"""Static API facade (reference ``SphU`` / ``SphO`` / ``Tracer`` — the
global-singleton entry points most Sentinel code uses).

The class-based API (:class:`~sentinel_tpu_torch.runtime.Sentinel`) is the
primary surface; this module provides the reference's static-facade
ergonomics over a process-wide default instance, which is on ``cuda``
unless a ``device=`` says otherwise::

    import sentinel_tpu_torch as stt
    import sentinel_tpu_torch.api as sph

    sph.init(stt.load_config())               # optional; lazy default else
    with sph.entry("HelloWorld"):             # SphU.entry
        ...
    if sph.try_entry("maybe"):                # SphO.entry (boolean, no raise)
        try: ...
        finally: sph.exit()

``Tracer``-style exception reporting: ``sph.trace(exc)`` marks the current
innermost entry (reference ``Tracer.trace`` walks ``context.curEntry``).

The PyTorch port's own copy of ``sentinel_tpu/api.py``.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

from sentinel_tpu_torch.core.errors import BlockException
from sentinel_tpu_torch.core.initexec import InitExecutor
from sentinel_tpu_torch.runtime import ENTRY_TYPE_IN, Entry, Sentinel

_lock = threading.Lock()
_instance: Optional[Sentinel] = None
_generation = 0           # bumped by init/reset; invalidates old tls stacks
_tls = threading.local()


def init(config=None, **kw) -> Sentinel:
    """Install the process-wide instance (reference ``Env`` static init);
    idempotent unless a config is passed. Runs registered InitFunc SPI
    hooks once per process (``InitExecutor.doInit``)."""
    global _instance, _generation
    with _lock:
        if _instance is None or config is not None or kw:
            _instance = Sentinel(config, **kw)
            _generation += 1
        inst = _instance
    InitExecutor.do_init(inst)
    return inst


def instance() -> Sentinel:
    global _instance
    if _instance is None:
        with _lock:
            if _instance is None:
                _instance = Sentinel()
    # Always rendezvous with InitExecutor: if another thread is mid-init,
    # this blocks until its hooks complete, so no caller can use the
    # instance before "hooks run before first use" holds. Steady state is
    # one lock-free Event.is_set() check.
    InitExecutor.do_init(_instance)
    return _instance


def reset() -> None:
    """Drop the global instance (test hygiene — ``ContextTestUtil`` analog).
    Every thread's entry stack is invalidated: entries opened against the
    dead instance are no longer addressable through this facade."""
    global _instance, _generation
    with _lock:
        _instance = None
        _generation += 1


def _stack():
    # stacks are tied to the instance generation they were opened under so
    # reset()/re-init can't route exits into a discarded instance
    if getattr(_tls, "generation", None) != _generation:
        _tls.generation = _generation
        _tls.entries = []
    return _tls.entries


def entry(resource: str, **kw) -> Entry:
    """``SphU.entry`` — raises BlockException when denied. The returned Entry
    is also pushed on a per-thread stack so ``exit()``/``trace()`` can find
    it (reference ``context.curEntry`` chain)."""
    e = instance().entry(resource, **kw)
    st = _stack()
    st.append(e)

    def _pop(done: Entry) -> None:
        # pop on exit regardless of which exit path ran; mispaired exits
        # just remove their own entry (ErrorEntryFree semantics are already
        # enforced by Entry.exit's double-exit check)
        if st and st[-1] is done:
            st.pop()
        elif done in st:
            st.remove(done)

    e.when_terminate(_pop)
    return e


def try_entry(resource: str, **kw) -> bool:
    """``SphO.entry`` — boolean, never raises; pair with ``exit()``."""
    try:
        entry(resource, **kw)
        return True
    except BlockException:
        return False


def exit(n: int = 1) -> None:           # noqa: A001 (reference name)
    """``SphO.exit``/``Entry.exit`` for the innermost ``n`` entries."""
    st = _stack()
    for _ in range(min(n, len(st))):
        st[-1].exit()


# Tracer exception-class filters (reference ``Tracer.setExceptionsToTrace``
# / ``setExceptionsToIgnore``; ignore wins on overlap)
_trace_classes: tuple = (Exception,)
_ignore_classes: tuple = ()


def set_exceptions_to_trace(*classes) -> None:
    """Only these exception classes (and subclasses) count toward
    exception stats/breakers via :func:`trace` (``Tracer.java:96``)."""
    global _trace_classes
    _trace_classes = tuple(classes) or (Exception,)


def set_exceptions_to_ignore(*classes) -> None:
    """These classes never count, even if listed in the trace set
    (``Tracer.java:117``; ignore takes precedence)."""
    global _ignore_classes
    _ignore_classes = tuple(classes)


def should_trace(exc: BaseException) -> bool:
    return (exc is not None
            and not isinstance(exc, _ignore_classes or ())
            and isinstance(exc, _trace_classes))


def trace(exc: BaseException) -> None:
    """``Tracer.trace`` — record a business exception on the innermost
    in-flight entry of this thread, honoring the class filters."""
    if not should_trace(exc):
        return
    st = _stack()
    if st:
        st[-1].trace(exc)


def trace_entry(exc: BaseException, entry_obj: Entry) -> None:
    """``Tracer.traceEntry`` — record on an explicit entry."""
    if entry_obj is not None and should_trace(exc):
        entry_obj.trace(exc)


def current_entry() -> Optional[Entry]:
    st = _stack()
    return st[-1] if st else None
