"""``@sentinel_resource`` decorator (reference
``sentinel-extension/sentinel-annotation-aspectj/.../SentinelResourceAspect.java:36-42``
+ ``AbstractSentinelAspectSupport`` handler resolution).

Semantics mirror ``@SentinelResource``: ``block_handler`` is called on
BlockException (with the original args + the exception appended);
``fallback`` on business exceptions (unless listed in
``exceptions_to_ignore``); ``default_fallback`` takes only the exception.
Without handlers, exceptions propagate after being traced into the stats
(feeding exception-ratio breakers) — ``Tracer.traceEntry`` behavior.

The PyTorch port's own copy of ``sentinel_tpu/adapters/decorator.py``.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, Optional, Sequence, Tuple, Type

from sentinel_tpu_torch.core.errors import BlockException

ENTRY_TYPE_OUT = 0
ENTRY_TYPE_IN = 1


def _invoke_handler(handler: Callable, args: tuple, kwargs: dict,
                    exc: BaseException):
    """Reference handler resolution appends the exception as the last
    positional parameter; handlers that only take the exception work too
    (defaultFallback shape)."""
    try:
        sig = inspect.signature(handler)
        n_params = len([p for p in sig.parameters.values()
                        if p.kind in (p.POSITIONAL_ONLY,
                                      p.POSITIONAL_OR_KEYWORD)])
    except (ValueError, TypeError):
        n_params = len(args) + 1
    if n_params <= 1:
        return handler(exc)
    return handler(*args, exc, **kwargs)


def sentinel_resource(name: Optional[str] = None, *,
                      sentinel=None,
                      entry_type: int = ENTRY_TYPE_OUT,
                      resource_type: int = 0,
                      block_handler: Optional[Callable] = None,
                      fallback: Optional[Callable] = None,
                      default_fallback: Optional[Callable] = None,
                      exceptions_to_ignore: Sequence[Type[BaseException]] = (),
                      args_as_params: bool = False):
    """Guard a function as a Sentinel resource.

    ``sentinel`` may be a :class:`~sentinel_tpu_torch.runtime.Sentinel` or a
    zero-arg callable returning one (late binding for module-level
    decoration). ``args_as_params=True`` forwards the call's positional args
    to hot-param rules (the adapter's ``SphU.entry(name, args)`` form).
    """

    def deco(fn: Callable) -> Callable:
        res_name = name or f"{fn.__module__}:{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            sph = sentinel() if callable(sentinel) else sentinel
            if sph is None:
                raise RuntimeError(
                    f"@sentinel_resource({res_name!r}): no Sentinel instance "
                    f"bound; pass sentinel=... (instance or callable)")
            try:
                e = sph.entry(res_name, entry_type=entry_type,
                              resource_type=resource_type,
                              args=args if args_as_params else ())
            except BlockException as bex:
                if block_handler is not None:
                    return _invoke_handler(block_handler, args, kwargs, bex)
                if default_fallback is not None:
                    return _invoke_handler(default_fallback, args, kwargs, bex)
                raise
            try:
                return fn(*args, **kwargs)
            except BaseException as exc:
                ignored = isinstance(exc, tuple(exceptions_to_ignore)) \
                    if exceptions_to_ignore else False
                if not ignored:
                    e.trace(exc)     # before exit: feeds exception stats
                handler = fallback or default_fallback
                if handler is not None and not ignored \
                        and not isinstance(exc, BlockException):
                    return _invoke_handler(handler, args, kwargs, exc)
                raise
            finally:
                e.exit()

        wrapper.__sentinel_resource__ = res_name
        return wrapper

    return deco
