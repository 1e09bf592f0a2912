"""Per-task call context (ContextUtil analog).

The PyTorch port's own copy of ``sentinel_tpu/core/context.py``.
Reference: ``sentinel-core/.../context/ContextUtil.java`` — the context
name (entrance) and origin (caller app) that adapters set before
``SphU.entry``. The context name keys CHAIN-strategy flow rules; the
origin keys authority checks and origin-specific flow rules. Storage is a
``contextvars.ContextVar``, so every asyncio task and every thread sees
its own value.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Optional

DEFAULT_CONTEXT_NAME = "sentinel_default_context"


@dataclasses.dataclass
class Context:
    name: str = DEFAULT_CONTEXT_NAME
    origin: str = ""


_ctx_var: contextvars.ContextVar[Optional[Context]] = contextvars.ContextVar(
    "sentinel_tpu_torch_context", default=None)

_DEFAULT = Context()


def current_context() -> Context:
    ctx = _ctx_var.get()
    return ctx if ctx is not None else _DEFAULT


def snapshot_context() -> Context:
    """Copy of the current context for asynchronous continuation — the
    ``AsyncEntry.java`` context snapshot. Restore with
    :func:`restore_context` from whatever task or thread completes the
    work."""
    cur = current_context()
    return Context(name=cur.name, origin=cur.origin)


def restore_context(ctx: Context) -> None:
    _ctx_var.set(Context(name=ctx.name, origin=ctx.origin))


class ContextScope:
    """``with ContextScope("entrance", origin="app-a"): ...`` — the
    ``ContextUtil.enter``/``exit`` pair, restored by token on exit."""

    def __init__(self, name: str, origin: str = ""):
        self._name = name
        self._origin = origin
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> Context:
        ctx = Context(name=self._name or DEFAULT_CONTEXT_NAME,
                      origin=self._origin or "")
        self._token = _ctx_var.set(ctx)
        return ctx

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _ctx_var.reset(self._token)
            self._token = None
