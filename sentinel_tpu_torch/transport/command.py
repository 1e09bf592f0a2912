"""Command handler registry (reference ``sentinel-transport-common``).

A command is ``name → handler(CommandRequest) → CommandResponse`` — the
reference's ``@CommandMapping`` annotated ``CommandHandler`` SPI
(``transport/command/CommandHandler.java``, dispatched by
``SimpleHttpCommandCenter``/``NettyHttpCommandCenter``). Handlers are plain
callables here; ``command_mapping`` attaches metadata and ``CommandCenter``
is the in-process registry the HTTP frontends dispatch into.

The PyTorch port's own copy of ``sentinel_tpu/transport/command.py``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional


@dataclasses.dataclass
class CommandRequest:
    """Parsed request: query/body parameters + raw body."""

    parameters: Dict[str, str] = dataclasses.field(default_factory=dict)
    body: bytes = b""

    def param(self, name: str, default: str = "") -> str:
        return self.parameters.get(name, default)


@dataclasses.dataclass
class CommandResponse:
    success: bool
    result: str = ""
    code: int = 200

    @staticmethod
    def of_success(result: str) -> "CommandResponse":
        return CommandResponse(True, result)

    @staticmethod
    def of_failure(message: str, code: int = 400) -> "CommandResponse":
        return CommandResponse(False, message, code)


Handler = Callable[[CommandRequest], CommandResponse]


def command_mapping(name: str, desc: str = "") -> Callable[[Handler], Handler]:
    """Decorator analog of ``@CommandMapping(name=…, desc=…)``."""

    def wrap(fn: Handler) -> Handler:
        fn.command_name = name          # type: ignore[attr-defined]
        fn.command_desc = desc          # type: ignore[attr-defined]
        return fn

    return wrap


class CommandCenter:
    """Name → handler registry; thread-safe; shared by HTTP frontends."""

    def __init__(self) -> None:
        self._handlers: Dict[str, Handler] = {}
        self._descs: Dict[str, str] = {}
        self._interceptors: list = []     # CommandHandlerInterceptor SPI
        self._lock = threading.Lock()

    def add_interceptor(self, fn) -> None:
        """``CommandHandlerInterceptor`` analog: ``fn(name, request) →
        Optional[CommandResponse]`` runs before the handler; a non-None
        return short-circuits it (auth gates, audit logs, rate limits on
        the command plane itself)."""
        with self._lock:
            self._interceptors = self._interceptors + [fn]

    def register(self, fn: Handler, name: Optional[str] = None,
                 desc: Optional[str] = None) -> None:
        cmd = name or getattr(fn, "command_name", None)
        if not cmd:
            raise ValueError("handler has no command name")
        with self._lock:
            self._handlers[cmd] = fn
            self._descs[cmd] = desc or getattr(fn, "command_desc", "")

    def handler(self, name: str) -> Optional[Handler]:
        with self._lock:
            return self._handlers.get(name)

    def names(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._descs)

    def handle(self, name: str, request: CommandRequest) -> CommandResponse:
        fn = self.handler(name)
        if fn is None:
            return CommandResponse.of_failure(f"Unknown command `{name}`", 404)
        try:
            for interceptor in self._interceptors:   # copy-on-write list
                short = interceptor(name, request)
                if short is not None:
                    return short
            return fn(request)
        except Exception as exc:  # handler bug must not kill the server
            return CommandResponse.of_failure(f"internal error: {exc!r}", 500)
