"""Entry/exit callback hooks (reference
``StatisticSlotCallbackRegistry`` — onPass/onBlocked hooks StatisticSlot
fires around its recording — and the ``MetricExtension`` SPI
(``metric/extension/MetricExtension.java``) that external metric systems
plug into; the param-flow extension and metric exporters attach here in the
reference).

Handlers run on the calling thread after the decision; they must be fast
and must not raise (exceptions are swallowed into the record log, like SPI
callback failures in the reference).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

from sentinel_tpu_torch.core.logs import record_log

# handler signatures
OnPass = Callable[[str, str, int, Sequence], None]          # resource, origin, acquire, args
OnBlocked = Callable[[str, str, int, BaseException], None]  # resource, origin, acquire, exc
OnExit = Callable[[str, int, bool, int], None]              # resource, rt_ms, error, acquire


class StatisticCallbackRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._on_pass: List[OnPass] = []
        self._on_blocked: List[OnBlocked] = []
        self._on_exit: List[OnExit] = []

    # registration (addEntryCallback / addExitCallback)
    def add_pass_handler(self, fn: OnPass) -> None:
        with self._lock:
            self._on_pass = self._on_pass + [fn]

    def add_blocked_handler(self, fn: OnBlocked) -> None:
        with self._lock:
            self._on_blocked = self._on_blocked + [fn]

    def add_exit_handler(self, fn: OnExit) -> None:
        with self._lock:
            self._on_exit = self._on_exit + [fn]

    def clear(self) -> None:
        with self._lock:
            self._on_pass, self._on_blocked, self._on_exit = [], [], []

    @property
    def empty(self) -> bool:
        return not (self._on_pass or self._on_blocked or self._on_exit)  # graftlint: disable=LOCK002 -- copy-on-write lists: writers swap whole lists under the lock; lock-free reads see one coherent snapshot

    # dispatch (copy-on-write lists: iteration is lock-free)
    def fire_pass(self, resource: str, origin: str, acquire: int,
                  args: Sequence = ()) -> None:
        for fn in self._on_pass:  # graftlint: disable=LOCK002 -- copy-on-write list swap under the lock; lock-free iteration is the documented dispatch contract
            try:
                fn(resource, origin, acquire, args)
            except Exception as exc:
                record_log().warning("onPass callback failed: %r", exc)

    def fire_blocked(self, resource: str, origin: str, acquire: int,
                     exc_val: Optional[BaseException]) -> None:
        for fn in self._on_blocked:
            try:
                fn(resource, origin, acquire, exc_val)
            except Exception as exc:
                record_log().warning("onBlocked callback failed: %r", exc)

    def fire_exit(self, resource: str, rt_ms: int, error: bool,
                  acquire: int) -> None:
        for fn in self._on_exit:  # graftlint: disable=LOCK002 -- copy-on-write list swap under the lock; lock-free iteration is the documented dispatch contract
            try:
                fn(resource, rt_ms, error, acquire)
            except Exception as exc:
                record_log().warning("onExit callback failed: %r", exc)
