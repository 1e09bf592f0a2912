"""Injectable time source.

The reference routes *every* time read through a single cached clock
(``sentinel-core/.../util/TimeUtil.java:222``), which is what makes its whole
test suite deterministic (``AbstractTimeBasedTest`` PowerMocks it). We preserve
that property structurally: device code receives ``now_ms`` as an explicit
scalar argument, and host code reads time only through a ``Clock`` object that
tests can replace with :class:`ManualClock`.

Unlike the reference's adaptive cached-millis thread (TimeUtil RUNNING/IDLE
modes, needed because ``System.currentTimeMillis`` is a contended vDSO call at
>1M qps), the host here reads time once per *batch*, so a plain monotonic read
is already off the hot path.

The PyTorch port's own copy of ``sentinel_tpu/core/clock.py``.
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Wall-clock milliseconds. Base class doubles as the system clock."""

    def now_ms(self) -> int:
        return time.time_ns() // 1_000_000

    def sleep_ms(self, ms: int) -> None:
        if ms > 0:
            time.sleep(ms / 1000.0)


SystemClock = Clock


class ManualClock(Clock):
    """Deterministic clock for tests (parity with AbstractTimeBasedTest).

    ``set_ms`` / ``advance_ms`` step virtual time; ``sleep_ms`` advances it
    instead of blocking, so throttling-wait tests run instantly.
    """

    def __init__(self, start_ms: int = 1_000_000):
        self._ms = start_ms
        self._lock = threading.Lock()

    def now_ms(self) -> int:
        with self._lock:
            return self._ms

    def set_ms(self, ms: int) -> None:
        with self._lock:
            self._ms = ms

    def advance_ms(self, delta: int) -> None:
        with self._lock:
            self._ms += delta

    def sleep_ms(self, ms: int) -> None:
        if ms > 0:
            self.advance_ms(int(ms))


_global_clock: Clock = SystemClock()


def global_clock() -> Clock:
    return _global_clock


def set_global_clock(clock: Clock) -> Clock:
    """Install a clock process-wide; returns the previous one."""
    global _global_clock
    prev = _global_clock
    _global_clock = clock
    return prev
