"""``sentinel_tpu_torch.Sentinel`` of a configuration's sizes, its rules
loaded by kind and every name interned in rank order."""

from __future__ import annotations

import time
from typing import Optional

from portbench import deploy


class RunClock:
    """The program's clock: the wall clock, held at one reading while
    the program is built, so that its time base (read at construction)
    is a number the harness chose and hands the reference."""

    def __init__(self):
        self.held: Optional[int] = None

    def now_ms(self) -> int:
        if self.held is not None:
            return self.held
        return time.time_ns() // 1_000_000

    def sleep_ms(self, ms: int) -> None:
        if ms > 0:
            time.sleep(ms / 1000.0)


class Program:
    """The built ``Sentinel`` (``sph``), the row of each name (``rows``,
    by rank), and what the harness reads of it."""

    def __init__(self, config: dict, device):
        import sentinel_tpu_torch as stt

        self.stt = stt
        # an instance of the program's clock type (no ``set_ms``: the
        # program's spans keep the monotonic clock)
        self.clock = type("PortbenchClock", (RunClock, stt.Clock), {})()
        self.epoch_ms = self.clock.held = time.time_ns() // 1_000_000
        self.sph = stt.Sentinel(config=stt.load_config(**config["sentinel"]),
                                clock=self.clock, device=device)
        for kind, rules in deploy.rules_of(config).items():
            deploy.rule_kind(kind).load(stt, self.sph, rules)
        self.rows = self.sph.intern_resources(
            [deploy.name_of(i) for i in range(config["names"])])
        self.clock.held = None
        self.alt_rows = self.sph.spec.alt_rows

    def spans(self) -> list:
        return self.sph.obs.spans.snapshot()

    def counters(self) -> dict:
        return self.sph.obs.counters.snapshot()

    def routes(self) -> dict:
        return dict(self.sph.routes)

    def state(self) -> dict:
        from sentinel_tpu_torch import convert
        return convert.engine_to_numpy(self.sph)

    def close(self) -> None:
        self.sph.close()
        self.sph = None


def build(config: dict, device) -> Program:
    return Program(config, device)
