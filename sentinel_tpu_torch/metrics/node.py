"""Metric line codec — byte-format parity with the reference so its dashboard
and tooling can read our files.

Reference: ``sentinel-core/.../node/metric/MetricNode.java:160-231`` — thin
format ``ts|resource|pass|block|success|exception|rt|occupiedPass|concurrency|
classification`` and fat format with a human date inserted after ts; ``|`` in
resource names is replaced by ``_``.
"""

from __future__ import annotations

import dataclasses
import time as _time

# ResourceTypeConstants.java
TYPE_COMMON = 0
TYPE_WEB = 1
TYPE_RPC = 2
TYPE_GATEWAY = 3
TYPE_DB = 4
TYPE_CACHE = 5

TOTAL_IN_RESOURCE_NAME = "__total_inbound_traffic__"   # Constants.java:45


@dataclasses.dataclass
class MetricNode:
    timestamp: int = 0           # ms, floor of the aggregated second
    resource: str = ""
    pass_qps: int = 0
    block_qps: int = 0
    success_qps: int = 0
    exception_qps: int = 0
    rt: int = 0                  # average rt of the second, ms
    occupied_pass_qps: int = 0
    concurrency: int = 0
    classification: int = TYPE_COMMON

    def _legal_name(self) -> str:
        return self.resource.replace("|", "_")

    def to_thin_string(self) -> str:
        return "|".join(str(x) for x in (
            self.timestamp, self._legal_name(), self.pass_qps, self.block_qps,
            self.success_qps, self.exception_qps, self.rt,
            self.occupied_pass_qps, self.concurrency, self.classification))

    def to_fat_string(self) -> str:
        date = _time.strftime("%Y-%m-%d %H:%M:%S",
                              _time.localtime(self.timestamp / 1000))
        return "|".join(str(x) for x in (
            self.timestamp, date, self._legal_name(), self.pass_qps,
            self.block_qps, self.success_qps, self.exception_qps, self.rt,
            self.occupied_pass_qps, self.concurrency,
            self.classification)) + "\n"

    @staticmethod
    def from_thin_string(line: str) -> "MetricNode":
        s = line.strip().split("|")
        n = MetricNode(timestamp=int(s[0]), resource=s[1], pass_qps=int(s[2]),
                       block_qps=int(s[3]), success_qps=int(s[4]),
                       exception_qps=int(s[5]), rt=int(s[6]))
        if len(s) >= 8:
            n.occupied_pass_qps = int(s[7])
        if len(s) >= 9:
            n.concurrency = int(s[8])
        if len(s) == 10:
            n.classification = int(s[9])
        return n

    @staticmethod
    def from_fat_string(line: str) -> "MetricNode":
        s = line.strip().split("|")
        n = MetricNode(timestamp=int(s[0]), resource=s[2], pass_qps=int(s[3]),
                       block_qps=int(s[4]), success_qps=int(s[5]),
                       exception_qps=int(s[6]), rt=int(s[7]))
        if len(s) >= 9:
            n.occupied_pass_qps = int(s[8])
        if len(s) >= 10:
            n.concurrency = int(s[9])
        if len(s) == 11:
            n.classification = int(s[10])
        return n
