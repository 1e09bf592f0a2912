"""Metric event axis for the counter tensors.

Union of the reference's per-bucket event sets:
``sentinel-core/.../slots/statistic/MetricEvent.java:21-38`` (PASS, BLOCK,
EXCEPTION, SUCCESS, OCCUPIED_PASS; RT is handled separately) and the cluster
server's ``ClusterFlowEvent`` (PASS_REQUEST/BLOCK_REQUEST/WAITING).

RT lives outside this axis: ``rt_sum`` is a float32 tensor (int32 would
overflow on the global ENTRY_NODE row: 25M events × 100ms avg per 500ms bucket
exceeds 2^31; float32 degrades gracefully for an average) and ``min_rt`` is an
int32 min-tensor (scatter-min, not scatter-add).

The PyTorch port's own copy of ``sentinel_tpu/stats/events.py`` (the lane
order is part of the state layout both packages share).
"""

PASS = 0
BLOCK = 1
EXCEPTION = 2
SUCCESS = 3
OCCUPIED_PASS = 4
PASS_REQUEST = 5   # cluster: number of acquire *requests* granted
BLOCK_REQUEST = 6  # cluster: number of acquire requests denied
WAITING = 7        # cluster: prioritized requests parked on future windows

NUM_EVENTS = 8

NAMES = [
    "pass", "block", "exception", "success",
    "occupied_pass", "pass_request", "block_request", "waiting",
]
