"""Self-driving overload protection.

Port of ``sentinel_tpu/control/``: a closed loop from the device
telemetry to the front end. The policy core
(:mod:`~sentinel_tpu_torch.control.policy`) turns the per-second
telemetry timeline, the rolling request-latency histogram and the ingest
queue depth into typed actions under AIMD with hysteresis and
per-action cooldowns; the actuators
(:mod:`~sentinel_tpu_torch.control.actuators`) apply them through
existing runtime seams only (the front end's admission fraction, an
online batcher retune, forced breaker transitions); and
:class:`~sentinel_tpu_torch.control.loop.ControlLoop` runs the cycle on
the :class:`~sentinel_tpu_torch.serving.CadenceScheduler` daemon,
pinning every action and its evidence into the flight recorder. The user
builds the loop: ``ControlLoop(sph, batcher)`` attaches itself as
``sph.control``.
"""

from sentinel_tpu_torch.control.policy import (      # noqa: F401
    Degrade, HistDeltaP99, Observation, OverloadPolicy, PolicyConfig,
    RetuneBatcher, ShedRate, WindowedFilter, action_kind)
from sentinel_tpu_torch.control.actuators import Actuators  # noqa: F401
from sentinel_tpu_torch.control.loop import (          # noqa: F401
    CONTROL_DISABLE_ENV, ControlLoop, control_disabled)
