"""The loops that drive a cell's window, one module each, found by the
name a traffic mix gives (``"loop"``). A module defines ``drive(entry,
traffic, pool, seconds, clock, trace_cfg, spans, device)`` → a
``window.Run``: the warm-up steps, then ``seconds`` of measured steps
from the first timed submit, each step's ``at_ms``, submit time,
readiness and collection kept (``window.Step``)."""
