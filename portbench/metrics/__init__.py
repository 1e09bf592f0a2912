"""One reader per per-layer metric, found by the metric's name: each
module defines ``read(ctx)`` (``harness.Context``) → the number, or None
when the run gave it nothing to read."""
