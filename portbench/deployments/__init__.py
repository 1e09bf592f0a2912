"""The programs under test, one module each, found by the name a
configuration gives (``"deployment"``). A module defines ``build(config,
device)`` → a program object with ``clock`` and ``epoch_ms`` (the time
base both sides are given), ``spans()``, ``counters()``, ``routes()``,
``state()`` (its state as numpy leaves, by the reference's leaf names)
and ``close()``; the entries drive it."""
