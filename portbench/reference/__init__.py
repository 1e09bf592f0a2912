"""Plain references of the semantics the cells exercise, one module per
kind of configuration (named by a configuration's ``"reference"``), each
defining ``build(config, rules, traffic, epoch_ms, device, **precision)``
→ an engine with ``step(at_ms=, **batch, **exits)`` → the batch's
``(allow, reason, wait_ms)``, ``leaves()`` and ``windows``. They import
nothing of the program."""
