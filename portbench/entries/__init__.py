"""The program's entry points a cell's window drives, one module each,
found by the name a traffic mix gives (``"entry"``). A module defines
``Entry(prog, batch, route)`` (``prog``: the deployment's program) with
``submit(cols, at_ms, exits)`` → a ticket whose ``result()`` gives the
batch's ``Verdicts`` (``cols``: the batch's columns by the raw entry's
argument names, ``exits``: the completions' ``exit_*`` columns, or
None), ``flush()``, ``pipe`` (its pipeline), ``route`` (the engine
route the cell's batches must take) and ``exits`` (whether a step
carries the completions of an earlier one)."""
