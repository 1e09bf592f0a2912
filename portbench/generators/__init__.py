"""Traffic generators, one module each, found by the name a traffic mix
gives (``"generator"``). A module defines ``Traffic(mix, config, seed,
device)``: every random draw made at set-up from ``--seed``, so that a
step of the window only picks and slices. What the loops, the replay and
the readers ask of it:

* ``batch``, ``warmup`` (steps before the window), ``lag`` (the step
  whose admissions a step's exits complete lies ``lag`` back; 0: no
  exits), ``exits``, ``pool`` (the batches, sent in turn);
* ``program_pool(prog)`` → each pool batch as the program's entry takes
  it; ``inputs(p)`` → pool batch ``p`` as the reference takes it;
* ``exit_lanes(k, allow)`` → ``(lanes, rt, err)`` of step ``k``'s exits,
  given the admissions of step ``k - lag``; ``program_exits(k, allow,
  pool)`` and ``reference_exits(k, allow, inputs, device)`` → the same
  exits as each side takes them;
* ``keep_verdicts(k)`` → whether step ``k``'s verdicts are compared.
"""
