"""``generator_ms`` (layer: caller): the benchmark's own clock around
making each step's batch and its exits, ms a step over the window."""


def read(ctx):
    run = ctx.run
    steps = run.steps[run.first:run.last]
    if not steps:
        return None
    return sum(s.gen_s for s in steps) * 1e3 / len(steps)
