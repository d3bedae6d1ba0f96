"""Share of the traced window in which no operation ran on the device:
100 x (1 - busy / window), from the profiler's device intervals."""

from h100bench.trace import idle_percent


def read(ctx):
    return idle_percent(ctx.view)
