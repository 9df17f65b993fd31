"""device.idle_pct: the share of the traced window in which no operation
ran on the card (100 less the union of the profiler's device intervals
over the window's host-clock length), %."""

from portbench.yardstick.readers import idle_pct


def read(ctx):
    return idle_pct(ctx.trace)
