"""ed25519_verify_roofline: the verify kernel's share of its roofline in
the traced window, %: the least time the real signatures it decided need
(operations or bytes, `portbench/yardstick/roofline.py`) over the
kernel's device time in the profiler's trace."""

from portbench.yardstick.roofline import verify_roofline_pct


def read(ctx):
    return verify_roofline_pct(ctx.counts.get("sigs_decided", 0),
                               ctx.trace, ctx.card)
