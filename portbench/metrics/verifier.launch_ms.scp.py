"""verifier.launch_ms: the port's `crypto.launch` span (the host's side
of a chunk's kernel launch on each member), mean a launch, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "crypto.launch")
