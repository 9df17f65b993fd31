"""verifier.prep_ms: the port's `crypto.stage.prep` span (a chunk packed
and run through the C prep), mean a chunk of the checkpoint's drain, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "crypto.stage.prep")
