"""verifier.stage_ms: the port's `crypto.stage` span (a chunk's prep,
recode, padding and copies to the card), mean a chunk of an envelope's
flush, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "crypto.stage")
