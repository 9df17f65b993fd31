"""verifier.recode_ms: the port's `crypto.stage.recode` span (the C
prep's digits recoded to signed ones in numpy), mean a chunk of the
checkpoint's drain, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "crypto.stage.recode")
