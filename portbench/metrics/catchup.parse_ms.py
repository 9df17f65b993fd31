"""catchup.parse_ms: the port's `catchup.txset_parse` span (the
checkpoint's transaction sets parsed into frames), mean a checkpoint, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "catchup.txset_parse")
