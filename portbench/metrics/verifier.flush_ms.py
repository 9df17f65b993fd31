"""verifier.flush_ms: the port's `crypto.verify_many` span (prep, the
launch and the gather of one flush), mean a flush, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "crypto.verify_many")
