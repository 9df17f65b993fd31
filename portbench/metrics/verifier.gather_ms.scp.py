"""verifier.gather_ms: the port's `crypto.gather` span (a chunk's
decisions brought back: the pinned output, the copy to the host and the
wait for the stream), mean a gather, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "crypto.gather")
