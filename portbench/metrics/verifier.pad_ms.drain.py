"""verifier.pad_ms: the port's `crypto.stage.pad` span (`pad_batch_to`: a
chunk's arrays padded to its bucket), mean a chunk of the checkpoint's
drain, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "crypto.stage.pad")
