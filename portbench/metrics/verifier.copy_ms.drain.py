"""verifier.copy_ms: the port's `crypto.stage.copy` span (a chunk's six
arrays pinned and copied to the card, with their ready events), mean a
chunk of the checkpoint's drain, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "crypto.stage.copy")
