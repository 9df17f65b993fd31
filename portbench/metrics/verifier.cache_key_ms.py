"""verifier.cache_key_ms: the port's `crypto.prewarm` span less the
`crypto.verify_many` spans inside it (the drain's cache keys, probes and
fills), mean a checkpoint, ms."""

from portbench.yardstick.readers import less_children_ms


def read(ctx):
    outer = [s for s in ctx.program_spans if s[0] == "crypto.prewarm"]
    return less_children_ms(outer, ctx.program_spans, "crypto.verify_many")
