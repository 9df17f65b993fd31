"""verifier.cache_fill_ms: the port's `crypto.cache_fill` span (the
verify-cache puts of a drain's decisions under the cache lock, inside
`crypto.prewarm`), mean a prewarm, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "crypto.cache_fill")
