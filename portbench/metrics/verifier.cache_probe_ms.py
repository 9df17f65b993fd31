"""verifier.cache_probe_ms: the port's `crypto.cache_probe` span (a
drain's verify-cache lookups under the cache lock, inside
`crypto.prewarm`), mean a prewarm, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "crypto.cache_probe")
