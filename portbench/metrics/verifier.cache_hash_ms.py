"""verifier.cache_hash_ms: the port's `crypto.cache_keys` span (the
hashlib loop that makes a drain's verify-cache keys, inside
`crypto.prewarm`), mean a prewarm, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "crypto.cache_keys")
