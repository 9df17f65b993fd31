"""verifier.staging_ms: host prep and copies of one staged chunk, from the
port's `VerifierStats.staging` (`staged_s` over `chunks`, the window's
increase), ms a chunk of 8,192."""


def read(ctx):
    a, b = ctx.staging_before, ctx.staging_after
    if not a or not b:
        return None
    chunks = b["chunks"] - a["chunks"]
    if chunks <= 0:
        return None
    return 1e3 * (b["staged_s"] - a["staged_s"]) / chunks
