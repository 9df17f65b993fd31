"""catchup.sig_prep_ms: the port's `catchup.sig_prep` span (candidate
signature triples collected against the ledger state), mean a
checkpoint, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "catchup.sig_prep")
