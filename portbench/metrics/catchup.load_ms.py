"""catchup.load_ms: the port's `catchup.load_files` span
(`ApplyCheckpointWork._load`: the checkpoint's ledger headers and
transaction sets read and decoded), mean a pass, ms."""

from portbench.yardstick.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx.program_spans, "catchup.load_files")
