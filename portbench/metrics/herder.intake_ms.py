"""herder.intake_ms: the harness's span around each
`Herder.recv_scp_envelope` call less the port's `crypto.verify_many` span
inside it (the herder's own work on an envelope), mean an envelope, ms."""

from portbench.yardstick.readers import less_children_ms


def read(ctx):
    outer = [s for s in ctx.spans if s[0] == "herder.recv_scp_envelope"]
    return less_children_ms(outer, ctx.program_spans, "crypto.verify_many")
