"""herder.recv_self_ms: the port's `herder.recv_scp_envelope` span less
the `crypto.verify_many` spans inside it on its thread (the herder's own
work on an envelope), mean an envelope, ms."""


def read(ctx):
    drains = [(a, b, t) for (n, a, b, t) in ctx.program_spans
              if n == "crypto.verify_many"]
    own = []
    for (n, a, b, t) in ctx.program_spans:
        if n == "herder.recv_scp_envelope":
            own.append((b - a) - sum(y - x for (x, y, u) in drains
                                     if u == t and x >= a and y <= b))
    return 1e3 * sum(own) / len(own) if own else None
