"""process.gc_pct: the interpreter's cyclic collections, the port's
`gc.gen0`/`gc.gen1`/`gc.gen2` spans, their time inside the traced window
over the window's length, %. None without a device trace (the window is
the profiler's) or without collector spans."""


def read(ctx):
    trace = ctx.trace
    if trace is None or trace.window_s <= 0:
        return None
    t0, t1 = trace.t0, trace.t0 + trace.window_s
    spans = [(a, b) for (n, a, b, _t) in ctx.program_spans
             if n.startswith("gc.gen")]
    if not spans:
        return None
    inside = sum(max(0.0, min(b, t1) - max(a, t0)) for (a, b) in spans)
    return 100.0 * inside / trace.window_s
