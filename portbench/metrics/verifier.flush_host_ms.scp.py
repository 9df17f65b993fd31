"""verifier.flush_host_ms: of the port's `crypto.verify_many` spans inside
the traced window, the part the device does not cover, mean a flush, ms.
None without a device trace.

On the synchronous stack every device operation of the cell (the copies,
the kernel and the copy back) is launched and waited for inside a flush,
so the device's busy time in the window is the sum, over the window's
flushes, of the time it covers of each. The mean of flush less covered is
then the mean flush less `busy_s` over the number of flushes: no interval
is placed against a span, so the profiler's clock need not match the
host's."""


def read(ctx):
    trace = ctx.trace
    if trace is None:
        return None
    t0, t1 = trace.t0, trace.t0 + trace.window_s
    flushes = [b - a for (n, a, b, _t) in ctx.program_spans
               if n == "crypto.verify_many" and t0 <= a and b <= t1]
    if not flushes:
        return None
    return 1e3 * (sum(flushes) - trace.busy_s) / len(flushes)
