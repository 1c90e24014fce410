"""The device's idle share of the profiled windows: 1 - (the union of its
activity) / (the windows' wall time), in percent. Tracing adds about a
microsecond a kernel to a replay's wall time, so this reads above the
untraced idle share by about (kernels a step x 1 µs) / (a step's time)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
