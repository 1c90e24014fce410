"""Device time of a window's plan (the feed's draws, K5), from the graph's
first stamp node to the plan's end (the program's ``window.plan`` span,
``utils/spans.py``), the mean over the windows of the cell's length
recorded with the profiler off, in ms. None without such a span."""

from perfbench import spec


def read(ctx):
    return spec.load_module("metrics", "window_device_ms.train").mean_ms(
        ctx, "window.plan")
