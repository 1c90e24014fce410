"""Device time of the comparison in a window's last online step: the
rankers' Plackett-Luce rankings, the team draft, the click uniforms and
clicks, and the credit (the program's ``step.multileave`` span,
``utils/spans.py``), the mean over the windows of the cell's length
recorded with the profiler off, in ms. None without such a span."""

from perfbench import spec


def read(ctx):
    return spec.load_module("metrics", "window_device_ms.train").mean_ms(
        ctx, "step.multileave")
