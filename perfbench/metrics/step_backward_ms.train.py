"""Device time of the backward of a window's last step (``gradients``) (the
program's ``step.backward`` span, ``utils/spans.py``), the median over
the windows of the cell's length recorded with the profiler off, in ms.
None without such a span."""

from perfbench import spec


def read(ctx):
    return spec.load_module("metrics", "window_device_ms.train").mean_ms(
        ctx, "step.backward")
