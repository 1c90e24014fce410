"""Device time of the online feed's batch in a window's last step: the
queries' whole lists ranked with the current ranker (K1), the
Plackett-Luce draw and the click rounds (the program's ``step.feed``
span, ``utils/spans.py``), the mean over the windows of the cell's
length recorded with the profiler off, in ms. None without such a
span."""

from perfbench import spec


def read(ctx):
    return spec.load_module("metrics", "window_device_ms.train").mean_ms(
        ctx, "step.feed")
