"""Device time of the forward of a window's last step: the batch's gather
from the plan and ``algorithm.losses`` (the ranker's forward, both
towers' losses) (the program's ``step.forward`` span,
``utils/spans.py``), the mean over the windows of the cell's length
recorded with the profiler off, in ms. None without such a span."""

from perfbench import spec


def read(ctx):
    return spec.load_module("metrics", "window_device_ms.train").mean_ms(
        ctx, "step.forward")
