"""Device time of the candidates in a window's last online step: the
noises, and the current ranker and each perturbed candidate scored over
the batch's whole lists (the program's ``step.candidates`` span,
``utils/spans.py``), the mean over the windows of the cell's length
recorded with the profiler off, in ms. None without such a span."""

from perfbench import spec


def read(ctx):
    return spec.load_module("metrics", "window_device_ms.train").mean_ms(
        ctx, "step.candidates")
