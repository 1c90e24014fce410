"""Host time of a window's replay call (``cudaGraphLaunch``; the
program's host span ``window.replay``, ``utils/spans.py``), the median
over the windows of the cell's length recorded with the profiler off, in
ms: a host time's rare long samples (a collection, a page fault) are not
the launch's. None without such a span."""

from perfbench import spec


def read(ctx):
    return spec.load_module("metrics", "window_device_ms.train").median_ms(
        ctx, "window.replay")
