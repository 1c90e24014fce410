"""The device's wait between two training windows: from the previous
window's last stamp node to this window's first (the program's
``window.launch_wait`` span, ``utils/spans.py``; in the benchmark's loop
the read-back of the previous window, the host's work and the launch),
the median over the windows of the cell's length recorded with the
profiler off, in ms: the first window after set-up waits for the check's
reads, which are not the loop's. None without such a span."""

from perfbench import spec


def read(ctx):
    return spec.load_module("metrics", "window_device_ms.train").median_ms(
        ctx, "window.launch_wait")
