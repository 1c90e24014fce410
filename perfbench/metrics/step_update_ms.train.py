"""Device time of the update of a window's last step: the clip and Adagrad
(``apply_gradients``), the propensity tower's update (``update_aux``)
and the step's metrics stacked and added (the program's ``step.update``
span, ``utils/spans.py``), the mean over the windows of the cell's
length recorded with the profiler off, in ms. None without such a span."""

from perfbench import spec


def read(ctx):
    return spec.load_module("metrics", "window_device_ms.train").mean_ms(
        ctx, "step.update")
