"""Host time of one ``Experiment.train_steps_device`` call (one replay
of a window's graph, the device idle: windows run one at a time), the
median of the benchmark's spans around the calls of the measured window,
in ms."""

import statistics


def read(ctx):
    if not ctx.host_spans:
        return None
    return statistics.median(ctx.host_spans) * 1e3
