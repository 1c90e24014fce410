"""Device time of a training window, the graph's first stamp node to its
last (the program's ``window.device`` span, ``utils/spans.py``), the
mean over the windows of the cell's length recorded with the profiler
off, in ms: a process's windows sit at two levels 6-12% apart, and the
mean, as ``train_qps``, weighs each by its share. The other span readers
take :func:`mean_ms` or :func:`median_ms` from here. None where the
program records no such span (the CPU, or a program without spans)."""

import statistics


def samples(ctx, name):
    """The durations in ms of `name`'s samples of the cell's windows run
    with the profiler off; empty without the program's spans."""
    try:
        from ultra_pytorch_tpu_torch.utils import spans
    except ImportError:
        return []
    got = spans.snapshot()["spans"].get(name)
    steps = ctx.cell.traffic["window_steps"]
    return [s["ms"] for s in (got["samples"] if got else ())
            if s["steps"] == steps and not s["profiled"]]


def mean_ms(ctx, name):
    found = samples(ctx, name)
    return statistics.fmean(found) if found else None


def median_ms(ctx, name):
    found = samples(ctx, name)
    return statistics.median(found) if found else None


def read(ctx):
    return mean_ms(ctx, "window.device")
