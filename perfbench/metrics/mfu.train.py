"""The whole step's share of the 3xTF32 peak: the step's counted
operations (``work/<config>.py``) over the measured window's time with
the profiler off, in percent."""

from perfbench.yardstick import peaks


def read(ctx):
    return peaks.mfu(ctx.work.flops_per_step(ctx.cfg) * ctx.steps,
                     ctx.seconds)
