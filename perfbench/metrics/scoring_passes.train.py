"""Passes of a ranker over the batch's whole lists a step: the online
feed's (the program's counter ``online.feed_scored``) and the
algorithm's, the current ranker and each candidate
(``online.rankers_scored``), counted over the windows of the measured
seconds, over their steps. None where the program has no such counter."""

NAMES = ("online.feed_scored", "online.rankers_scored")


def read(ctx):
    counted = getattr(ctx, "counters", None) or {}
    if not ctx.steps or not all(name in counted for name in NAMES):
        return None
    return sum(counted[name] for name in NAMES) / ctx.steps
