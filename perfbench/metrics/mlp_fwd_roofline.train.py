"""The DNN's forward over one step's rows (batch x cutoff) through the
ranker as the cell's hparams build it (K1, or the library chain), timed
by CUDA events over a graph of repeated calls, against its roofline
bound (``work/<config>.py`` ``mlp_fwd``), in percent."""

import torch

from perfbench.yardstick import peaks, timing


def read(ctx):
    if ctx.sample.device.type != "cuda":
        return None
    x = ctx.sample
    with torch.no_grad():
        seconds = timing.graph_seconds(lambda: ctx.ranker(x))
    ops, nbytes = ctx.work.mlp_fwd(ctx.cfg, x.shape[0] * x.shape[1])
    return peaks.roofline_share(ops, nbytes, seconds)
