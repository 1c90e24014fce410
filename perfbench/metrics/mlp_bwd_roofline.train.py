"""The DNN's forward and backward over one step's rows (K1 and K2, or
the library chain and autograd), timed by CUDA events over a graph of
repeated calls, against the roofline bound of the fused backward
(``work/<config>.py`` ``mlp_bwd``: the forward recomputed, every
parameter's and the features' gradient), in percent."""

import torch

from perfbench.yardstick import peaks, timing


def read(ctx):
    if ctx.sample.device.type != "cuda":
        return None
    x = ctx.sample
    params = list(ctx.ranker.parameters())

    def step():
        return torch.autograd.grad(ctx.ranker(x).sum(), params)

    seconds = timing.graph_seconds(step)
    ops, nbytes = ctx.work.mlp_bwd(ctx.cfg, x.shape[0] * x.shape[1])
    return peaks.roofline_share(ops, nbytes, seconds)
