"""Work of the DNN configuration: a copy of the port's
``tools/roofline.py`` counts (``mlp_work``, ``mlp_bwd_work``,
``step_work``'s ``flops_per_step``) from the widths alone.

A layer (d_in -> d_out) a row: 2 d_in d_out + d_out for the Linear,
6 d_in for the LayerNorm, d_out for the activation (not on the output).
The backward a row: dW and, past the first layer, the activations'
gradient (2 d_in d_out each), db (d_out), and past the first layer the
LayerNorm's (10 d_in) and the activation's (2 d_in) backward. K2 also
recomputes the forward and takes the features' gradient."""

from __future__ import annotations

from typing import Dict, List, Tuple

from perfbench.yardstick import dla_work as dla

NORM_FWD, NORM_BWD, ACT_BWD = 6, 10, 2


def layer_widths(cfg: Dict) -> List[Tuple[int, int]]:
    sizes = ([cfg["features"]]
             + list(cfg["ranker_hparams"]["hidden_layer_sizes"]) + [1])
    return list(zip(sizes[:-1], sizes[1:]))


def n_params(cfg: Dict) -> int:
    return sum(d_in * d_out + d_out + 2 * d_in
               for d_in, d_out in layer_widths(cfg))


def mlp_fwd(cfg: Dict, rows: int) -> Tuple[int, int]:
    """(operations, bytes) of the forward over `rows` rows; bytes read the
    features and the weights once and write the scores."""
    widths = layer_widths(cfg)
    ops = 0
    for j, (d_in, d_out) in enumerate(widths):
        ops += 2 * d_in * d_out + d_out + NORM_FWD * d_in
        if j != len(widths) - 1:
            ops += d_out
    return rows * ops, 4 * (rows * cfg["features"] + n_params(cfg) + rows)


def mlp_bwd(cfg: Dict, rows: int) -> Tuple[int, int]:
    """(operations, bytes) of the fused backward (K2): the forward again,
    then dz W^T and post^T dz, db, the LayerNorm's and the activation's
    backward; bytes read x, g and the weights and write dx and every
    parameter's gradient."""
    ops, _ = mlp_fwd(cfg, rows)
    for j, (d_in, d_out) in enumerate(layer_widths(cfg)):
        ops += rows * (4 * d_in * d_out + d_out + NORM_BWD * d_in)
        if j:
            ops += rows * ACT_BWD * d_in
    return ops, 4 * (2 * rows * cfg["features"] + rows + 2 * n_params(cfg))


def flops_per_step(cfg: Dict) -> int:
    """The step's function: the ranker's forward, its backward in every
    weight and hidden activation (not in the features), both losses and
    their gradients, both towers' weights and optimizers."""
    B, L = cfg["batch_size"], cfg["selection_bias_cutoff"]
    n = B * L
    backward = 0
    for j, (d_in, d_out) in enumerate(layer_widths(cfg)):
        backward += 2 * n * d_in * d_out + n * d_out
        if j:
            backward += 2 * n * d_in * d_out + n * (ACT_BWD + NORM_BWD) * d_in
    return (mlp_fwd(cfg, n)[0] + backward
            + dla.outside_ranker(B, L, n_params(cfg)))
