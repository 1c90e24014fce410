"""Work of the SetRank configuration, counted from its widths a row (a
document) of a list of L.

Forward: the input LayerNorm (6 F); each Linear (d_in -> d_out) 2 d_in
d_out + d_out; each relu 1 an element; per encoder layer the attention
(q k^T and the weighted sum, 2 L d each; scale, mask and a 4-operation
softmax a logit, H L logits), the output projection, two residual adds
(d each), two LayerNorms (6 d each) and the FFN. Backward: two products
a Linear (dX, dW: 4 d_in d_out) and db; the attention's two products
twice (8 L d) and 3 a logit for the softmax; 10 a LayerNorm element, 2 a
relu element, d a residual. Outside the ranker the DLA step counts as
for any ranker (``yardstick/dla_work.py``)."""

from __future__ import annotations

from typing import Dict

from perfbench.yardstick import dla_work as dla

NORM_FWD, NORM_BWD, ACT_BWD = 6, 10, 2
SOFTMAX_FWD, SOFTMAX_BWD = 4, 3


def _dims(cfg: Dict):
    hp = cfg["ranker_hparams"]
    return (cfg["features"], hp["d_model"], hp["diff"], hp["num_heads"],
            hp["num_layers"], cfg["selection_bias_cutoff"])


def _linears(cfg: Dict):
    f, d, dff, _, layers, _ = _dims(cfg)
    encoder = [(d, d), (d, dff), (dff, d)] * layers
    return [(f, dff), (dff, d)] + encoder + [(d, dff), (dff, 1)]


def n_params(cfg: Dict) -> int:
    f, d, _, _, layers, _ = _dims(cfg)
    return (sum(a * b + b for a, b in _linears(cfg)) + 2 * f
            + 4 * d * layers)


def _per_row(cfg: Dict, length: int):
    """(forward, backward) operations a row in lists of `length`."""
    f, d, dff, heads, layers, _ = _dims(cfg)
    fwd = NORM_FWD * f + sum(2 * a * b + b for a, b in _linears(cfg))
    bwd = NORM_BWD * f + sum(4 * a * b + b for a, b in _linears(cfg))
    relus = dff * (2 + layers)
    fwd += relus
    bwd += ACT_BWD * relus
    attn_fwd = 4 * length * d + (2 + SOFTMAX_FWD) * heads * length
    attn_bwd = 8 * length * d + SOFTMAX_BWD * heads * length
    fwd += layers * (attn_fwd + 2 * d + 2 * NORM_FWD * d)
    bwd += layers * (attn_bwd + 2 * d + 2 * NORM_BWD * d)
    return fwd, bwd


def flops_per_step(cfg: Dict) -> int:
    B, L = cfg["batch_size"], cfg["selection_bias_cutoff"]
    fwd, bwd = _per_row(cfg, L)
    return B * L * (fwd + bwd) + dla.outside_ranker(B, L, n_params(cfg))
