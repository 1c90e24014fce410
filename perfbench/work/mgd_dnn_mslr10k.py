"""Work of the MGD configuration, from the shapes alone.

K1's forward is ``work/dnn_mslr10k.py``'s (a copy of the port's
``tools/roofline.py`` ``mlp_work``). A step (``yardstick/mgd.py``) runs
the DNN forward six times over B x N rows of whole lists: the feed's
ranking with the current ranker, then the current ranker and the four
candidates. Around them, counted an element at a time: each noise's
draw scaled to unit norm, each candidate's weights, six Plackett-Luce
rankings (Gumbel keys and a sort of N log2 N comparisons a list), two
sets of 1 + 16 click rounds on L positions, the draft (a scan of a
ranking a shown position), the credit, the update (the credit-weighted
noise, its global norm, the clip and SGD) and the loss (an nDCG over L)."""

from __future__ import annotations

import math
from typing import Dict, Tuple

from perfbench.work import dnn_mslr10k as dnn

NOISE_OPS = 3      # an element's square, its share of the norm, the scale
PERTURB_OPS = 2    # params + lr * noise
KEY_OPS = 4        # two logs, a product by tau, a difference
CLICK_OPS = 3      # exam x click_prob, the comparison, the mask
DRAFT_OPS = 3      # a scanned slot's pointer test, used test and select
CREDIT_OPS = 3     # a shown slot's team test, click product, sum
UPDATE_OPS = 5     # a parameter's norm term, clip, rate, add (and sum)
NDCG_OPS = 6       # gain, discount product, sums, ideal's, the ratio


def mlp_fwd(cfg: Dict, rows: int) -> Tuple[int, int]:
    """(operations, bytes) of K1's forward over `rows` rows."""
    return dnn.mlp_fwd(cfg, rows)


def perturbed(cfg: Dict) -> int:
    """The parameters the noise moves: every Linear's weight and bias."""
    return sum(d_in * d_out + d_out for d_in, d_out in dnn.layer_widths(cfg))


def flops_per_step(cfg: Dict) -> int:
    B, N = cfg["batch_size"], cfg["list_length"]
    L = min(cfg["selection_bias_cutoff"], N)
    R = int(cfg["algorithm_hparams"]["ranker_num"])
    rankings = 1 + (1 + R)                  # the feed's and each ranker's
    rounds = 1 + 16
    p = perturbed(cfg)
    forwards = rankings * mlp_fwd(cfg, B * N)[0]
    noise = R * p * (NOISE_OPS + PERTURB_OPS)
    sampling = rankings * B * N * (KEY_OPS + math.ceil(math.log2(N)))
    clicks = 2 * rounds * B * L * CLICK_OPS
    draft = B * L * N * DRAFT_OPS + B * (1 + R) * L * CREDIT_OPS
    update = R * p * 2 + dnn.n_params(cfg) * UPDATE_OPS
    loss = B * L * (NDCG_OPS + 2 * math.ceil(math.log2(L)))
    return forwards + noise + sampling + clicks + draft + update + loss
