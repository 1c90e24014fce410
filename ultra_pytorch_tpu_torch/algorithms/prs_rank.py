"""PRS-rank: propensity-ratio-scored pairwise debiasing.

The port's counterpart of the JAX package's ``algorithms/prs_rank.py``: a
LambdaRank-style ΔNDCG-weighted pairwise BCE on probabilities, weighted by
the propensity ratio score matrix ``prs = ipw_i * pw_j`` in score order
(``ipw`` from a pre-trained estimator with ``use_non_clicked_data=True``,
``pw = safe_div(1, ipw)``), upper-triangular, without its gradient. No
aux state.

The clip of ``p`` is ``minimum(maximum(p, 0), 1)``, whose gradient at a
bound is 0.5 like ``jnp.clip``'s (``torch.clamp`` passes 1); the logs are
clamped at -100 through a double ``where``, so a term the triangle mask
zeroes keeps a finite gradient.
"""

from __future__ import annotations

import torch

from ultra_pytorch_tpu_torch.algorithms.base import BaseAlgorithm
from ultra_pytorch_tpu_torch.algorithms.ipw import load_estimator
from ultra_pytorch_tpu_torch.algorithms.lambda_rank import (
    LambdaRank, safe_div)
from ultra_pytorch_tpu_torch.utils.registry import register


def _clamped_log(ok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``max(log x, -100)`` where `ok`, else -100."""
    floor = torch.full_like(x, -100.0)
    return torch.maximum(torch.where(
        ok, torch.log(torch.where(ok, x, torch.ones_like(x))), floor), floor)


@register("algorithm", "PRSrank",
          aliases=["ultra.learning_algorithm.PRSrank"])
class PRSrank(LambdaRank):

    name = "prs_rank"

    def default_hparams(self):
        return {
            "propensity_estimator_type": "ultra.utils.propensity_estimator."
                                         "RandomizedPropensityEstimator",
            "propensity_estimator_json": "./example/PropensityEstimator/"
                                         "randomized_pbm_0.1_1.0_4_1.0.json",
            "learning_rate": 0.05,
            "max_gradient_norm": 5.0,
            "grad_strategy": "ada",
            "sigma": 1.0,
        }

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.propensity_estimator = load_estimator(self.hparams)

    def init_state(self, generator):
        return BaseAlgorithm.init_state(self, generator)

    def losses(self, state, batch, *, generator=None):
        batch = self.train_slice(batch)
        clicks = batch["labels"]
        L = clicks.shape[1]
        ipw = self.propensity_estimator.weights(clicks,
                                                use_non_clicked_data=True)
        pw = safe_div(torch.ones_like(ipw), ipw)
        triu = torch.triu(torch.ones((L, L), device=clicks.device),
                          diagonal=1)[None]
        scores = self.score_with_params(state.params, batch, generator)
        order, p_ij, std_p_ij, delta = self._pair_matrices(scores, clicks)
        prs = (torch.gather(ipw, 1, order)[:, :, None]
               * torch.gather(pw, 1, order)[:, None, :] * triu)
        p = torch.minimum(torch.maximum(p_ij * triu, torch.zeros_like(p_ij)),
                          torch.ones_like(p_ij))
        z = std_p_ij * triu
        log_p = _clamped_log(p > 1e-12, p)
        log_1mp = _clamped_log((1.0 - p) > 1e-12, 1.0 - p)
        bce = -(z * log_p + (1.0 - z) * log_1mp) * (delta * triu)
        return (torch.sum(bce * prs.detach()),)

    def update_aux(self, state, out):
        return state
