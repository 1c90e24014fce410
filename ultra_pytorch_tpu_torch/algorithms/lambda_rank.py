"""Debiased LambdaRank.

The port's counterpart of the JAX package's ``algorithms/lambda_rank.py``:
sort by score (a stable descending argsort), the pairwise targets
``std_p_ij = 0.5 (1 + clamp(l_i - l_j, -1, 1))`` and probabilities
``p_ij = sigmoid(sigma (s_i - s_j))``, each pair weighted by the |ΔNDCG|
of swapping it, and PairDebias-style t+/t- EMA state in ``aux`` (updated
in place). The mask
is ignored, as in the JAX package.

Reference quirks kept: the BCE treats ``p_ij`` (already a sigmoid) as a
LOGIT (torch's ``BCEWithLogitsLoss(weight=delta)(p_ij, std_p_ij)``), and
the IDCG of ΔNDCG is summed over the whole batch into one scalar.
"""

from __future__ import annotations

import torch

from ultra_pytorch_tpu_torch.algorithms.base import BaseAlgorithm
from ultra_pytorch_tpu_torch.algorithms.pairwise_debias import ones_t
from ultra_pytorch_tpu_torch.ops.losses import bce_with_logits
from ultra_pytorch_tpu_torch.utils.registry import register


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den``, 0 where ``den == 0``."""
    zero = den == 0
    return torch.where(zero, torch.zeros_like(num),
                       num / torch.where(zero, torch.ones_like(den), den))


@register("algorithm", "LambdaRank",
          aliases=["ultra.learning_algorithm.LambdaRank"])
class LambdaRank(BaseAlgorithm):

    name = "lambda_rank"

    def default_hparams(self):
        return {
            "EM_step_size": 0.05,
            "learning_rate": 0.05,
            "max_gradient_norm": 5.0,
            "grad_strategy": "ada",
            "regulation_p": 1,
            "sigma": 1.0,
        }

    def init_state(self, generator):
        state = super().init_state(generator)
        state.aux = ones_t(self.rank_list_size, self.device)
        return state

    @staticmethod
    def delta_ndcg(ideal_sorted, labels_sorted_via_preds):
        """``[B, L, L]`` |ΔNDCG| of pairwise swaps, with the batch-summed
        scalar IDCG."""
        L = ideal_sorted.shape[1]
        dev = ideal_sorted.device
        pos = torch.arange(1, L + 1, dtype=torch.float32, device=dev)
        idcg = torch.sum(safe_div(2.0 ** ideal_sorted - 1.0,
                                  torch.log(pos + 1.0)[None, :]))
        gains = 2.0 ** labels_sorted_via_preds - 1.0
        n_gains = safe_div(gains, idcg.expand(gains.shape))
        ng_diffs = n_gains[:, :, None] - n_gains[:, None, :]
        dists = 1.0 / torch.log2(torch.arange(L, dtype=torch.float32,
                                              device=dev) + 2.0)
        dist_diffs = dists[:, None] - dists[None, :]
        return torch.abs(ng_diffs) * torch.abs(dist_diffs)[None]

    def _pair_matrices(self, scores, labels):
        """(order, p_ij, std_p_ij, delta) in descending-score order."""
        order = torch.argsort(-scores, dim=1, stable=True)
        preds_sorted = torch.gather(scores, 1, order)
        labels_sorted = torch.gather(labels, 1, order)
        std_diffs = labels_sorted[:, :, None] - labels_sorted[:, None, :]
        std_p_ij = 0.5 * (1.0 + torch.clamp(std_diffs, -1.0, 1.0))
        s_ij = preds_sorted[:, :, None] - preds_sorted[:, None, :]
        p_ij = torch.sigmoid(self.hparams.sigma * s_ij)
        ideal_sorted = torch.flip(torch.sort(labels, dim=1).values, [1])
        delta = self.delta_ndcg(ideal_sorted, labels_sorted)
        return order, p_ij, std_p_ij, delta

    def losses(self, state, batch, *, generator=None):
        """(loss, pair_loss [L, L] without its gradient)."""
        batch = self.train_slice(batch)
        scores = self.score_with_params(state.params, batch, generator)
        _, p_ij, std_p_ij, delta = self._pair_matrices(scores,
                                                       batch["labels"])
        pair_loss = torch.sum(bce_with_logits(p_ij, std_p_ij) * delta, dim=0)
        t_plus, t_minus = state.aux["t_plus"], state.aux["t_minus"]
        loss = torch.sum(safe_div(pair_loss,
                                  t_plus[:, None] * t_minus[None, :]))
        return loss, pair_loss.detach()

    def update_aux(self, state, out):
        pair_loss = self.sync(out[1])
        t_plus, t_minus = state.aux["t_plus"], state.aux["t_minus"]
        t_plus_loss = torch.sum(pair_loss / t_minus[None, :], dim=1)
        t_minus_loss = torch.sum(pair_loss.T / t_plus[None, :], dim=1)
        alpha = self.hparams.EM_step_size
        power = 1.0 / (self.hparams.regulation_p + 1.0)

        def ema(t, t_loss):
            return (1 - alpha) * t + alpha * torch.pow(
                safe_div(t_loss, t_loss[0].expand(t_loss.shape)), power)

        new_plus, new_minus = ema(t_plus, t_plus_loss), ema(t_minus,
                                                            t_minus_loss)
        t_plus.copy_(new_plus)
        t_minus.copy_(new_minus)
        return state
