"""Pairwise Debiasing (unbiased LambdaMART-style) algorithm.

The port's counterpart of the JAX package's
``algorithms/pairwise_debias.py``:

* for every ordered position pair (i, j), ``valid_pair = min(1, relu(l_i
  - l_j))`` per list and ``pair_loss[i, j] = sum_b valid_pair * log(1 +
  exp(s_j - s_i))``, one ``[B, L, L]`` broadcast;
* the debiased loss ``sum_ij pair_loss / (t+_i t-_j)``;
* EMA power updates, in place, of the position-bias ratios in ``aux``
  (``t_plus``, ``t_minus``, each ``[L]`` from ones): ``t <- (1 - a) t + a
  (t_loss / t_loss[0]) ^ (1 / (p + 1))``, the ratio 1 where ``t_loss[0]``
  is not positive.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ultra_pytorch_tpu_torch.algorithms.base import BaseAlgorithm
from ultra_pytorch_tpu_torch.utils.registry import register


def ones_t(L: int, device):
    """Fresh t+ / t- state: ones over the training list."""
    return {"t_plus": torch.ones(L, device=device),
            "t_minus": torch.ones(L, device=device)}


@register("algorithm", "PairDebias",
          aliases=["ultra.learning_algorithm.PairDebias"])
class PairDebias(BaseAlgorithm):

    name = "pairwise_debias"

    def default_hparams(self):
        return {
            "EM_step_size": 0.05,
            "learning_rate": 0.005,
            "max_gradient_norm": 5.0,
            "regulation_p": 1,
            "l2_loss": 0.0,
            "grad_strategy": "ada",
        }

    def init_state(self, generator):
        state = super().init_state(generator)
        state.aux = ones_t(self.rank_list_size, self.device)
        return state

    @staticmethod
    def _pair_loss_matrix(scores, labels, mask):
        """``[L, L]`` batch-summed valid-pair cross entropies."""
        valid_pair = torch.clamp(
            F.relu(labels[:, :, None] - labels[:, None, :]), max=1.0)
        if mask is not None:
            valid_pair = valid_pair * mask[:, :, None] * mask[:, None, :]
        ce = torch.log1p(torch.exp(-(scores[:, :, None]
                                     - scores[:, None, :])))
        return torch.sum(valid_pair * ce, dim=0)

    def losses(self, state, batch, *, generator=None):
        """(loss, pair_loss [L, L] without its gradient)."""
        batch = self.train_slice(batch)
        clicks, mask = batch["labels"], batch.get("mask")
        t_plus, t_minus = state.aux["t_plus"], state.aux["t_minus"]
        L = clicks.shape[1]
        off_diag = 1.0 - torch.eye(L, device=clicks.device)
        scores = self.score_with_params(state.params, batch, generator)
        pair_loss = self._pair_loss_matrix(scores, clicks, mask) * off_diag
        loss = torch.sum(pair_loss / (t_plus[:, None] * t_minus[None, :]))
        return (loss + self.l2_penalty(self.trainable(state)),
                pair_loss.detach())

    def update_aux(self, state, out):
        pair_loss = self.sync(out[1])
        t_plus, t_minus = state.aux["t_plus"], state.aux["t_minus"]
        t_plus_loss = torch.sum(pair_loss / t_minus[None, :], dim=1)
        t_minus_loss = torch.sum(pair_loss / t_plus[:, None], dim=0)
        alpha = self.hparams.EM_step_size
        power = 1.0 / (self.hparams.regulation_p + 1.0)

        def ema(t, t_loss):
            ratio = torch.where(t_loss[0] > 0, t_loss / t_loss[0],
                                torch.ones_like(t_loss))
            return (1 - alpha) * t + alpha * torch.pow(ratio, power)

        new_plus, new_minus = ema(t_plus, t_plus_loss), ema(t_minus,
                                                            t_minus_loss)
        t_plus.copy_(new_plus)
        t_minus.copy_(new_minus)
        return state
