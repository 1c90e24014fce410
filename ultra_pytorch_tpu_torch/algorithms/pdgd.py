"""Pairwise Differentiable Gradient Descent (PDGD).

The port's counterpart of the JAX package's ``algorithms/pdgd.py``
(Oosterhuis and de Rijke, CIKM'18). A step scores the whole candidate
list once without gradients for the debiasing weights, then again for
the loss ``sum(w * -sigmoid(s_l - s_k)) + l2`` over the pairs (clicked l,
candidate k) with ``label_k < label_l`` and ``k <= l + 1`` within the
cutoff. Both passes score the full list (B * Lc rows: K1, and K2 for the
loss's backward with ``use_pallas=true``), as the JAX step does.

The pair weight is ``1 / (1 + exp(dlog))``, where dlog is the change of
the Plackett-Luce log-denominators when l and k swap places: swapping
positions (lo, hi) changes only the denominators d_m with lo < m <= hi,
each by ``e_lo - e_hi``, so it is a masked sum over one ``[B, L, L, L]``
tensor (clamped at 20).
"""

from __future__ import annotations

import torch

from ultra_pytorch_tpu_torch.algorithms.base import BaseAlgorithm
from ultra_pytorch_tpu_torch.utils.registry import register


def pdgd_pair_weights(scores0: torch.Tensor, labels_full: torch.Tensor,
                      mask_full: torch.Tensor, L: int,
                      tau: float) -> torch.Tensor:
    """Debiasing weights ``[B, L, L]`` of every (clicked l, candidate k)
    pair from the full list's scores ``[B, Lc]``; zero at invalid
    pairs."""
    scores0 = scores0 - scores0.max(dim=1, keepdim=True).values
    e = torch.exp(tau * scores0) * mask_full
    d = torch.flip(torch.cumsum(torch.flip(e, [1]), dim=1), [1])
    log_d = torch.where(d > 0, torch.log(d.clamp_min(1e-30)), 0.0)

    labels = labels_full[:, :L]
    mask = mask_full[:, :L]
    idx = torch.arange(L, device=scores0.device)
    l_idx, k_idx = idx[:, None], idx[None, :]
    pair_ok = ((labels[:, :, None] > 0)
               & (labels[:, None, :] < labels[:, :, None])
               & (k_idx <= l_idx + 1)[None]
               & (mask[:, :, None] > 0) & (mask[:, None, :] > 0))

    lo = torch.minimum(l_idx, k_idx)
    hi = torch.maximum(l_idx, k_idx)
    e_top = e[:, :L]
    delta = e_top[:, lo] - e_top[:, hi]                       # [B, L, L]
    in_range = (idx[None, None, :] > lo[:, :, None]) & (
        idx[None, None, :] <= hi[:, :, None])                   # [L, L, L]
    d_flip = d[:, None, None, :L] + delta[:, :, :, None]
    log_flip = torch.where(d_flip > 0, torch.log(d_flip.clamp_min(1e-30)),
                           0.0)
    dlog = torch.sum(in_range[None] * (log_flip
                                       - log_d[:, None, None, :L]), dim=-1)
    weights = 1.0 / (1.0 + torch.exp(dlog.clamp_max(20.0)))
    return weights * pair_ok


@register("algorithm", "PDGD", aliases=["ultra.learning_algorithm.PDGD"])
class PDGD(BaseAlgorithm):

    name = "pdgd"

    def default_hparams(self):
        return {
            "learning_rate": 0.05,
            "tau": 1.0,
            "max_gradient_norm": 1.0,
            "l2_loss": 0.005,
            "grad_strategy": "ada",
        }

    def losses(self, state, batch, *, generator=None):
        """(loss, and the shown list's ``online_reward`` and
        ``online_ndcg`` when the batch came from an online feed)."""
        labels_full = batch["labels"]
        mask_full = batch.get("mask")
        if mask_full is None:
            mask_full = torch.ones_like(labels_full)
        L = min(self.rank_list_size, labels_full.shape[1])
        weights = pdgd_pair_weights(self.score(state, batch), labels_full,
                                    mask_full, L, float(self.hparams.tau))
        scores = self.score_with_params(state.params, batch,
                                        generator)[:, :L]
        pair_term = -torch.sigmoid(scores[:, :, None] - scores[:, None, :])
        loss = (torch.sum(weights * pair_term)
                + self.l2_penalty(self.trainable(state)))
        online = self.online_reward_metric(batch)
        if online is None:
            return (loss,)
        return loss, online["online_reward"], online["online_ndcg"]

    def metrics(self, out):
        return dict(zip(("loss", "online_reward", "online_ndcg"),
                        (t.detach() for t in out)))
