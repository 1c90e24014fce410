"""Listwise / pairwise / pointwise ranking losses, mask-aware.

The port's counterpart of the JAX package's ``ops/losses.py``, with the
same formulas and the same documented divergences from the original
ULTRA reference (every pair counted once in ``pairwise_loss_on_list``;
masked positions excluded from softmax mass and from pairs). All
functions take ``[B, L]`` scores and labels plus optional ``[B, L]``
propensity weights and a validity ``mask`` and reduce to a scalar.

``LOSS_FUNCTIONS`` keeps the JAX package's four keys;
``fused_softmax_loss`` is K3/K4 (``ops/kernels/listwise_loss.py``).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e9


def softmax_cross_entropy_with_logits(logits: torch.Tensor,
                                      labels: torch.Tensor) -> torch.Tensor:
    """Per-list CE between a label distribution and softmax(logits); [B]."""
    return torch.sum(-labels * F.log_softmax(logits, dim=-1), dim=-1)


def _ones_if_none(w, like):
    return torch.ones_like(like) if w is None else w


def softmax_loss(output: torch.Tensor, labels: torch.Tensor,
                 propensity_weights: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Propensity-weighted listwise softmax loss: labels + 1e-7, masked
    scores to -1e9, each list's CE weighted by its denominator, divided by
    the total weight."""
    propensity_weights = _ones_if_none(propensity_weights, labels)
    weighted_labels = (labels + 1e-7) * propensity_weights
    if mask is not None:
        weighted_labels = weighted_labels * mask
        output = torch.where(mask > 0, output,
                             torch.full_like(output, NEG_INF))
    denom = torch.sum(weighted_labels, dim=1, keepdim=True)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    label_dis = torch.where(denom > 0, weighted_labels / safe,
                            torch.zeros_like(weighted_labels))
    per_list = softmax_cross_entropy_with_logits(output, label_dis)
    per_list = per_list * denom.squeeze(1)
    total = torch.sum(weighted_labels)
    return torch.sum(per_list) / torch.where(total > 0, total,
                                             torch.ones_like(total))


def bce_with_logits(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Elementwise ``max(x, 0) - x z + log(1 + exp(-|x|))``. Written with
    ``relu``: at x == 0 its gradient (0) plus torch's ``abs`` (0) gives
    JAX's ``-z`` there, where ``jnp.maximum`` (0.5) and ``jnp.abs`` (1)
    also sum to it; ``torch.maximum`` would give 0.5 - z and
    ``clamp_min`` 1 - z."""
    return F.relu(x) - x * z + torch.log1p(torch.exp(-x.abs()))


def sigmoid_loss_on_list(output: torch.Tensor, labels: torch.Tensor,
                         propensity_weights: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Pointwise BCE-with-logits, summed over the list and averaged over
    the batch."""
    propensity_weights = _ones_if_none(propensity_weights, labels)
    loss = bce_with_logits(output, labels) * propensity_weights
    if mask is not None:
        loss = loss * mask
    return torch.mean(torch.sum(loss, dim=1))


def pairwise_loss_on_list(output: torch.Tensor, labels: torch.Tensor,
                          propensity_weights: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Pairwise loss over all ordered pairs i < j:
    sign(l_i - l_j) * (-sigmoid(s_i - s_j)) * (pw_i*l_i + pw_j*l_j),
    summed and divided by the batch size."""
    propensity_weights = _ones_if_none(propensity_weights, labels)
    s_i, s_j = output[:, :, None], output[:, None, :]
    l_i, l_j = labels[:, :, None], labels[:, None, :]
    w_i, w_j = propensity_weights[:, :, None], propensity_weights[:, None, :]
    label_weight = torch.sign(l_i - l_j)
    pair_propensity = w_i * l_i + w_j * l_j
    pair_loss = -torch.sigmoid(s_i - s_j)
    length = output.shape[1]
    valid = torch.triu(torch.ones((length, length), dtype=output.dtype,
                                  device=output.device), diagonal=1)[None]
    if mask is not None:
        valid = valid * mask[:, :, None] * mask[:, None, :]
    total = torch.sum(label_weight * pair_loss * pair_propensity * valid)
    return total / output.shape[0]


def pairwise_cross_entropy_loss(pos_scores: torch.Tensor,
                                neg_scores: torch.Tensor,
                                propensity_weights: Optional[torch.Tensor]
                                = None) -> torch.Tensor:
    """Softmax CE on (pos, neg) score pairs labelled (1, 0); shapes
    ``[N, 1]``, returns the ``[N, 1]`` per-pair loss."""
    propensity_weights = _ones_if_none(propensity_weights, pos_scores)
    loss = torch.log1p(torch.exp(-(pos_scores - neg_scores)))
    return loss * propensity_weights


def l2_loss(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sum(x^2)/2 over parameter tensors."""
    return sum(torch.sum(x ** 2) for x in tensors) / 2.0


def _fused_softmax_loss(output, labels, propensity_weights=None, mask=None):
    """softmax_loss through K3/K4 (``loss_func=fused_softmax_loss``)."""
    from ultra_pytorch_tpu_torch.ops.kernels.listwise_loss import (
        fused_softmax_loss)
    return fused_softmax_loss(output, labels, propensity_weights, mask)


LOSS_FUNCTIONS = {
    "softmax_loss": softmax_loss,
    "sigmoid_loss": sigmoid_loss_on_list,
    "pairwise_loss": pairwise_loss_on_list,
    "fused_softmax_loss": _fused_softmax_loss,
}
