"""Naive algorithm: train directly on the fed labels or clicks.

The port's counterpart of the JAX package's ``algorithms/naive.py``: the
training list's scores under the selected loss (``loss_func``:
``softmax_loss``, ``sigmoid_loss``, ``pairwise_loss`` or
``fused_softmax_loss``, which is K3/K4), with no debiasing.
"""

from __future__ import annotations

from ultra_pytorch_tpu_torch.algorithms.base import BaseAlgorithm
from ultra_pytorch_tpu_torch.utils.registry import register


@register("algorithm", "NaiveAlgorithm",
          aliases=["ultra.learning_algorithm.NavieAlgorithm",
                   "ultra.learning_algorithm.NaiveAlgorithm"])
class NaiveAlgorithm(BaseAlgorithm):

    name = "naive"

    def losses(self, state, batch, *, generator=None):
        batch = self.train_slice(batch)
        mask = batch.get("mask")
        scores = self.score_with_params(state.params, batch, generator)
        loss = self.loss_fn(scores, batch["labels"], mask=mask)
        return (loss + self.l2_penalty(self.trainable(state)),)
