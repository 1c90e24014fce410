"""Regression-based EM (online EM) for unbiased learning to rank.

The port's counterpart of the JAX package's ``algorithms/regression_em.py``:

* E-step: from scores of a no-grad training-mode forward without a
  generator (a second K1 launch with ``use_pallas=true``; a ranker with
  dropout raises there, as in the JAX package, whose E-step passes no
  rng), ``gamma = sigmoid(scores)`` and the posterior
  relevance ``p_r1 = c + (1 - c) (1 - prop) gamma / (1 - prop gamma)``;
  Bernoulli pseudo-labels ``ceil(p_r1 - u)`` trained with BCE;
* M-step: the propensity ``[1, L]`` (``aux["propensity"]``, from 0.9,
  updated in place) moves by ``EM_step_size`` toward the batch mean of
  ``c + (1 - c) prop (1 - gamma) / (1 - prop gamma)`` (averaged over the
  ranks under data parallelism).

``train_step`` draws the uniforms ``u`` from this rank's generator;
:meth:`RegressionEM.step_with_uniforms` takes them from the caller.
"""

from __future__ import annotations

import torch

from ultra_pytorch_tpu_torch.algorithms.base import BaseAlgorithm
from ultra_pytorch_tpu_torch.ops.losses import bce_with_logits
from ultra_pytorch_tpu_torch.utils.registry import register


@register("algorithm", "RegressionEM",
          aliases=["ultra.learning_algorithm.RegressionEM"])
class RegressionEM(BaseAlgorithm):

    name = "regression_em"

    def default_hparams(self):
        return {
            "EM_step_size": 0.05,
            "learning_rate": 0.05,
            "max_gradient_norm": 5.0,
            "l2_loss": 0.0,
            "grad_strategy": "ada",
        }

    def init_state(self, generator):
        state = super().init_state(generator)
        state.aux = {"propensity": torch.full(
            (1, self.rank_list_size), 0.9, device=self.device)}
        return state

    def losses(self, state, batch, u, *, generator=None):
        """(loss, M-step target [1, L]) with the uniforms `u` of the
        step's Bernoulli pseudo-labels."""
        batch = self.train_slice(batch)
        clicks, mask = batch["labels"], batch.get("mask")
        propensity = state.aux["propensity"]
        with torch.no_grad():
            gamma = torch.sigmoid(self.score_with_params(state.params, batch))
            denom = 1.0 - propensity * gamma
            p_e1_r0_c0 = propensity * (1.0 - gamma) / denom
            p_e0_r1_c0 = (1.0 - propensity) * gamma / denom
            p_r1 = clicks + (1.0 - clicks) * p_e0_r1_c0
            ranker_labels = torch.ceil(p_r1 - u)
            target = torch.mean(clicks + (1.0 - clicks) * p_e1_r0_c0,
                                dim=0, keepdim=True)
        bce = bce_with_logits(
            self.score_with_params(state.params, batch, generator),
            ranker_labels)
        if mask is not None:
            loss = torch.sum(bce * mask) / torch.clamp_min(torch.sum(mask),
                                                           1.0)
        else:
            loss = torch.mean(bce)
        return loss + self.l2_penalty(self.trainable(state)), target

    def update_aux(self, state, out):
        alpha = self.hparams.EM_step_size
        propensity = state.aux["propensity"]
        propensity.copy_((1.0 - alpha) * propensity
                         + alpha * self.sync(out[1]))
        return state

    def step_with_uniforms(self, state, batch, u, generator=None):
        """One step with the pseudo-labels' uniforms `u` ``[B, L]``;
        `generator` goes to the ranker's dropout."""
        return self._step(state, batch, u, generator=generator)

    def train_step(self, state, batch, generator=None):
        shard = self.per_shard(generator)
        shape = self.train_slice(batch)["labels"].shape
        u = torch.rand(shape, generator=shard, device=self.device)
        return self.step_with_uniforms(state, batch, u, shard)
