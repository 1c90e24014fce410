"""Inverse Propensity Weighting (IPW) rank.

The port's counterpart of the JAX package's ``algorithms/ipw.py``: a
pre-trained propensity estimator (the reference's JSON schema) turns the
click pattern into per-position weights, which weight the selected loss
(``fused_softmax_loss`` is K3/K4). The estimator class is the last
component of ``propensity_estimator_type``; an unknown one falls back to
the randomized estimator, as in the JAX package.
"""

from __future__ import annotations

from ultra_pytorch_tpu_torch.algorithms.base import BaseAlgorithm
from ultra_pytorch_tpu_torch.sim.propensity import (
    BasicPropensityEstimator, OraclePropensityEstimator,
    RandomizedPropensityEstimator)
from ultra_pytorch_tpu_torch.utils.registry import register

_ESTIMATORS = {
    "BasicPropensityEstimator": BasicPropensityEstimator,
    "RandomizedPropensityEstimator": RandomizedPropensityEstimator,
    "OraclePropensityEstimator": OraclePropensityEstimator,
}


def load_estimator(hparams):
    """The estimator named by ``propensity_estimator_type``, loaded from
    ``propensity_estimator_json``."""
    name = hparams.propensity_estimator_type.rsplit(".", 1)[-1]
    cls = _ESTIMATORS.get(name, RandomizedPropensityEstimator)
    return cls(file_name=hparams.propensity_estimator_json)


@register("algorithm", "IPWrank",
          aliases=["ultra.learning_algorithm.IPWrank"])
class IPWrank(BaseAlgorithm):

    name = "ipw_rank"

    def default_hparams(self):
        return {
            "propensity_estimator_type": "ultra.utils.propensity_estimator."
                                         "RandomizedPropensityEstimator",
            "propensity_estimator_json": "./example/PropensityEstimator/"
                                         "randomized_pbm_0.1_1.0_4_1.0.json",
            "learning_rate": 0.05,
            "max_gradient_norm": 5.0,
            "loss_func": "softmax_loss",
            "l2_loss": 0.0,
            "grad_strategy": "ada",
        }

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.propensity_estimator = load_estimator(self.hparams)

    def losses(self, state, batch, *, generator=None):
        batch = self.train_slice(batch)
        clicks, mask = batch["labels"], batch.get("mask")
        pw = self.propensity_estimator.weights(clicks)
        scores = self.score_with_params(state.params, batch, generator)
        loss = self.loss_fn(scores, clicks, pw, mask=mask)
        return (loss + self.l2_penalty(self.trainable(state)),)
