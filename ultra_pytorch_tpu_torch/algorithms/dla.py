"""Dual Learning Algorithm (DLA): joint ranker and propensity estimation.

The port's counterpart of the JAX package's ``algorithms/dla.py``. One
train step computes

* the ranker's scores over the top-``selection_bias_cutoff`` list;
* the propensity logits ``elu(w + b)`` over ``[L]`` positions (the
  reference's one-hot Linear(L, 1) + ELU);
* stop-gradient IPW weights ``p_0 / p_i`` from the normalized
  propensities, clipped by ``max_propensity_weight``, and the symmetric
  relevance weights from the normalized ranker scores;
* ``loss = exam_loss + ranker_loss_weight * rank_loss``, with one
  optimizer and one clip per tower.

With ``loss_func=fused_softmax_loss`` both losses go through K3/K4; with
the DNN's ``use_pallas=true`` the ranker goes through K1/K2. The default
``grad_strategy=ada`` is persistent Adagrad; ``ada_reset`` reproduces
the reference's per-step optimizer re-creation.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ultra_pytorch_tpu_torch.algorithms.base import (
    BaseAlgorithm, TrainState, flat_gradient, make_optimizer)
from ultra_pytorch_tpu_torch.models import base
from ultra_pytorch_tpu_torch.utils.registry import register


def sigmoid_prob(logits: torch.Tensor) -> torch.Tensor:
    """sigmoid(logits - mean(logits))."""
    return torch.sigmoid(logits - logits.mean(dim=-1, keepdim=True))


@register("algorithm", "DLA", aliases=["ultra.learning_algorithm.DLA"])
class DLA(BaseAlgorithm):

    name = "dla"

    def default_hparams(self):
        return {
            "learning_rate": 0.05,
            "max_gradient_norm": 5.0,
            "loss_func": "softmax_loss",
            "logits_to_prob": "softmax",
            "propensity_learning_rate": -1.0,
            "ranker_loss_weight": 1.0,
            "l2_loss": 0.0,
            "max_propensity_weight": -1.0,
            "constant_propensity_initialization": False,
            "grad_strategy": "ada",
        }

    # -- propensity tower -------------------------------------------------
    @staticmethod
    def _prop_leaves(prop: Dict[str, torch.Tensor]):
        """The tower in JAX's leaf order (keys sorted: b, w)."""
        return [(prop["b"], False), (prop["w"], False)]

    def _propensity_logits(self, prop) -> torch.Tensor:
        return F.elu(prop["w"] + prop["b"])

    def _logits_to_prob(self, logits: torch.Tensor) -> torch.Tensor:
        if self.hparams.logits_to_prob == "sigmoid":
            return sigmoid_prob(logits)
        return torch.softmax(logits, dim=-1)

    def _normalized_weights(self, propensity: torch.Tensor) -> torch.Tensor:
        pw = propensity[:, 0:1] / propensity
        if self.hparams.max_propensity_weight > 0:
            pw = torch.clamp(pw, 0.0, self.hparams.max_propensity_weight)
        return pw

    # -- state ------------------------------------------------------------
    def _optimizers(self):
        lr = float(self.hparams.learning_rate)
        plr = float(self.hparams.propensity_learning_rate)
        plr = lr if plr < 0 else plr
        mgn = float(self.hparams.max_gradient_norm)
        gs = self.hparams.grad_strategy
        return make_optimizer(gs, lr, mgn), make_optimizer(gs, plr, mgn)

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Draw the ranker's weights and the tower from `generator` (a CPU
        generator; the tensors then move to the ranker's device)."""
        device = self.device
        self.ranker.reset_parameters(generator)
        L = self.rank_list_size
        if self.hparams.constant_propensity_initialization:
            w, b = torch.full((L,), 0.001), torch.zeros(())
        else:
            # one-hot(i) @ W + b == W[i, 0] + b; torch's default init.
            bound = 1.0 / float(np.sqrt(L))
            w = torch.empty(L).uniform_(-bound, bound, generator=generator)
            b = torch.empty(()).uniform_(-bound, bound, generator=generator)
        prop = {"w": w.to(device).requires_grad_(True),
                "b": b.to(device).requires_grad_(True)}
        opt_r, opt_p = self._optimizers()
        n_rank = sum(p.numel() for p in self.ranker.parameters())
        return TrainState(
            params=self.ranker,
            opt_state=opt_r.init(n_rank, device),
            aux={"propensity": prop,
                 "prop_opt_state": opt_p.init(L + 1, device)},
            step=0)

    # -- train ------------------------------------------------------------
    def trainable(self, state: TrainState) -> List[torch.Tensor]:
        """The ranker's tensors then the tower's, in JAX's leaf order."""
        return [t for t, _ in state.params.jax_leaves()
                + self._prop_leaves(state.aux["propensity"])]

    def losses(self, state: TrainState, batch: Dict[str, torch.Tensor], *,
               generator=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The step's (loss, rank_loss, exam_loss), differentiable in both
        towers."""
        batch = self.train_slice(batch)
        labels = batch["labels"]
        mask = batch.get("mask")
        scores = self.score_with_params(state.params, batch, generator)
        prop_logits = self._propensity_logits(
            state.aux["propensity"])[None, :].expand(labels.shape)
        pw = self._normalized_weights(
            self._logits_to_prob(prop_logits)).detach()
        rank_loss = self.loss_fn(scores, labels, pw, mask=mask)
        rw = self._normalized_weights(self._logits_to_prob(scores)).detach()
        exam_loss = self.loss_fn(prop_logits, labels, rw, mask=mask)
        rank_loss = rank_loss + self.l2_penalty(
            [t for t, _ in state.params.jax_leaves()])
        loss = exam_loss + self.hparams.ranker_loss_weight * rank_loss
        return loss, rank_loss, exam_loss

    def apply_gradients(self, state: TrainState,
                        grads: Sequence[torch.Tensor]) -> TrainState:
        """One optimizer step per tower (`grads` in :meth:`trainable`
        order; both towers' flat gradients averaged over the ranks in one
        collective, before each tower's clip), the towers and both
        optimizer states updated in place; advances the step."""
        opt_r, opt_p = self._optimizers()
        rank_leaves = state.params.jax_leaves()
        prop_leaves = self._prop_leaves(state.aux["propensity"])
        n = len(rank_leaves)
        g = self.sync(torch.cat([flat_gradient(grads[:n], rank_leaves),
                                 flat_gradient(grads[n:], prop_leaves)]))
        k = sum(t.numel() for t, _ in rank_leaves)
        opt_r.step(rank_leaves, g[:k], state.opt_state)
        opt_p.step(prop_leaves, g[k:], state.aux["prop_opt_state"])
        state.step += 1
        return state

    def metrics(self, out):
        loss, rank_loss, exam_loss = out
        return {"loss": loss.detach(), "rank_loss": rank_loss.detach(),
                "exam_loss": exam_loss.detach()}


def params_to_jax(state: TrainState) -> Dict[str, Any]:
    """Both towers as the JAX DLA's numpy trees:
    ``{"params": <ranker tree>, "propensity": {"w", "b"}}``."""
    prop = state.aux["propensity"]
    return {"params": base.params_to_jax(state.params),
            "propensity": {k: v.detach().cpu().numpy().copy()
                           for k, v in prop.items()}}


def params_from_jax(state: TrainState, params: Dict[str, Any],
                    propensity: Dict[str, Any]) -> TrainState:
    """Load the JAX DLA's ranker params and propensity tower into
    `state` (numpy or JAX arrays)."""
    base.params_from_jax(state.params, params)
    with torch.no_grad():
        for k, t in state.aux["propensity"].items():
            t.copy_(torch.as_tensor(np.array(propensity[k])))
    return state


def opt_state_to_jax(state: TrainState) -> Dict[str, Any]:
    """Both optimizer states as numpy: ``{"ranker": {...}, "propensity":
    {...}}``, each ``{"sum_of_squares": flat}`` for ``ada`` and ``{}``
    otherwise (JAX's ravel order)."""
    def arrs(d):
        return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}

    return {"ranker": arrs(state.opt_state),
            "propensity": arrs(state.aux["prop_opt_state"])}


def opt_state_from_jax(state: TrainState, opt_state: Dict[str, Any]
                       ) -> TrainState:
    """Load flat optimizer vectors (JAX's ravel order) into `state`."""
    with torch.no_grad():
        for mine, key in ((state.opt_state, "ranker"),
                          (state.aux["prop_opt_state"], "propensity")):
            for k, t in mine.items():
                t.copy_(torch.as_tensor(np.array(opt_state[key][k])))
    return state
