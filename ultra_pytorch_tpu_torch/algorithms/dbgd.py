"""Dueling Bandit Gradient Descent (DBGD), the online bandit.

The port's counterpart of the JAX package's ``algorithms/dbgd.py`` (Yue
and Joachims, ICML'09). A step:

* draws ``ranker_num`` unit noise directions over the ranker's linear
  weights (:func:`models.base.dbgd_noise_like`);
* scores the batch's whole candidate lists with the current ranker and
  with each candidate, ``params + learning_rate * noise`` (or a freshly
  initialised ranker plus the scaled noise under
  ``candidate_source=fresh``);
* decides the winners by team-draft multileaving of the rankers'
  rankings (Plackett-Luce at ``tau`` or by score, per
  ``interleave_strategy``) and clicks from the algorithm's own click
  model with 16 resample rounds, credit by click share; or, under
  ``need_interleave=false``, by each candidate's batch nDCG gain;
* updates with ``grad = sum_r win_share[r + 1] * noise_r`` through the
  flat ``sgd`` optimizer (clipped at ``max_gradient_norm``).

The reported loss is ``1 - nDCG`` of the current ranker on the batch's
labels. Every candidate scores through its own ``forward``: the
algorithm keeps one scratch copy of the ranker (never checkpointed) and
writes each candidate's weights into it, so a DNN with
``use_pallas=true`` scores every candidate with K1.

Spans (``utils/spans.py``): the step marks ``step.feed`` as it starts
(the online feed's batch lies between ``step.start`` and it),
``step.candidates`` once the current ranker and the candidates are
scored, and ``step.multileave`` once the credit is known;
``window_steps``' ``step.update`` closes the update. A captured window
stamps them at its last step alone. The rankers' passes over the whole
lists count in ``online.rankers_scored`` (1 + ``ranker_num`` a step).

Draws come from the step's generator in this order: the noises (one
``torch.randn`` a perturbed leaf), each fresh candidate's initialisation
(``fresh`` only), the rankings' Plackett-Luce uniforms (``Stochastic``
only), the drafting order, then the 1 + 16 rounds of click uniforms.
Under data parallelism the noises and fresh candidates come from the
replica generator, the same on every rank, and the rest from this rank's
shard generator (``per_shard``); the win shares, the win totals and the
online metrics are averaged over the ranks.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch

from ultra_pytorch_tpu_torch.algorithms.base import BaseAlgorithm, shown_ndcg
from ultra_pytorch_tpu_torch.metrics.ranking import (
    normalized_discounted_cumulative_gain)
from ultra_pytorch_tpu_torch.models import base as model_base
from ultra_pytorch_tpu_torch.sim import click_models as cm
from ultra_pytorch_tpu_torch.sim.interleave import (
    draft, infer_winners, round_assignments)
from ultra_pytorch_tpu_torch.sim.sampling import (
    deterministic_rank, plackett_luce_sample, rerank)
from ultra_pytorch_tpu_torch.utils import spans
from ultra_pytorch_tpu_torch.utils.checkpoint import tree_leaves
from ultra_pytorch_tpu_torch.utils.registry import register

NEG_INF = -1e9


def _ndcg_at(labels: torch.Tensor, scores: torch.Tensor,
             mask: torch.Tensor, n: int) -> torch.Tensor:
    """Batch nDCG@n of `scores` with padded documents last."""
    return normalized_discounted_cumulative_gain(
        labels, torch.where(mask > 0, scores, NEG_INF), None, [n])[0]


@register("algorithm", "DBGD", aliases=["ultra.learning_algorithm.DBGD"])
class DBGD(BaseAlgorithm):

    name = "dbgd"
    CLICK_RESAMPLE_ROUNDS = 16

    def default_hparams(self):
        return {
            "click_model_json": "./example/ClickModel/pbm_0.1_1.0_4_1.0.json",
            "learning_rate": 0.5,
            "max_gradient_norm": 5.0,
            "need_interleave": True,
            "interleave_strategy": "Stochastic",
            "grad_strategy": "sgd",
            "tau": 1.0,
            "ranker_num": 1,  # number of perturbed rankers
            # "perturb": current params + lr * noise (the DBGD and MGD
            # papers); "fresh": a freshly initialised ranker + lr * noise
            # (the reference's torch port).
            "candidate_source": "perturb",
        }

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.ranker_num = int(self.hparams.get("ranker_num", 1))
        self.click_model = None
        if self.hparams.need_interleave:
            self.click_model = cm.load_model_from_file(
                self.hparams.click_model_json).to(self.device)
        # The scratch ranker each candidate is written into.
        self.scratch = copy.deepcopy(self.ranker).requires_grad_(False)

    # -- a step, in parts -------------------------------------------------
    def sample_noises(self, state, generator: torch.Generator
                      ) -> List[torch.Tensor]:
        """``ranker_num`` noises: one tensor a ``jax_leaves()`` entry, in
        the ranker's layout, with a leading axis of ``ranker_num``."""
        return model_base.dbgd_noise_like(generator, state.params,
                                          self.ranker_num)

    @torch.no_grad()
    def candidate_scores(self, state, batch: Dict[str, torch.Tensor],
                         noises: List[torch.Tensor],
                         generator: Optional[torch.Generator] = None
                         ) -> List[torch.Tensor]:
        """Eval-mode scores ``[B, Lc]`` of the current ranker, then of
        each candidate."""
        scores = [self.score_with_params(state.params, batch,
                                         training=False)]
        fresh = self.hparams.get("candidate_source", "perturb") == "fresh"
        lr = float(self.hparams.learning_rate)
        cand = self.scratch
        for r in range(self.ranker_num):
            if fresh:
                cand.reset_parameters(generator)
            model_base.perturb_(cand, cand if fresh else state.params,
                                [n[r] for n in noises], lr)
            scores.append(self.score_with_params(cand, batch,
                                                 training=False))
        spans.count("online.rankers_scored", len(scores))
        return scores

    def interleave_winners(self, scores: List[torch.Tensor],
                           batch: Dict[str, torch.Tensor],
                           generator: torch.Generator
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      Optional[torch.Tensor]]:
        """(click share ``[B, R + 1]``, clicks ``[B, L]`` on the shown
        multileaved list, its online nDCG or None): each ranker's ranking,
        the multileave and the clicks, drawn from `generator`."""
        mask = batch["mask"]
        stacked = torch.stack(scores, dim=1)                  # [B, n, Lc]
        B, n, Lc = stacked.shape
        L = min(self.rank_list_size, Lc)
        flat = stacked.reshape(B * n, Lc)
        flat_mask = mask[:, None].expand(B, n, Lc).reshape(B * n, Lc)
        if self.hparams.interleave_strategy == "Stochastic":
            rankings = plackett_luce_sample(generator, flat, flat_mask,
                                            tau=float(self.hparams.tau))
        else:
            rankings = deterministic_rank(flat, flat_mask)
        multileaved, teams = draft(rankings.view(B, n, Lc),
                                   round_assignments(generator, B, n, L), L)
        u = torch.rand((1 + self.CLICK_RESAMPLE_ROUNDS, B, L),
                       generator=generator, device=mask.device)
        return self.draft_winners(multileaved, teams, batch, u, n)

    def draft_winners(self, multileaved: torch.Tensor, teams: torch.Tensor,
                      batch: Dict[str, torch.Tensor], u: torch.Tensor,
                      n_rankers: int):
        """:meth:`interleave_winners` given the draft ``[B, L]`` and the
        click uniforms ``u [1 + 16, B, L]``."""
        top_mask = rerank(batch["mask"], multileaved)
        clicks, _ = cm.resampled_clicks(
            self.click_model, rerank(batch["labels"], multileaved), top_mask,
            u)
        online_ndcg = None
        if "relevance" in batch:
            online_ndcg = shown_ndcg(rerank(batch["relevance"], multileaved),
                                     top_mask)
        return infer_winners(teams, clicks, n_rankers), clicks, online_ndcg

    def ndcg_winners(self, scores: List[torch.Tensor],
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Credit ``[R + 1]`` by batch nDCG gain over the current ranker:
        ``ceil`` of the difference, normalised to sum 1."""
        L = self.rank_list_size
        labels, mask = batch["labels"][:, :L], batch["mask"][:, :L]
        ndcgs = torch.stack([_ndcg_at(labels, s[:, :L], mask, L)
                             for s in scores])
        gains = torch.ceil(ndcgs - ndcgs[0])
        return gains / (torch.sum(gains) + 1e-9)

    def apply_noise_update(self, state, noises: List[torch.Tensor],
                           win_share: torch.Tensor):
        """One optimizer step on ``sum_r win_share[r + 1] * noise_r``, in
        place; advances the step."""
        w = win_share[1:]
        return self.apply_gradients(
            state, [torch.tensordot(w, n, dims=1) for n in noises])

    def ranking_loss(self, scores: torch.Tensor,
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The reported loss: ``1 - nDCG@L`` of `scores` ``[B, Lc]`` (the
        current ranker's) on the batch's labels."""
        L = self.rank_list_size
        return 1.0 - _ndcg_at(batch["labels"][:, :L], scores[:, :L],
                              batch["mask"][:, :L], L)

    def updated_aux(self, state, noises: List[torch.Tensor],
                    win_totals: torch.Tensor):
        """The aux state after a step (NSGD's memory); none here."""
        return state.aux

    @torch.no_grad()
    def update_aux_(self, state, noises: List[torch.Tensor],
                    win_totals: torch.Tensor) -> None:
        """:meth:`updated_aux` written into the state's aux tensors in
        place, so a captured window replays into them."""
        new = self.updated_aux(state, noises, win_totals)
        if new is not state.aux:
            torch._foreach_copy_(tree_leaves(state.aux), tree_leaves(new))

    def train_step(self, state, batch, generator=None):
        spans.mark("step.feed")
        noises = self.sample_noises(state, generator)
        scores = self.candidate_scores(state, batch, noises, generator)
        spans.mark("step.candidates")
        metrics = {}
        if self.hparams.need_interleave:
            winners, clicks, online_ndcg = self.interleave_winners(
                scores, batch, self.per_shard(generator))
            win_share, win_totals = winners.mean(dim=0), winners.sum(dim=0)
            online = [clicks.sum(dim=1).mean()] + (
                [] if online_ndcg is None else [online_ndcg])
            metrics.update(zip(("online_reward", "online_ndcg"),
                               self.sync(torch.stack(online)).unbind(0)))
        else:
            win_share = win_totals = self.ndcg_winners(scores, batch)
        spans.mark("step.multileave")
        # Averaged over the ranks: the noises are the same on every rank,
        # so the credit is the global batch's, and NSGD's losers (a zero
        # total) are the same everywhere.
        win_share, win_totals = self.sync(
            torch.stack([win_share, win_totals])).unbind(0)
        self.update_aux_(state, noises, win_totals)
        state = self.apply_noise_update(state, noises, win_share)
        metrics["loss"] = self.ranking_loss(scores[0], batch)
        return state, metrics
