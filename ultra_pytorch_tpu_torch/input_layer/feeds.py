"""Input feeds: batch builders over a :class:`DeviceDataset`.

The port's counterpart of the JAX package's ``input_layer/feeds.py``:
``DirectLabelFeed``, ``ClickSimulationFeed`` and the two online feeds.
Every draw comes from an explicit ``torch.Generator`` on the dataset's
device. Batch layout: ``{"features": [B, L, F], "labels": [B, L],
"mask": [B, L], "initial_scores": [B, L]}``; for click feeds ``labels``
are sampled clicks.

Rejection resampling keeps the JAX semantics: ``compact`` draws one
overdrawn candidate pool and keeps the first B clicked lists (a stable
sort on validity), its size auto-sized from a click rate measured once at
feed init; ``rounds`` draws 1 + 8 candidates per slot and keeps each
slot's first clicked one. Slots left without a clicked list are masked
out of the loss. The window plan draws a whole window's queries and
clicks in one batched pass, written out as a leading batch dimension, so
K5 (``use_pallas_click=true`` with PBM) runs once per window; with UBM or
cascade the flag changes nothing, as in the JAX feed, whose kernel
branch is PBM's alone. The plan reads
nothing back to the host, so a window can be captured as a CUDA graph:
its start step may be a device scalar, and the pool size is fixed when the
feed is built.

The online feeds cannot plan: they score with the current ranker, which
changes every step. Their ``train_batch(generator, state, step)`` draws,
in this order, the B queries, the Plackett-Luce uniforms (stochastic feed
only) and the click uniforms of all 1 + 16 resample rounds in one
``torch.rand``; each list keeps its first round with a click (the JAX
feed's 16-round scan keeps the same one). They sample clicks with the
click model's sampler, never with K5, as the JAX online feed does. The
click model's eta is that of `step`, which a captured window passes as a
0-dim int64 tensor on the device (its start plus the step's index), so a
replay reads the step it runs, as the JAX feed reads the traced
``state.step``.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ultra_pytorch_tpu_torch.data.dataset import DeviceDataset
from ultra_pytorch_tpu_torch.ops.kernels import click_sim
from ultra_pytorch_tpu_torch.sim import click_models as cm
from ultra_pytorch_tpu_torch.sim.sampling import (
    deterministic_rank, plackett_luce_sample, rerank)
from ultra_pytorch_tpu_torch.utils.hparams import HParams
from ultra_pytorch_tpu_torch.utils.registry import register

Batch = Dict[str, torch.Tensor]
# (query indices [n, B], clicks [n, B, L], valid [n, B]) for n steps.
Plan = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

CLICK_RATE_SEED = 0x5EED


def _randint(generator: torch.Generator, high: int, shape) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=generator,
                         device=generator.device)


class BaseInputFeed:
    """Shared feed plumbing."""

    def __init__(self, algorithm, batch_size: int, hparam_str: str,
                 dataset: DeviceDataset, list_size: Optional[int] = None,
                 world_size: int = 1):
        """`batch_size` is the global batch B; with `world_size` N ranks
        each rank's training draws take B / N queries (``batch_size``),
        while ``eval_batches`` still walks the split B queries at a
        time."""
        if batch_size % world_size:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"{world_size} data-parallel ranks")
        self.algorithm = algorithm
        self.batch_size = batch_size // world_size
        self.eval_batch_size = batch_size
        self.dataset = dataset
        self.list_size = list_size or dataset.list_size
        self.rank_list_size = getattr(
            algorithm, "rank_list_size", self.list_size)
        self.hparams = HParams(**self.default_hparams())
        self.hparams.parse(hparam_str or "")

    def default_hparams(self) -> Dict[str, Any]:
        return {}

    def can_plan(self) -> bool:
        """Whether this feed draws a window in one pass
        (:meth:`train_batch_plan`) or a batch a step (:meth:`train_batch`,
        given the current state)."""
        return (type(self).train_batch_plan
                is not BaseInputFeed.train_batch_plan)

    def train_batch(self, generator: torch.Generator, state,
                    step=None) -> Batch:
        """One training batch for the current `state` at `step` (an int or
        a 0-dim int64 tensor on the dataset's device; ``state.step`` when
        None)."""
        raise NotImplementedError

    def train_batch_plan(self, generator: torch.Generator, step,
                         n: int) -> Any:
        """n steps' draws (from `step` on, an int or a 0-dim int64 tensor
        on the dataset's device) in one batched pass."""
        raise NotImplementedError

    def batch_from_plan(self, plan, i: int) -> Batch:
        raise NotImplementedError

    def eval_batches(self) -> Iterator[Tuple[Batch, int, int]]:
        """Sequential batches over the whole dataset; yields (batch,
        start index, count)."""
        q = self.dataset.num_queries
        for start in range(0, q, self.eval_batch_size):
            count = min(self.eval_batch_size, q - start)
            qs = torch.arange(start, start + count, device=self.dataset.device)
            yield self.dataset.gather(qs), start, count


@register("feed", "DirectLabelFeed",
          aliases=["ultra.input_layer.DirectLabelFeed"])
class DirectLabelFeed(BaseInputFeed):
    """Feed true relevance labels."""

    def default_hparams(self):
        return {"use_max_candidate_num": True}

    def train_batch_plan(self, generator, step, n):
        return _randint(generator, self.dataset.num_queries,
                        (n, self.batch_size))

    def batch_from_plan(self, plan, i):
        return self.dataset.gather(plan[i])


class _ClickFeedMixin:
    """Click-model plumbing shared by the simulation feeds: the model from
    ``click_model_json`` (none in oracle mode) and the dynamic bias
    schedule."""

    def _load_click_model(self) -> None:
        self.click_model = None
        if not self.hparams.oracle_mode:
            path = self.hparams.click_model_json
            if not os.path.isfile(path):
                raise FileNotFoundError(f"click model json not found: {path}")
            self.click_model = cm.load_model_from_file(path).to(
                self.dataset.device)

    def _eta_at_steps(self, steps: torch.Tensor) -> torch.Tensor:
        """The dynamic bias schedule: every `dynamic_bias_step_interval`
        steps eta grows by `dynamic_bias_eta_change`. One eta per step."""
        base = self.click_model.eta
        change = float(self.hparams.get("dynamic_bias_eta_change", 0.0))
        interval = int(self.hparams.get("dynamic_bias_step_interval", 1000))
        return base + torch.div(steps, interval,
                                rounding_mode="floor").float() * change


@register("feed", "ClickSimulationFeed",
          aliases=["ultra.input_layer.ClickSimulationFeed"])
class ClickSimulationFeed(BaseInputFeed, _ClickFeedMixin):
    """Offline click simulation on the fixed initial ranking."""

    RESAMPLE_ROUNDS = 8  # query redraw rounds for resample_strategy=rounds

    def default_hparams(self):
        return {
            "click_model_json": "./example/ClickModel/pbm_0.1_1.0_4_1.0.json",
            "oracle_mode": False,
            "dynamic_bias_eta_change": 0.0,
            "dynamic_bias_step_interval": 1000,
            # PBM clicks through K5 (ops/kernels/click_sim.py); another
            # click model samples with its own sampler, as in the JAX feed.
            "use_pallas_click": False,
            "resample_strategy": "compact",
            # Pool size multiple; 0 = auto-size from the click rate
            # measured at init (see _pool_size).
            "resample_overdraw": 0.0,
        }

    def __init__(self, *args, check_validation: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.check_validation = check_validation
        self._load_click_model()
        self._p_click_lo = self._estimate_click_rate()

    def _simulate_clicks(self, model, generator, qs: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Clicks for query indices `qs` ``[n, C]`` (with one eta per row
        of `qs` in `model`), without touching the feature table."""
        L = self.rank_list_size
        ds = self.dataset
        labels = ds.labels[qs][..., :L]
        mask = ds.mask[qs][..., :L]
        if self.hparams.oracle_mode:
            clicks = labels * mask
        elif (self.hparams.get("use_pallas_click")
              and model.model_name == cm.PBM):
            # K5 samples PBM only; UBM and cascade take their own sampler
            # below, as the JAX feed's kernel branch is PBM's alone.
            clicks = click_sim.sample_pbm_clicks(model, generator, labels,
                                                 mask)
        else:
            clicks, _, _ = cm.sample_clicks(model, generator, labels, mask)
        return clicks, clicks.sum(dim=-1) > 0

    def _estimate_click_rate(self) -> Optional[float]:
        """A 3-sigma-lowered estimate of the probability that a drawn list
        is clicked, to auto-size the compact pool; None when auto-sizing
        does not apply (oracle mode, explicit overdraw, dynamic bias)."""
        if (not self.check_validation or self.hparams.oracle_mode
                or self.hparams.resample_strategy != "compact"
                or float(self.hparams.resample_overdraw) > 0
                or float(self.hparams.dynamic_bias_eta_change)):
            return None
        n = min(4096, self.dataset.num_queries)
        gen = torch.Generator(device=self.dataset.device).manual_seed(
            CLICK_RATE_SEED)
        qs = _randint(gen, self.dataset.num_queries, (1, n))
        _, valid = self._simulate_clicks(self.click_model, gen, qs)
        p = float(valid.float().mean())
        return max(p - 3.0 * math.sqrt(max(p * (1 - p), 1e-6) / n),
                   p / 2.0, 1e-3)

    def _pool_size(self, batch_size: int) -> int:
        """Compact candidate-pool size: the explicit overdraw multiple, or
        B + 4 sqrt(B) expected clicked candidates at the measured rate;
        within [B, 9B]."""
        explicit = float(self.hparams.get("resample_overdraw", 0.0))
        if explicit > 0:
            return int(min(max(round(batch_size * explicit), batch_size),
                           batch_size * 9))
        if self._p_click_lo is None:
            return batch_size * 9
        need = batch_size + 4.0 * math.sqrt(batch_size)
        return int(min(max(math.ceil(need / self._p_click_lo), batch_size),
                       batch_size * 9))

    # -- drawing ----------------------------------------------------------
    def train_batch_plan(self, generator: torch.Generator, step,
                         n: int) -> Plan:
        """n steps of (queries, clicks, valid) in one batched pass; `step`
        may be a device scalar (a captured window's start), so nothing here
        reads it on the host."""
        ds = self.dataset
        Q, B = ds.num_queries, self.batch_size
        model = None
        if self.click_model is not None:
            steps = step + torch.arange(n, device=ds.device)
            model = self.click_model.replace(eta=self._eta_at_steps(steps))
        if not (self.check_validation and not self.hparams.oracle_mode):
            qs = _randint(generator, Q, (n, B))
            clicks, valid = self._simulate_clicks(model, generator, qs)
            return qs, clicks, valid
        if self.hparams.resample_strategy == "compact":
            qs_all = _randint(generator, Q, (n, self._pool_size(B)))
            clicks_all, valid_all = self._simulate_clicks(model, generator,
                                                          qs_all)
            pick = torch.argsort((~valid_all).to(torch.int8), dim=1,
                                 stable=True)[:, :B]
            return (torch.gather(qs_all, 1, pick),
                    clicks_all[torch.arange(n, device=ds.device)[:, None],
                               pick],
                    torch.gather(valid_all, 1, pick))
        R = 1 + self.RESAMPLE_ROUNDS
        qs_all = _randint(generator, Q, (n, R * B))
        clicks_all, valid_all = self._simulate_clicks(model, generator,
                                                      qs_all)
        clicks_all = clicks_all.view(n, R, B, -1)
        valid_all = valid_all.view(n, R, B)
        first = torch.argmax(valid_all.to(torch.int8), dim=1)  # 0 if none
        rows = torch.arange(n, device=ds.device)[:, None]
        cols = torch.arange(B, device=ds.device)[None, :]
        return (qs_all.view(n, R, B)[rows, first, cols],
                clicks_all[rows, first, cols], valid_all.any(dim=1))

    def batch_from_plan(self, plan: Plan, i: int) -> Batch:
        qs, clicks, valid = plan
        batch = self.dataset.gather(qs[i], list_size=self.rank_list_size)
        batch["labels"] = clicks[i]
        if self.check_validation and not self.hparams.oracle_mode:
            # Lists that never clicked are masked out of the loss.
            batch["mask"] = batch["mask"] * valid[i][:, None]
        return batch


class _OnlineSimulationFeed(BaseInputFeed, _ClickFeedMixin):
    """Online simulation: rank every candidate with the current ranker,
    then simulate clicks on the top ``rank_list_size`` of that ranking."""

    CLICK_RESAMPLE_ROUNDS = 16  # click redraws on the fixed ranking

    def default_hparams(self):
        return {
            "click_model_json": "./example/ClickModel/pbm_0.1_1.0_4_1.0.json",
            "oracle_mode": False,
            "dynamic_bias_eta_change": 0.0,
            "dynamic_bias_step_interval": 1000,
            "tau": 1.0,  # the stochastic feed's Plackett-Luce temperature
        }

    def __init__(self, *args, check_validation: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.check_validation = check_validation
        self._load_click_model()

    def _rank(self, generator: torch.Generator, scores: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _resampling(self) -> bool:
        return self.check_validation and not self.hparams.oracle_mode

    def train_batch(self, generator: torch.Generator, state,
                    step=None) -> Batch:
        ds = self.dataset
        qs = _randint(generator, ds.num_queries, (self.batch_size,))
        batch = ds.gather(qs)
        scores = self.algorithm.score(state, batch)       # eval mode: K1
        ranking = self._rank(generator, scores, batch["mask"])
        u = None
        if not self.hparams.oracle_mode:
            rounds = 1 + (self.CLICK_RESAMPLE_ROUNDS
                          if self._resampling() else 0)
            L = min(self.rank_list_size, ranking.shape[1])
            u = torch.rand((rounds, self.batch_size, L), generator=generator,
                           device=ds.device)
        return self.online_batch(batch, ranking, u,
                                 state.step if step is None else step)

    def online_batch(self, batch: Batch, ranking: torch.Tensor,
                     u: Optional[torch.Tensor], step) -> Batch:
        """The batch of `ranking` ``[B, Lc]``: every tensor in ranked
        order, clicks on the top L from the uniforms ``u [rounds, B, L]``
        (none in oracle mode) with the click model at `step` (an int or a
        0-dim int64 tensor on the dataset's device), labels past L zeroed,
        lists that never clicked masked out, and the true labels in ranked
        order as ``relevance``."""
        feats = torch.gather(batch["features"], 1, ranking[:, :, None].expand(
            -1, -1, batch["features"].shape[-1]))
        labels = rerank(batch["labels"], ranking)
        mask = rerank(batch["mask"], ranking)
        L = min(self.rank_list_size, labels.shape[1])
        if self.hparams.oracle_mode:
            clicks = labels[:, :L] * mask[:, :L]
        else:
            model = self.click_model.replace(eta=self._eta_at_steps(
                torch.as_tensor(step, device=self.dataset.device)))
            clicks, valid = cm.resampled_clicks(model, labels[:, :L],
                                             mask[:, :L], u)
            if self._resampling():
                mask = mask * valid[:, None]
        return {
            "features": feats,
            "labels": torch.cat([clicks, torch.zeros_like(labels[:, L:])],
                                dim=1),
            "mask": mask,
            "initial_scores": rerank(batch["initial_scores"], ranking),
            "relevance": labels,
        }


@register("feed", "DeterministicOnlineSimulationFeed",
          aliases=["ultra.input_layer.DeterministicOnlineSimulationFeed"])
class DeterministicOnlineSimulationFeed(_OnlineSimulationFeed):
    """Rank by score, descending."""

    def _rank(self, generator, scores, mask):
        return deterministic_rank(scores, mask)


@register("feed", "StochasticOnlineSimulationFeed",
          aliases=["ultra.input_layer.StochasticOnlineSimulationFeed"])
class StochasticOnlineSimulationFeed(_OnlineSimulationFeed):
    """Rank by a Plackett-Luce draw at temperature ``tau``."""

    def _rank(self, generator, scores, mask):
        return plackett_luce_sample(generator, scores, mask,
                                    tau=float(self.hparams.tau))
