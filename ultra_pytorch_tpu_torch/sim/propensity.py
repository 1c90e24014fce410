"""Propensity estimators and their CLI.

The port's counterpart of the JAX package's ``sim/propensity.py``:

* :class:`BasicPropensityEstimator`: a fixed per-position IPW table from
  JSON (``{"IPW_list": [...], "click_model": {...}}``, the reference's
  schema, which either package reads and writes), applied to click
  patterns;
* :class:`RandomizedPropensityEstimator`: result randomization. Sessions
  of uniformly shuffled lists go through the click model in batches on
  the device, and ``IPW[x] = first_click / agg_click`` per position;
* :class:`OraclePropensityEstimator`: the click model's own examination
  probabilities (UBM's given the clicks before each position).

Every estimator has ``weights(clicks [B, L]) -> [B, L]`` on the clicks'
device, with the table kept there after the first call.

CLI, defaulting to the card (``--device cpu`` for the CPU)::

    python -m ultra_pytorch_tpu_torch.sim.propensity <click_model_json> \\
        <data_dir> <output_dir> [sessions] [--device cpu]

estimates from the train split and writes
``<output_dir>/randomized_<click model name>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from ultra_pytorch_tpu_torch.sim import click_models as cm
from ultra_pytorch_tpu_torch.sim.sampling import plackett_luce_sample, rerank
from ultra_pytorch_tpu_torch.utils.device import resolve_device

DEFAULT_SESSIONS = 10_000_000


class BasicPropensityEstimator:
    """Per-position inverse propensity weights from a JSON table."""

    def __init__(self, file_name: Optional[str] = None,
                 ipw_list: Optional[np.ndarray] = None):
        self.click_model = None
        self.IPW_list = None
        if file_name:
            self.load(file_name)
        elif ipw_list is not None:
            self.IPW_list = list(np.asarray(ipw_list, dtype=np.float64))

    @property
    def IPW_list(self):
        return self._ipw_list

    @IPW_list.setter
    def IPW_list(self, value) -> None:
        self._ipw_list = value
        self._table = None   # the device copy, made again on next use

    def load(self, file_name: str) -> None:
        with open(file_name) as fin:
            data = json.load(fin)
        self.IPW_list = data["IPW_list"]
        if "click_model" in data:
            self.click_model = cm.load_model_from_json(data["click_model"])

    def save(self, file_name: str) -> None:
        payload = {"IPW_list": list(map(float, self.IPW_list))}
        if self.click_model is not None:
            payload["click_model"] = cm.model_to_json(self.click_model)
        with open(file_name, "w") as fout:
            fout.write(json.dumps(payload, indent=4, sort_keys=True))

    def weights(self, clicks: torch.Tensor,
                use_non_clicked_data: bool = False) -> torch.Tensor:
        """``[B, L]`` clicks -> ``[B, L]`` propensity weights; positions
        beyond the table take its last entry; zero where nothing was
        clicked unless `use_non_clicked_data`."""
        if self._table is None or self._table.device != clicks.device:
            self._table = torch.tensor(self.IPW_list, dtype=torch.float32,
                                       device=clicks.device)
        table = self._table
        pos = torch.clamp(torch.arange(clicks.shape[1], device=clicks.device),
                          max=table.shape[0] - 1)
        pw = torch.broadcast_to(table[pos], clicks.shape)
        if not use_non_clicked_data:
            pw = pw * (clicks > 0)
        return pw


class RandomizedPropensityEstimator(BasicPropensityEstimator):
    """Result-randomization propensity estimation, batched on the
    device."""

    def estimate_from_model(self, click_model: cm.ClickModelParams,
                            labels: np.ndarray, mask: np.ndarray,
                            sessions: int = DEFAULT_SESSIONS,
                            batch: int = 1 << 17, seed: int = 0,
                            device=None) -> None:
        """Run `sessions` randomized sessions over (labels, mask) ``[Q,
        L]`` on `device` (default CUDA), in batches of `batch` sessions
        (the last batch may overshoot, as in the JAX package).

        A batch draws `batch` queries, shuffles each list uniformly
        (Plackett-Luce on flat scores), samples the click model's clicks
        (PBM, UBM or cascade), and adds the
        clicks into an ``[L, L]`` float64 count by list length
        (``index_add_``); the count is read back once at the end."""
        device = resolve_device(device)
        self.click_model = click_model
        model = click_model.to(device)
        labels_d = torch.as_tensor(np.asarray(labels, np.float32),
                                   device=device)
        mask_d = torch.as_tensor(np.asarray(mask, np.float32), device=device)
        Q, L = labels_d.shape
        gen = torch.Generator(device=device).manual_seed(seed)
        flat = torch.zeros((batch, L), device=device)
        counts = torch.zeros((L, L), dtype=torch.float64, device=device)
        done = 0
        while done < sessions:
            qs = torch.randint(0, Q, (batch,), generator=gen, device=device)
            lb, mk = labels_d[qs], mask_d[qs]
            perm = plackett_luce_sample(gen, flat, mk)   # a uniform shuffle
            clicks, _, _ = cm.sample_clicks(model, gen, rerank(lb, perm),
                                            rerank(mk, perm))
            # A list without documents has no clicks: row 0 takes its
            # zeros (the JAX package's index -1 wraps to row L - 1).
            rows = (mk.sum(dim=1).long() - 1).clamp_min_(0)
            counts.index_add_(0, rows, clicks.double())
            done += batch
        counts = counts.cpu().numpy()

        # first[x] = clicks at position 0 over lists longer than x;
        # agg[x] = clicks at position x over those lists; the reference's
        # 10e-6 epsilon and min() guard.
        first = np.array([counts[x:, 0].sum() for x in range(L)])
        agg = np.array([counts[x:, x].sum() for x in range(L)])
        self.IPW_list = [float(min(first[x] / (agg[x] + 10e-6), first[x]))
                         for x in range(L)]


class OraclePropensityEstimator(BasicPropensityEstimator):
    """True propensities straight from the click model."""

    def __init__(self, click_model: cm.ClickModelParams = None,
                 file_name: Optional[str] = None):
        super().__init__()
        self.click_model = click_model
        if file_name:
            self.load(file_name)

    def load(self, file_name: str) -> None:
        with open(file_name) as fin:
            data = json.load(fin)
        self.click_model = cm.load_model_from_json(data["click_model"])
        self.IPW_list = data.get("IPW_list")

    def weights(self, clicks: torch.Tensor,
                use_non_clicked_data: bool = False) -> torch.Tensor:
        if self.click_model.click_prob.device != clicks.device:
            self.click_model = self.click_model.to(clicks.device)
        return cm.propensity_weights(self.click_model, clicks,
                                     use_non_clicked_data)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Estimate a randomized propensity estimator from the "
                    "train split of an ULTRA-format dataset")
    p.add_argument("click_model_json")
    p.add_argument("data_dir")
    p.add_argument("output_dir")
    p.add_argument("sessions", type=int, nargs="?", default=DEFAULT_SESSIONS)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs on the CPU")
    return p.parse_args(argv)


def main(argv=None) -> str:
    from ultra_pytorch_tpu_torch.data.dataset import read_data

    args = parse_args(argv)
    device = resolve_device(args.device)
    train = read_data(args.data_dir, "train")
    click_model = cm.load_model_from_file(args.click_model_json)
    est = RandomizedPropensityEstimator()
    est.estimate_from_model(click_model, train.labels,
                            (train.initial_list >= 0).astype(np.float32),
                            sessions=args.sessions, device=device)
    name = os.path.basename(args.click_model_json)[: -len(".json")]
    out = os.path.join(args.output_dir, f"randomized_{name}.json")
    os.makedirs(args.output_dir, exist_ok=True)
    est.save(out)
    print(out)
    return out


if __name__ == "__main__":
    main()
