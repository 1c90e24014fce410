"""Entry points: the flagship forward and the data-parallel dry run.

The port's counterpart of the JAX system's ``__graft_entry__.py``:

* :func:`entry` builds the flagship ranker (DLA's DNN at [512, 256, 128]
  over 136 features) and returns ``fn(ranker, features, mask) -> [B, L]``
  scores with its arguments, a batch of 8 synthetic queries of 10
  documents. The DNN runs with ``use_pallas=true``: on the card ``fn`` is
  one K1 launch.
* :func:`dryrun_multichip` runs the product's data-parallel path (the
  ``Experiment`` as a rank of a process group, what ``python -m
  ultra_pytorch_tpu_torch.run --dp N`` runs) over `n` ranks on tiny
  shapes for the JAX dry run's 18 cases, in its order and with its
  hparams (:func:`cases`): the eight offline algorithms under
  ``ClickSimulationFeed``; DBGD, MGD, NSGD and PDGD under the online
  feeds; DLA host-stacked and DLA with ``shard_data``; DLA + SetRank with
  dropout 0.1, DLA + DLCM and Naive + GSF; PDGD on the stochastic online
  feed over striped data. The host-stacked case is the coordinated
  launch's path (``ULTRA_COORDINATOR``, ``run/launch.py``): each process
  keeps its stripe of the train split, as the CLI sets it there.

The ranks are spawned once (``parallel.spawn_ranks``) and loop over the
cases. After each case every rank checks what the JAX dry run checks:
the state at step 2, a finite loss, and the state the same on every rank
(rank 0's bytes broadcast, ``parallel.same_on_every_rank``); rank 0
prints ``dryrun_multichip(n) ALGO/LABEL ok: loss=...``. The backend
follows the device (NCCL on the card, where every window is a captured
CUDA graph with its all-reduces inside; gloo on the CPU);
``--share_card N`` runs N gloo ranks on ``cuda:0``, as the tools'
flag of that name does (``run/launch.shared_card``).

Usage: python -m ultra_pytorch_tpu_torch.run.dryrun --ranks N
           [--device cpu] [--backend gloo] [--share_card N]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ESTIMATOR_JSON = os.path.join(ROOT, "example", "PropensityEstimator",
                              "randomized_pbm_0.1_1.0_4_1.0.json")
STEPS = 2          # steps a case, one window


def entry(device=None):
    """The flagship forward on `device` (default CUDA): ``(fn, (ranker,
    features, mask))`` with ``fn(ranker, features, mask) -> [8, 10]``
    scores, the ranker's weights drawn from seed 0."""
    from ultra_pytorch_tpu_torch.run.experiment import create_algorithm
    from ultra_pytorch_tpu_torch.tools.bench_common import (exp_settings,
                                                            synthetic)
    from ultra_pytorch_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    ds = synthetic(64, 0)
    settings = exp_settings()
    settings["ranking_model_hparams"] += ",use_pallas=true"
    alg = create_algorithm(settings, ds.feature_size, ds.max_label, device)
    alg.ranker.reset_parameters(torch.Generator().manual_seed(0))
    batch = ds.to_device(device).gather(torch.arange(8, device=device))

    def fn(ranker, features, mask):
        with torch.no_grad():
            return ranker(features, mask)

    return fn, (alg.ranker, batch["features"], batch["mask"])


def cases(est_hp: str, cm_hp: str) -> List[Tuple]:
    """The dry run's cases in the JAX dry run's order: (algorithm, train
    feed, algorithm hparams, host-stacked, shard_data, ranker, ranker
    hparams); `est_hp` and `cm_hp` are the estimator's and the click
    model's hparam strings."""
    offline = [(a, "ClickSimulationFeed",
                est_hp if a in ("IPWrank", "PRSrank") else "")
               for a in ("DLA", "RegressionEM", "IPWrank", "PairDebias",
                         "LambdaRank", "PRSrank", "NaiveAlgorithm",
                         "PDGD")]
    online = [
        ("DBGD", "DeterministicOnlineSimulationFeed", cm_hp),
        ("MGD", "StochasticOnlineSimulationFeed", cm_hp),
        ("NSGD", "StochasticOnlineSimulationFeed", cm_hp),
        ("PDGD", "StochasticOnlineSimulationFeed", ""),
    ]
    dnn = ("DNN", "hidden_layer_sizes=[16]")
    return ([(a, f, hp, False, False) + dnn for a, f, hp in offline + online]
            + [("DLA", "ClickSimulationFeed", "", True, False) + dnn,
               ("DLA", "ClickSimulationFeed", "", False, True) + dnn]
            + [("DLA", "ClickSimulationFeed", "", False, False, "SetRank",
                "d_model=16,num_heads=2,num_layers=1,diff=8,rate=0.1"),
               ("DLA", "ClickSimulationFeed", "", False, False, "DLCM",
                "embed_size=8,hidden_size=8"),
               ("NaiveAlgorithm", "ClickSimulationFeed", "", False, False,
                "GSF", "group_size=2,hidden_layer_sizes=[16]")]
            + [("PDGD", "StochasticOnlineSimulationFeed", "", False, True)
               + dnn])


def case_settings(case: Tuple, cm_hp: str) -> Dict:
    """A case's experiment settings (the JAX dry run's)."""
    algo, feed, algo_hparams, _, _, ranker, ranker_hp = case
    return {
        "train_input_feed": feed,
        "train_input_hparams": cm_hp,
        "valid_input_feed": "DirectLabelFeed",
        "valid_input_hparams": "",
        "ranking_model": ranker,
        "ranking_model_hparams": ranker_hp,
        "learning_algorithm": algo,
        "learning_algorithm_hparams": algo_hparams,
        "metrics": ["ndcg"],
        "metrics_topn": [5],
        "objective_metric": "ndcg_5",
        "selection_bias_cutoff": 5,
    }


def case_names(case: Tuple) -> Tuple[str, str]:
    """A case's directory tag and printed label (the JAX dry run's)."""
    algo, feed, _, host_stacked, shard_data, ranker, _ = case
    tag = algo + ("_hoststacked" if host_stacked else
                  "_sharddata" if shard_data else "_" + feed)
    label = feed + ("+host_stacked" if host_stacked else
                    "+shard_data" if shard_data else "")
    if ranker != "DNN":
        tag += "_" + ranker
        label += "+" + ranker
    return tag, label


def _rank_cases(rank: int, world: int, init_method: str, work: str,
                click_json: str, device: str, backend: Optional[str]
                ) -> List[Dict]:
    """Every case as rank `rank` of a `world`-rank group: per case its
    label, loss, step, whether the state equals rank 0's, whether its
    window ran as a CUDA graph, and the kernels' launches."""
    from ultra_pytorch_tpu_torch.parallel import (
        close_data_parallel, init_data_parallel, same_on_every_rank)
    from ultra_pytorch_tpu_torch.run.experiment import Experiment
    from ultra_pytorch_tpu_torch.run.launch import host_threads, rank_device
    from ultra_pytorch_tpu_torch.tools.bench_common import (
        launch_counts, launches_since)

    dev = rank_device(device, rank)
    torch.set_num_threads(host_threads(world))
    init_data_parallel(world, rank, dev, backend=backend,
                       init_method=init_method)
    cm_hp = f"click_model_json={click_json}"
    est_hp = (f"propensity_estimator_json={ESTIMATOR_JSON}"
              if os.path.isfile(ESTIMATOR_JSON) else "")
    out = []
    try:
        for case in cases(est_hp, cm_hp):
            algo, _, _, host_stacked, shard_data, _, _ = case
            tag, label = case_names(case)
            before = launch_counts()
            exp = Experiment(case_settings(case, cm_hp),
                             os.path.join(work, "data"),
                             os.path.join(work, "model_" + tag),
                             batch_size=2 * world, dp="auto",
                             shard_data=shard_data or (host_stacked
                                                       and world > 1),
                             device=dev)
            exp.setup()
            if not (exp.data_parallel and exp.world_size == world):
                raise RuntimeError(f"{algo}/{label}: not a rank of a "
                                   f"{world}-rank group")
            exp.init_state()
            loss = exp.train_steps(STEPS)["loss"]
            same = same_on_every_rank(
                exp.algorithm.state_leaves(exp.state), dev)
            if exp.state.step != STEPS:
                raise RuntimeError(f"{algo}/{label}: step {exp.state.step}")
            if not math.isfinite(loss):
                raise RuntimeError(f"{algo}/{label}: loss is {loss}")
            if not same:
                raise RuntimeError(f"{algo}/{label}: rank {rank}'s state "
                                   "differs from rank 0's")
            if rank == 0:
                print(f"dryrun_multichip({world}) {algo}/{label} ok: "
                      f"loss={loss:.4f}", flush=True)
            out.append({"algo": algo, "label": label, "loss": loss,
                        "step": exp.state.step, "same": same,
                        "graph": exp.eager_reason() is None,
                        "launches": launches_since(before)})
        return out
    finally:
        close_data_parallel()


def dryrun_multichip(n_ranks: int, device=None, backend: Optional[str] = None,
                     timeout: float = 900.0) -> List[List[Dict]]:
    """The 18 cases over `n_ranks` ranks on `device` (default CUDA: rank i
    on ``cuda:i``; ``cuda:0`` puts every rank there, which takes
    ``backend="gloo"``: ``run/launch.shared_card``). Raises on a case that fails; returns each rank's
    per-case results (see ``_rank_cases``)."""
    from ultra_pytorch_tpu_torch.parallel import spawn_ranks
    from ultra_pytorch_tpu_torch.tools.bench_common import (
        write_click_model, write_ultra_split)
    from ultra_pytorch_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(device))
    with tempfile.TemporaryDirectory(prefix="ultra_dryrun_") as work:
        data_dir = os.path.join(work, "data")
        queries = max(8, 2 * n_ranks)
        write_ultra_split(data_dir, "train", queries, seed=0, features=32)
        write_ultra_split(data_dir, "valid", queries, seed=1, features=32)
        with open(os.path.join(data_dir, "settings.json"), "w") as fout:
            json.dump({"feature_size": 32, "max_label": 2}, fout)
        return spawn_ranks(_rank_cases, n_ranks, (
            f"file://{os.path.join(work, 'rendezvous')}", work,
            write_click_model(work), device, backend), timeout=timeout)


def main(argv=None) -> List[List[Dict]]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=None,
                   help="default: the visible cards (1 on the CPU)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; without a card that "
                        "is an error, pass cpu to run there)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: NCCL on the card, gloo on the CPU")
    p.add_argument("--share_card", type=int, default=0,
                   help="N gloo ranks sharing cuda:0")
    args = p.parse_args(argv)
    from ultra_pytorch_tpu_torch.run.launch import shared_card
    from ultra_pytorch_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.share_card:
        return dryrun_multichip(*shared_card(args.share_card, device))
    ranks = args.ranks or (torch.cuda.device_count()
                           if device.type == "cuda" else 1)
    return dryrun_multichip(ranks, device, args.backend)


if __name__ == "__main__":
    main()
