"""Online cells: an online learner of the DBGD family (MGD) in windows of
``window_steps`` steps through ``Experiment.train_steps_device`` (on the
card each window length one captured CUDA graph, replayed), fed by the
stochastic online feed, on the configuration's data made from the seed,
with the ranker's kernel hparams on or off as the traffic says.

Set-up builds the ``Experiment`` and loads the seed's weights into it,
then drives it through three one-step windows, whose states the check
compares, and through its first full window, which captures that
window's graph and whose mean loss the check also compares. The same
object then runs windows for the measured seconds one at a time, each
replay followed by a synchronise, and the rate is taken over every
window and the whole time. After it the plain reference shadows the
program's steps from the same inputs (``yardstick/mgd.py``), scoring
with the plain forward and deciding with the program's own scores: in
the three checked steps those the step produced, in the window a copy of
the port's ranker (K1 under ``no_grad`` where the kernels are on). The
sample the per-layer readers get is one batch of whole lists,
``[B, N, F]``."""

from __future__ import annotations

import copy
import gc
import json
import os
import tempfile
import time
from types import SimpleNamespace
from typing import Callable, Dict, List

import numpy as np
import torch

from perfbench.drivers.common import KERNELS, profile_span, read_metrics
from perfbench.drivers.train import Setup, _hparams, _launches, _sync
from perfbench.yardstick import compare, inputs, keys, mgd, trees, weights


def settings(cell, click_json: str) -> Dict:
    """The experiment settings of the cell: the configuration's ranker,
    learner and online feed, each click model from `click_json`, with the
    traffic's kernel hparams."""
    cfg = cell.config
    ranker = _hparams(cfg["ranker_hparams"])
    if cell.traffic["kernels"] and cfg["kernel_hparams"]:
        ranker += "," + cfg["kernel_hparams"]
    return {
        "ranking_model": cfg["ranker"], "ranking_model_hparams": ranker,
        "learning_algorithm": cfg["algorithm"],
        "learning_algorithm_hparams": _hparams(dict(
            cfg["algorithm_hparams"], click_model_json=click_json)),
        "train_input_feed": cfg["feed"],
        "train_input_hparams": _hparams(dict(cfg["feed_hparams"],
                                             click_model_json=click_json)),
        "metrics": ["ndcg"], "metrics_topn": [cfg["selection_bias_cutoff"]],
        "max_candidate_num": cfg["list_length"],
        "selection_bias_cutoff": cfg["selection_bias_cutoff"],
    }


def build(cell, seed: int, device) -> Setup:
    """The ``Experiment`` on the seed's data, holding the seed's weights."""
    from ultra_pytorch_tpu_torch.data.dataset import RankingDataset
    from ultra_pytorch_tpu_torch.models.base import params_from_jax
    from ultra_pytorch_tpu_torch.run.experiment import Experiment
    from perfbench.yardstick.clicks import click_model_json

    cfg = cell.config
    table, grades = inputs.training_data(cfg, seed, device)
    host = table.cpu().numpy()
    del table
    q, n = cfg["queries"], cfg["list_length"]
    data = RankingDataset(
        features=host, initial_list=np.arange(q * n).reshape(q, n),
        labels=grades.cpu().numpy(), qids=list(map(str, range(q))),
        dids=list(map(str, range(q * n))), feature_size=cfg["features"],
        rank_list_size=n, max_label=float(cfg["max_grade"]))
    ranker = weights.make(cell.reference.param_shapes(cfg), seed, device)
    tmp = tempfile.TemporaryDirectory(prefix="perfbench_online_")
    click_json = os.path.join(tmp.name, "click_model.json")
    with open(click_json, "w") as fout:
        json.dump(click_model_json(cfg), fout)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    exp = Experiment(settings(cell, click_json), tmp.name,
                     os.path.join(tmp.name, "model"),
                     batch_size=cfg["batch_size"], seed=seed, device=device)
    exp.setup(splits=("train",), datasets={"train": data})
    exp.init_state()
    params_from_jax(exp.algorithm.ranker, trees.map_tree(
        lambda t: t.cpu().numpy(), ranker))
    sizes = [t.numel() for t, _ in exp.algorithm.ranker.jax_leaves()]
    if sizes != [t.numel() for _, t in trees.flatten(ranker)]:
        raise RuntimeError("the ranker's leaves are not the reference's")
    return Setup(exp, host, grades, ranker, None, tmp)


def _leaves(ranker) -> List[torch.Tensor]:
    """The port ranker's leaves in the reference tree's order and layout
    (a Linear's weight ``[in, out]``), copied on its device."""
    return [(t.t() if transposed else t).detach().clone()
            for t, transposed in ranker.jax_leaves()]


def check_steps(setup: Setup, window_steps: int) -> Dict:
    """Three one-step windows and the first full window through the
    program: the leaves after each step, the scores each step produced
    (the feed's pass of the whole lists, then the current ranker's and
    each candidate's, copied inside the step, so on the card inside the
    one-step window's graph) and the window's mean loss (set-up). The
    full window is captured without the copies."""
    exp = setup.exp
    alg = exp.algorithm
    kind = type(alg)
    seen = {}

    def score(state, batch):                 # the online feed's pass
        out = kind.score(alg, state, batch)
        seen["feed"] = out.detach().clone()
        return out

    def candidate_scores(*args, **kwargs):
        out = kind.candidate_scores(alg, *args, **kwargs)
        seen["rankers"] = [s.detach().clone() for s in out]
        return out

    states, scores = [], []
    alg.score, alg.candidate_scores = score, candidate_scores
    try:
        for _ in range(mgd.CHECK_STEPS):
            exp.train_steps_device(1)
            states.append(_leaves(alg.ranker))
            scores.append([t.clone() for t in [seen["feed"]]
                           + seen["rankers"]])
    finally:
        del alg.score, alg.candidate_scores
    seen.clear()
    names, means = exp.train_steps_device(window_steps)
    return {"states": states, "scores": scores,
            "window_loss": float(means[names.index("loss")])}


def program_scoring(ranker) -> Callable:
    """The program's scores of a reference tree over features ``[B, N,
    F]``: a copy of the port's ranker (its kernel hparams and all)
    holding the tree's leaves, under ``no_grad`` as the step scores."""
    port = copy.deepcopy(ranker)
    targets = port.jax_leaves()

    @torch.no_grad()
    def score(tree, x):
        for (t, transposed), (_, leaf) in zip(targets, trees.flatten(tree)):
            t.copy_(leaf.t() if transposed else leaf)
        return port(x)

    return score


def reference(cell, seed: int, setup: Setup, device, *, fault=None,
              shadow=None, recorded=None, score_program=None,
              dtype: torch.dtype = torch.float32) -> Dict:
    """The plain MGD run over the same inputs (``yardstick/mgd.follow``),
    its features and weights in `dtype` (the matmuls' precision is the
    caller's to set)."""
    cfg = cell.config
    table = torch.from_numpy(setup.table).to(device, dtype)
    return mgd.follow(cfg, table, setup.grades, trees.map_tree(
        lambda t: t.to(dtype), setup.ranker), cell.reference.forward,
        cell.reference.noise, keys.window_seeds(seed, mgd.CHECK_STEPS + 1),
        cell.traffic["window_steps"], recorded=recorded,
        score_program=score_program, shadow=shadow, fault=fault)


def _counters() -> Dict[str, int]:
    from ultra_pytorch_tpu_torch.utils import spans

    return spans.snapshot()["counters"]


def run(cell, seed: int, seconds: float, trace: bool, device,
        t0: float) -> Dict:
    cfg, traffic = cell.config, cell.traffic
    steps_a_window = traffic["window_steps"]
    setup = build(cell, seed, device)
    exp = setup.exp
    program = check_steps(setup, steps_a_window)
    _sync(device)
    cuda = torch.device(device).type == "cuda"
    spans, means = [], []
    before = _counters()
    start = time.perf_counter()
    setup_s = start - t0
    while time.perf_counter() - start < seconds:
        t = time.perf_counter()
        names, m = exp.train_steps_device(steps_a_window)
        spans.append(time.perf_counter() - t)
        means.append(m)
        _sync(device)
    elapsed = time.perf_counter() - start
    counted = {k: n - before.get(k, 0) for k, n in _counters().items()}
    losses = torch.stack(means)[:, names.index("loss")].cpu()
    failed = int((~torch.isfinite(losses)).sum())
    windows = len(means)
    traced, launches = None, None
    if trace and cuda:
        launched = _launches()
        traced = profile_span(lambda: [
            exp.train_steps_device(steps_a_window)
            for _ in range(traffic["profiled_windows"])])
        launches = dict(zip(KERNELS, (a - b for a, b in
                                      zip(_launches(), launched))))
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    per_layer = {}
    if trace:
        sample = exp.device_data["train"].gather(
            torch.arange(cfg["batch_size"], device=exp.device)
            % cfg["queries"])
        ctx = SimpleNamespace(
            cell=cell, cfg=cfg, work=cell.work, trace=traced,
            steps=windows * steps_a_window, seconds=elapsed,
            host_spans=spans, ranker=exp.algorithm.ranker,
            sample=sample["features"], launches=launches, counters=counted)
        per_layer = read_metrics(cell, ctx)
    score_program = program_scoring(exp.algorithm.ranker)
    del exp, setup.exp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference(cell, seed, setup, device, shadow=program["states"],
                    recorded=program["scores"], score_program=score_program)
    gaps = mgd.gaps(program, ref)
    setup.tmp.cleanup()
    return {
        "correct": failed == 0 and compare.judge(gaps, cell.limits),
        "attempted": windows, "failed": failed,
        "end_to_end": {"train_qps": windows * steps_a_window
                       * cfg["batch_size"] / elapsed, "setup_s": setup_s},
        "per_layer": per_layer, "memory_peak_bytes": memory_peak,
        "trace": traced, "gaps": gaps,
        "notes": {"windows": windows, "launches_traced": launches,
                  "records_traced": traced and traced["kernel_records"],
                  "flipped_queries": gaps["flipped_queries"],
                  "passes_counted": {k: counted[k] for k in counted
                                     if k.startswith("online.")}},
    }
