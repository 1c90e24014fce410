"""Training cells: DLA in windows of ``window_steps`` steps through
``Experiment.train_steps_device`` (on the card each window length one
captured CUDA graph, replayed), on the configuration's data made from the
seed, with the kernel hparams on or off as the traffic says.

Set-up builds the ``Experiment`` and loads the seed's weights into it,
then drives it through three one-step windows, whose losses, first
gradient (from Adagrad's accumulators) and change the check compares,
and through its first full window, which captures that window's graph
and whose mean loss the check also compares. The same object then runs
windows for the measured seconds one at a time, each replay followed by
a synchronise, and the rate is taken over every window and the whole
time. After it the plain reference shadows the program's steps from the
same inputs (``yardstick/dla.py``)."""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.drivers.common import KERNELS, profile_span, read_metrics
from perfbench.yardstick import compare, dla, inputs, keys, trees, weights

PROPENSITY_TAG = 0x9B0B


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _hparams(pairs: Dict) -> str:
    def text(v):
        return "[" + ",".join(map(str, v)) + "]" if isinstance(v, list) \
            else str(v).lower() if isinstance(v, bool) else str(v)
    return ",".join(f"{k}={text(v)}" for k, v in pairs.items())


def settings(cell, click_json: str) -> Dict:
    """The experiment settings of the cell: the configuration's ranker,
    DLA and click feed, with the traffic's kernel hparams."""
    cfg, kernels = cell.config, cell.traffic["kernels"]
    ranker = _hparams(cfg["ranker_hparams"])
    if kernels and cfg["kernel_hparams"]:
        ranker += "," + cfg["kernel_hparams"]
    algo = dict(cfg["algorithm_hparams"])
    if kernels:
        algo["loss_func"] = "fused_softmax_loss"
    return {
        "ranking_model": cfg["ranker"], "ranking_model_hparams": ranker,
        "learning_algorithm": cfg["algorithm"],
        "learning_algorithm_hparams": _hparams(algo),
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": f"click_model_json={click_json}"
                               + (",use_pallas_click=true" if kernels
                                  else ""),
        "metrics": ["ndcg"], "metrics_topn": [10],
        "max_candidate_num": cfg["list_length"],
        "selection_bias_cutoff": cfg["selection_bias_cutoff"],
    }


@dataclasses.dataclass
class Setup:
    exp: object
    table: np.ndarray        # the features, on the host
    grades: torch.Tensor     # on the device
    ranker: Dict             # the initial weights, on the device
    propensity: Dict
    tmp: tempfile.TemporaryDirectory


def build(cell, seed: int, device) -> Setup:
    """The ``Experiment`` on the seed's data, holding the seed's weights."""
    from ultra_pytorch_tpu_torch.algorithms import dla as port_dla
    from ultra_pytorch_tpu_torch.data.dataset import RankingDataset
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
    cutoff = cfg["selection_bias_cutoff"]
    ranker = weights.make(cell.reference.param_shapes(cfg), seed, device)
    prop = weights.make({"w": ("uniform", (cutoff,), cutoff),
                         "b": ("uniform", (), cutoff)},
                        seed ^ PROPENSITY_TAG, device)
    tmp = tempfile.TemporaryDirectory(prefix="perfbench_train_")
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
    to_host = lambda t: t.cpu().numpy()  # noqa: E731
    port_dla.params_from_jax(exp.state, trees.map_tree(to_host, ranker),
                             trees.map_tree(to_host, prop))
    sizes = [t.numel() for t, _ in exp.algorithm.ranker.jax_leaves()]
    if sizes != [t.numel() for _, t in trees.flatten(ranker)]:
        raise RuntimeError("the ranker's leaves are not the reference's")
    return Setup(exp, host, grades, ranker, prop, tmp)


def _state(exp, shapes: List[tuple]):
    """The program's state on the host: every leaf (the ranker's in tree
    order, then the tower's b and w) and both towers' Adagrad
    accumulators cut into the same leaves."""
    from ultra_pytorch_tpu_torch.models.base import params_to_jax

    state = exp.state
    prop = state.aux["propensity"]
    leaves = ([leaf for _, leaf in trees.flatten(params_to_jax(
        exp.algorithm.ranker))]
        + [prop["b"].detach().cpu().numpy().copy(),
           prop["w"].detach().cpu().numpy().copy()])
    flat = torch.cat([state.opt_state["sum_of_squares"],
                      state.aux["prop_opt_state"]["sum_of_squares"]]
                     ).cpu().numpy()
    ends = np.cumsum([int(np.prod(s)) for s in shapes])
    accs = [flat[e - int(np.prod(s)):e].reshape(s)
            for s, e in zip(shapes, ends)]
    return leaves, accs


def check_steps(setup: Setup, window_steps: int) -> Dict:
    """Three one-step windows and the first full window through the
    program: what the check compares and the states it reached, read on
    the host (set-up)."""
    exp = setup.exp
    start = [t.detach().cpu().numpy() for _, t in trees.flatten(
        setup.ranker)] + [setup.propensity["b"].cpu().numpy(),
                          setup.propensity["w"].cpu().numpy()]
    shapes = [a.shape for a in start]
    losses, states = [], []
    for _ in range(dla.CHECK_STEPS):
        names, means = exp.train_steps_device(1)
        losses.append(float(means[names.index("loss")]))
        states.append(_state(exp, shapes))
    grad_norms = [float(np.sqrt(a.astype(np.float64).sum()))
                  for a in states[0][1]]
    change = [float(np.linalg.norm((now.astype(np.float64)
                                    - was.astype(np.float64)).ravel()))
              for now, was in zip(states[-1][0], start)]
    names, means = exp.train_steps_device(window_steps)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "states": states,
            "window_loss": float(means[names.index("loss")])}


def reference(cell, seed: int, setup: Setup, device,
              fault: Optional[str] = None, shadow=None,
              dtype: torch.dtype = torch.float32) -> Dict:
    """The plain DLA run over the same inputs, shadowing the states of
    `shadow` where given, its features and weights in `dtype` (the
    matmuls' precision is the caller's to set)."""
    cfg = cell.config
    table = torch.from_numpy(setup.table).to(device, dtype)
    cast = lambda t: t.to(dtype)  # noqa: E731
    forward = lambda p, x, m: cell.reference.forward(cfg, p, x, m)  # noqa
    return dla.follow(cfg, table, setup.grades,
                      trees.map_tree(cast, setup.ranker),
                      trees.map_tree(cast, setup.propensity), forward,
                      keys.window_seeds(seed, dla.CHECK_STEPS + 1),
                      cell.traffic["window_steps"],
                      philox_clicks=cell.traffic["kernels"], fault=fault,
                      shadow=shadow)


def _launches() -> List[int]:
    from ultra_pytorch_tpu_torch.run.window import read_launches

    return read_launches()


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
    start = time.perf_counter()
    setup_s = start - t0
    while time.perf_counter() - start < seconds:
        t = time.perf_counter()
        names, m = exp.train_steps_device(steps_a_window)
        spans.append(time.perf_counter() - t)
        means.append(m)
        _sync(device)
    elapsed = time.perf_counter() - start
    losses = torch.stack(means)[:, names.index("loss")].cpu()
    failed = int((~torch.isfinite(losses)).sum())
    windows = len(means)
    traced, launches = None, None
    if trace and cuda:
        before = _launches()
        traced = profile_span(lambda: [
            exp.train_steps_device(steps_a_window)
            for _ in range(traffic["profiled_windows"])])
        launches = dict(zip(KERNELS, (a - b for a, b in
                                      zip(_launches(), before))))
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    per_layer = {}
    if trace:
        gather = exp.device_data["train"].gather(
            torch.arange(cfg["batch_size"], device=exp.device),
            list_size=cfg["selection_bias_cutoff"])
        ctx = SimpleNamespace(
            cell=cell, cfg=cfg, work=cell.work, trace=traced,
            steps=windows * steps_a_window, seconds=elapsed,
            host_spans=spans, ranker=exp.algorithm.ranker,
            sample=gather["features"], launches=launches)
        per_layer = read_metrics(cell, ctx)
    del exp, setup.exp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    gaps = compare.training_gaps(program, reference(
        cell, seed, setup, device, shadow=program["states"]))
    setup.tmp.cleanup()
    return {
        "correct": failed == 0 and compare.judge(gaps, cell.limits),
        "attempted": windows, "failed": failed,
        "end_to_end": {"train_qps": windows * steps_a_window
                       * cfg["batch_size"] / elapsed, "setup_s": setup_s},
        "per_layer": per_layer, "memory_peak_bytes": memory_peak,
        "trace": traced, "gaps": gaps,
        "notes": {"windows": windows, "launches_traced": launches,
                  "records_traced": traced and traced["kernel_records"]},
    }
