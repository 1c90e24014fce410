"""The bench protocol that the port's tools and ``chip_smoke.py`` share.

The port's counterpart of the JAX package's ``tools/bench_common.py``,
with its own copy of the synthetic data and settings that tool takes from
``__graft_entry__.py``: DLA with the DNN at [512, 256, 128] (LayerNorm,
ELU), F = 136 features, B = 256 queries a step of L = 10 documents, PBM
clicks at eta 1.0 from a click-model JSON written to a temporary
directory, 4,096 synthetic queries from a numpy seed, and every kernel
hparam on (``use_pallas=true``, ``loss_func=fused_softmax_loss``,
``use_pallas_click=true``). Also the card's name and power limit, the
H100's peak rates and the tools' shared argument and output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

FEATURES = 136                 # MSLR-WEB10K's feature count
HIDDEN = "hidden_layer_sizes=[512, 256, 128]"
BATCH, LIST = 256, 10          # the training batch: queries x documents
NUM_QUERIES = 4096             # synthetic train queries
KERNELS = ("K1", "K2", "K3", "K4", "K5")


def _rate(var: str, default: float) -> float:
    return float(os.environ.get(var, default))


# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W), in operations or
# bytes a second; each can be overridden by its variable (TFLOP/s, GB/s).
PEAK_F32 = _rate("ULTRA_PEAK_F32_TFLOPS", 67) * 1e12
PEAK_TF32 = _rate("ULTRA_PEAK_TF32_TFLOPS", 495) * 1e12
PEAK_3XTF32 = PEAK_TF32 / 3   # float32 products as three TF32 ones
PEAK_BF16 = _rate("ULTRA_PEAK_BF16_TFLOPS", 989) * 1e12
PEAK_BYTES = _rate("ULTRA_PEAK_HBM_GBS", 3350) * 1e9


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def synthetic(num_queries: int, seed: int, length: int = LIST,
              features: int = FEATURES):
    """The bench protocol's synthetic data: `length` documents a query,
    normal features, grades 0-2, a positive first document."""
    from ultra_pytorch_tpu_torch.data.dataset import RankingDataset

    rng = np.random.default_rng(seed)
    d = num_queries * length
    labels = rng.integers(0, 3, size=(num_queries, length)).astype(
        np.float32)
    labels[:, 0] = np.maximum(labels[:, 0], 1.0)
    return RankingDataset(
        features=rng.normal(size=(d, features)).astype(np.float32),
        initial_list=np.arange(d, dtype=np.int64).reshape(num_queries,
                                                          length),
        labels=labels, qids=[str(i) for i in range(num_queries)],
        dids=[f"d{i}" for i in range(d)], feature_size=features,
        rank_list_size=length, max_label=2.0)


def dla_settings(kernels: bool, click_json: str, hidden: str = HIDDEN,
                 list_size: int = LIST) -> Dict:
    """The bench protocol's experiment settings, kernel hparams on or off."""
    on = "true" if kernels else "false"
    return {
        "train_input_feed": "ClickSimulationFeed",
        "train_input_hparams": f"click_model_json={click_json},"
                               f"use_pallas_click={on}",
        "valid_input_feed": "DirectLabelFeed", "valid_input_hparams": "",
        "test_input_feed": "DirectLabelFeed", "test_input_hparams": "",
        "ranking_model": "DNN",
        "ranking_model_hparams": f"{hidden},use_pallas={on}",
        "learning_algorithm": "DLA",
        "learning_algorithm_hparams":
            "loss_func=fused_softmax_loss" if kernels else "",
        "metrics": ["ndcg", "mrr"], "metrics_topn": [3, 5, 10],
        "objective_metric": "ndcg_10", "selection_bias_cutoff": list_size,
    }


def write_click_model(directory: str) -> str:
    """The protocol's PBM click model (eta 1.0) as a JSON file in
    `directory`; returns its path."""
    from ultra_pytorch_tpu_torch.sim.click_models import (
        click_model_json_numpy)

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "pbm_0.1_1.0_4_1.0.json")
    with open(path, "w") as fout:
        json.dump(click_model_json_numpy("pbm", 0.1, 1.0, 4, 1.0), fout)
    return path


def write_ultra_split(data_dir: str, split: str, num_queries: int,
                      seed: int, length: int = LIST,
                      features: int = FEATURES) -> None:
    """One split of the synthetic data in ULTRA format."""
    ds = synthetic(num_queries, seed, length, features)
    sub = os.path.join(data_dir, split)
    os.makedirs(sub, exist_ok=True)
    cols = np.arange(1, features + 1)
    with open(os.path.join(sub, f"{split}.feature"), "w") as fout:
        for did, row in zip(ds.dids, ds.features):
            fout.write(did + " " + " ".join(
                f"{i}:{v:.6g}" for i, v in zip(cols, row)) + "\n")
    with open(os.path.join(sub, f"{split}.init_list"), "w") as fout:
        for qid, docs in zip(ds.qids, ds.initial_list):
            fout.write(qid + " " + " ".join(map(str, docs)) + "\n")
    with open(os.path.join(sub, f"{split}.labels"), "w") as fout:
        for qid, labels in zip(ds.qids, ds.labels):
            fout.write(qid + " " + " ".join(f"{v:g}" for v in labels) + "\n")


def bench_experiment(device, batch: int = BATCH, list_size: int = LIST,
                     features: int = FEATURES, hidden: str = HIDDEN,
                     num_queries: int = NUM_QUERIES, valid_queries: int = 0,
                     kernels: bool = True, seed: int = 0,
                     data: Optional[Dict] = None):
    """An ``Experiment`` on the bench protocol, its state initialised from
    `seed`: synthetic train queries (numpy seed 0) and, with
    `valid_queries`, a valid split (seed 1), or the splits of `data`. The
    click-model JSON and the model directory live in a temporary
    directory held by the experiment."""
    from ultra_pytorch_tpu_torch.run.experiment import Experiment

    tmp = tempfile.TemporaryDirectory(prefix="ultra_bench_")
    settings = dla_settings(kernels, write_click_model(tmp.name), hidden,
                            list_size)
    if data is None:
        data = {"train": synthetic(num_queries, 0, list_size, features)}
        if valid_queries:
            data["valid"] = synthetic(valid_queries, 1, list_size,
                                      features)
    exp = Experiment(settings, tmp.name, os.path.join(tmp.name, "model"),
                     batch_size=batch, seed=seed, device=device)
    exp._tmpdir = tmp   # the JSON lives as long as the experiment
    exp.setup(splits=tuple(data), datasets=data)
    exp.init_state()
    return exp


def tool_parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with the tools' ``--device``."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; without a card "
                             "that is an error, pass cpu to run there)")
    return parser


def start(args) -> torch.device:
    """The tool's device (``resolve_device``); on the card, print its name
    and power limit first."""
    from ultra_pytorch_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    return device


def sync(device) -> None:
    """Wait for the device's work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts() -> Dict[str, int]:
    """K1-K5's launch counters, by kernel."""
    from ultra_pytorch_tpu_torch.run.window import read_launches

    return dict(zip(KERNELS, read_launches()))


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches of each kernel since the counts `before`."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in KERNELS}


def device_events(fn):
    """(name, device microseconds) of every kernel, copy and set that
    torch.profiler records on the card while `fn` runs; empty when the
    profiler records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]
