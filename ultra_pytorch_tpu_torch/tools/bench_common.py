"""The bench protocol that the port's tools and ``chip_smoke.py`` share.

The port's counterpart of the JAX package's ``tools/bench_common.py``,
with its own copy of the synthetic data and settings that tool takes from
``__graft_entry__.py`` (:func:`synthetic`, :func:`exp_settings`): DLA with
the DNN at [512, 256, 128] (LayerNorm, ELU), F = 136 features, B = 256
queries a step of L = 10 documents, PBM clicks at eta 1.0 from a
click-model JSON written to a temporary directory, 4,096 synthetic
queries from a numpy seed.

One protocol, the JAX harness's own: :func:`make_bench_setup` (the
counterpart of its ``make_bench_setup``) builds :func:`exp_settings`
with the extras appended where the JAX harness appends them, so the
kernel hparams stay at their defaults (off) unless an extra turns one on,
and :func:`time_chunks` times it. Every tool's settings are these
(:func:`protocol_settings`), as its JAX counterpart's are, and the
training tools' ``--kernels`` appends :data:`KERNEL_EXTRAS` (the
``all_on`` row of ``bench_pallas.py``'s combinations: K1-K5) through
:func:`extras`. :func:`dla_settings` adds validation and test feeds and
nDCG and MRR at 3, 5 and 10: the JAX ``tools/bench_eval.py``'s settings,
which ``bench_eval`` and ``chip_smoke.py``'s phases build.

Also the card's name and power limit, the H100's peak rates and the
tools' shared argument and output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

FEATURES = 136                 # MSLR-WEB10K's feature count
HIDDEN = "hidden_layer_sizes=[512, 256, 128]"
BATCH, LIST = 256, 10          # the training batch: queries x documents
NUM_QUERIES = 4096             # synthetic train queries
PRNGS = ("threefry2x32", "rbg", "unsafe_rbg")   # the JAX tools' --prng
KERNELS = ("K1", "K2", "K3", "K4", "K5")
# The kernel hparams as the all_on row of bench_pallas.py's combinations
# writes them: (ranker extra, algorithm hparams, feed extra).
KERNEL_EXTRAS = (",use_pallas=true", "loss_func=fused_softmax_loss",
                 ",use_pallas_click=true")


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
    normal features, grades 0-2, a positive first document. The JAX
    system's ``_make_synthetic`` drawn in its order (features, then
    grades), so the arrays are JAX's for the same seed."""
    from ultra_pytorch_tpu_torch.data.dataset import RankingDataset

    rng = np.random.default_rng(seed)
    d = num_queries * length
    feats = rng.normal(size=(d, features)).astype(np.float32)
    labels = rng.integers(0, 3, size=(num_queries, length)).astype(
        np.float32)
    labels[:, 0] = np.maximum(labels[:, 0], 1.0)
    return RankingDataset(
        features=feats,
        initial_list=np.arange(d, dtype=np.int64).reshape(num_queries,
                                                          length),
        labels=labels, qids=[str(i) for i in range(num_queries)],
        dids=[f"d{i}" for i in range(d)], feature_size=features,
        rank_list_size=length, max_label=2.0)


def exp_settings(list_size: int = LIST, hidden: str = HIDDEN) -> Dict:
    """The JAX system's ``_exp_settings``: DLA with the DNN at
    [512, 256, 128] (or `hidden`), every hparam at its default, nDCG@10,
    lists and the cutoff at `list_size`."""
    return {
        "ranking_model": "DNN",
        "ranking_model_hparams": hidden,
        "learning_algorithm": "DLA",
        "learning_algorithm_hparams": "",
        "metrics": ["ndcg"],
        "metrics_topn": [10],
        "max_candidate_num": list_size,
        "selection_bias_cutoff": list_size,
    }


def extras(kernels: bool = False, ranker_extra: str = "") -> Dict[str, str]:
    """:func:`make_bench_setup`'s three extras: with `kernels`
    :data:`KERNEL_EXTRAS`, then `ranker_extra` appended to the ranker's."""
    ranker, algo, feed = KERNEL_EXTRAS if kernels else ("", "", "")
    return {"ranker_extra": ranker + ranker_extra, "algo_extra": algo,
            "feed_extra": feed}


def protocol_settings(click_json: str, list_size: int = LIST,
                      hidden: str = HIDDEN, ranker_extra: str = "",
                      algo_extra: str = "", feed_extra: str = "") -> Dict:
    """The JAX harness's settings: :func:`exp_settings` with
    `ranker_extra` appended to the ranker's hparams, `algo_extra` as the
    algorithm's and ``click_model_json=<click_json>`` + `feed_extra` as
    the ``ClickSimulationFeed``'s."""
    settings = exp_settings(list_size, hidden)
    settings["ranking_model_hparams"] += ranker_extra
    settings["learning_algorithm_hparams"] = algo_extra
    settings["train_input_feed"] = "ClickSimulationFeed"
    settings["train_input_hparams"] = (f"click_model_json={click_json}"
                                       + feed_extra)
    return settings


def dla_settings(kernels: bool, click_json: str, hidden: str = HIDDEN,
                 list_size: int = LIST) -> Dict:
    """:func:`protocol_settings` with :data:`KERNEL_EXTRAS` when
    `kernels`, direct-label validation and test feeds, and nDCG and MRR
    at 3, 5 and 10 (the objective nDCG@10): the JAX
    ``tools/bench_eval.py``'s settings at the cutoff `list_size`."""
    settings = protocol_settings(click_json, list_size, hidden,
                                 **extras(kernels))
    settings.update(
        valid_input_feed="DirectLabelFeed", valid_input_hparams="",
        test_input_feed="DirectLabelFeed", test_input_hparams="",
        metrics=["ndcg", "mrr"], metrics_topn=[3, 5, 10],
        objective_metric="ndcg_10")
    return settings


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


def experiment(settings_of, device, data: Dict, batch: int = BATCH,
               seed: int = 0, prng: str = "threefry2x32"):
    """An ``Experiment`` of ``settings_of(click_json)`` (the protocol's
    PBM click model written to a temporary directory, which the
    experiment holds) over the splits of `data`, its state initialised
    from `seed`; `prng` is the JAX trainer's ``--prng`` (the shape of the
    data key)."""
    from ultra_pytorch_tpu_torch.run.experiment import Experiment

    tmp = tempfile.TemporaryDirectory(prefix="ultra_bench_")
    settings = settings_of(write_click_model(tmp.name))
    exp = Experiment(settings, tmp.name, os.path.join(tmp.name, "model"),
                     batch_size=batch, seed=seed, device=device,
                     prng_impl=prng)
    exp._tmpdir = tmp   # the click-model JSON lives as long as `exp`
    exp.setup(splits=tuple(data), datasets=data)
    exp.init_state()
    return exp


def make_bench_setup(device, batch: int = BATCH, list_size: int = LIST,
                     features: int = FEATURES,
                     num_queries: int = NUM_QUERIES, ranker_extra: str = "",
                     algo_extra: str = "", feed_extra: str = "",
                     prng: str = "threefry2x32", hidden: str = HIDDEN):
    """An ``Experiment`` on the JAX bench protocol, the counterpart of the
    JAX harness's ``make_bench_setup``: :func:`protocol_settings` over
    :func:`synthetic` train queries (numpy seed 0), its state from seed 0
    (see :func:`experiment`). `hidden` replaces the ranker's widths."""
    data = {"train": synthetic(num_queries, 0, list_size, features)}
    return experiment(
        lambda click_json: protocol_settings(
            click_json, list_size, hidden, ranker_extra, algo_extra,
            feed_extra), device, data, batch, prng=prng)


def graph_pools(device) -> Optional[Dict[tuple, int]]:
    """Bytes that the caching allocator holds on `device` by private pool
    (a CUDA graph's pool: every segment outside the default pool), keyed
    by the pool's id; None off the card."""
    if torch.device(device).type != "cuda":
        return None
    pools: Dict[tuple, int] = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg["segment_pool_id"])
        if pool != (0, 0):
            pools[pool] = pools.get(pool, 0) + seg["total_size"]
    return pools


def new_pool_bytes(before: Optional[Dict[tuple, int]], device
                   ) -> Optional[int]:
    """The bytes of `device`'s graph pools that were not there `before`
    (a :func:`graph_pools`): the pools of the graphs captured since. A
    pool's id is never reused, so a pool released meanwhile (an earlier
    graph's, collected) does not count against them; None off the
    card."""
    if before is None:
        return None
    return sum(n for pool, n in graph_pools(device).items()
               if pool not in before)


def time_chunks(exp, steps: int, chunk: int, verbose: bool = True
                ) -> Dict:
    """The JAX harness's ``time_chunks`` on `exp`: one warm-up window of
    `chunk` steps (on the card also its CUDA graph's capture), then
    ``steps // chunk`` windows of `chunk` steps on the host clock, synced
    once at the end. Returns ``queries_per_s`` of the timed windows, and
    ``warmup_s`` (the warm-up window to its loss on the host),
    ``pool_bytes`` (the bytes of the warm-up window's graph pool; None
    off the card), the last window's mean ``loss``, and the ``windows`` and
    ``steps`` run, the warm-up's included."""
    pools = graph_pools(exp.device)
    t0 = time.perf_counter()
    keys, means = exp.train_steps_device(chunk)
    loss = float(means[keys.index("loss")])
    warmup_s = time.perf_counter() - t0
    pool = new_pool_bytes(pools, exp.device)
    if verbose:
        print(f"    (warm-up and capture {warmup_s:.1f}s, loss={loss:.4f})",
              flush=True)
    windows = steps // chunk
    t0 = time.perf_counter()
    for _ in range(windows):
        keys, means = exp.train_steps_device(chunk)
    sync(exp.device)
    seconds = time.perf_counter() - t0
    return {"queries_per_s": (windows * chunk * exp.feeds["train"].batch_size
                              / seconds),
            "warmup_s": warmup_s, "pool_bytes": pool,
            "loss": float(means[keys.index("loss")]),
            "windows": windows + 1, "steps": (windows + 1) * chunk}


def tool_parser(description: str, kernels: bool = False
                ) -> argparse.ArgumentParser:
    """An argument parser with the tools' ``--device`` and, with
    `kernels`, ``--kernels``."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; without a card "
                             "that is an error, pass cpu to run there)")
    if kernels:
        parser.add_argument("--kernels", action="store_true",
                            help="append bench_pallas.py's all_on extras "
                                 "(K1-K5); by default the kernel hparams "
                                 "are off, as in the JAX tool")
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
    """K1-K5's launch counts (the spans' registry), by kernel."""
    from ultra_pytorch_tpu_torch.run.window import read_launches

    return dict(zip(KERNELS, read_launches()))


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches of each kernel since the counts `before`."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in KERNELS}


def dla_launches(steps: int, windows: int, ranks: int = 1
                 ) -> Dict[str, int]:
    """A DLA run's launches with every kernel on and no validation: K1 =
    K2 = steps, K3 = K4 = 2 x steps, K5 = windows + 1 (the feed's
    click-rate estimate), on each rank."""
    return {"K1": ranks * steps, "K2": ranks * steps,
            "K3": 2 * ranks * steps, "K4": 2 * ranks * steps,
            "K5": ranks * (windows + 1)}


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
