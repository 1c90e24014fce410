#!/usr/bin/env python3
"""Convergence of the port's trainer against the JAX package's, on
synthetic LETOR data whose labels can be learned.

The data (:func:`generate`, numpy only, from ``--seed``): one hidden linear
scorer for all three splits, 136 sparse features a document (10-24 of
them non-zero, as ``tools/make_toy_data.py`` writes them), lists of 10-30
documents (past the selection-bias cutoff of 10), grades 0-4 by
within-query quantile of the true score plus a little label noise, and
an initial list ordered by the true score plus Gaussian noise, so that
position bias correlates with relevance. ULTRA-format files and a libsvm
twin (``<split>/<split>.txt``).

The protocol (:data:`PROTOCOL`): each algorithm of :data:`ALGORITHMS`
trains from its ``configs/<name>.json`` with the DNN at
``[512, 256, 128]``, batch 256 and the PBM click model of
``example/ClickModel/pbm_0.1_1.0_4_1.0.json``, through the port's
``Experiment`` (on the card each window is a replayed CUDA graph and each
validation pass another); nDCG@10 on the valid split before training and
every 50 steps. A run's record: its curve, its peak (the best trained
point), its final value (the mean of the last 3 points) and its untrained
(step 0) value.

The check (:func:`band`): for each algorithm and for peak and final each,
``|mean_port - mean_jax| <= max(0.01, 4 sqrt(s_port^2 / n_port + s_jax^2 /
n_jax))``, and on both sides the trained peak exceeds the untrained value
by at least 0.05 on average. The JAX side's runs come from
``tests/torch_convergence_expected.json``, which
``torch_convergence_jax.py`` writes from the JAX package on the CPU.

Run from the root of a checkout (the card by default):

    python3 torch_convergence.py                       # the full protocol
    python3 torch_convergence.py --algorithms DLA,PDGD --seeds 2

It prints one line a run (its peak, final, untrained value and wall
time) and one line an algorithm (mean and standard deviation of peak and
final on both sides, the band and the verdict) and exits non-zero when
an algorithm falls outside its band or the generated files differ from
the fixture's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
EXPECTED = os.path.join(ROOT, "tests", "torch_convergence_expected.json")

# The generator's arguments (:func:`generate`), fixed before the study's
# first run on the card.
GENERATOR = {
    "seed": 2026,
    "train_queries": 2000,
    "valid_queries": 500,
    "test_queries": 0,
    "features": 136,
    "min_docs": 10,
    "max_docs": 30,
    "min_nnz": 10,
    "max_nnz": 24,
    "label_noise": 0.5,
    "init_noise": 3.0,
}
# The training protocol, shared by both sides.
PROTOCOL = {
    "hidden": [512, 256, 128],
    "batch": 256,
    "eval_every": 50,
    "seeds": 5,
    "click_model": "example/ClickModel/pbm_0.1_1.0_4_1.0.json",
    "selection_bias_cutoff": 10,
    "final_points": 3,
}
# Algorithm -> (its config under configs/, training steps).
ALGORITHMS = {
    "DLA": ("dla", 1000),
    "IPWrank": ("ipw_rank", 1000),
    "RegressionEM": ("regression_EM", 1000),
    "PairDebias": ("pairwise_debias", 1000),
    "NaiveAlgorithm": ("naive", 1000),
    "PDGD": ("pdgd", 600),
    "MGD": ("mgd", 600),
}
# The online feeds score the whole list and take no click-sampling kernel.
ONLINE = ("PDGD", "MGD")
# The algorithms whose loss may be the fused listwise softmax (K3/K4).
SOFTMAX = ("DLA", "IPWrank", "NaiveAlgorithm")
METRIC = "ndcg_10"
# The band's floor and its width in standard errors; the least gain of the
# trained peak over the untrained value.
BAND_FLOOR = 0.01
BAND_SIGMAS = 4.0
MIN_GAIN = 0.05
# Held to the band but not to MIN_GAIN: at configs/mgd.json's settings MGD
# does not learn in 600 steps in the JAX package either (its curve is a
# random walk about the untrained value, and a run with its update turned
# toward the winners draws nearly the same curve, so its winner credit is
# near uniform); its gain is printed all the same.
NO_GAIN = ("MGD",)
SPLITS = ("train", "valid", "test")
UNIT = 10 ** 6   # features and the hidden scorer in integer millionths


# -- data ----------------------------------------------------------------
def _split_arrays(rng, w, num_queries, features, min_docs, max_docs,
                  min_nnz, max_nnz, label_noise, init_noise):
    """One split's documents: features as integer millionths, graded
    labels and initial scores, with each query's document count. The true
    score is an integer product (exact in any order, so no BLAS can change
    a grade or a written digit) scaled once."""
    n_docs = rng.integers(min_docs, max_docs + 1, size=num_queries)
    total = int(n_docs.sum())
    nnz = rng.integers(min_nnz, max_nnz + 1, size=total)
    # Each document's non-zero features: the nnz smallest of F random keys.
    keys = rng.random((total, features))
    cut = np.sort(keys, axis=1)[np.arange(total), nnz - 1]
    values = rng.integers(-UNIT, UNIT + 1, size=(total, features))
    x = np.where(keys <= cut[:, None], values, 0)
    true = (x @ w) / float(UNIT) ** 2
    raw = true + label_noise * rng.standard_normal(total)
    initial = true + init_noise * rng.standard_normal(total)
    grades = np.zeros(total, np.int64)
    start = 0
    for n in n_docs:
        order = np.argsort(raw[start:start + n], kind="stable")
        grades[start + order] = np.minimum(4, np.arange(n) * 5 // n)
        start += n
    return x, grades, initial, n_docs


def _ndcg_at(grades_in_order, k: int = 10) -> float:
    gains = 2.0 ** np.asarray(grades_in_order, np.float64) - 1.0
    disc = 1.0 / np.log2(np.arange(2, len(gains) + 2))
    ideal = np.sort(gains)[::-1]
    idcg = float((ideal[:k] * disc[:k]).sum())
    return float((gains[:k] * disc[:k]).sum()) / idcg if idcg > 0 else 0.0


def _write_split(out_dir, prefix, x, grades, initial, n_docs) -> float:
    """The split's ULTRA files and libsvm twin; returns the initial list's
    mean nDCG@10."""
    sub = os.path.join(out_dir, prefix)
    os.makedirs(sub, exist_ok=True)
    tokens = []
    for row in x:
        idx = np.flatnonzero(row)
        tokens.append(" ".join(f"{i + 1}:{row[i] / UNIT:.6f}" for i in idx))
    feat, init, labels, scores, svm = [], [], [], [], []
    ndcgs, start = [], 0
    for q, n in enumerate(n_docs, start=1):
        rows = np.arange(start, start + n)
        order = rows[np.argsort(-initial[rows], kind="stable")]
        for d, r in enumerate(rows):
            feat.append(f"{prefix}_{q}_{d} {tokens[r]}\n")
        init.append(f"{q} " + " ".join(str(r) for r in order) + "\n")
        labels.append(f"{q} " + " ".join(
            f"{float(grades[r])}" for r in order) + "\n")
        scores.append(f"{q} " + " ".join(
            f"{initial[r]:.6f}" for r in order) + "\n")
        svm.extend(f"{grades[r]} qid:{q} {tokens[r]}\n" for r in order)
        ndcgs.append(_ndcg_at(grades[order]))
        start += n
    for ext, lines in (("feature", feat), ("init_list", init),
                       ("labels", labels), ("initial_scores", scores),
                       ("txt", svm)):
        with open(os.path.join(sub, f"{prefix}.{ext}"), "w") as fout:
            fout.writelines(lines)
    return float(np.mean(ndcgs))


def generate(out_dir: str, **overrides) -> dict:
    """Write the dataset under `out_dir` (:data:`GENERATOR`'s arguments,
    with `overrides`); returns the arguments, each file's sha256 and
    bytes, and each split's initial-list nDCG@10."""
    args = dict(GENERATOR, **overrides)
    rng = np.random.default_rng(args["seed"])
    w = np.round(rng.standard_normal(args["features"]) * UNIT).astype(
        np.int64)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "settings.json"), "w") as fout:
        json.dump({"feature_size": args["features"], "max_label": 4.0},
                  fout)
    initial_ndcg = {}
    for i, prefix in enumerate(SPLITS):
        n = args[f"{prefix}_queries"]
        if n == 0:
            continue
        split_rng = np.random.default_rng([args["seed"], i + 1])
        arrays = _split_arrays(
            split_rng, w, n, args["features"], args["min_docs"],
            args["max_docs"], args["min_nnz"], args["max_nnz"],
            args["label_noise"], args["init_noise"])
        initial_ndcg[prefix] = _write_split(out_dir, prefix, *arrays)
    files = {}
    for dirpath, _, names in sorted(os.walk(out_dir)):
        for name in sorted(names):
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fin:
                blob = fin.read()
            files[os.path.relpath(path, out_dir)] = {
                "sha256": hashlib.sha256(blob).hexdigest(),
                "bytes": len(blob)}
    return {"args": args, "files": files, "initial_ndcg_10": initial_ndcg}


# -- settings --------------------------------------------------------------
def settings(algorithm: str, hidden, kernels: bool):
    """``configs/<name>.json`` of `algorithm` with the DNN at `hidden`, the
    protocol's click model and cutoff, its ``./example/`` paths under the
    checkout, and with `kernels` every kernel hparam its path allows (the
    fused MLP, the fused listwise loss where the loss is the softmax, the
    PBM click kernel on the offline feeds)."""
    config = ALGORITHMS[algorithm][0]
    with open(os.path.join(ROOT, "configs", f"{config}.json")) as fin:
        out = json.loads(fin.read().replace(
            "./example/", os.path.join(ROOT, "example") + "/"))
    on = "true" if kernels else "false"
    sizes = ", ".join(str(h) for h in hidden)
    click = (f"click_model_json="
             f"{os.path.join(ROOT, PROTOCOL['click_model'])}")
    feed = click if algorithm in ONLINE else f"{click},use_pallas_click={on}"
    out.update(ranking_model_hparams=(f"hidden_layer_sizes=[{sizes}],"
                                      f"use_pallas={on}"),
               train_input_hparams=feed,
               selection_bias_cutoff=PROTOCOL["selection_bias_cutoff"])
    if kernels and algorithm in SOFTMAX:
        extra = out.get("learning_algorithm_hparams", "")
        out["learning_algorithm_hparams"] = ",".join(
            p for p in (extra, "loss_func=fused_softmax_loss") if p)
    return out


def record(curve, steps_at) -> dict:
    """A run's record from its validation curve (step 0 first)."""
    k = PROTOCOL["final_points"]
    return {"steps": list(steps_at), "curve": list(curve),
            "untrained": curve[0], "peak": max(curve[1:]),
            "final": float(np.mean(curve[-k:]))}


# -- the port's side -------------------------------------------------------
def run_port(algorithm: str, seed: int, data_dir: str, steps: int,
             device="cuda", hidden=None, datasets=None,
             overrides=None) -> dict:
    """One run of `algorithm` with every kernel hparam on through the
    port's Experiment; `overrides` are ``key=value`` learning-algorithm
    hparams appended to its own."""
    from ultra_pytorch_tpu_torch.run.experiment import Experiment

    exp_settings = settings(algorithm, hidden or PROTOCOL["hidden"], True)
    if overrides:
        exp_settings["learning_algorithm_hparams"] = ",".join(
            p for p in (exp_settings.get("learning_algorithm_hparams", ""),
                        overrides) if p)
    exp = Experiment(exp_settings, data_dir, os.path.join(
        data_dir, "..", "model"), batch_size=PROTOCOL["batch"], seed=seed,
        device=device)
    exp.setup(datasets=datasets)
    exp.init_state()
    t0 = time.perf_counter()
    every = PROTOCOL["eval_every"]
    curve, at = [exp.validate("valid")[METRIC]], [0]
    for done in range(every, steps + 1, every):
        exp.train_steps(every)
        curve.append(exp.validate("valid")[METRIC])   # a host read
        at.append(done)
    out = record(curve, at)
    out["seconds"] = time.perf_counter() - t0
    out["windows"] = exp.eager_reason() or "graphs"
    return out


def load_datasets(data_dir: str):
    """The train and valid splits, read once for every run."""
    from ultra_pytorch_tpu_torch.data.dataset import read_data

    return {s: read_data(data_dir, s) for s in ("train", "valid")}


# -- the check -------------------------------------------------------------
def stats(runs, key: str):
    """(mean, sample standard deviation, n) of `key` over `runs`."""
    values = np.asarray([r[key] for r in runs], np.float64)
    std = float(values.std(ddof=1)) if len(values) > 1 else 0.0
    return float(values.mean()), std, len(values)


def band(port_runs, jax_runs, name: str = None) -> dict:
    """The verdict for algorithm `name`: for peak and final, the two means,
    standard deviations, the band and whether the port lies in it; the
    trained - untrained gain on each side (required unless `name` is in
    NO_GAIN); the verdict."""
    out = {"ok": True}
    for key in ("peak", "final"):
        mp, sp, n_p = stats(port_runs, key)
        mj, sj, n_j = stats(jax_runs, key)
        width = max(BAND_FLOOR,
                    BAND_SIGMAS * math.sqrt(sp ** 2 / n_p + sj ** 2 / n_j))
        inside = abs(mp - mj) <= width
        out[key] = {"port": [mp, sp, n_p], "jax": [mj, sj, n_j],
                    "band": width, "inside": inside}
        out["ok"] &= inside
    for side, runs in (("port", port_runs), ("jax", jax_runs)):
        gain = float(np.mean([r["peak"] - r["untrained"] for r in runs]))
        out[f"gain_{side}"] = gain
        out["ok"] &= gain >= MIN_GAIN or name in NO_GAIN
    return out


def describe(name: str, verdict: dict) -> str:
    parts = []
    for key in ("peak", "final"):
        v = verdict[key]
        parts.append(
            f"{key} port {v['port'][0]:.4f} +- {v['port'][1]:.4f} "
            f"(n={v['port'][2]}) jax {v['jax'][0]:.4f} +- "
            f"{v['jax'][1]:.4f} (n={v['jax'][2]}) |diff| "
            f"{abs(v['port'][0] - v['jax'][0]):.4f} band {v['band']:.4f}")
    return (f"[convergence] {name}: " + "; ".join(parts)
            + f"; gain port {verdict['gain_port']:.4f} jax "
            f"{verdict['gain_jax']:.4f} ("
            + ("not required" if name in NO_GAIN else f">= {MIN_GAIN}")
            + "); "
            + ("PASS" if verdict["ok"] else "FAIL"))


def check_files(generated: dict, expected: dict) -> list:
    """The files whose sha256 differs from the fixture's (or is missing)."""
    want = expected["generator"]["files"]
    got = generated["files"]
    return sorted(k for k in set(want) | set(got)
                  if want.get(k, {}).get("sha256")
                  != got.get(k, {}).get("sha256"))


def study(data_dir: str, expected: dict, algorithms, seeds: int,
          device="cuda", log=print) -> dict:
    """Every algorithm's port runs against the fixture's JAX runs; returns
    {algorithm: {"runs", "verdict"}}."""
    datasets = load_datasets(data_dir)
    results = {}
    for name in algorithms:
        n_steps = ALGORITHMS[name][1]
        runs = []
        for seed in range(seeds):
            run = run_port(name, seed, data_dir, n_steps, device,
                           datasets=datasets)
            runs.append(run)
            log(f"[convergence] {name} seed {seed}: peak {run['peak']:.4f} "
                f"final {run['final']:.4f} untrained {run['untrained']:.4f} "
                f"in {run['seconds']:.2f} s ({n_steps} steps, windows "
                f"{run['windows']})")
        verdict = band(runs, expected["algorithms"][name]["runs"], name)
        log(describe(name, verdict))
        results[name] = {"runs": runs, "verdict": verdict}
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_dir", default=os.path.join(
        ROOT, "build", "convergence", "data"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--algorithms", default=",".join(ALGORITHMS))
    parser.add_argument("--seeds", type=int, default=PROTOCOL["seeds"])
    args = parser.parse_args(argv)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_convergence: no CUDA device", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(f"[convergence] card: {smi.stdout.strip()}", flush=True)
    sys.path.insert(0, ROOT)
    with open(EXPECTED) as fin:
        expected = json.load(fin)
    generated = generate(args.data_dir, **expected["generator"]["args"])
    differ = check_files(generated, expected)
    if differ:
        print(f"torch_convergence: generated files differ from the "
              f"fixture's: {differ}", file=sys.stderr)
        return 1
    results = study(args.data_dir, expected, args.algorithms.split(","),
                    args.seeds, args.device,
                    log=lambda line: print(line, flush=True))
    return 0 if all(r["verdict"]["ok"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
