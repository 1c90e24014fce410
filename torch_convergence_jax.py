#!/usr/bin/env python3
"""The JAX package's side of the convergence study (``torch_convergence.py``):
the same generated data, protocol and algorithms through
``ultra_pytorch_tpu``'s ``Experiment`` on the CPU, written as the fixture
``tests/torch_convergence_expected.json`` that the port's side is held to.

This script is the reference's, not the port's: it imports the JAX
package. Run from the root of a checkout:

    python3 torch_convergence_jax.py                   # the full protocol
    python3 torch_convergence_jax.py --algorithms DLA  # one algorithm,
                                       # merged into an existing fixture
    python3 torch_convergence_jax.py --toy_ceiling     # what
                    # tools/make_toy_data.py's data lets a learner reach

Each kernel hparam of the port's settings runs here as the function it
computes (``use_pallas``, ``use_pallas_click`` and ``fused_softmax_loss``
off): on the CPU the JAX package would run its Pallas kernels in interpret
mode, which computes the same values far slower. The fixture holds the
generator's arguments, each generated file's sha256 and size, every run's
curve, peak, final and untrained value, the command and the commit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch_convergence as conv  # noqa: E402


def run_jax(algorithm: str, seed: int, data_dir: str, steps: int,
            hidden=None, overrides=None) -> dict:
    """One run of `algorithm` through the JAX package's Experiment on one
    CPU device."""
    from ultra_pytorch_tpu.run.experiment import Experiment

    exp_settings = conv.settings(algorithm, hidden or
                                 conv.PROTOCOL["hidden"], kernels=False)
    if overrides:
        exp_settings["learning_algorithm_hparams"] = ",".join(
            p for p in (exp_settings.get("learning_algorithm_hparams", ""),
                        overrides) if p)
    exp = Experiment(exp_settings, data_dir, os.path.join(
        data_dir, "..", "model_jax"), batch_size=conv.PROTOCOL["batch"],
        seed=seed, dp=0)
    exp.setup()
    exp.init_state()
    t0 = time.perf_counter()
    every = conv.PROTOCOL["eval_every"]
    curve, at = [exp.validate("valid")[conv.METRIC]], [0]
    for done in range(every, steps + 1, every):
        exp.train_steps(every)
        curve.append(exp.validate("valid")[conv.METRIC])
        at.append(done)
    out = conv.record(curve, at)
    out["seconds"] = time.perf_counter() - t0
    return out


def toy_ceiling(out_dir: str, queries: int = 400, seed: int = 1234) -> dict:
    """What ``tools/make_toy_data.py``'s data lets a learner reach: it draws
    a hidden scorer inside each split from that split's own seed, so the
    train split's scorer is not the valid split's. Writes the data at its
    default arguments with `queries` queries a split and returns the two
    scorers' cosine and the valid split's nDCG@10 for a random order (the
    mean of 100 shuffles), the train split's scorer, the valid split's own
    and the initial list."""
    import numpy as np

    from tools.make_toy_data import main as make_main

    make_main([out_dir, "--queries", str(queries), "--seed", str(seed)])
    # make_split's first draw from each split's generator is its scorer.
    w_train, w_valid = (np.random.default_rng(seed + i).normal(size=136)
                        for i in (0, 1))
    sub = os.path.join(out_dir, "valid")
    feats = []
    with open(os.path.join(sub, "valid.feature")) as fin:
        for line in fin:
            vec = np.zeros(136)
            for tok in line.split()[1:]:
                i, v = tok.split(":")
                vec[int(i) - 1] = float(v)
            feats.append(vec)
    x = np.asarray(feats)
    with open(os.path.join(sub, "valid.init_list")) as fin:
        lists = [[int(t) for t in line.split()[1:]] for line in fin]
    with open(os.path.join(sub, "valid.labels")) as fin:
        labels = [[float(t) for t in line.split()[1:]] for line in fin]
    rng = np.random.default_rng(0)
    out = {"cosine_train_valid": float(
        w_train @ w_valid / np.linalg.norm(w_train) / np.linalg.norm(w_valid))}
    for name, order_of in (
            ("random", None),
            ("train_scorer", lambda rows: np.argsort(-(x[rows] @ w_train),
                                                     kind="stable")),
            ("valid_scorer", lambda rows: np.argsort(-(x[rows] @ w_valid),
                                                     kind="stable")),
            ("initial_list", lambda rows: np.arange(len(rows)))):
        values = []
        for rows, grades in zip(lists, labels):
            grades = np.asarray(grades)
            if order_of is None:
                values.append(np.mean([conv._ndcg_at(
                    grades[rng.permutation(len(rows))]) for _ in range(100)]))
            else:
                values.append(conv._ndcg_at(grades[order_of(rows)]))
        out[f"ndcg_10_{name}"] = float(np.mean(values))
    return out


def commit() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
            text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_dir", default=os.path.join(
        ROOT, "build", "convergence_jax", "data"))
    parser.add_argument("--out", default=conv.EXPECTED)
    parser.add_argument("--algorithms", default=",".join(conv.ALGORITHMS))
    parser.add_argument("--seeds", type=int, default=conv.PROTOCOL["seeds"])
    parser.add_argument("--toy_ceiling", action="store_true",
                        help="print what tools/make_toy_data.py's data lets "
                             "a learner reach (400 queries a split) and exit")
    args = parser.parse_args(argv)
    if args.toy_ceiling:
        print(json.dumps(toy_ceiling(os.path.join(
            os.path.dirname(args.data_dir), "toy")), indent=1))
        return 0

    generated = conv.generate(args.data_dir)
    print(f"data: {generated['initial_ndcg_10']} initial nDCG@10; "
          f"{sum(f['bytes'] for f in generated['files'].values())} bytes",
          flush=True)
    fixture = {"algorithms": {}}
    if os.path.isfile(args.out):
        with open(args.out) as fin:
            fixture = json.load(fin)
        if fixture.get("generator", {}).get("files") != generated["files"]:
            fixture = {"algorithms": {}}   # another dataset: start over
    fixture.update(generator=generated, protocol=conv.PROTOCOL,
                   steps={a: s for a, (_, s) in conv.ALGORITHMS.items()},
                   band={"floor": conv.BAND_FLOOR,
                         "sigmas": conv.BAND_SIGMAS,
                         "min_gain": conv.MIN_GAIN,
                         "no_gain": list(conv.NO_GAIN)})
    for name in args.algorithms.split(","):
        steps = conv.ALGORITHMS[name][1]
        runs = []
        for seed in range(args.seeds):
            run = run_jax(name, seed, args.data_dir, steps)
            runs.append(run)
            print(f"[jax] {name} seed {seed}: peak {run['peak']:.4f} final "
                  f"{run['final']:.4f} untrained {run['untrained']:.4f} in "
                  f"{run['seconds']:.1f} s", flush=True)
        fixture["algorithms"][name] = {
            "runs": runs, "steps": steps,
            "command": " ".join(["python3", "torch_convergence_jax.py"]
                                + (argv if argv is not None
                                   else sys.argv[1:])),
            "commit": commit(), "jax": jax.__version__,
            "device": "cpu"}
        with open(args.out, "w") as fout:
            json.dump(fixture, fout, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
