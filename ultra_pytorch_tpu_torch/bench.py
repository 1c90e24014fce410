"""Benchmark: DLA training throughput (queries/s) on one card.

The port's counterpart of the JAX system's ``bench.py``, on its protocol
(``tools/bench_common.make_bench_setup``): synthetic data drawn as the
JAX ``_make_synthetic`` draws it, DLA with the DNN at [512, 256, 128]
over 136 features, batch 256, lists and selection-bias cutoff 10, PBM
clicks at eta 1.0, every kernel hparam at its default (off), the data key
as ``--prng rbg``'s. It trains ``BENCH_STEPS`` steps in windows of
``CHUNK`` after one warm-up window; on the card each window is one
replayed CUDA graph (``Experiment.train_steps_device``), so with the
defaults the graph holds 800 steps of ``F.linear`` and autograd, torch's
softmax loss and the plain click draw. ``--kernels`` adds the JAX
``bench_pallas.py`` ``all_on`` extras (K1-K5).

Prints the card's name and power limit, ``matmul.allow_tf32``, the
baseline, and one JSON line of details (the warm-up's seconds, the graph
pool's bytes, the last window's loss, K1-K5's launches) before the last
line, which has the JAX script's four keys:

  {"metric": "dla_dnn_train_throughput", "value": N, "unit": "queries/s",
   "vs_baseline": N}

``vs_baseline`` is the rate over this machine's CPU running the same
protocol eagerly in plain PyTorch (``--baseline-steps`` steps after one
warm-up step), measured in the same run; ``ULTRA_REF_QPS``, when set,
replaces it (the JAX script divides by its upstream toolbox's CPU rate,
2142 queries/s on the TPU host, which is another machine's figure).

Usage: python -m ultra_pytorch_tpu_torch.bench [--device cuda] [--kernels]
           [--steps 2400] [--chunk 800] [--baseline-steps 20]
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import torch

from ultra_pytorch_tpu_torch.tools import bench_common as bc

BATCH = 256
LIST_SIZE = 10
FEATURES = 136
BENCH_STEPS = 2400
CHUNK = 800        # steps a window: one CUDA graph of 800 steps
PRNG = "rbg"       # the JAX script's jax_default_prng_impl


def cpu_baseline(steps: int) -> float:
    """Queries/s of the protocol on this machine's CPU, eager in plain
    PyTorch: one warm-up step, then `steps` steps as one window."""
    exp = bc.make_bench_setup("cpu", BATCH, LIST_SIZE, FEATURES, prng=PRNG)
    exp.train_steps_device(1)
    t0 = time.perf_counter()
    exp.train_steps_device(steps)
    return steps * BATCH / (time.perf_counter() - t0)


def main(argv=None) -> Dict:
    p = bc.tool_parser(__doc__.splitlines()[0], kernels=True)
    p.add_argument("--steps", type=int, default=BENCH_STEPS)
    p.add_argument("--chunk", type=int, default=CHUNK)
    p.add_argument("--baseline-steps", type=int, default=20,
                   help="CPU steps of the baseline (ULTRA_REF_QPS skips it)")
    args = p.parse_args(argv)
    device = bc.start(args)
    print(f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    ref = os.environ.get("ULTRA_REF_QPS")
    if ref is None:
        ref_qps = cpu_baseline(args.baseline_steps)
        print(f"baseline: {ref_qps:.1f} queries/s, plain PyTorch eager on "
              f"this machine's CPU ({torch.get_num_threads()} threads, "
              f"{args.baseline_steps} steps)", flush=True)
    else:
        ref_qps = float(ref)
        print(f"baseline: ULTRA_REF_QPS = {ref_qps}", flush=True)
    before = bc.launch_counts()
    exp = bc.make_bench_setup(device, BATCH, LIST_SIZE, FEATURES,
                              prng=PRNG, **bc.extras(args.kernels))
    run = bc.time_chunks(exp, args.steps, args.chunk, verbose=False)
    run["launches"] = bc.launches_since(before)
    run.update(device=str(exp.device), chunk=args.chunk,
               kernels=args.kernels, baseline_queries_per_s=ref_qps)
    print(json.dumps(run), flush=True)
    qps = run["queries_per_s"]
    out = {
        "metric": "dla_dnn_train_throughput",
        "value": round(qps, 1),
        "unit": "queries/s",
        "vs_baseline": round(qps / ref_qps, 2),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
