"""Data-parallel scaling efficiency of the DLA training window.

The port's counterpart of the JAX package's ``tools/bench_scaling.py``.
Runs the JAX bench protocol's training window
(``bench_common.make_bench_setup``, the JAX tool's ``_exp_settings(10)``:
DLA with the DNN at [512, 256, 128], F = 136, the kernel hparams off;
``--kernels`` turns K1-K5 on) as 1, 2, 4, ... data-parallel ranks and reports queries/s and the scaling efficiency
against the 1-rank row. Each rank holds the whole split (4,096 synthetic
queries x 10 documents, as the JAX tool's ``shard_dataset`` replicates
it) and draws B / N of the B = 256 queries a step.

World sizes run up to the visible cards on the card (NCCL, rank i on
``cuda:i``; each window one CUDA graph with its all-reduces inside), up to
``--max_ranks`` on the CPU (gloo), the counterpart of the JAX tool's
virtual CPU mesh. ``--share_card N`` runs up to N gloo ranks on
``cuda:0``: their windows run eager and their lines say
``"shared_card": true``, since ranks that share one card measure the
host, not scaling. On a machine with one card the default run is the
1-rank row.

Each world size spawns its ranks, runs one warm-up window (the capture on
the card), then times `windows` windows: the clock starts at a CUDA
synchronize on every rank after a barrier (a one-element all-reduce) and
stops at the last window's read-back; the slowest rank's time counts.
Each prints one JSON line with the JAX tool's keys (``devices``,
``queries_per_sec``, ``scaling_efficiency``) and the port's (``windows``:
"graph" or "eager", ``shared_card``, ``same_state``: the state identical
on every rank afterwards, and the kernels' ``launches`` summed over the
ranks).

Usage: python -m ultra_pytorch_tpu_torch.tools.bench_scaling
           [steps_per_window] [windows] [--share_card N] [--kernels]
           [--device cpu]
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import torch

from ultra_pytorch_tpu_torch.tools import bench_common as bc


def _rank_rate(rank: int, world: int, init_method: str, device: str,
               backend: Optional[str], window: int, windows: int,
               features: int, hidden: str, kernels: bool) -> Dict:
    """One rank's timed windows: seconds, whether they ran as graphs,
    whether the state equals rank 0's, and the kernels' launches."""
    from ultra_pytorch_tpu_torch.parallel import (
        all_reduce_mean, close_data_parallel, init_data_parallel,
        same_on_every_rank)
    from ultra_pytorch_tpu_torch.run.launch import host_threads, rank_device

    dev = rank_device(device, rank)
    torch.set_num_threads(host_threads(world))
    init_data_parallel(world, rank, dev, backend=backend,
                       init_method=init_method)
    try:
        before = bc.launch_counts()
        exp = bc.make_bench_setup(dev, features=features, hidden=hidden,
                                  **bc.extras(kernels))
        exp.train_steps(window)                     # warm-up (capture)
        all_reduce_mean(torch.zeros(1, device=dev))
        bc.sync(dev)
        t0 = time.perf_counter()
        for _ in range(windows):
            _, means = exp.train_steps_device(window)
        means.tolist()
        seconds = time.perf_counter() - t0
        return {"seconds": seconds, "graph": exp.eager_reason() is None,
                "same": same_on_every_rank(
                    exp.algorithm.state_leaves(exp.state), dev),
                "launches": bc.launches_since(before)}
    finally:
        close_data_parallel()


def world_sizes(limit: int) -> List[int]:
    """1, 2, 4, ... up to `limit`."""
    sizes, n = [], 1
    while n <= limit:
        sizes.append(n)
        n *= 2
    return sizes


def scaling(device, window: int = 25, windows: int = 4,
            max_ranks: int = 2, share_card: int = 0,
            features: int = bc.FEATURES, hidden: str = bc.HIDDEN,
            kernels: bool = False) -> List[Dict]:
    """One row a world size (see the module's docstring), printed as it
    is measured."""
    from ultra_pytorch_tpu_torch.parallel import spawn_ranks
    from ultra_pytorch_tpu_torch.run.launch import shared_card

    device = torch.device(device)
    if share_card:
        limit, device, backend = shared_card(share_card, device)
    elif device.type == "cuda":
        limit, backend = torch.cuda.device_count(), None
    else:
        limit, backend = max_ranks, None
    rows = []
    for n in world_sizes(limit):
        store = tempfile.mkdtemp(prefix="ultra_scaling_")
        try:
            ranks = spawn_ranks(_rank_rate, n, (
                f"file://{os.path.join(store, 'rendezvous')}", str(device),
                backend, window, windows, features, hidden, kernels),
                timeout=1800)
        finally:
            shutil.rmtree(store, ignore_errors=True)
        qps = window * windows * bc.BATCH / max(r["seconds"] for r in ranks)
        base = rows[0]["queries_per_sec"] if rows else qps
        rows.append({
            "devices": n, "queries_per_sec": qps,
            "scaling_efficiency": qps / (base * n),
            "windows": "graph" if all(r["graph"] for r in ranks) else "eager",
            "shared_card": bool(share_card),
            "same_state": all(r["same"] for r in ranks),
            "launches": {k: sum(r["launches"][k] for r in ranks)
                         for k in bc.KERNELS}})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> List[Dict]:
    p = bc.tool_parser(__doc__.splitlines()[0], kernels=True)
    p.add_argument("window", nargs="?", type=int, default=25,
                   help="steps a window")
    p.add_argument("windows", nargs="?", type=int, default=4,
                   help="timed windows")
    p.add_argument("--max_ranks", type=int, default=2,
                   help="the largest world size on the CPU")
    p.add_argument("--share_card", type=int, default=0,
                   help="up to N gloo ranks sharing cuda:0")
    p.add_argument("--features", type=int, default=bc.FEATURES)
    p.add_argument("--hidden", default=bc.HIDDEN)
    args = p.parse_args(argv)
    device = bc.start(args)
    return scaling(device, args.window, args.windows, args.max_ranks,
                   args.share_card, args.features, args.hidden, args.kernels)


if __name__ == "__main__":
    main()
