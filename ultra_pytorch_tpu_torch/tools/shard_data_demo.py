"""Istella-scale feature-table sharding demo.

The port's counterpart of the JAX package's ``tools/shard_data_demo.py``.
A synthetic table of Istella's size (10M query-document rows x 220
features, 8.8 GB of float32, in lists of 200) is striped over the ranks
of a data-parallel group, each rank holding its queries and only the
feature rows they reference on its device (``shard_data``, the
counterpart of ``device_sharded_dataset``), and DLA trains on it through
the product's data-parallel path: one CUDA graph a window with its
all-reduces inside under NCCL, eager windows under gloo.

The table is the JAX demo's: ``initial_list = arange(Q * L).reshape(Q,
L)``, grades 0-4 with the first document at least 1, ``max_label`` 4.
Host memory is what limits a full table: ``shard_queries_for_host`` of the
whole table would build all of it on every rank's host. So the features
are drawn in fixed blocks of BLOCK_ROWS rows, each from its own numpy
generator seeded by (seed, block), in threads; a rank draws only the
blocks its stripe references (with ``initial_list = arange`` a stripe is
one range of rows, wrapped at the end) and the stripe it builds equals
``shard_queries_for_host`` of the whole table, array for array
(:func:`stripe_dataset`). The feature table goes to the device in one
copy (``RankingDataset.to_device``).

The model is the JAX demo's (DLA, the DNN at [512, 256, 128],
``max_candidate_num`` = L, cutoff 10, nDCG@10, ``example/ClickModel/
pbm_0.1_1.0_4_1.0.json``), the kernel hparams off as in the JAX demo.
A step trains on the top 10 documents of each list (the cutoff); with
``--kernels`` it runs K1 and K2 over B x 10 rows of F features and K3
and K4 at [B, 10], and K5 once a window. Each step is a window of one step whose loss is
read back, as the JAX demo reads each step's; ``queries_per_s`` leaves
out the first step (the capture on the card).

Prints one JSON line with the JAX demo's keys (``queries_per_s`` in
place of ``queries_per_s_cpu_mesh``) and the port's: ``ranks``,
``shared_card``, ``windows`` ("graph" or "eager"),
``max_memory_allocated_gb`` a rank (``torch.cuda.max_memory_allocated``,
null on the CPU), the seconds to build a stripe, and the kernels'
``launches`` summed over the ranks.

Usage: python -m ultra_pytorch_tpu_torch.tools.shard_data_demo
           [--rows 10000000] [--features 220] [--list_size 200]
           [--steps 20] [--batch 256] [--ranks N] [--share_card N]
           [--kernels] [--device cpu]
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ultra_pytorch_tpu_torch.tools import bench_common as bc

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CLICK_JSON = os.path.join(ROOT, "example", "ClickModel",
                          "pbm_0.1_1.0_4_1.0.json")
BLOCK_ROWS = 1_000_000      # rows a generator block of the feature table
MAX_LABEL = 4.0


def draw_block(seed: int, block: int, rows: int, features: int,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Rows ``block * BLOCK_ROWS ...`` of the table (`rows` of them), from
    the block's own generator; into `out` when given."""
    rng = np.random.default_rng([seed, 0, block])
    return rng.standard_normal((rows, features), dtype=np.float32, out=out)


def table_labels(seed: int, queries: int, list_size: int) -> np.ndarray:
    """Every query's grades, 0-4 with the first document at least 1."""
    rng = np.random.default_rng([seed, 1])
    labels = rng.integers(0, 5, size=(queries, list_size)).astype(np.float32)
    labels[:, 0] = np.maximum(labels[:, 0], 1.0)
    return labels


def fill_rows(out: np.ndarray, used: np.ndarray, total_rows: int,
              seed: int, block_rows: int = BLOCK_ROWS,
              threads: int = 1) -> None:
    """``out[i]`` = row ``used[i]`` of the table of `total_rows` rows
    (`used` sorted and unique), drawing only the blocks that `used`
    touches, `threads` blocks at a time. A block used whole is drawn
    straight into `out`."""
    features = out.shape[1]

    def one(block: int) -> None:
        lo = block * block_rows
        n = min(block_rows, total_rows - lo)
        i0, i1 = np.searchsorted(used, [lo, lo + n])
        if i1 - i0 == n:
            draw_block(seed, block, n, features, out=out[i0:i1])
        else:
            out[i0:i1] = draw_block(seed, block, n, features)[
                used[i0:i1] - lo]

    blocks = np.unique(used // block_rows)
    with ThreadPoolExecutor(max(threads, 1)) as pool:
        list(pool.map(one, blocks))   # raises a block's failure


def stripe_rows(queries: int, list_size: int, rank: int, ranks: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Stripe `rank`'s queries (``shard_queries_for_host``'s: ceil(Q/H)
    of them from ``rank * ceil(Q/H)``, wrapped) and the sorted table rows
    they reference."""
    qh = -(-queries // ranks)
    sel = np.arange(rank * qh, (rank + 1) * qh) % queries
    rows = sel[:, None] * list_size + np.arange(list_size)
    return sel, np.unique(rows)


def stripe_dataset(rows: int, features: int, list_size: int, rank: int,
                   ranks: int, seed: int = 0, block_rows: int = BLOCK_ROWS,
                   threads: int = 1):
    """Stripe `rank` of `ranks` of the table of `rows` rows, equal to
    ``shard_queries_for_host`` of the whole table (stripe 0 of 1) array
    for array, drawing only the feature blocks it references."""
    from ultra_pytorch_tpu_torch.data.dataset import RankingDataset

    queries = rows // list_size
    if queries < ranks:
        raise ValueError(f"{queries} queries cannot stripe over {ranks} "
                         "ranks")
    sel, used = stripe_rows(queries, list_size, rank, ranks)
    feats = np.empty((used.size, features), np.float32)
    fill_rows(feats, used, queries * list_size, seed, block_rows, threads)
    initial_list = np.searchsorted(
        used, sel[:, None] * list_size + np.arange(list_size))
    return RankingDataset(
        features=feats, initial_list=initial_list,
        labels=table_labels(seed, queries, list_size)[sel], qids=sel,
        dids=used, feature_size=features, rank_list_size=list_size,
        max_label=MAX_LABEL)


def demo_settings(list_size: int, kernels: bool = False) -> Dict:
    """The JAX demo's settings (the bench protocol's at lists of
    `list_size`, the cutoff at 10), with ``bench_common.KERNEL_EXTRAS``
    when `kernels`."""
    settings = bc.protocol_settings(CLICK_JSON, list_size,
                                    **bc.extras(kernels))
    settings["selection_bias_cutoff"] = 10
    return settings


def _rank_demo(rank: int, world: int, init_method: str, device: str,
               backend: Optional[str], rows: int, features: int,
               list_size: int, steps: int, batch: int, seed: int,
               kernels: bool) -> Dict:
    """One rank's stripe and training: its table's bytes, the seconds to
    build it, the step losses, the timed steps' seconds, whether the
    windows ran as graphs, its peak device memory and launches."""
    from ultra_pytorch_tpu_torch.parallel import (
        close_data_parallel, init_data_parallel, same_on_every_rank)
    from ultra_pytorch_tpu_torch.run.experiment import Experiment
    from ultra_pytorch_tpu_torch.run.launch import host_threads, rank_device

    dev = rank_device(device, rank)
    threads = host_threads(world)
    torch.set_num_threads(threads)
    init_data_parallel(world, rank, dev, backend=backend,
                       init_method=init_method)
    try:
        t0 = time.perf_counter()
        stripe = stripe_dataset(rows, features, list_size, rank, world, seed,
                                threads=threads)
        build_s = time.perf_counter() - t0
        table_bytes = stripe.features.nbytes
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        before = bc.launch_counts()
        with tempfile.TemporaryDirectory(prefix="ultra_demo_") as tmp:
            exp = Experiment(demo_settings(list_size, kernels), tmp,
                             os.path.join(tmp, "model"), batch_size=batch,
                             seed=seed, device=dev)
            exp.setup(splits=("train",), datasets={"train": stripe})
            exp.init_state()
            losses = []
            for i in range(steps):
                losses.append(exp.train_steps(1)["loss"])
                if i == 0:
                    t1 = time.perf_counter()
            seconds = time.perf_counter() - t1
        return {"table_bytes": table_bytes, "build_s": build_s,
                "losses": losses, "seconds": seconds,
                "graph": exp.eager_reason() is None,
                "same": same_on_every_rank(
                    exp.algorithm.state_leaves(exp.state), dev),
                "max_memory_allocated_gb": (
                    torch.cuda.max_memory_allocated(dev) / 1e9
                    if dev.type == "cuda" else None),
                "launches": bc.launches_since(before)}
    finally:
        close_data_parallel()


def demo(device, rows: int = 10_000_000, features: int = 220,
         list_size: int = 200, steps: int = 20, batch: int = 256,
         ranks: Optional[int] = None, share_card: int = 0,
         seed: int = 0, kernels: bool = False) -> Dict:
    """The demo over `ranks` ranks (default: the visible cards on the
    card, 1 on the CPU), or `share_card` gloo ranks on ``cuda:0``."""
    from ultra_pytorch_tpu_torch.parallel import spawn_ranks

    from ultra_pytorch_tpu_torch.run.launch import shared_card

    device, backend = torch.device(device), None
    if share_card:
        ranks, device, backend = shared_card(share_card, device)
    elif ranks is None:
        ranks = torch.cuda.device_count() if device.type == "cuda" else 1
    if steps < 2:
        raise ValueError("--steps must be at least 2 (the first is not "
                         "timed)")
    queries = rows // list_size
    print(f"synthesizing {queries} queries x {list_size} docs x {features} "
          f"features ({queries * list_size * features * 4 / 1e9:.1f} GB "
          f"table) as {ranks} stripe(s)...", flush=True)
    store = tempfile.mkdtemp(prefix="ultra_demo_")
    try:
        out = spawn_ranks(_rank_demo, ranks, (
            f"file://{os.path.join(store, 'rendezvous')}", str(device),
            backend, rows, features, list_size, steps, batch, seed,
            kernels),
            timeout=1800)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    if not all(r["same"] for r in out):
        raise RuntimeError("the ranks' states differ after training")
    losses = out[0]["losses"]
    result = {
        "rows": queries * list_size, "features": features,
        "gb_per_device_sharded": max(r["table_bytes"] for r in out) / 1e9,
        "gb_replicated": queries * list_size * features * 4 / 1e9,
        "steps": steps, "loss_first": losses[0], "loss_last": losses[-1],
        "queries_per_s": (steps - 1) * batch / max(r["seconds"] for r in out),
        "ranks": ranks, "shared_card": bool(share_card),
        "windows": "graph" if all(r["graph"] for r in out) else "eager",
        "max_memory_allocated_gb": [r["max_memory_allocated_gb"]
                                    for r in out],
        "build_s": [r["build_s"] for r in out],
        "launches": {k: sum(r["launches"][k] for r in out)
                     for k in bc.KERNELS}}
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> Dict:
    p = bc.tool_parser(__doc__.splitlines()[0], kernels=True)
    p.add_argument("--rows", type=int, default=10_000_000)
    p.add_argument("--features", type=int, default=220)
    p.add_argument("--list_size", type=int, default=200)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--ranks", type=int, default=None,
                   help="default: the visible cards (1 on the CPU)")
    p.add_argument("--share_card", type=int, default=0,
                   help="N gloo ranks sharing cuda:0")
    args = p.parse_args(argv)
    device = bc.start(args)
    return demo(device, args.rows, args.features, args.list_size,
                args.steps, args.batch, args.ranks, args.share_card,
                kernels=args.kernels)


if __name__ == "__main__":
    main()
