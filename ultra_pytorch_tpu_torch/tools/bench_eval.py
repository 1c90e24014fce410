"""Validation-path throughput: three ways of validating, held to one
another.

The port's counterpart of the JAX package's ``tools/bench_eval.py``. On a
valid split of `--queries` synthetic queries of `--list-size` candidates
(ragged: each list keeps between half and all of them), the DLA ranker
of the bench protocol at full width with K1 (state from the seed) is
validated

* ``fused``: ``Experiment.validate``, on the card one replayed CUDA graph
  a split (eager on the CPU), one read-back;
* ``naive_loop``: a Python loop over the split's batches that reads each
  batch's metrics back to the host, never captured (the counterpart of
  the JAX tool's ``naive_validate``);
* ``pipelined``: pass i + 1 dispatched (``validate_device``) before pass
  i's values are read; ``deep_pipeline``: every pass dispatched, then
  every one read.

All three use the same tie-break draws, and their metrics must agree
within 1e-4 (the tool raises otherwise). ``window_share_pct`` is the
share a pass would take of a 50-step training window at the
training rate this run measures on the bench protocol (graph windows on
the card), so no other machine's rate enters it.

Usage: python -m ultra_pytorch_tpu_torch.tools.bench_eval [--queries 1000]
           [--list-size 200] [--features 136] [--batch 256] [--repeats 5]
           [--device cuda]
"""

from __future__ import annotations

import json
import time
from typing import Dict

import numpy as np

from ultra_pytorch_tpu_torch.tools import bench_common as bc

AGREE = 1e-4
WINDOW = 50    # training steps a window (the CLI's steps_per_checkpoint)
TRAIN_WINDOWS = 4


def ragged(ds, seed: int):
    """`ds` with each list cut to a length drawn between half (at least
    3) and all of its documents; labels 0 where cut."""
    rng = np.random.default_rng(seed)
    q, length = ds.initial_list.shape
    keep = rng.integers(min(max(length // 2, 3), length), length + 1,
                        size=q)
    cut = np.arange(length)[None, :] >= keep[:, None]
    ds.initial_list = np.where(cut, -1, ds.initial_list)
    ds.labels = np.where(cut, 0.0, ds.labels).astype(np.float32)
    ds.initial_list_lengths = keep
    return ds


def loop_validate(exp, split: str = "valid") -> Dict[str, float]:
    """One batch at a time, each batch's metrics read back to the host,
    merged weighted by query counts; the tie-break draws of
    ``Experiment.validate``."""
    from ultra_pytorch_tpu_torch.data.dataset import merge_summary

    gen = exp._eval_generator()
    summaries, counts = [], []
    for batch, _, count in exp.feeds[split].eval_batches():
        _, summary = exp.algorithm.validation_metrics(exp.state, batch,
                                                      generator=gen)
        summaries.append({k: float(v) for k, v in summary.items()})
        counts.append(count)
    return merge_summary(summaries, counts)


def train_rate(device, batch: int, features: int, hidden: str) -> float:
    """Training queries/s on the bench protocol (L = 10) at this batch and
    width: TRAIN_WINDOWS windows of WINDOW steps after a warm-up window."""
    exp = bc.bench_experiment(device, batch, bc.LIST, features, hidden)
    exp.train_steps_device(WINDOW)
    bc.sync(device)
    t0 = time.perf_counter()
    for _ in range(TRAIN_WINDOWS):
        exp.train_steps_device(WINDOW)
    bc.sync(device)
    return TRAIN_WINDOWS * WINDOW * batch / (time.perf_counter() - t0)


def bench(device, queries: int = 1000, list_size: int = 200,
          features: int = bc.FEATURES, hidden: str = bc.HIDDEN,
          batch: int = bc.BATCH, repeats: int = 5) -> Dict:
    data = {"train": bc.synthetic(64, 0, list_size, features),
            "valid": ragged(bc.synthetic(queries, 1, list_size, features),
                            2)}
    exp = bc.bench_experiment(device, batch, list_size, features, hidden,
                              data=data)
    qps_train = train_rate(device, batch, features, hidden)
    window_s = WINDOW * batch / qps_train

    def row(dt: float) -> Dict[str, float]:
        return {"wall_s": dt, "eval_queries_per_sec": queries / dt,
                "window_share_pct": 100 * dt / (dt + window_s)}

    before = bc.launch_counts()
    out = {"queries": queries, "list_size": list_size, "features": features,
           "batch": batch, "metric_values": len(exp._metric_keys()),
           "device": str(device), "train_queries_per_sec": qps_train,
           "window": WINDOW}
    values = {}
    for name, fn in (("fused", exp.validate),
                     ("naive_loop", lambda: loop_validate(exp))):
        first = fn()   # warm-up (on the card, the graph's capture)
        bc.sync(device)
        t0 = time.perf_counter()
        for _ in range(repeats):
            last = fn()
        dt = (time.perf_counter() - t0) / repeats
        for k in first:
            assert abs(first[k] - last[k]) < AGREE, (name, k, first[k],
                                                     last[k])
        values[name] = last
        out[name] = row(dt)

    keys, prev = exp.validate_device()
    t0 = time.perf_counter()
    for _ in range(repeats):
        _, cur = exp.validate_device()
        prev.tolist()
        prev = cur
    values["pipelined"] = dict(zip(keys, prev.tolist()))
    out["pipelined"] = row((time.perf_counter() - t0) / (repeats + 1))

    n = repeats + 1
    t0 = time.perf_counter()
    vecs = [exp.validate_device()[1] for _ in range(n)]
    read = [v.tolist() for v in vecs]
    values["deep_pipeline"] = dict(zip(keys, read[-1]))
    out["deep_pipeline"] = row((time.perf_counter() - t0) / n)
    out["launches"] = bc.launches_since(before)

    diff = max(abs(v[k] - values["fused"][k])
               for v in values.values() for k in keys)
    out["max_diff"] = diff
    out["metrics"] = values["fused"]
    if diff > AGREE:
        raise AssertionError(f"validation ways differ by {diff} > {AGREE}: "
                             f"{values}")
    out["speedup"] = out["naive_loop"]["wall_s"] / out["fused"]["wall_s"]
    out["speedup_pipelined"] = (out["naive_loop"]["wall_s"]
                                / out["pipelined"]["wall_s"])
    return out


def main(argv=None) -> Dict:
    p = bc.tool_parser(__doc__.splitlines()[0])
    p.add_argument("--queries", type=int, default=1000)
    p.add_argument("--list-size", type=int, default=200)
    p.add_argument("--features", type=int, default=bc.FEATURES)
    p.add_argument("--hidden", default=bc.HIDDEN)
    p.add_argument("--batch", type=int, default=bc.BATCH)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    device = bc.start(args)
    out = bench(device, args.queries, args.list_size, args.features,
                args.hidden, args.batch, args.repeats)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
